"""Decentralized optimization on the one-sided window and gossip layers.

Counterpart of ``examples/decentralized_optimization.py`` of the JAX package
(BASELINE.json ``configs[2,3]``): push-sum over ``win_accumulate`` on a
directed ring, gradient tracking over ``win_get`` on MeshGrid2D, and exact
diffusion over ``neighbor_allreduce``, on ``n`` virtual ranks.

Problem: distributed least squares.  Rank r holds ``(A_r, b_r)``; the network
minimizes ``f(x) = sum_r ||A_r x - b_r||^2 / 2``, whose optimum solves
``(sum A_r^T A_r) x* = sum A_r^T b_r`` in closed form.  The data comes from
seeded numpy (the JAX example draws it with ``jax.random``), in f32.

Algorithms:

- ``push_sum``: directed ring, mass-weighted gossip through ``win_accumulate``
  with the associated push-sum scalar ``p``; handles topologies that are not
  doubly stochastic.
- ``gradient_tracking``: MeshGrid2D; each rank publishes ``(x, y)`` in a
  window, pulls its neighbours' copies with ``win_get`` and mixes, tracking
  the average gradient; exact optimum with a constant step.
- ``exact_diffusion``: correction-term diffusion (ATC form) on the
  bidirectional ring through ``neighbor_allreduce``.

Run on the GPU (the default device; it raises without one)::

  python -m bluefog_tpu_torch.examples.decentralized_optimization \\
      --algorithm push_sum

and on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from bluefog_tpu_torch.ops import collectives as C
from bluefog_tpu_torch.ops import windows as W
from bluefog_tpu_torch.parallel.context import resolve_device
from bluefog_tpu_torch.topology import (
    MeshGrid2DGraph, RingGraph, build_schedule)

__all__ = ["DIM", "ALGORITHMS", "make_problem", "grad", "push_sum",
           "push_sum_step", "gradient_tracking", "exact_diffusion", "main"]

DIM = 6
SIZE = 8


def make_problem(n: int, seed: int = 7):
    """``(A (n, 12, DIM), b (n, 12))`` f32 numpy arrays from ``seed``, and the
    closed-form optimum ``x*`` in f64."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, 12, DIM)).astype(np.float32)
    b = rng.standard_normal((n, 12)).astype(np.float32)
    AtA = np.einsum("rmi,rmj->ij", A.astype(np.float64), A)
    Atb = np.einsum("rmi,rm->i", A.astype(np.float64), b)
    return A, b, np.linalg.solve(AtA, Atb)


def grad(A: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Every rank's gradient ``A_r^T (A_r x_r - b_r)``, rank-stacked."""
    resid = torch.bmm(A, x[:, :, None])[:, :, 0] - b
    return torch.bmm(A.transpose(1, 2), resid[:, :, None])[:, :, 0]


def push_sum_step(win: W.WindowState, A: torch.Tensor, b: torch.Tensor,
                  t: int, lr: float) -> W.WindowState:
    """Step ``t`` of push-sum on ``win``, an associated-p window over the
    ``(n, DIM)`` iterates."""
    x, p = win.self_buf, W.win_associated_p(win)
    z = x / p.clamp(min=1e-12)[:, None]  # de-biased estimate
    # diminishing step, in f32 as the JAX example computes it
    lr_t = lr / torch.sqrt(1.0 + torch.tensor(float(t)) / 100.0)
    x = x - lr_t * grad(A, b, z) * p[:, None]  # scaled subgradient step
    W.win_sync(win, x)  # republish the post-gradient mass
    # send half the (value, p) mass to the out-neighbour, keep half
    W.win_accumulate(win, None, dst_weight=0.5)
    win.self_buf.mul_(0.5)
    win.assoc_self.mul_(0.5)
    W.win_update_then_collect(win)
    return win


def push_sum(A: torch.Tensor, b: torch.Tensor, steps: int, lr: float
             ) -> torch.Tensor:
    """Push-sum subgradient method on the directed ring: the window carries
    the associated scalar ``p``, which rides every transfer with the
    tensor's weight.  Returns the de-biased iterates ``x / p``."""
    n = A.shape[0]
    sched = build_schedule(RingGraph(n, connect_style=1))
    win = W.win_create(A.new_zeros(n, DIM), sched, associated_p=True)
    for t in range(steps):
        push_sum_step(win, A, b, t, lr)
    return win.self_buf / W.win_associated_p(win).clamp(min=1e-12)[:, None]


def gradient_tracking(A: torch.Tensor, b: torch.Tensor, steps: int,
                      lr: float) -> torch.Tensor:
    """Gradient tracking on MeshGrid2D over ``win_get``: publish ``(x, y)``,
    pull the neighbours' copies, mix, step."""
    n = A.shape[0]
    sched = build_schedule(MeshGrid2DGraph(n))
    x = A.new_zeros(n, DIM)
    g = grad(A, b, x)
    y = g
    win = W.win_create({"x": x, "y": y}, sched)
    for _ in range(steps):
        W.win_sync(win, {"x": x, "y": y})  # publish
        W.win_get(win)  # one-sided pull
        mixed, _ = W.win_update(win)  # weighted mix
        x_new = mixed["x"] - lr * y
        g_new = grad(A, b, x_new)
        y = mixed["y"] + g_new - g
        x, g = x_new, g_new
    return x


def exact_diffusion(A: torch.Tensor, b: torch.Tensor, steps: int,
                    lr: float) -> torch.Tensor:
    """Exact diffusion (ATC form) on the bidirectional ring, through the
    gossip layer."""
    n = A.shape[0]
    sched = build_schedule(RingGraph(n, connect_style=0))
    x = A.new_zeros(n, DIM)
    psi_prev = x
    for _ in range(steps):
        phi = x - lr * grad(A, b, x)
        psi = phi + x - psi_prev
        x = C.neighbor_allreduce(psi, sched)
        psi_prev = phi
    return x


ALGORITHMS = {
    # (function, steps, lr, tolerance), as in the JAX example: lr bounded by
    # the topology's spectral gap times the local curvature
    "push_sum": (push_sum, 6000, 0.01, 2e-2),
    "gradient_tracking": (gradient_tracking, 2500, 0.004, 1e-5),
    "exact_diffusion": (exact_diffusion, 800, 0.02, 1e-3),
}


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algorithm", choices=sorted(ALGORITHMS),
                    default="gradient_tracking")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    fn, d_steps, d_lr, tol = ALGORITHMS[args.algorithm]
    steps = args.steps or d_steps
    lr = args.lr or d_lr
    A, b, x_star = make_problem(SIZE)
    with torch.no_grad():
        xs = fn(torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev),
                steps, lr).cpu().double().numpy()

    err = np.abs(xs - x_star).max()
    consensus = (xs.max(axis=0) - xs.min(axis=0)).max()
    print(f"{args.algorithm}: steps={steps} lr={lr} ranks={SIZE} "
          f"device={args.device}")
    print(f"  max|x_r - x*|     = {err:.3e}")
    print(f"  consensus spread  = {consensus:.3e}")
    print(f"  x*                = {np.round(x_star, 4)}")
    if err >= tol:
        raise AssertionError(
            f"failed to reach optimum (err={err:.3e}, tol={tol})")
    print("OK")
    return xs


if __name__ == "__main__":
    main()

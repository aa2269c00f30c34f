"""Asynchronous decentralized SGD on a real model, self-checking.

Counterpart of ``examples/async_dsgd.py`` of the JAX package.  The
reference's production asynchronous path is ``DistributedWinPutOptimizer``:
each rank pushes its parameters one-sidedly into its neighbours' windows
every step and merges whatever has landed, with no barrier, so ranks step
at whatever rate their hardware allows.  Here
``DistributedWinPutOptimizer(async_=True)`` drives 8 rank threads training
**LeNet-5** (:class:`bluefog_tpu_torch.models.lenet.LeNet5`, its published
widths) on disjoint synthetic shards with a deliberate step-rate skew.  The
parameters and the gradient live on the card (each rank thread on its own
CUDA stream); :class:`~bluefog_tpu_torch.runtime.async_windows.TreePacker`
carries them into the native window table and back.  The data is the JAX
example's (numpy, seed 0); the initial weights come from ``LeNet5``'s
seeded initializer, not from ``jax.random``.

Checks, as in the JAX example (exit status 1 on failure):
  1. the skew materialised: the fastest rank took >= 2x the steps of the
     slowest;
  2. the loss fell by >= 35% on every rank that got scheduled (>= 25% of
     the median step count);
  3. push-sum mass is conserved exactly (sum of p == n to 1e-9);
  4. the ranks agree: the consensus gap is at most a quarter of the
     parameter scale.

Run on the GPU (the default device; it raises without one)::

  python -m bluefog_tpu_torch.examples.async_dsgd [--ranks 8] [--duration 10]

and on the CPU with ``--device cpu``.  Under a chaos spec the rank threads
die and stall on cue::

  python -m bluefog_tpu_torch.chaos \
      --spec "rank2:die:at_step=8;rank1:stall:at_step=6:s=1.5" \
      -- python -m bluefog_tpu_torch.examples.async_dsgd

A killed rank leaves its last will: the mass check is then ``total +
died == n`` exactly, and the loss and consensus checks are over the
survivors.
"""

from __future__ import annotations

import argparse
import copy
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from bluefog_tpu_torch.models.lenet import LeNet5
from bluefog_tpu_torch.optim import DistributedWinPutOptimizer
from bluefog_tpu_torch.parallel.context import resolve_device
from bluefog_tpu_torch.topology import ExponentialTwoGraph

__all__ = ["main"]

PER_RANK_BATCHES = 16


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Run the example; returns its numbers, ``ok`` and the failed checks
    (``failures``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--duration", type=float, default=10.0,
                    metavar="SECONDS")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--name", default="async_dsgd_demo")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    threads = torch.get_num_threads()
    if dev.type == "cpu":
        # eight rank threads each running torch's intra-op pool would
        # oversubscribe the cores many times over
        torch.set_num_threads(1)
    try:
        return _run(args, dev)
    finally:
        torch.set_num_threads(threads)


def _run(args, dev) -> Dict[str, object]:
    n = args.ranks

    model = LeNet5(num_classes=10).to(dev)
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}

    # disjoint per-rank shards of a learnable problem: the class is which
    # of 10 fixed random templates the noisy image correlates with most
    rng = np.random.default_rng(0)
    templates = rng.standard_normal((10, 28, 28, 1)).astype(np.float32)
    data = []
    for _ in range(n):
        labels = rng.integers(0, 10, size=(PER_RANK_BATCHES, args.batch))
        noise = rng.standard_normal(
            (PER_RANK_BATCHES, args.batch, 28, 28, 1)).astype(np.float32)
        imgs = 0.7 * templates[labels] + 0.5 * noise
        data.append((torch.from_numpy(imgs).to(dev),
                     torch.from_numpy(labels).to(dev)))

    # functional_call swaps a module's parameters for the call's duration,
    # so concurrent rank threads each need a module of their own
    models = [copy.deepcopy(model) for _ in range(n)]

    def loss_of(params, x, y, rank=0):
        return F.cross_entropy(functional_call(models[rank], params, (x,)),
                               y)

    def loss_and_grad(rank, step, params):
        x, y = data[rank]
        b = step % PER_RANK_BATCHES
        params = {k: v.requires_grad_() for k, v in params.items()}
        loss = loss_of(params, x[b], y[b], rank)
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), dict(zip(params.keys(), grads))

    # one step of every rank, each in a thread of its own, before the
    # budget starts: a fresh process's first steps load cuDNN and cuBLAS
    # and create their handles in each thread, seconds of the budget on a
    # loaded host (a finished thread's handles go back to torch's pool,
    # where the rank threads take them up); map re-raises a failure
    t_warm = time.perf_counter()
    with ThreadPoolExecutor(max_workers=n) as ex:
        list(ex.map(lambda r: loss_and_grad(
            r, 0, {k: v.clone() for k, v in params0.items()}), range(n)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t_warm

    opt = DistributedWinPutOptimizer(None, topology=ExponentialTwoGraph(n),
                                     async_=True, lr=args.lr)
    opt.name = args.name
    print(f"async DSGD: {n} rank threads, LeNet-5, exp2 topology, "
          f"rank-dependent compute skew, {args.duration:.0f}s budget, "
          f"device={dev}; warm-up {warm_s:.2f} s before the budget")
    # rank-dependent extra time per step (the gradient costs about the same
    # everywhere, so the skew must dominate it to be observable)
    skew = [0.3 * r / max(n - 1, 1) for r in range(n)]
    report = opt.run(params0, loss_and_grad, duration_s=args.duration,
                     skew=skew)

    # judge the drained final model (all mass in flight folded in) of every
    # rank that survived (a chaos-killed rank has none)
    alive = [r for r in range(n) if report.final_params[r] is not None]
    first = [ls[0] if ls else float("nan") for ls in report.losses]
    last = [float("nan")] * n
    with torch.no_grad():
        for r in alive:
            x, y = data[r]
            last[r] = float(np.mean(
                [float(loss_of(report.final_params[r], x[b], y[b]))
                 for b in range(4)]))
    drop = [1 - l / f for f, l in zip(first, last)]
    scale = max(float(v.abs().max())
                for v in report.final_params[alive[0]].values())
    print(f"steps/rank: {report.steps_per_rank}")
    print("loss first->last per rank: " +
          " ".join(f"{f:.2f}->{l:.2f}" for f, l in zip(first, last)))
    print(f"total mass: {report.total_mass:.9f} (expect {n})")
    if report.dead_ranks:
        print(f"dead ranks {report.dead_ranks}, died mass "
              f"{report.died_mass!r}; total + died = "
              f"{report.total_mass + report.died_mass!r}")
    print(f"consensus gap: {report.consensus_gap:.4f} "
          f"(param scale {scale:.2f})")

    failures = []
    ratio = max(report.steps_per_rank) / max(min(report.steps_per_rank), 1)
    if ratio < 2.0:
        failures.append(
            f"step-rate skew did not materialize (ratio {ratio:.1f})")
    # a rank starved by host load takes its model from its neighbours'
    # deposits: its local loss may lag while the consensus checks hold
    med = float(np.median(report.steps_per_rank))
    active = [r for r in alive if report.steps_per_rank[r] >= 0.25 * med]
    if min(drop[r] for r in active) < 0.35:
        failures.append("loss did not converge (min active-rank drop "
                        f"{min(drop[r] for r in active):.0%})")
    if len(active) < len(alive):
        print(f"note: {len(alive) - len(active)} rank(s) starved by host "
              "load "
              f"(steps {report.steps_per_rank}); their local-loss check "
              "was waived, consensus checks still apply")
    if abs(report.total_mass + report.died_mass - n) > 1e-9:
        failures.append(f"mass not conserved: {report.total_mass!r} + "
                        f"{report.died_mass!r} != {n}")
    if report.consensus_gap > 0.25 * scale:
        failures.append("ranks did not reach consensus")
    for f in failures:
        print(f"FAIL: {f}")
    if not failures:
        print("OK — asynchronous decentralized training: skewed ranks "
              "converged, mass conserved")
    return {"ok": not failures, "failures": failures,
            "steps_per_rank": report.steps_per_rank, "loss_drop": drop,
            "total_mass": report.total_mass, "died_mass": report.died_mass,
            "dead_ranks": report.dead_ranks, "warm_s": warm_s,
            "consensus_gap": report.consensus_gap, "param_scale": scale,
            "wall_time_s": report.wall_time_s}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)

"""CHOCO-SGD: decentralized least squares over a compressed wire.

Counterpart of ``examples/choco_sgd.py`` of the JAX package: least-squares
regression with per-rank data on a ring of ``n`` virtual ranks, gossiping
only a compressed innovation each round
(:func:`~bluefog_tpu_torch.optim.DistributedChocoSGDOptimizer`, see
:mod:`bluefog_tpu_torch.ops.compression`).  Every rank must reach the
*shared* least-squares optimum, which plain compressed gossip cannot (its
compression noise accumulates; CHOCO's mirror copies cancel it).  The data
comes from ``numpy.random.default_rng(0)`` as in the JAX example, in f32.

Run on the GPU (the default device; it raises without one)::

  python -m bluefog_tpu_torch.examples.choco_sgd [--ranks 8] [--dim 8] \\
      [--rows 32] [--steps 1500] [--ratio 0.1] \\
      [--compressor random_block_k|top_k] [--lr 0.05]

and on the CPU with ``--device cpu``.  It asserts ``max|w_i - w*| < 0.05``
and a rank spread below 0.01, and prints ``OK``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from bluefog_tpu_torch.ops import compression as CP
from bluefog_tpu_torch.optim import DistributedChocoSGDOptimizer
from bluefog_tpu_torch.parallel.context import resolve_device
from bluefog_tpu_torch.topology import RingGraph

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--rows", type=int, default=32, help="data rows per rank")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--ratio", type=float, default=0.1,
                    help="kept fraction of wire bytes (0.1 = 10x compression)")
    ap.add_argument("--compressor", choices=["random_block_k", "top_k"],
                    default="random_block_k")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    n = args.ranks
    comp = getattr(CP, args.compressor)(args.ratio)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.normal(size=(n, args.rows, args.dim)),
                        dtype=torch.float32, device=dev)
    w_star = torch.as_tensor(rng.normal(size=(args.dim,)),
                             dtype=torch.float32, device=dev)
    b = a @ w_star
    w = torch.zeros(n, args.dim, device=dev, requires_grad=True)
    opt = DistributedChocoSGDOptimizer(
        torch.optim.SGD([w], lr=args.lr), RingGraph(n),
        compressor=comp)  # gamma = the compressor's delta
    t0 = time.perf_counter()
    for _ in range(args.steps):
        # each rank's mean squared residual; their sum has each rank's
        # own gradient in its row
        loss = ((torch.bmm(a, w[:, :, None])[..., 0] - b) ** 2).mean(1).sum()
        (w.grad,) = torch.autograd.grad(loss, [w])
        opt.step()
    out = w.detach().double().cpu().numpy()
    seconds = time.perf_counter() - t0
    err = float(np.abs(out - w_star.double().cpu().numpy()).max())
    spread = float(np.abs(out - out.mean(axis=0)).max())
    wire = comp.wire_ratio(torch.zeros(1, args.dim))
    print(f"ranks={n} compressor={comp.name} ratio={args.ratio} "
          f"(wire = {wire:.0%} of dense bytes)")
    print(f"max|w_i - w*|      = {err:.2e}")
    print(f"max rank spread    = {spread:.2e}")
    if not err < 0.05:
        raise RuntimeError(f"did not reach the shared optimum: {err}")
    if not spread < 0.01:
        raise RuntimeError(f"ranks did not agree: {spread}")
    print("OK")
    return {"err": err, "spread": spread, "seconds": seconds}


if __name__ == "__main__":
    main()

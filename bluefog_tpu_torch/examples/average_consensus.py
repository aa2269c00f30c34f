"""Average consensus by gossip over ``n`` virtual ranks.

Counterpart of ``examples/average_consensus.py`` of the JAX package, the
reference's ``examples/pytorch_average_consensus.py``: each rank starts with
a random vector, and repeated ``neighbor_allreduce`` steps drive every rank
to the global average.  Each step is one call of the kernel K1 on the card,
on every topology, the grid and the star included.  The start vectors come
from ``torch.randn`` under a seeded generator (the JAX example draws them
with ``jax.random``), so the numbers differ and the convergence does not.

The JAX example holds every topology to the plain average, which the star
never reaches: its uniform ``1/(degree + 1)`` weights are row-stochastic but
not doubly stochastic, so gossip on it agrees on the Perron-weighted average
(:func:`consensus_weights`) and that example fails there.  This one holds
each topology to the value its gossip converges to, which is the plain
average for the other four.

Run on the GPU (the default device; it raises without one)::

  python -m bluefog_tpu_torch.examples.average_consensus \\
      --topology exp2|ring|grid|star|full [--size 8] [--steps 50] [--dim 1000]

and on the CPU with ``--device cpu``.  It prints the error to the average
every 10 steps and ``OK`` when the last is below 1e-3.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

import bluefog_tpu_torch as bf
from bluefog_tpu_torch.topology import (
    ExponentialTwoGraph,
    FullyConnectedGraph,
    MeshGrid2DGraph,
    RingGraph,
    StarGraph,
)

__all__ = ["TOPOLOGIES", "consensus_weights", "main"]

TOPOLOGIES = {
    "exp2": ExponentialTwoGraph,
    "ring": RingGraph,
    "grid": MeshGrid2DGraph,
    "star": StarGraph,
    "full": FullyConnectedGraph,
}


def consensus_weights(w: np.ndarray) -> np.ndarray:
    """The weights ``pi`` of the value gossip along the row-stochastic ``W``
    converges to, ``pi^T x``: the left Perron vector (``pi W = pi``, summing
    to one).  Uniform, the plain average, when ``W`` is doubly stochastic
    (exp2, ring, grid, full); the star's ``1/(degree + 1)`` weights are
    not, so its ranks agree on another weighting of the start vectors."""
    vals, vecs = np.linalg.eig(np.asarray(w, dtype=np.float64).T)
    pi = np.real(vecs[:, np.argmin(np.abs(vals - 1.0))])
    return pi / pi.sum()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=8, help="virtual ranks")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--dim", type=int, default=1000)
    ap.add_argument("--topology", choices=sorted(TOPOLOGIES), default="exp2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n = args.size
    ctx = bf.init(topology=TOPOLOGIES[args.topology](n), size=n,
                  device=args.device)
    try:
        print(f"ranks={bf.size()} topology={bf.load_topology().name}")
        gen = torch.Generator(device=ctx.device).manual_seed(args.seed)
        # stacked: row r is rank r's vector
        x = torch.randn(n, args.dim, generator=gen, device=ctx.device)
        pi = consensus_weights(bf.load_topology().weights)
        target = torch.as_tensor(pi, dtype=torch.float32,
                                 device=ctx.device) @ x
        print("target: " + ("the average" if np.allclose(pi, 1 / n) else
                            "the Perron-weighted average (W is not doubly "
                            "stochastic)"))
        t0 = time.perf_counter()
        for step in range(args.steps):
            x = bf.neighbor_allreduce(x)
            if step % 10 == 0 or step == args.steps - 1:
                err = float((x - target).abs().max())
                print(f"step {step:4d}  max|x - avg| = {err:.3e}")
        seconds = time.perf_counter() - t0
        err = float((x - target).abs().max())
        print(f"final consensus error: {err:.3e}")
        if not err < 1e-3:
            raise RuntimeError(f"consensus failed to converge: {err:.3e}")
        print("OK")
        return {"err": err, "seconds": seconds}
    finally:
        bf.shutdown()


if __name__ == "__main__":
    main()

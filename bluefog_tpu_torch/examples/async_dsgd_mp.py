"""Cross-process asynchronous decentralized SGD, self-checking.

Counterpart of ``examples/async_dsgd_mp.py`` of the JAX package, over
shared memory.  :mod:`~bluefog_tpu_torch.examples.async_dsgd` runs the
reference's asynchronous execution model (``DistributedWinPutOptimizer``)
with rank threads; this example runs it the way the reference deploys it,
one OS process per rank (``mpirun -np N``): each process creates its
landing window in named POSIX shared memory and deposits into its
neighbours' windows directly, ``MPI_Put`` across a real process boundary
with no receiver involvement and no barrier in the training loop
(:func:`~bluefog_tpu_torch.runtime.async_windows.run_async_dsgd_rank`).

Each rank process trains a linear regressor on its own shard of a synthetic
linear problem, its parameters and gradient on the card (``--device cpu``
runs them on the CPU), with deliberately skewed step rates.  The parent
starts this module again once per rank with ``--worker R``, and rank 0
checks its report:

  1. every rank took >= 5 steps and the skew materialised (the fastest
     rank >= 1.5x the steps of the slowest);
  2. push-sum mass is conserved exactly (sum of p == n to 1e-9);
  3. rank 0's loss fell by >= 50%;
  4. the ranks agree: the consensus gap is below 5% of the parameter scale.

Run::

  python -m bluefog_tpu_torch.examples.async_dsgd_mp [--ranks 2] \\
      [--duration 3] [--device cuda|cpu]

``--transport tcp`` and ``--resilient`` (the TCP window server and peer
fault tolerance) come with ROADMAP Queue 1 item 9b.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from typing import Optional, Sequence

__all__ = ["main", "worker"]


def worker(rank: int, n: int, bdir: str, duration_s: float, lr: float,
           device: str) -> None:
    import numpy as np
    import torch

    from bluefog_tpu_torch.parallel.context import resolve_device
    from bluefog_tpu_torch.runtime.async_windows import (FileBarrier,
                                                         run_async_dsgd_rank)
    from bluefog_tpu_torch.topology import RingGraph

    torch.set_num_threads(1)
    dev = resolve_device(device)
    # shard r of a synthetic linear regression y = X @ w* + noise
    rng = np.random.default_rng(1234)
    w_star = rng.standard_normal(16).astype(np.float32)
    X = rng.standard_normal((n * 64, 16)).astype(np.float32)
    y = X @ w_star + 0.01 * rng.standard_normal(n * 64).astype(np.float32)
    Xr = torch.from_numpy(X[rank * 64:(rank + 1) * 64]).to(dev)
    yr = torch.from_numpy(y[rank * 64:(rank + 1) * 64]).to(dev)

    params0 = {"w": torch.zeros(16, device=dev),
               "b": torch.zeros((), device=dev)}

    def loss_and_grad(r, step, params):
        w = params["w"].requires_grad_()
        b = params["b"].requires_grad_()
        loss = torch.mean((Xr @ w + b - yr) ** 2)
        gw, gb = torch.autograd.grad(loss, (w, b))
        return float(loss.detach()), {"w": gw, "b": gb}

    # the base sleep grows with the rank count, so the skew stays visible
    # above scheduler contention when many processes share few cores
    skew_s = 0.0005 * max(n - 1, 1) * (1.0 + 4.0 * rank / max(n - 1, 1))
    report = run_async_dsgd_rank(
        RingGraph(n), rank, params0, loss_and_grad,
        barrier=FileBarrier(bdir, n, rank), lr=lr, duration_s=duration_s,
        skew_s=skew_s, name=f"async_dsgd_mp_{os.path.basename(bdir)}",
        transport="shm")

    if rank == 0:
        steps = report.steps_per_rank
        assert min(steps) >= 5, f"a rank starved: {steps}"
        assert max(steps) >= 1.5 * min(steps), f"no skew in {steps}"
        assert abs(report.total_mass - n) < 1e-9 * n, report.total_mass
        l0 = report.losses[0]
        assert l0[-1] < 0.5 * l0[0], (l0[0], l0[-1])
        scale = float(np.abs(w_star).max())
        assert report.consensus_gap < 0.05 * scale, report.consensus_gap
        print(f"steps/rank: {steps}  (skewed, barrier-free)")
        print(f"push-sum mass: {report.total_mass:.12f}  (== {n} exactly)")
        print(f"rank-0 loss: {l0[0]:.3f} -> {l0[-1]:.4f}")
        print(f"consensus gap: {report.consensus_gap:.2e}")
        print(f"ASYNC_MP_REPORT steps={steps} mass={report.total_mass!r} "
              f"loss0={l0[0]!r} loss1={l0[-1]!r} "
              f"gap={report.consensus_gap!r} device={dev}")
        print("OK — async DSGD spanned real OS processes over shm with no "
              "barrier")
    print(f"WORKER_DONE {rank}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--duration", type=float, default=3.0, metavar="SECONDS")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--transport", default="shm",
                    help="deposit fabric: shm (same host); tcp comes with "
                         "ROADMAP Queue 1 item 9b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--bdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.transport != "shm":
        raise NotImplementedError(
            f"--transport {args.transport} is not ported yet: it comes with "
            "ROADMAP Queue 1 item 9b (the TCP window server)")

    if args.worker is not None:
        worker(args.worker, args.ranks, args.bdir, args.duration, args.lr,
               args.device)
        return 0

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as bdir:
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "bluefog_tpu_torch.examples."
                 "async_dsgd_mp", "--ranks", str(args.ranks),
                 "--duration", str(args.duration), "--lr", str(args.lr),
                 "--device", args.device, "--worker", str(r),
                 "--bdir", bdir], env=env)
            for r in range(args.ranks)
        ]
        try:
            rcs = [p.wait(timeout=120 + args.duration * 4) for p in procs]
        except subprocess.TimeoutExpired:
            # a hung worker (stuck at a barrier because a peer died) must
            # not orphan the rest against a vanishing barrier directory
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            print("FAILED: a worker timed out; all workers killed",
                  file=sys.stderr)
            return 1
    if any(rcs):
        print(f"FAILED: worker exit codes {rcs}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

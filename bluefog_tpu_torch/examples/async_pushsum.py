"""Asynchronous push-sum: ranks step at different rates and still converge.

Counterpart of ``examples/async_pushsum.py`` of the JAX package.  The
reference's one-sided MPI path (``MPI_Put`` lands with no receiver
involvement, upstream ``bluefog/common/mpi_controller.cc`` Win ops) lets
every rank run its own loop: here 8 rank threads with rank-dependent step
times (the slowest ~5x the fastest) deposit weighted (x, p) mass into their
neighbours' passive-target windows (the port's native table,
``csrc/windows.cc``) and consume whatever has landed whenever they step.
The algorithm is host arithmetic on the window table; no tensor reaches a
device, so the example takes no ``--device``.

Self-checking: exits non-zero unless
  * every rank's x/p estimate reaches the true mean, though the ranks took
    very different step counts;
  * the ranks did step at different rates (at least 2x);
  * push-sum mass is conserved exactly (sum of p == n).

Run::

  python -m bluefog_tpu_torch.examples.async_pushsum [--ranks 8] [--dim 16]
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import numpy as np

from bluefog_tpu_torch.runtime.async_windows import run_async_pushsum
from bluefog_tpu_torch.topology import ExponentialTwoGraph

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Run the example; returns its numbers, ``ok`` and the failed checks
    (``failures``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--name", default="async_pushsum_demo")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(args.ranks, args.dim)) * 10.0
    report = run_async_pushsum(ExponentialTwoGraph(args.ranks), x0,
                               tol=args.tol, timeout_s=args.timeout,
                               name=args.name)
    steps = report.steps_per_rank
    print(f"converged={report.converged} in {report.wall_time_s:.2f}s")
    print(f"steps per rank: {steps}  (skew ratio "
          f"{max(steps) / max(min(steps), 1):.1f}x)")
    print(f"max |x/p - mean| = {report.max_abs_err:.2e}")
    print(f"total mass = {report.total_mass:.12f} (want {args.ranks})")

    failures = []
    if not report.converged:
        failures.append("did not converge to the global mean")
    if max(steps) < 2 * min(steps):
        # the demonstration requires real skew, not lockstep by accident
        failures.append("ranks advanced at similar rates; no skew "
                        "demonstrated")
    if abs(report.total_mass - args.ranks) > 1e-6:
        failures.append("push-sum mass not conserved")
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    print("FAIL" if failures else "PASS")
    return {"ok": not failures, "failures": failures,
            "steps_per_rank": steps, "wall_time_s": report.wall_time_s,
            "max_abs_err": report.max_abs_err,
            "total_mass": report.total_mass}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)

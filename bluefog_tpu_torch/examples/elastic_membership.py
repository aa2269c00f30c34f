"""Elastic membership: ranks join, leave and warm-start mid-run.

Counterpart of ``examples/elastic_membership.py`` of the JAX package.  An
autoscaling decentralized fleet in one process: a capacity-5 job starts
with 3 member ranks training a quadratic consensus problem over
asynchronous push-sum windows, their parameters and gradients on the card
(``--device cpu`` runs them on the CPU).  At 0.5 s a 4th rank joins: it
warm-starts by reading a live member's published (x, p) window snapshot
(no checkpoint file anywhere) and is admitted at a round boundary.  At
1.5 s one of the original ranks leaves gracefully: it hands its whole
push-sum mass to its out-neighbours in drain deposits, so the mass audit
stays exact (a leaver's mass is conserved, a corpse's written off).  The
mixing graph re-plans over the live member set at every membership
boundary (:func:`~bluefog_tpu_torch.topology.graphs.replan`,
deterministic in the member list).

Self-checking; exits non-zero on failure.  Run::

  python -m bluefog_tpu_torch.examples.elastic_membership [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

__all__ = ["CAPACITY", "DIM", "main", "run"]

CAPACITY = 5
DIM = 6


def run(device: str = "cuda", duration_s: float = 2.5):
    """The demo's run; returns its :class:`~bluefog_tpu_torch.runtime.
    async_windows.DSGDReport`."""
    import torch

    from bluefog_tpu_torch import topology as T
    from bluefog_tpu_torch.parallel.context import resolve_device
    from bluefog_tpu_torch.runtime.async_windows import run_async_dsgd
    from bluefog_tpu_torch.runtime.resilience import ResilienceConfig

    dev = resolve_device(device)
    # each rank pulls toward its own target; consensus lands on the mean
    targets = torch.stack([torch.full((DIM,), float(r + 1), device=dev)
                           for r in range(CAPACITY)])

    def loss_and_grad(r, step, params):
        diff = params["w"] - targets[r]
        return 0.5 * float(diff @ diff), {"w": diff}

    return run_async_dsgd(
        T.FullyConnectedGraph(CAPACITY),       # the job's capacity
        {"w": torch.zeros(DIM, device=dev)},
        loss_and_grad,
        lr=0.05,
        duration_s=duration_s,
        skew=[0.001] * CAPACITY,
        name="elastic_membership_demo",
        resilience=ResilienceConfig(suspect_after_s=0.2, dead_after_s=0.6),
        join_at_s={3: 0.5,                     # rank 3 attaches at 0.5 s
                   4: []},                     # rank 4: reserved capacity
        leave_at_s={1: 1.5},                   # rank 1 drains at 1.5 s
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--duration", type=float, default=2.5,
                    metavar="SECONDS")
    args = ap.parse_args(argv)
    report = run(args.device, args.duration)

    print(f"steps per rank : {report.steps_per_rank}")
    print(f"joined         : {report.joined_ranks}")
    print(f"left           : {report.left_ranks}")
    print(f"consensus gap  : {report.consensus_gap:.2e}")
    print(f"mass audit     : total={report.total_mass!r} "
          f"baseline={report.baseline_mass!r}")

    # the elastic lifecycle happened...
    assert report.joined_ranks == [3], report.joined_ranks
    assert report.left_ranks == [1], report.left_ranks
    assert report.dead_ranks == [], report.dead_ranks
    # ...the joiner trained meaningfully after its warm start...
    assert report.steps_per_rank[3] > 20, report.steps_per_rank
    # ...the final members reached consensus...
    assert report.consensus_gap < 0.5, report.consensus_gap
    # ...and the mass audit is exact over the churn: 3 initial units + 1
    # admission, the leaver's unit conserved through its handoff
    assert report.baseline_mass == 4.0, report.baseline_mass
    assert abs(report.total_mass - report.baseline_mass) < 1e-9, \
        report.total_mass
    print(f"ELASTIC_REPORT steps={report.steps_per_rank} "
          f"joined={report.joined_ranks} left={report.left_ranks} "
          f"mass={report.total_mass!r} baseline={report.baseline_mass!r} "
          f"gap={report.consensus_gap!r}")
    print("elastic_membership: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serve while training: a replica follows a live training fleet.

Counterpart of ``examples/serving_replica.py`` of the JAX package.  Three
rank threads train a quadratic consensus problem with asynchronous
push-sum (no barrier anywhere) while publishing round-stamped ``(round,
x, p)`` snapshots every round.  A
:class:`~bluefog_tpu_torch.runtime.window_server.WindowServer` in the same
process serves those snapshots over TCP, and a
:class:`~bluefog_tpu_torch.serving.replica.ServingReplica` (the shape a
prediction server embeds) subscribes to rank 0's model and serves
predictions from it while it trains.  The model's parameters live on
``--device`` (the card by default): the trainers pack them from there,
and the replica unpacks the served ``z = x / p`` back onto it.

Self-asserted invariants (the reference's):

- every snapshot delivered is round-consistent (the in-band ``round``
  stamp leaf equals the pushed round, exactly);
- the served model's staleness is bounded: sampled repeatedly during
  training, the replica is never more than K rounds behind the trainer's
  live round (K = subscription stride + delivery slack);
- predictions from the served weights track the training objective (the
  replica's final model is close to the fleet's consensus);
- and here: every served parameter lies on ``--device``.

Exits non-zero on failure.  Run on the GPU (the default device; it raises
without one)::

  python -m bluefog_tpu_torch.examples.serving_replica

and on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from bluefog_tpu_torch import serving
from bluefog_tpu_torch import topology as T
from bluefog_tpu_torch.parallel.context import resolve_device
from bluefog_tpu_torch.runtime.async_windows import run_async_dsgd
from bluefog_tpu_torch.runtime.window_server import WindowServer
from bluefog_tpu_torch.serving.replica import ServingReplica
from bluefog_tpu_torch.serving.subscriber import Subscriber

__all__ = ["main"]

N_RANKS = 3
DIM = 8
EVERY = 2          # subscription stride: push every 2nd round
STALENESS_K = 60   # rounds of slack the SLO allows: the stride plus the
                   # delivery lag (at ~5 ms a round, ~300 ms of scheduler
                   # noise on a loaded host)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Run the example; returns its numbers, ``ok`` and the failed checks
    (``failures``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--duration", type=float, default=4.0,
                    metavar="SECONDS")
    ap.add_argument("--name", default="serving_replica_demo")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    group = f"{args.name}:0"
    targets = torch.stack([torch.full((DIM,), float(r + 1),
                                      dtype=torch.float64, device=dev)
                           for r in range(N_RANKS)])

    def loss_and_grad(r, step, params):
        diff = params["w"].double() - targets[r]
        return 0.5 * float(diff @ diff), {"w": diff}

    template = {"w": torch.zeros(DIM, dtype=torch.float32, device=dev)}

    # the training fleet runs in a background thread; the service is the
    # main thread, and the two touch only through the snapshot fabric
    report_box = {}

    def train():
        report_box["report"] = run_async_dsgd(
            T.FullyConnectedGraph(N_RANKS), template, loss_and_grad,
            lr=0.05, duration_s=args.duration, skew=[0.005] * N_RANKS,
            name=args.name, snapshot_every=1)

    trainer = threading.Thread(target=train, daemon=True)
    trainer.start()

    srv = WindowServer()
    addr = srv.start("127.0.0.1")

    # an auditing subscriber rides beside the replica: every pushed
    # snapshot's in-band `round` stamp leaf must equal the frame's round
    audit = {"frames": 0, "mismatches": 0}

    def check_stamp(snap):
        audit["frames"] += 1
        if int(snap.leaves["round"][0]) != snap.round:
            audit["mismatches"] += 1

    auditor = Subscriber(addr, group, every=1, on_snapshot=check_stamp)
    replica = ServingReplica(addr, group, template, every=EVERY)
    failures = []
    try:
        replica.wait_ready(timeout_s=20.0)

        # sample the staleness SLO while training progresses
        tbl = serving.table()
        worst_age = 0
        samples = 0
        off_device = 0
        first_round = replica.round
        probe = torch.ones(DIM, dtype=torch.float64, device=dev)
        while trainer.is_alive():
            live = tbl.current_round(group)
            if live < 0:
                break  # training finished and dropped its groups
            age = replica.staleness_rounds(live)
            worst_age = max(worst_age, age)
            samples += 1
            if age > STALENESS_K:
                failures.append(
                    f"staleness SLO violated: replica at round "
                    f"{replica.round}, trainer at {live} (age {age} > "
                    f"K={STALENESS_K})")
                break
            # serve a prediction from the live weights: the de-biased
            # model applied to a probe input, on the device
            w = replica.params()["w"]
            off_device += int(w.device != dev)
            _ = float(w.double() @ probe)
            time.sleep(0.05)
        trainer.join(timeout=30)
        final_round = replica.round
        report = report_box["report"]
    finally:
        auditor.close()
        replica.close()
        srv.stop()

    print(f"steps per rank   : {report.steps_per_rank}")
    print(f"replica rounds   : first={first_round} final={final_round} "
          f"adopted={replica.adopted}")
    print(f"staleness        : worst={worst_age} over {samples} samples "
          f"(SLO K={STALENESS_K})")
    print(f"round-stamp audit: {audit['frames']} frames, "
          f"{audit['mismatches']} mismatches")

    # the replica followed a live model...
    if not final_round > first_round:
        failures.append(f"the replica did not move: {first_round} -> "
                        f"{final_round}")
    if replica.adopted < 3:
        failures.append(f"only {replica.adopted} snapshots adopted")
    if samples < 3 or worst_age > STALENESS_K:
        failures.append(f"staleness samples {samples}, worst {worst_age}")
    # ...every delivered snapshot was round-consistent, exactly...
    if audit["frames"] < 3 or audit["mismatches"]:
        failures.append(f"round-stamp audit {audit}")
    # ...training was never perturbed by the readers (exact mass audit)...
    if abs(report.total_mass - N_RANKS) >= 1e-9 * N_RANKS:
        failures.append(f"mass audit {report.total_mass!r}")
    # ...the served parameters live on the device...
    served = replica.params()["w"]
    if off_device or served.device != dev:
        failures.append(f"served parameters left {dev}: {off_device} "
                        f"samples, final on {served.device}")
    # ...and the served model converged with the fleet: close to the
    # consensus optimum (the mean of the rank targets)
    optimum = targets.mean(dim=0)
    err = float((served.double() - optimum).abs().max())
    print(f"served model err : {err:.3e} vs consensus optimum "
          f"(on {served.device})")
    if not err < 0.5:
        failures.append(f"served model error {err}")
    for f in failures:
        print(f"FAIL: {f}")
    if not failures:
        print("serving_replica: OK")
    return {"ok": not failures, "failures": failures,
            "steps_per_rank": report.steps_per_rank,
            "first_round": first_round, "final_round": final_round,
            "adopted": replica.adopted, "worst_staleness": worst_age,
            "samples": samples, "audit": audit, "served_err": err,
            "total_mass": report.total_mass}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)

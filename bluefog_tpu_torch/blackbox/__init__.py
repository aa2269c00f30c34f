"""Flight recorder & cross-rank hang forensics.

Counterpart of ``bluefog_tpu/blackbox``, with its event kinds and file
formats: metrics say *how much*, the timeline says *when*; the blackbox
says **what happened when it didn't work**.

The reference has no failure story: a wedged MPI rank silently stalls the
whole decentralized job (SURVEY §5), and an aggregate watchdog can only
say "no beat arrived" — not which rank, which collective, which step.
Production systems treat this as a first-class problem (MegaScale,
arXiv:2402.15627: an always-on per-rank flight recorder dumped on
failure).  Three pieces:

- :mod:`~bluefog_tpu_torch.blackbox.recorder` — always-on bounded ring buffer
  of structured events (collective begin/end with collective-id + step +
  bytes, window deposits/reads, optimizer steps, heartbeat beats).
  Off-able via ``BLUEFOG_TPU_BLACKBOX=0``; the per-call collective
  events are opt-in (``=jit``).
- :mod:`~bluefog_tpu_torch.blackbox.dump` — on heartbeat timeout, uncaught
  exception/``HangError``, fatal signal, or atexit-after-exception,
  write ``blackbox-rank<k>.jsonl`` (ring + thread stacks + open spans +
  metrics snapshot) into ``BLUEFOG_TPU_BLACKBOX_DIR``.
- :mod:`~bluefog_tpu_torch.blackbox.merge` — ``python -m
  bluefog_tpu_torch.blackbox <incident-dir>`` aligns per-rank recorders by (step, collective-id), reports rounds
  entered-but-never-exited, names the suspect rank/edges, and exports a
  merged per-rank-pid chrome trace.
"""

from bluefog_tpu_torch.blackbox.dump import (collect_attempt, default_rank,
                                             dump, incident_dir, install)
from bluefog_tpu_torch.blackbox.recorder import (
    FlightRecorder,
    begin,
    configure,
    enabled,
    end,
    get,
    jit_enabled,
    next_collective_id,
    record,
    reset,
    settle,
    suppress_blackbox,
    traced_event,
)

__all__ = [
    "FlightRecorder",
    "begin",
    "collect_attempt",
    "configure",
    "default_rank",
    "dump",
    "enabled",
    "end",
    "get",
    "incident_dir",
    "install",
    "jit_enabled",
    "next_collective_id",
    "record",
    "reset",
    "settle",
    "suppress_blackbox",
    "traced_event",
]

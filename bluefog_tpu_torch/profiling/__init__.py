"""Continuous profiling.

Counterpart of ``bluefog_tpu/profiling/``.  A sampling profiler, off by
default: a daemon thread walks ``sys._current_frames()`` at a
configurable rate, tags every sample with the sampled thread's current
tracing phase (compute / gossip / publish / net-wait, read lock-free from
the tracing package's cross-thread span map), and appends folded-stack
windows to per-rank JSONL.  ``python -m bluefog_tpu_torch.profiling``
merges ranks, renders flamegraphs, joins against a trace's critical path,
and gates A/B differential profiles with an exit code.

Arm it with ``BLUEFOG_TPU_PROFILE=<dir>`` (and optionally
``BLUEFOG_TPU_PROFILE_HZ``), with :func:`configure`, or with ``profile=``
in the runners.  Disarmed, there is no sampler thread and no import-time
side effect.
"""

from bluefog_tpu_torch.profiling.sampler import (
    PHASES,
    Profiler,
    configure,
    enabled,
    flush,
    get,
    phase_for_span,
    reset,
    set_rank,
)
from bluefog_tpu_torch.profiling.report import (
    diff,
    load_profiles,
    merge,
    phase_frames,
    render_folded,
    render_svg,
    top_table,
)

__all__ = [
    "PHASES",
    "Profiler",
    "configure",
    "diff",
    "enabled",
    "flush",
    "get",
    "load_profiles",
    "merge",
    "phase_for_span",
    "phase_frames",
    "render_folded",
    "render_svg",
    "reset",
    "set_rank",
    "top_table",
]

"""Metric export: JSONL per-step append, Prometheus text, atexit summary.

Counterpart of ``bluefog_tpu/metrics/export.py``, writing the same
formats, so each package's dash reads the other's files.  Three
consumers, three formats:

- the dash CLI wants a **per-step time series**: one JSON line per
  :func:`step` call, each a full registry snapshot (cumulative counters;
  the reader differentiates).  Append-only, so a crash loses at most the
  last line, and the file is tail-able while training runs.
- An operator's scrape wants the **Prometheus text format**:
  :func:`prometheus_text` / :func:`write_prometheus` render the same
  snapshot with ``# TYPE`` headers.
- A human at the terminal wants the **atexit summary**: when the process
  exits with metrics enabled, the final snapshot is appended as a
  ``{"summary": ...}`` line and a compact table goes to the
  ``bluefog_tpu_torch`` logger.

No export waits on the card.  The JAX package drains its unordered
device callbacks (``jax.effects_barrier``) before a snapshot; the port's
hooks are host calls made before the call returns, and every counter is
computed from shapes and dtypes, so a snapshot already holds every call
made and :func:`step` needs no device synchronize.
"""

from __future__ import annotations

import atexit
import json
import os
import time
from typing import Optional

from bluefog_tpu_torch.metrics import registry as _reg
from bluefog_tpu_torch.utils import lockcheck as _lc

__all__ = [
    "MetricsWriter",
    "attach_writer",
    "detach_writer",
    "prometheus_text",
    "snapshot",
    "step",
    "write_prometheus",
]


_initialized_paths = set()


class MetricsWriter:
    """Append-only JSONL writer; one line per snapshot."""

    def __init__(self, path: str):
        self.path = path
        self._lock = _lc.lock("metrics.export.MetricsWriter._lock")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        # truncate once per process per path: each run owns its file
        # (matching the timeline writer), but a stop/start cycle within
        # ONE process must append, not erase the data already recorded
        key = os.path.abspath(path)
        if key not in _initialized_paths:
            _initialized_paths.add(key)
            with open(path, "w"):
                pass

    def write(self, record: dict) -> None:
        line = json.dumps(record, allow_nan=True, sort_keys=True)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


_WRITER: Optional[MetricsWriter] = None
_writer_lock = _lc.lock("metrics.export._writer_lock")
_step_counter = 0
_atexit_armed = False


def attach_writer(path: str) -> MetricsWriter:
    global _WRITER, _atexit_armed
    old = None
    with _writer_lock:
        # compare normalized paths: a relative and absolute spelling of
        # the same file must not be mistaken for a writer switch (which
        # would append a premature mid-file summary)
        if (_WRITER is None
                or os.path.abspath(_WRITER.path) != os.path.abspath(path)):
            old, _WRITER = _WRITER, MetricsWriter(path)
        if not _atexit_armed:
            atexit.register(_finalize)
            _atexit_armed = True
        w = _WRITER
    if old is not None:
        # re-pointing the export must not orphan the previous file
        # without its summary line — every JSONL this subsystem writes
        # ends with the {"summary": ...} record the dash treats as the
        # authoritative totals
        _summarize(old)
    return w


def detach_writer() -> None:
    global _WRITER
    with _writer_lock:
        w, _WRITER = _WRITER, None
    if w is not None:
        _summarize(w)


def step(step: Optional[int] = None) -> Optional[dict]:
    """Record one per-step snapshot line.  Call once per training step
    (or epoch/iteration: whatever granularity the consumer wants the time
    series at).  No-op when metrics are off, so examples call it
    unconditionally.  No device synchronize: see the module docstring.
    """
    global _step_counter
    reg = _reg.current()
    if reg is None:
        return None
    if step is None:
        step = _step_counter
    _step_counter = int(step) + 1
    record = {"step": int(step), "time": time.time(),
              "metrics": reg.snapshot()}
    with _writer_lock:
        w = _WRITER
    if w is not None:
        w.write(record)
    return record


def snapshot() -> Optional[dict]:
    """One-shot registry snapshot (``None`` when metrics are off): the
    crash-dump API.  :mod:`bluefog_tpu_torch.blackbox` embeds it in each
    incident file so the counters at failure time survive without the
    writer machinery.  It never waits on the card, so a watchdog thread
    may call it while the main thread is wedged in a device call."""
    reg = _reg.current()
    if reg is None:
        return None
    return reg.snapshot()


def prometheus_text(registry: Optional[_reg.MetricsRegistry] = None) -> str:
    """Render the current snapshot in the Prometheus exposition text
    format (``# HELP`` / ``# TYPE`` headers, one sample per series)."""
    reg = registry if registry is not None else _reg.current()
    if reg is None:
        return "# bluefog_tpu metrics disabled\n"
    snap = reg.snapshot()
    kinds = reg.kinds()
    helps = reg.helps()
    lines = []
    seen_headers = set()
    for series in sorted(snap):
        base = series.split("{", 1)[0]
        # histogram expansions (<name>_p50 etc.) inherit gauge typing
        family = base
        for suffix in _reg.HIST_SUFFIXES:
            if base.endswith(suffix) and base[: -len(suffix)] in kinds:
                family = base[: -len(suffix)]
                break
        if base not in seen_headers:
            seen_headers.add(base)
            if family in helps:
                lines.append(f"# HELP {base} {helps[family]}")
            kind = kinds.get(base)
            if kind is None:
                kind = "counter" if base.endswith("_total") else "gauge"
            lines.append(f"# TYPE {base} {kind}")
        val = snap[series]
        lines.append(f"{series} {val}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str,
                     registry: Optional[_reg.MetricsRegistry] = None) -> None:
    """Atomic-replace a Prometheus text snapshot at ``path`` (point a
    node_exporter textfile collector or a sidecar scraper at it)."""
    text = prometheus_text(registry)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _summarize(writer: MetricsWriter) -> None:
    reg = _reg.current()
    if reg is None:
        return
    snap = reg.snapshot()
    writer.write({"summary": True, "time": time.time(), "metrics": snap})
    from bluefog_tpu_torch.utils.logging import log

    totals = {k: v for k, v in snap.items() if "_total" in k}
    if totals:
        head = ", ".join(f"{k}={v:g}" for k, v in sorted(totals.items())[:6])
        log.info("metrics summary (%d series; run "
                 "`python -m bluefog_tpu_torch.metrics.dash %s` for the full table): %s",
                 len(snap), writer.path, head)


def _finalize() -> None:
    global _WRITER
    with _writer_lock:
        w, _WRITER = _WRITER, None
    if w is not None:
        _summarize(w)

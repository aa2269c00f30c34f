"""Chrome-trace timeline: a host-side span profiler.

Counterpart of ``bluefog_tpu/utils/timeline.py`` (the reference's
``bluefog/common/timeline.{h,cc}`` and ``bf.timeline_start_activity /
timeline_end_activity``).  Enabled by ``BLUEFOG_TPU_TIMELINE=<file>`` or
:func:`timeline_start`; the events are chrome trace-event JSON.

The writer is the native runtime's (``csrc/timeline.cc``, on its own
thread).  Its Python twin, a buffered writer with a flusher thread that
appends to the file, runs when the caller asks for it (``native=False``, or
``BLUEFOG_TPU_TORCH_NO_NATIVE``).  Device activity is for
``torch.profiler``: every activity span recorded here also opens a
``torch.profiler.record_function`` of the same name, so host spans and the
card's kernels line up in one profiler trace (the JAX package opens a
``jax.profiler.TraceAnnotation`` there).

Two span flavours:

- ``begin``/``end``: duration events (``ph: "B"/"E"``), matched by name per
  lane (``tid``).
- ``begin_async``/``end_async``: chrome async events (``ph: "b"/"e"``) with
  a unique ``id`` per span instance, paired first-in first-out per (name,
  category, lane), so interleaved same-name instances never render as
  crossed intervals.  The ids are assigned here for both writers; the
  native writer puts the async events in lane 0 (chrome groups them by id).

:func:`device_stage` marks a collective call's start (``phase='B'``) and
return (``'E'``) as an async span, and records a ``device_stage`` event in
the flight recorder.  The JAX package fires it from inside the compiled
step once the data exists; the port runs eagerly, so the span covers the
host's side of the call, and on the card the kernels may still run after
its end (``torch.profiler`` shows them).
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from bluefog_tpu_torch.runtime import native as _native
from bluefog_tpu_torch.utils import lockcheck as _lc

__all__ = [
    "Timeline",
    "timeline_start",
    "timeline_stop",
    "timeline_start_activity",
    "timeline_end_activity",
    "timeline_context",
    "timeline_active",
    "current",
    "device_stage",
    "suppress_device_stage",
]

_OPEN_PER_KEY = 256
_OPEN_KEYS = 512


class Timeline:
    """A chrome-trace writer: the native one, or the Python twin.

    The Python twin drains and appends: each flush serialises only the
    events recorded since the previous one and appends them to the array on
    disk.  The closing ``]`` is written by :meth:`close`; until then the
    file is an unterminated array, which chrome and Perfetto accept, so a
    killed process still leaves a loadable trace of what was flushed.
    """

    def __init__(self, path: str, flush_interval_s: float = 2.0, *,
                 native: Optional[bool] = None):
        self.path = path
        self._events: List[dict] = []
        self._lock = _lc.lock("utils.timeline.Timeline._lock")
        self._io_lock = _lc.lock("utils.timeline.Timeline._io_lock")
        self._wrote_header = False
        self._finalized = False
        self._closed = False
        self._t0 = time.perf_counter()
        self._stop = threading.Event()
        self._open_async: Dict[Tuple, "collections.deque"] = {}
        self._async_ids = itertools.count(1)
        self._thread = None
        use_native = _native.enabled() if native is None else native
        self._native = _native.TimelineWriter(path) if use_native else None
        if self._native is None:
            with open(self.path, "w"):
                pass
            self._thread = threading.Thread(
                target=self._flush_loop, args=(flush_interval_s,),
                daemon=True)
            self._thread.start()
        atexit.register(self.close)

    @property
    def native(self) -> bool:
        return self._native is not None

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _event(self, name, category, ph, tid, **extra):
        ev = {"name": name, "cat": category, "ph": ph, "ts": self._now_us(),
              "pid": os.getpid(), "tid": tid, **extra}
        self._events.append(ev)

    def begin(self, name: str, category: str = "activity", tid: int = 0):
        if self._closed:
            return
        if self._native is not None:
            self._native.begin(name.encode(), category.encode(), tid)
            return
        with self._lock:
            self._event(name, category, "B", tid)

    def end(self, name: str, category: str = "activity", tid: int = 0):
        if self._closed:
            return
        if self._native is not None:
            self._native.end(name.encode(), category.encode(), tid)
            return
        with self._lock:
            self._event(name, category, "E", tid)

    def begin_async(self, name: str, category: str = "activity",
                    tid: int = 0) -> int:
        """Open an async span instance (``ph: "b"``); returns its id."""
        if self._closed:
            return 0
        aid = next(self._async_ids)
        with self._lock:
            key = (name, category, tid)
            q = self._open_async.get(key)
            if q is None:
                while len(self._open_async) >= _OPEN_KEYS:
                    self._open_async.pop(next(iter(self._open_async)))
                q = self._open_async[key] = collections.deque(
                    maxlen=_OPEN_PER_KEY)
            q.append(aid)
            if self._native is None:
                self._event(name, category, "b", tid, id=f"0x{aid:x}")
        if self._native is not None:
            self._native.begin_async(name.encode(), category.encode(), aid)
        return aid

    def end_async(self, name: str, category: str = "activity",
                  tid: int = 0) -> int:
        """Close the oldest open async span of (name, category, lane)."""
        if self._closed:
            return 0
        with self._lock:
            key = (name, category, tid)
            q = self._open_async.get(key)
            if q:
                aid = q.popleft()
                if not q:
                    self._open_async.pop(key, None)
            else:
                aid = next(self._async_ids)  # unmatched end: its own id
            if self._native is None:
                self._event(name, category, "e", tid, id=f"0x{aid:x}")
        if self._native is not None:
            self._native.end_async(name.encode(), category.encode(), aid)
        return aid

    def open_spans(self) -> List[dict]:
        """Async spans begun but not yet ended: the blackbox dump's "what
        was in flight" view of the timeline.  Timeout acquire: the dump
        path runs from fatal-signal handlers on the thread they
        interrupt, and an empty list beats a wedged dump."""
        if not self._lock.acquire(timeout=1.0):
            return []
        try:
            return [{"name": name, "cat": cat, "tid": tid, "id": aid,
                     "flavor": "async"}
                    for (name, cat, tid), q in self._open_async.items()
                    for aid in q]
        finally:
            self._lock.release()

    def instant(self, name: str, category: str = "marker"):
        if self._closed:
            return
        if self._native is not None:
            self._native.instant(name.encode(), category.encode())
            return
        with self._lock:
            self._event(name, category, "i", 0, s="p")

    def _flush_loop(self, interval: float):
        while not self._stop.wait(interval):
            self.flush()

    def flush(self):
        """Drain the buffered events and append them to the file (the
        Python twin; the native writer flushes on its own thread)."""
        if self._native is not None:
            return
        with self._lock:
            drained, self._events = self._events, []
        if not drained:
            return
        payload = ",\n".join(json.dumps(e) for e in drained)
        with self._io_lock:
            if self._finalized:
                return
            with open(self.path, "a") as f:
                f.write(("[\n" if not self._wrote_header else ",\n")
                        + payload)
            self._wrote_header = True

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._native is not None:
            self._native.close()
            self._native = None
            return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.flush()
        with self._io_lock:
            if not self._finalized:
                with open(self.path, "a") as f:
                    f.write("\n]\n" if self._wrote_header else "[]\n")
                self._finalized = True


_TIMELINE: Optional[Timeline] = None


def timeline_start(path: Optional[str] = None, *,
                   native: Optional[bool] = None) -> Optional[Timeline]:
    """Start tracing to ``path`` (default ``$BLUEFOG_TPU_TIMELINE``)."""
    global _TIMELINE
    path = path or os.environ.get("BLUEFOG_TPU_TIMELINE")
    if path:
        _TIMELINE = Timeline(path, native=native)
    return _TIMELINE


def timeline_stop():
    global _TIMELINE
    if _TIMELINE is not None:
        _TIMELINE.close()
        _TIMELINE = None


def _get() -> Optional[Timeline]:
    if _TIMELINE is None and os.environ.get("BLUEFOG_TPU_TIMELINE"):
        timeline_start()
    return _TIMELINE


def timeline_active() -> bool:
    """True when a timeline is recording: the cheap guard hot paths use to
    skip span bookkeeping."""
    return _get() is not None


def current() -> Optional[Timeline]:
    """The active :class:`Timeline`, or None.  Hot paths that need their
    own lanes (the rank threads of the asynchronous runners) call
    ``begin``/``end`` on it with their ``tid``."""
    return _get()


_profiler_spans = threading.local()


def timeline_start_activity(name: str, category: str = "activity"):
    """Open a named span (reference ``bf.timeline_start_activity``), and a
    ``torch.profiler.record_function`` of that name."""
    tl = _get()
    if tl is not None:
        tl.begin(name, category)
    import torch

    rf = torch.profiler.record_function(name)
    rf.__enter__()
    stacks = getattr(_profiler_spans, "stacks", None)
    if stacks is None:
        stacks = _profiler_spans.stacks = {}
    stacks.setdefault(name, []).append(rf)
    return True


def timeline_end_activity(name: str, category: str = "activity"):
    """Close a named span (reference ``bf.timeline_end_activity``)."""
    tl = _get()
    if tl is not None:
        tl.end(name, category)
    stacks = getattr(_profiler_spans, "stacks", None) or {}
    opened = stacks.get(name)
    if opened:
        opened.pop().__exit__(None, None, None)
    return True


@contextlib.contextmanager
def timeline_context(name: str, category: str = "activity"):
    """Context manager over start/end activity."""
    timeline_start_activity(name, category)
    try:
        yield
    finally:
        timeline_end_activity(name, category)


_suppress_stage = threading.local()


@contextlib.contextmanager
def suppress_device_stage():
    """:func:`device_stage` is the identity inside this block: a wrapper
    that runs an inner collective (the dynamic gossip's taken schedule)
    keeps one span, its own."""
    prev = getattr(_suppress_stage, "on", False)
    _suppress_stage.on = True
    try:
        yield
    finally:
        _suppress_stage.on = prev


def device_stage(x, name: str, *, phase: str = "B",
                 category: str = "gossip"):
    """Open (``phase='B'``) or close (``'E'``) ``name``'s async span in the
    active timeline, once per call, and record a ``device_stage`` event in
    the flight recorder when it is on.  Returns ``x`` unchanged; the
    identity when no timeline is active."""
    if phase not in ("B", "E"):
        raise ValueError(f"phase must be 'B' or 'E', got {phase!r}")
    tl = _get()
    if tl is None or getattr(_suppress_stage, "on", False):
        return x
    (tl.begin_async if phase == "B" else tl.end_async)(name, category)
    from bluefog_tpu_torch.blackbox import recorder as _bb

    rec = _bb.get()
    if rec is not None:
        rec.record("device_stage", name=name, phase=phase, rank=0)
    return x

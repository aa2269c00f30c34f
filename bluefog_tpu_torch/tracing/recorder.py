"""Per-rank causal span recorder.

Counterpart of ``bluefog_tpu/tracing/recorder.py``.  It answers "which
peer's deposit gated round k, and was the time in coalescing, the wire,
the owner's queue or its apply?": this module records the spans that
question needs, and :mod:`bluefog_tpu_torch.tracing.analyze` (``python -m
bluefog_tpu_torch.tracing``) joins them across ranks into the per-round
causal graph.

Every span is one JSONL record ::

    {"sid": <u63 span id>, "par": <parent sid | 0>, "tid": <trace id>,
     "name": "wire", "cat": "tcp", "rank": 3, "round": 17,
     "t0": <epoch s>, "dur": <s>, ...free-form fields}

- ``sid`` is unique across the job (seeded per-process randomness);
- ``par`` links child to parent within a rank (phase nesting) and across
  ranks (the wire-propagated trace context: a deposit batch carries
  ``(tid, sid, round)`` in a compact wire header, and the owner's recv,
  queue, apply and ack spans parent to the sender's wire span);
- ``tid`` groups one job's spans (derived from the job name, so every
  rank of a job computes the same id with no coordination);
- ``round`` stamps the training round the span belongs to, carried
  through thread-local context so transport internals need no API
  plumbing.

Recording is off by default.  ``BLUEFOG_TPU_TRACE=<dir>`` (read lazily;
the JAX package reads the same variable) or :func:`configure` arms it;
the disabled path is one env read and a ``None`` test per hook.  A span
is host time: nothing here touches the device.

Spans buffer in memory and land in ``trace-rank<k>.jsonl`` on
:func:`flush` (``trace-pid<p>.jsonl`` for a rank-less process, so a
serving reader does not alias rank 0's file; also flushed at interpreter
exit and when the buffer fills); the analyzer tolerates torn tails.  The
records are the JAX package's field for field, so each package's
analyzer reads the other's files.  Spans begun but never finished are
written as ``"open": true`` records at flush time without being
discharged: a wedged peer must show an open span, not a missing one.  An
explicit ``begin_span`` therefore needs a ``finally``-guaranteed
``finish``, unless the finish lives on another thread by design (the
deposit stream's wire span, begun by the sender and finished by the ack
reader).
"""

from __future__ import annotations

import atexit
import json
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from bluefog_tpu_torch.utils import lockcheck as _lc

__all__ = [
    "Span",
    "SpanRecorder",
    "active_phases",
    "configure",
    "current_ctx",
    "enabled",
    "flush",
    "get",
    "phase_tracking",
    "reset",
    "set_phase_tracking",
    "set_rank",
    "span",
    "trace_id_for",
    "wire_ctx",
]

#: buffered span records before an automatic flush to disk
_FLUSH_EVERY = 1024


def _fnv64(s: str) -> int:
    """FNV-1a 64-bit of a job name: every rank of a job derives the SAME
    trace id with no coordination (the id is a grouping key, not a
    secret)."""
    h = 0xCBF29CE484222325
    for b in s.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h or 1


def trace_id_for(job: str) -> int:
    return _fnv64(job)


class _Ctx(threading.local):
    """Thread-local active-span context: (trace_id, span_id, round).
    The transport reads it at ``deposit_async`` time (producer thread ==
    training thread), so round/parentage propagate into the wire layer
    with zero API churn."""

    def __init__(self):
        self.stack: List[Tuple[int, int, Optional[int]]] = []


_ctx = _Ctx()

#: thread ident -> (innermost span name, round) — the cross-thread
#: mirror of ``_ctx.stack``'s top.  A ``threading.local`` cannot be
#: read from another thread, and the profiling sampler thread must tag
#: every sample with the SAMPLED thread's open span; this dict is
#: written with single GIL-atomic assignments by the span context
#: managers (save-prev on enter, restore-or-delete on exit) and read
#: lock-free by the sampler (:mod:`bluefog_tpu_torch.profiling`) — no lock
#: anywhere, by construction.
_ACTIVE: Dict[int, Tuple[str, Optional[int]]] = {}

#: when True, :func:`span` maintains ``_ACTIVE`` even with tracing OFF
#: (a near-free phase-only context manager) — armed by the profiler so
#: ``profile=`` users get phase attribution without paying for full
#: span recording
_PHASE_TRACK = False


def set_phase_tracking(on: bool) -> None:
    """Arm/disarm phase-only context tracking (the profiler's switch).
    Idempotent; a plain bool flip — safe from any thread."""
    global _PHASE_TRACK
    _PHASE_TRACK = bool(on)


def phase_tracking() -> bool:
    return _PHASE_TRACK


def active_phases() -> Dict[int, Tuple[str, Optional[int]]]:
    """The live thread-ident -> (span name, round) map.  Returned BY
    REFERENCE for the sampler's lock-free per-tick reads; treat it as
    read-only everywhere else."""
    return _ACTIVE


class _PhaseCm:
    """Phase-only span: maintains ``_ACTIVE`` with no recorder, no
    timestamps, no allocation beyond the CM itself — what :func:`span`
    returns when tracing is off but the profiler wants attribution."""

    __slots__ = ("name", "round", "_ident", "_prev")

    def __init__(self, name, round_):
        self.name = name
        self.round = round_

    def __enter__(self):
        self._ident = threading.get_ident()
        self._prev = _ACTIVE.get(self._ident)
        _ACTIVE[self._ident] = (self.name, self.round)
        return None

    def __exit__(self, *exc):
        if self._prev is None:
            _ACTIVE.pop(self._ident, None)
        else:
            _ACTIVE[self._ident] = self._prev
        return False


class Span:
    """One explicit (cross-thread capable) span.  Prefer the
    :func:`span` context manager — its end is ``finally``-guaranteed;
    use begin/finish pairs only when the finish genuinely lives on
    another thread (the DepositStream wire span: begun by the sender,
    finished by the ack reader)."""

    __slots__ = ("rec", "sid", "par", "tid", "name", "cat", "round",
                 "t0", "fields", "_done")

    def __init__(self, rec, sid, par, tid, name, cat, round_, fields):
        self.rec = rec
        self.sid = sid
        self.par = par
        self.tid = tid
        self.name = name
        self.cat = cat
        self.round = round_
        self.t0 = time.time()
        self.fields = fields
        self._done = False

    @property
    def ctx(self) -> Tuple[int, int, int]:
        """(trace_id, span_id, round) — what rides the wire header.
        Round is clamped to a u32-packable value (0 when the span has
        none): this tuple feeds struct.pack on the send AND replay
        paths, and a None must never reach the wire."""
        rnd = self.round
        return (self.tid, self.sid,
                0 if rnd is None else max(0, int(rnd)))

    def finish(self, **extra) -> None:
        """Idempotent; callable from any thread."""
        if self._done:
            return
        self._done = True
        self.rec._finish(self, extra)


class SpanRecorder:
    """Bounded in-memory span buffer + JSONL writer for one process."""

    def __init__(self, directory: str, rank: Optional[int] = None,
                 job: str = "bf"):
        self.directory = directory
        self.rank = rank
        self.trace_id = _fnv64(job)
        self._lock = _lc.lock("tracing.recorder.SpanRecorder._lock")
        # file appends serialize separately from span bookkeeping: two
        # threads flushing concurrently (auto-flush on the ack thread
        # vs the training thread's explicit flush) must not interleave
        # their buffered writes mid-line in the shared JSONL
        self._io_lock = _lc.lock("tracing.recorder.SpanRecorder._io_lock")
        self._buf: List[dict] = []
        self._open: Dict[int, Span] = {}
        self._rng = random.Random(os.urandom(16))
        self.spans_recorded = 0
        self.dropped = 0

    # ------------------------------------------------------------ recording
    def _sid(self) -> int:
        return self._rng.getrandbits(63) | 1

    def begin_span(self, name: str, cat: str = "", *,
                   parent: Optional[int] = None,
                   round_: Optional[int] = None,
                   trace_id: Optional[int] = None,
                   **fields) -> Span:
        """Explicit begin; MUST be paired with ``Span.finish`` in a
        ``finally`` unless the finish lives on another
        thread by design.
        Unfinished spans surface as ``"open": true`` records at flush —
        never silently lost."""
        if parent is None or round_ is None:
            stack = _ctx.stack
            if stack:
                ptid, psid, pround = stack[-1]
                if parent is None:
                    parent = psid
                if round_ is None:
                    round_ = pround
                if trace_id is None:
                    trace_id = ptid
        sp = Span(self, self._sid(), parent or 0,
                  trace_id if trace_id is not None else self.trace_id,
                  name, cat, round_, fields)
        with self._lock:
            self._open[sp.sid] = sp
        return sp

    def _finish(self, sp: Span, extra: dict) -> None:
        rec = {"sid": sp.sid, "par": sp.par, "tid": sp.tid,
               "name": sp.name, "cat": sp.cat,
               "rank": self.rank, "round": sp.round,
               "t0": sp.t0, "dur": time.time() - sp.t0}
        if sp.fields:
            rec.update(sp.fields)
        if extra:
            rec.update(extra)
        flush_now = False
        with self._lock:
            self._open.pop(sp.sid, None)
            self._buf.append(rec)
            self.spans_recorded += 1
            flush_now = len(self._buf) >= _FLUSH_EVERY
        if flush_now:
            self.flush()

    def emit(self, name: str, cat: str = "", *, t0: float, dur: float,
             parent: Optional[int] = None, round_: Optional[int] = None,
             trace_id: Optional[int] = None, **fields) -> int:
        """Append one already-measured span (no open-table round trip —
        the hot-path form for code that holds its own timestamps, e.g.
        the window server's apply worker).  Returns the span's sid so a
        caller can parent children to it."""
        sid = self._sid()
        rec = {"sid": sid, "par": parent or 0,
               "tid": trace_id if trace_id is not None else self.trace_id,
               "name": name, "cat": cat, "rank": self.rank,
               "round": round_, "t0": t0, "dur": dur}
        if fields:
            rec.update(fields)
        flush_now = False
        with self._lock:
            self._buf.append(rec)
            self.spans_recorded += 1
            flush_now = len(self._buf) >= _FLUSH_EVERY
        if flush_now:
            self.flush()
        return sid

    # -------------------------------------------------------------- context
    def span(self, name: str, cat: str = "", *,
             round_: Optional[int] = None, **fields):
        """Context manager: begins a span, pushes it as the thread's
        active context (children + the transport inherit it), and
        finishes it in a ``finally``."""
        return _SpanCm(self, name, cat, round_, fields)

    # ---------------------------------------------------------------- flush
    def _path(self) -> str:
        # a rank-less process (a serving reader, a bench client) must
        # NOT alias rank 0's file: colocated processes sharing a trace
        # dir would interleave appends and tear each other's lines
        # mid-file (the _io_lock only serializes threads in-process)
        if self.rank is None:
            return os.path.join(self.directory,
                                f"trace-pid{os.getpid()}.jsonl")
        return os.path.join(self.directory,
                            f"trace-rank{self.rank}.jsonl")

    def flush(self) -> Optional[str]:
        """Append buffered spans (and a snapshot of still-open ones) to
        this rank's JSONL file; returns the path (None if nothing was
        ever recorded)."""
        with self._lock:
            buf, self._buf = self._buf, []
            open_snap = [
                {"sid": sp.sid, "par": sp.par, "tid": sp.tid,
                 "name": sp.name, "cat": sp.cat, "rank": self.rank,
                 "round": sp.round, "t0": sp.t0, "open": True,
                 **(sp.fields or {})}
                for sp in self._open.values()]
        if not buf and not open_snap:
            return None
        path = self._path()
        try:
            with self._io_lock:
                os.makedirs(self.directory, exist_ok=True)
                with open(path, "a") as f:
                    for rec in buf:
                        f.write(json.dumps(rec) + "\n")
                    # open spans are a SNAPSHOT (not discharged):
                    # re-written on every flush so the newest flush
                    # always shows what is in flight — the wedged-peer
                    # forensics contract
                    for rec in open_snap:
                        f.write(json.dumps(rec) + "\n")
        except OSError:
            self.dropped += len(buf)
            return None
        return path


class _SpanCm:
    __slots__ = ("rec", "name", "cat", "round", "fields", "sp",
                 "_ident", "_prev")

    def __init__(self, rec, name, cat, round_, fields):
        self.rec = rec
        self.name = name
        self.cat = cat
        self.round = round_
        self.fields = fields
        self.sp: Optional[Span] = None

    def __enter__(self) -> Span:
        self.sp = self.rec.begin_span(self.name, self.cat,
                                      round_=self.round, **self.fields)
        _ctx.stack.append((self.sp.tid, self.sp.sid, self.sp.round))
        # cross-thread phase mirror for the profiling sampler: one
        # GIL-atomic dict assignment, restored on exit
        self._ident = threading.get_ident()
        self._prev = _ACTIVE.get(self._ident)
        _ACTIVE[self._ident] = (self.name, self.sp.round)
        return self.sp

    def __exit__(self, *exc):
        try:
            if self._prev is None:
                _ACTIVE.pop(self._ident, None)
            else:
                _ACTIVE[self._ident] = self._prev
            if _ctx.stack:
                _ctx.stack.pop()
        finally:
            if self.sp is not None:
                self.sp.finish()
        return False


# ---------------------------------------------------------------------------
# Process-global recorder (lazy env activation)
# ---------------------------------------------------------------------------

_RECORDER: Optional[SpanRecorder] = None
_state_lock = _lc.lock("tracing.recorder._state_lock")
_STOPPED = False
_atexit_armed = False


def enabled() -> bool:
    return get() is not None


def get() -> Optional[SpanRecorder]:
    """The process recorder, or None when tracing is off.  Lazily honors
    ``BLUEFOG_TPU_TRACE=<dir>``; an explicit :func:`reset` sticks."""
    global _RECORDER
    if _RECORDER is None:
        if _STOPPED:
            return None
        d = os.environ.get("BLUEFOG_TPU_TRACE")
        if not d:
            return None
        with _state_lock:
            if _RECORDER is None and not _STOPPED:
                _configure_locked(d, None, None)
    return _RECORDER


def configure(directory: str, rank: Optional[int] = None,
              job: Optional[str] = None) -> SpanRecorder:
    """Install a recorder with explicit settings (replaces the lazy
    one); also un-sticks a previous :func:`reset`."""
    global _STOPPED
    with _state_lock:
        _STOPPED = False
        return _configure_locked(directory, rank, job)


def _configure_locked(directory, rank, job) -> SpanRecorder:
    global _RECORDER, _atexit_armed
    _RECORDER = SpanRecorder(directory, rank=rank, job=job or "bf")
    if not _atexit_armed:
        _atexit_armed = True
        atexit.register(flush)
    return _RECORDER


def set_rank(rank: int) -> None:
    """Pin the file's identity (the per-process DSGD body calls this);
    it must happen before the first flush names the file."""
    rec = get()
    if rec is not None and rec.rank is None:
        rec.rank = int(rank)


def reset() -> None:
    """Drop the recorder (tests); sticky against the env var until
    :func:`configure` runs again."""
    global _RECORDER, _STOPPED
    with _state_lock:
        if _RECORDER is not None:
            _RECORDER.flush()
        _RECORDER = None
        _STOPPED = True


def flush() -> None:
    global _RECORDER
    rec = _RECORDER
    if rec is not None:
        rec.flush()


def span(name: str, cat: str = "", *, round_: Optional[int] = None,
         **fields):
    """Module-level convenience: a no-op context manager when tracing
    is off (one env read + a None test) — unless the profiler armed
    phase tracking, in which case a near-free phase-only CM maintains
    the sampler's thread->phase map without any span recording."""
    rec = get()
    if rec is None:
        if _PHASE_TRACK:
            return _PhaseCm(name, round_)
        return _NULL_CM
    return rec.span(name, cat, round_=round_, **fields)


class _NullCm:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CM = _NullCm()


def current_ctx() -> Optional[Tuple[int, int, Optional[int]]]:
    """The calling thread's active span context ``(trace_id, span_id,
    round)`` or None — what the transport captures per deposit."""
    stack = _ctx.stack
    return stack[-1] if stack else None


def wire_ctx() -> Optional[Tuple[int, int, int]]:
    """Wire-encodable context: ``(trace_id u64, span_id u64,
    round u32)`` with round clamped to >= 0; None when tracing is off
    or no span is active."""
    if get() is None:
        return None
    c = current_ctx()
    if c is None:
        return None
    tid, sid, rnd = c
    return (tid, sid, 0 if rnd is None else max(0, int(rnd)))

"""Per-rank flight recorder: a bounded ring buffer of structured events.

Counterpart of ``bluefog_tpu/blackbox/recorder.py``, with its event
kinds, fields and modes, so each package's merge reads the other's dumps.
MegaScale (arXiv:2402.15627) attributes most lost training hours to hangs
and stragglers, and diagnoses them with an always-on per-rank flight
recorder that is *dumped on failure* rather than streamed: the recorder
must be cheap enough to leave on, bounded so a week-long run cannot leak,
and crash-consistent so the last events before a wedge survive.
:mod:`bluefog_tpu_torch.blackbox.dump` writes it out on failure and
:mod:`bluefog_tpu_torch.blackbox.merge` aligns the per-rank files into a
cross-rank diagnosis.

Event kinds recorded by the framework (callers may add their own):

====================  ======================================================
``collective_begin``  a gossip/window round was started on this rank
``collective_end``    the round's outputs materialized (begin without a
                      matching end in a dump = the round this rank is
                      stuck in)
``window_deposit``    one-sided deposit into a landing slot (host path)
``window_read``       landing-slot consume (carries the fresh count)
``tcp_*``             window-server per-connection op records
``optimizer_step``    one optimizer update completed
``heartbeat_beat``    the training loop beat the watchdog
``device_stage``      a collective's timeline span opened or closed
``lock_order_cycle``  the lock-order tripwire caught an inversion
====================  ======================================================

Modes, via ``BLUEFOG_TPU_BLACKBOX`` (read lazily, like the metrics
variable):

- unset / ``1`` (default): **host-path recording on**: deque appends under
  one uncontended lock.  The collectives record nothing.
- ``0`` / ``off``: everything off; every hook is a no-op or the identity.
- ``jit`` (also ``full``): additionally arm the **per-call collective
  events** (:func:`traced_event`): every gossip, window and optimizer
  call records a begin and an end.  The JAX package records them from
  inside the compiled step; the port runs eagerly, so here they are made
  once per call.

``collective_end`` keeps the JAX package's meaning: the round's outputs
have materialized.  A call on the card returns once its kernels are
enqueued, so the end is not recorded at return: :func:`traced_event`
records a ``torch.cuda.Event`` on the current stream there, and the end
enters the ring when that event has completed, checked at the next
begin, at :meth:`FlightRecorder.settle` and at every dump.  A dump's
begin without an end therefore names a round the card (or, through the
transport's wait, a peer) never finished.  On the CPU the outputs exist
at return, and the end is recorded there.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading

import time
from typing import Dict, List, Optional, Tuple

from bluefog_tpu_torch.utils import lockcheck as _lc

__all__ = [
    "FlightRecorder",
    "begin",
    "configure",
    "enabled",
    "end",
    "get",
    "jit_enabled",
    "collective_calls",
    "next_collective_id",
    "record",
    "reset",
    "settle",
    "suppress_blackbox",
    "traced_event",
]

DEFAULT_CAPACITY = 4096
#: open-span table bound: a caller that begins rounds it never ends must
#: not leak memory faster than the ring itself
_MAX_OPEN = 1024


def _mode() -> str:
    v = os.environ.get("BLUEFOG_TPU_BLACKBOX", "1").strip().lower()
    if v in ("0", "off", "false", "no"):
        return "off"
    if v in ("jit", "full", "deep", "2"):
        return "jit"
    return "host"


def enabled() -> bool:
    """Host-path recording active (the default)."""
    return _mode() != "off"


def jit_enabled() -> bool:
    """Jitted-path hooks armed (``BLUEFOG_TPU_BLACKBOX=jit``)."""
    return _mode() == "jit"


class FlightRecorder:
    """Fixed-size ring of structured events + an open-span table.

    Lock-light: one plain mutex held only for the deque append / the
    open-table update: recorders include the window server's daemon
    threads and N rank loops, and an event is a dict build plus an
    append, so contention is negligible at any realistic rate (same
    reasoning as the metrics registry's single lock).  Ends whose outputs
    are still being computed on the card wait in a pending list until
    :meth:`settle` sees their event complete.
    """

    def __init__(self, capacity: Optional[int] = None,
                 rank: Optional[int] = None):
        if capacity is None:
            capacity = int(os.environ.get(
                "BLUEFOG_TPU_BLACKBOX_CAPACITY", DEFAULT_CAPACITY))
        self.capacity = int(capacity)
        self.rank = rank
        self.created_at = time.time()
        self._lock = _lc.lock("blackbox.recorder.FlightRecorder._lock")
        self._seq = itertools.count()
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity)
        # (name, key) -> the begin event still waiting for its end
        self._open: "collections.OrderedDict[Tuple, dict]" = \
            collections.OrderedDict()
        # FIFO occurrence pairing for begin/end pairs with no natural key
        # (stepless jitted rounds): begins enqueue a fresh occurrence id,
        # ends dequeue the oldest — the timeline's async-span policy
        self._occ_seq = itertools.count()
        self._occ_open: Dict[Tuple, "collections.deque"] = {}
        self.dropped = 0  # events evicted by the ring bound
        # (cuda event, name, base key, step, fields) of ends not yet
        # materialized, in the order of their calls
        self._pending: List[Tuple] = []
        self._pending_lock = _lc.lock(
            "blackbox.recorder.FlightRecorder._pending_lock")

    # ------------------------------------------------------------- recording
    def record(self, kind: str, **fields) -> dict:
        ev = {"seq": next(self._seq), "t": time.time(), "kind": kind}
        ev.update(fields)
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)
        return ev

    def begin(self, name: str, key=None, **fields) -> dict:
        """Record ``<name>_begin`` and track it as open until
        :meth:`end` with the same ``(name, key)`` — a dump lists what is
        still open, which is exactly the round a wedged rank is stuck
        in."""
        ev = {"seq": next(self._seq), "t": time.time(),
              "kind": f"{name}_begin"}
        ev.update(fields)
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)
            self._open[(name, key)] = ev
            while len(self._open) > _MAX_OPEN:
                self._open.popitem(last=False)
        return ev

    def end(self, name: str, key=None, **fields) -> dict:
        ev = {"seq": next(self._seq), "t": time.time(),
              "kind": f"{name}_end"}
        ev.update(fields)
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)
            self._open.pop((name, key), None)
        return ev

    def begin_occurrence(self, fifo_key: Tuple) -> int:
        """Fresh occurrence id for a stepless begin (paired FIFO)."""
        with self._lock:
            n = next(self._occ_seq)
            self._occ_open.setdefault(fifo_key, collections.deque()).append(n)
            return n

    def end_occurrence(self, fifo_key: Tuple) -> int:
        """Oldest open occurrence id for ``fifo_key`` (fresh if none)."""
        with self._lock:
            q = self._occ_open.get(fifo_key)
            if q:
                n = q.popleft()
                if not q:
                    self._occ_open.pop(fifo_key, None)
                return n
            return next(self._occ_seq)

    def _end_keyed(self, name: str, base: Tuple, step, fields: dict) -> dict:
        key = base + ((step,) if step is not None
                      else (self.end_occurrence(base),))
        return self.end(name, key=key, **fields)

    def defer_end(self, event, name: str, base: Tuple, step,
                  fields: dict) -> None:
        """Hold an end until ``event`` (a ``torch.cuda.Event`` recorded
        after the round's kernels) has completed."""
        with self._pending_lock:
            self._pending.append((event, name, base, step, fields))

    def settle(self) -> int:
        """Record the pending ends whose events have completed, oldest
        first, never waiting on the card (``Event.query``).  A key whose
        oldest pending end is incomplete keeps its later ones too, so the
        FIFO pairing of begins and ends holds.  Returns how many stay
        pending.  Timeout acquire, as in :meth:`_snapshot`: the dump path
        runs from signal handlers on the thread they interrupt."""
        if not self._pending_lock.acquire(timeout=1.0):
            return len(self._pending)
        try:
            keep, blocked, done = [], set(), []
            for item in self._pending:
                base = item[2]
                if base in blocked or not item[0].query():
                    blocked.add(base)
                    keep.append(item)
                else:
                    done.append(item)
            self._pending = keep
        finally:
            self._pending_lock.release()
        for _event, name, base, step, fields in done:
            self._end_keyed(name, base, step, fields)
        return len(keep)

    # ------------------------------------------------------------- snapshots
    def _snapshot(self, pull):
        # Timeout acquire, NOT a plain `with`: the dump path runs from
        # fatal-SIGNAL handlers, which execute on the very thread they
        # interrupt — if that thread was mid-record() holding this
        # non-reentrant lock, a blocking acquire would deadlock the
        # process the forensics exist to diagnose.  On timeout, read
        # unlocked: the interrupted mutator is SUSPENDED (same thread),
        # and a retry loop absorbs any other thread's concurrent append.
        if self._lock.acquire(timeout=1.0):
            try:
                return pull()
            finally:
                self._lock.release()
        for _ in range(3):
            try:
                return pull()
            except RuntimeError:  # deque mutated during iteration
                continue
        return []

    def events(self) -> List[dict]:
        return self._snapshot(lambda: [dict(e) for e in self._events])

    def counts_since(self, seq: int) -> Tuple[int, Dict[str, int]]:
        """``(newest seq, {kind: count})`` over ring events with
        ``seq`` strictly above the given watermark — the fleet
        publisher's cheap periodic sample: one lock-held counting pass
        over the deque, never a per-event dict copy (a 4096-event ring
        copy per round would be the publisher's whole overhead budget).
        Evicted events are simply absent, exactly as a dump would show
        them."""
        def pull():
            counts: Dict[str, int] = {}
            last = int(seq)
            # newest-first with early stop: the publisher calls this
            # every round, and scanning the full 4096-slot ring per
            # call would dominate its overhead budget — seqs are
            # monotone, so the first already-seen event ends the walk
            for ev in reversed(self._events):
                s = ev["seq"]
                if s <= seq:
                    break
                counts[ev["kind"]] = counts.get(ev["kind"], 0) + 1
                if s > last:
                    last = s
            return last, counts

        got = self._snapshot(pull)
        # _snapshot's unlocked-retry fallback returns [] when every
        # retry raced a mutation; report "nothing consumed" so the next
        # window recounts instead of skipping events
        return got if got else (int(seq), {})

    def recent(self, seconds: float = 30.0) -> List[dict]:
        """Ring events from the last ``seconds`` of wall time, oldest
        first — the dump/profile "what just happened" window.  Same
        timeout-acquire snapshot discipline as :meth:`events`, and the
        same newest-first early-stop walk as :meth:`counts_since`
        (timestamps are monotone within the ring, so the first
        too-old event ends the scan instead of copying 4096 slots)."""
        cutoff = time.time() - float(seconds)

        def pull():
            out: List[dict] = []
            for ev in reversed(self._events):
                if ev["t"] < cutoff:
                    break
                out.append(dict(ev))
            out.reverse()
            return out

        return self._snapshot(pull)

    def open_spans(self) -> List[dict]:
        return self._snapshot(
            lambda: [dict(e) for e in self._open.values()])

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._open.clear()
            self._occ_open.clear()
            self.dropped = 0
        with self._pending_lock:
            self._pending = []


_RECORDER: Optional[FlightRecorder] = None
_state_lock = _lc.lock("blackbox.recorder._state_lock")


def get() -> Optional[FlightRecorder]:
    """The process flight recorder, or None when recording is off.
    Created lazily on first use (env read per call, matching the metrics
    registry's lazy activation)."""
    global _RECORDER
    if not enabled():
        return None
    if _RECORDER is None:
        with _state_lock:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


def configure(capacity: Optional[int] = None,
              rank: Optional[int] = None) -> FlightRecorder:
    """Install a recorder with explicit settings (replaces the lazy one)."""
    global _RECORDER
    with _state_lock:
        _RECORDER = FlightRecorder(capacity=capacity, rank=rank)
    return _RECORDER


def reset() -> None:
    """Drop the process recorder and per-site counters (tests)."""
    global _RECORDER, _cid_counters
    with _state_lock:
        _RECORDER = None
        _cid_counters = {}


def record(kind: str, **fields) -> None:
    """Module-level convenience: record into the process recorder; no-op
    when recording is off (one env read + a None test)."""
    rec = get()
    if rec is not None:
        rec.record(kind, **fields)


def begin(name: str, key=None, **fields) -> None:
    rec = get()
    if rec is not None:
        rec.begin(name, key=key, **fields)


def end(name: str, key=None, **fields) -> None:
    rec = get()
    if rec is not None:
        rec.end(name, key=key, **fields)


def settle() -> int:
    """Record the pending ends whose card work has completed
    (:meth:`FlightRecorder.settle`); returns how many stay pending."""
    rec = get()
    return rec.settle() if rec is not None else 0


# ---------------------------------------------------------------------------
# Collective-id assignment
# ---------------------------------------------------------------------------

#: per-op call counters.  The JAX package numbers a jitted program's call
#: sites at trace time; the port runs eagerly, so every call takes the
#: next id.  SPMD processes make the same calls in the same order, so the
#: k-th neighbor_allreduce call gets the same id on every rank: the
#: cross-rank alignment key merge.py joins on.
_cid_counters: Dict[str, int] = {}
_cid_lock = _lc.lock("blackbox.recorder._cid_lock")


def next_collective_id(op: str) -> str:
    """``"<op>#<n>"``: the n-th call of ``op`` in this process.  Incremented unconditionally (even with recording off) so a
    mixed fleet (some ranks recording, some not) still assigns aligned
    ids."""
    with _cid_lock:
        c = _cid_counters.get(op, 0)
        _cid_counters[op] = c + 1
        return f"{op}#{c}"


def collective_calls() -> Dict[str, int]:
    """``{op: calls so far}`` of every collective this process has made
    (the ids :func:`next_collective_id` handed out)."""
    with _cid_lock:
        return dict(_cid_counters)




# ---------------------------------------------------------------------------
# Per-call collective events
# ---------------------------------------------------------------------------

_suppress = threading.local()


@contextlib.contextmanager
def suppress_blackbox():
    """:func:`traced_event` is the identity inside this block.  A wrapper
    that runs an inner collective (the dynamic gossip's taken schedule)
    uses it, so the call records one begin/end pair, its own."""
    prev = getattr(_suppress, "on", False)
    _suppress.on = True
    try:
        yield
    finally:
        _suppress.on = prev


def _suppressed() -> bool:
    return getattr(_suppress, "on", False)


def _cuda_event(x):
    """A ``torch.cuda.Event`` recorded on the current stream of ``x``'s
    first CUDA tensor leaf, or None when ``x`` holds none."""
    import torch
    from torch.utils import _pytree as pytree

    for leaf in pytree.tree_leaves(x):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(leaf.device))
            return ev
    return None


def traced_event(x, kind: str, *, fields: Optional[dict] = None,
                 traced: Optional[dict] = None):
    """Record ``kind`` once for this call, returning ``x`` unchanged.

    The identity unless ``BLUEFOG_TPU_BLACKBOX=jit``.  ``fields`` are the
    event's labels; ``traced`` maps field names to per-call numbers (the
    step), recorded as ints where integral, as the JAX package's
    callback records its traced scalars.  ``kind`` endings
    ``_begin``/``_end`` route through the recorder's open-span table keyed
    by ``(cid, rank, step)``, or by a first-in first-out occurrence id
    when there is no step.  A ``_begin`` first settles the pending ends.
    An ``_end`` whose ``x`` holds CUDA tensors is deferred until a
    ``torch.cuda.Event`` recorded now has completed (see the module
    docstring); on the CPU it is recorded at once.
    """
    rec = get() if jit_enabled() else None
    if rec is None or _suppressed():
        return x
    f = dict(fields or {})
    for k, v in (traced or {}).items():
        fv = float(v)
        f[k] = int(fv) if fv == int(fv) else fv
    step = f.get("step")
    base = (f.get("cid"), f.get("rank"))
    if kind.endswith("_begin"):
        rec.settle()
        key = base + ((step,) if step is not None
                      else (rec.begin_occurrence(base),))
        rec.begin(kind[:-len("_begin")], key=key, **f)
    elif kind.endswith("_end"):
        ev = _cuda_event(x)
        if ev is None:
            rec._end_keyed(kind[:-len("_end")], base, step, f)
        else:
            rec.defer_end(ev, kind[:-len("_end")], base, step, f)
    else:
        rec.record(kind, **f)
    return x

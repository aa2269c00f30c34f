"""Dynamic lock-order tripwire: lockdep for the host-side runtime.

Counterpart of ``bluefog_tpu/utils/lockcheck.py``.  A named lock is made
through the factories here (:func:`lock`, :func:`rlock`,
:func:`condition`), which return a thin proxy over the real
``threading`` primitive:

- **off** (default): the proxy's acquire and release delegate straight
  to the inner primitive: one attribute load and a module-global boolean
  test on the hot path.  ``BLUEFOG_TPU_LOCKCHECK`` unset or ``0``.
- **on** (``BLUEFOG_TPU_LOCKCHECK=1`` or :func:`enable`): each blocking
  acquire records, for every lock the acquiring thread already holds, a
  first-seen ordering edge ``held -> wanted`` in a process-global edge
  table (thread-local held sets; lock classes as in lockdep: all
  instances made under one name share an ordering identity).  An acquire
  whose new edge closes a cycle in the table is a potential deadlock
  observed live: it is recorded in :func:`violations` and, in ``raise``
  mode (the default when enabled), raises :class:`LockOrderViolation`
  before blocking, so the test that drove the runtime into the inversion
  fails instead of hanging.  ``BLUEFOG_TPU_LOCKCHECK=warn`` records
  without raising.

Scope:

- Edges are recorded only for acquires that can deadlock: blocking,
  untimed ones.  Timed and non-blocking acquires still update the held
  set but add no edges of their own.
- Two instances of one lock class acquired together (same name,
  different objects, e.g. two peers' stream locks) are recorded as a
  ``same_class`` self-edge for the report but never raise.
- The tripwire checks ordering, not liveness: a lock held across a
  blocking socket call trips nothing here.
- One exception to ordering: a thread blocking on a non-reentrant lock
  it already holds raises even in ``warn`` mode, since continuing is the
  hang.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "LockOrderViolation",
    "condition",
    "cycles",
    "disable",
    "edges",
    "enable",
    "enabled",
    "lock",
    "reset",
    "rlock",
    "violations",
]


class LockOrderViolation(RuntimeError):
    """A blocking acquire would close a cycle in the observed lock-order
    graph — the ABBA deadlock shape, caught before it blocks."""


# module-global switch (checked per acquire — cheap, and it means locks
# created at import time are still tracked when a test enables the
# tripwire later in the same process)
_enabled = False
_raise_on_cycle = True

# the meta-lock guarding the edge table.  A plain threading.Lock, never
# a tracked one: the tripwire must not trip over itself.
_meta = threading.Lock()
# (src_name, dst_name) -> first-seen info dict
_edges: Dict[Tuple[str, str], dict] = {}
# src_name -> set of dst_names (adjacency twin of _edges, for cycle DFS)
_adj: Dict[str, set] = {}
_violations: List[dict] = []

_tls = threading.local()


def _held() -> List:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _env_mode() -> Optional[str]:
    v = os.environ.get("BLUEFOG_TPU_LOCKCHECK", "").strip().lower()
    if v in ("", "0", "off", "false"):
        return None
    if v in ("warn", "record"):
        return "warn"
    return "raise"  # "1", "raise", anything else truthy


def enabled() -> bool:
    return _enabled


def enable(*, raise_on_cycle: bool = True) -> None:
    """Turn the tripwire on for locks already created and yet to come."""
    global _enabled, _raise_on_cycle
    _raise_on_cycle = bool(raise_on_cycle)
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Clear the edge table and recorded violations (held-sets are
    per-thread and self-correct as locks release)."""
    with _meta:
        _edges.clear()
        _adj.clear()
        _violations.clear()


def edges() -> Dict[Tuple[str, str], dict]:
    """Copy of the first-seen ordering edge table."""
    with _meta:
        return {k: dict(v) for k, v in _edges.items()}


def violations() -> List[dict]:
    with _meta:
        return [dict(v) for v in _violations]


def _reachable(frm: str, to: str) -> bool:
    """True iff ``to`` is reachable from ``frm`` in the edge graph.
    Caller holds ``_meta``."""
    seen = set()
    stack = [frm]
    while stack:
        cur = stack.pop()
        if cur == to:
            return True
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(_adj.get(cur, ()))
    return False


def cycles() -> List[List[str]]:
    """Every elementary cycle currently in the edge table (name lists;
    ``[a]`` alone is a recorded same-class self-edge, reported but not a
    violation).  The integration tests assert this is empty after
    driving the real runtime loops under the tripwire."""
    with _meta:
        adj = {k: sorted(v) for k, v in _adj.items()}
    out: List[List[str]] = []
    seen_keys = set()
    for start in sorted(adj):
        # DFS from each node; report cycles through the start node only
        # (canonical rotation), dedup by frozenset of members
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in adj.get(node, ()):
                if nxt == start:
                    key = frozenset(path)
                    if key not in seen_keys:
                        seen_keys.add(key)
                        out.append(list(path))
                elif nxt not in path and nxt > start:
                    stack.append((nxt, path + [nxt]))
    return out


def _brief_stack() -> List[str]:
    import traceback

    return [f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} {f.name}"
            for f in traceback.extract_stack(limit=8)[:-3]]


def _record_cycle(hit: dict, **extra) -> None:
    """The forensic record of a violation: a ``lock_order_cycle`` event in
    the flight recorder, so a dump taken after it names the inversion."""
    from bluefog_tpu_torch.blackbox import recorder as _bb

    _bb.record("lock_order_cycle", held=hit["held"], wanted=hit["wanted"],
               thread=hit["thread"], **extra)


def _note_blocking_acquire(wanted: "_TrackedLock") -> None:
    """Record edges held->wanted; raise on a cycle-closing edge."""
    held = _held()
    if not held:
        return
    hit: Optional[dict] = None
    me = threading.current_thread().name
    for entry in held:
        src = entry[0].name
        dst = wanted.name
        if src == dst:
            # same lock class, different instance (same instance is the
            # reentrancy path, handled by the caller): record for the
            # report, never a violation
            if entry[0] is not wanted:
                with _meta:
                    _edges.setdefault((src, dst), {
                        "thread": me, "same_class": True,
                        "stack": _brief_stack()})
                    _adj.setdefault(src, set()).add(dst)
            continue
        with _meta:
            if (src, dst) not in _edges:
                closes = _reachable(dst, src)
                _edges[(src, dst)] = {
                    "thread": me, "same_class": False,
                    "closes_cycle": closes, "stack": _brief_stack()}
                _adj.setdefault(src, set()).add(dst)
                if closes and hit is None:
                    hit = {"held": src, "wanted": dst, "thread": me,
                           "stack": _brief_stack()}
                    _violations.append(hit)
    if hit is not None:
        _record_cycle(hit)
        if _raise_on_cycle:
            raise LockOrderViolation(
                f"lock-order cycle: thread {hit['thread']!r} holds "
                f"{hit['held']!r} and wants {hit['wanted']!r}, but the "
                f"opposite order was already observed (edge table has a "
                f"path {hit['wanted']!r} -> {hit['held']!r}) — this is "
                "the ABBA deadlock shape; fix the nesting or make one "
                "side lock-free")


def _note_self_deadlock(wanted: "_TrackedLock") -> None:
    """The thread already holds this exact non-reentrant lock and is
    about to block on it again: not an ordering inversion but a certain
    single-thread deadlock.  Record it; raise even in warn mode:
    there is no 'observe and continue' here, continuing IS the hang."""
    me = threading.current_thread().name
    hit = {"held": wanted.name, "wanted": wanted.name, "thread": me,
           "self_deadlock": True, "stack": _brief_stack()}
    with _meta:
        _violations.append(hit)
    _record_cycle(hit, self_deadlock=True)
    raise LockOrderViolation(
        f"self-deadlock: thread {me!r} already holds non-reentrant lock "
        f"{wanted.name!r} and is blocking on it again — this can never "
        "succeed; make it an rlock() or lift the nested acquire out of "
        "the critical section")


def _push(lk: "_TrackedLock", count: int = 1) -> None:
    held = _held()
    for entry in held:
        if entry[0] is lk:
            entry[1] += count
            return
    held.append([lk, count])


def _pop(lk: "_TrackedLock", all_counts: bool = False) -> int:
    held = _held()
    for i, entry in enumerate(held):
        if entry[0] is lk:
            if all_counts:
                n = entry[1]
                del held[i]
                return n
            entry[1] -= 1
            if entry[1] <= 0:
                del held[i]
            return 1
    return 0


class _TrackedLock:
    """Order-recording proxy over a ``threading`` lock.  Also a valid
    ``threading.Condition`` underlying lock (``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` keep the held-set honest across
    a condvar wait)."""

    __slots__ = ("name", "_inner", "_reentrant")

    def __init__(self, name: str, inner, reentrant: bool):
        self.name = name
        self._inner = inner
        self._reentrant = reentrant

    # ------------------------------------------------------------- acquire
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _enabled:
            if blocking and (timeout is None or timeout < 0):
                if any(e[0] is self for e in _held()):
                    # same instance, same thread: legal re-entry for an
                    # RLock, a certain deadlock for a plain Lock; trip
                    # before blocking
                    if not self._reentrant:
                        _note_self_deadlock(self)
                else:
                    _note_blocking_acquire(self)
            ok = self._inner.acquire(blocking, -1 if timeout is None
                                     else timeout)
            if ok:
                _push(self)
            return ok
        return self._inner.acquire(blocking,
                                   -1 if timeout is None else timeout)

    def release(self) -> None:
        self._inner.release()
        # pop UNCONDITIONALLY: a lock acquired while the tripwire was
        # enabled may be released after disable() (test teardown racing
        # a daemon thread's critical section) — skipping the pop would
        # leave a stale held-set entry that fabricates edges on the
        # next enable().  Off-path cost: one thread-local load and a
        # scan of an (almost always empty) list.
        _pop(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    # ------------------------------------- threading.Condition integration
    def _is_owned(self) -> bool:
        owned = getattr(self._inner, "_is_owned", None)
        if owned is not None:
            return owned()
        # plain Lock fallback: CPython's own trick, on the inner lock
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        saver = getattr(self._inner, "_release_save", None)
        if saver is not None:
            state = saver()
        else:
            self._inner.release()
            state = None
        n = _pop(self, all_counts=True)  # unconditional: see release()
        return (state, max(1, n))

    def _acquire_restore(self, saved) -> None:
        state, n = saved
        restorer = getattr(self._inner, "_acquire_restore", None)
        if restorer is not None and state is not None:
            restorer(state)
        else:
            self._inner.acquire()
        if _enabled:
            _push(self, n)
            # the re-acquire after a condvar wait blocks exactly like a
            # fresh acquire: locks still held order BEFORE this one.
            # Checked AFTER the lock is restored (the self-entry just
            # pushed is skipped as same-instance): raising mid-restore
            # would leave the Condition's lock unheld and the enclosing
            # `with cv:` __exit__ would mask the violation with a
            # 'release unlocked lock' RuntimeError
            _note_blocking_acquire(self)

    def __repr__(self) -> str:
        return f"<bf-lock {self.name!r} over {self._inner!r}>"


def lock(name: str) -> _TrackedLock:
    """A named (non-reentrant) mutex; drop-in for ``threading.Lock()``."""
    return _TrackedLock(name, threading.Lock(), reentrant=False)


def rlock(name: str) -> _TrackedLock:
    """A named reentrant mutex; drop-in for ``threading.RLock()``."""
    return _TrackedLock(name, threading.RLock(), reentrant=True)


def condition(name: str, lk: Optional[_TrackedLock] = None
              ) -> threading.Condition:
    """A condition variable whose underlying lock is order-tracked.
    ``lk`` shares an existing tracked lock (the
    ``threading.Condition(existing)`` form); default is a fresh tracked
    RLock, matching ``threading.Condition()``."""
    return threading.Condition(lk if lk is not None else rlock(name))


# arm from the environment at import: a subprocess launched with
# BLUEFOG_TPU_LOCKCHECK=1 needs no code changes to run checked
_mode = _env_mode()
if _mode is not None:
    enable(raise_on_cycle=(_mode == "raise"))
del _mode

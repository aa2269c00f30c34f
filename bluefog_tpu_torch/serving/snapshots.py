"""Round-stamped consistent snapshots: the publish half of the serving tier.

Counterpart of ``bluefog_tpu/serving/snapshots.py``.  The asynchronous
training loops make progress with no barrier anywhere, which is why a
naive reader of their state can observe a *torn* model: ``x`` from round
``k`` next to ``p`` from round ``k+1`` de-biases to a point on no rank's
trajectory.  A trainer therefore publishes a set of named leaves stamped
with one round number, and a reader either gets all of them from that
one publish or a retriable error, never a mix.

:class:`SnapshotTable` is that primitive:

- **Double-buffered per group.**  ``publish(group, round, leaves)``
  copies every leaf into the group's inactive buffer (readers only ever
  copy from the active one, under the table lock), then swaps the active
  index under the table lock.  The heavy copy never blocks readers; the
  swap is O(1).
- **Copy-under-lock reads.**  ``read`` copies the requested leaves while
  holding the table lock, so a publish can never land mid-read: within
  one ``read`` every leaf carries the same round stamp.  ``want_round``
  pins a round across several reads: if the table moved on, the read
  fails with :class:`RoundRolled` (retriable).
- **Publish generations.**  Every publish bumps a per-group generation
  and notifies waiters; subscription senders block in
  :meth:`SnapshotTable.wait_newer` instead of polling, and use the
  generation delta to count the rounds a slow reader skipped.

Leaves are numpy arrays (f32 or f64), as on the wire: the trainers pack
their parameters from the card into the f64 window vector before they
publish, and a replica unpacks them back onto the card.

One process-global table (:func:`table`) mirrors the window table: the
dsgd loops publish into it, and any
:class:`~bluefog_tpu_torch.runtime.window_server.WindowServer` in the
process serves it over the wire (``SNAPSHOT`` / ``SUBSCRIBE`` ops).

Training is never blocked by readers beyond the swap and copy lock:
there is no per-reader state here, no reader ack, nothing a dead or
wedged reader can hold.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "RoundRolled",
    "SnapshotTable",
    "SnapshotUnavailable",
    "table",
]


class SnapshotUnavailable(RuntimeError):
    """No snapshot to serve (group never published, or an unknown leaf
    was requested).  Retriable early in a job's life, terminal for a
    misspelled group or leaf."""


class RoundRolled(RuntimeError):
    """A ``want_round``-pinned read found the table already swapped to a
    newer round.  Always retriable: re-read without the pin (or pin the
    round the exception names) and continue.

    :attr:`current_round` carries the round the table holds now."""

    def __init__(self, group: str, want_round: int, current_round: int):
        super().__init__(
            f"snapshot round rolled for group {group!r}: wanted round "
            f"{want_round}, table now holds {current_round}; re-pin and "
            "retry (the publisher moved on mid-consume)")
        self.group = group
        self.want_round = want_round
        self.current_round = current_round


class _Group:
    """One publisher's double-buffered snapshot slot."""

    __slots__ = ("buffers", "rounds", "active", "gen", "write_mu",
                 "published_at", "created_at", "trace")

    def __init__(self):
        self.buffers: List[Dict[str, np.ndarray]] = [{}, {}]
        self.rounds = [-1, -1]
        self.active = 0
        self.gen = 0            # publish count; 0 = never published
        self.write_mu = threading.Lock()  # serialises publishers
        self.published_at = 0.0
        self.created_at = time.monotonic()  # idle-TTL sweep baseline
        # (trace_id, span_id) of the latest publish, when the publisher
        # carried one (a relay hop): the server's push senders parent
        # their push spans to it, so the analyzer walks the reader tree
        self.trace: Optional[Tuple[int, int]] = None


class SnapshotTable:
    """Round-stamped, double-buffered snapshot store (see module doc)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._groups: Dict[str, _Group] = {}

    # ------------------------------------------------------------- publish
    def _group(self, group: str) -> _Group:
        with self._mu:
            g = self._groups.get(group)
            if g is None:
                g = self._groups[group] = _Group()
        return g

    def publish(self, group: str, round_: int,
                leaves: Dict[str, np.ndarray], *,
                trace: Optional[Tuple[int, int]] = None) -> None:
        """Atomically publish ``leaves`` as round ``round_`` of ``group``.

        Leaves are copied (the caller's buffers are free at once: the dsgd
        loops reuse theirs every step) into the inactive buffer, then the
        active index swaps under the read lock.  A concurrent :meth:`read`
        sees either entirely the previous round or entirely this one.
        ``trace`` is the publisher's ``(trace_id, span_id)``, returned by
        :meth:`trace_ctx` until the next publish."""
        if not leaves:
            raise ValueError("a snapshot needs at least one leaf")
        g = self._group(group)
        with g.write_mu:
            tgt = 1 - g.active
            buf = g.buffers[tgt]
            for name, arr in leaves.items():
                a = np.ascontiguousarray(arr)
                if a.dtype not in (np.dtype(np.float32),
                                   np.dtype(np.float64)):
                    raise TypeError(
                        f"snapshot leaf {name!r} must be f32/f64 (the "
                        f"wire dtype table), got {a.dtype}")
                dst = buf.get(name)
                if (dst is None or dst.shape != a.shape
                        or dst.dtype != a.dtype):
                    buf[name] = a.copy()
                else:
                    np.copyto(dst, a)
            for stale in [n for n in buf if n not in leaves]:
                del buf[stale]
            g.rounds[tgt] = int(round_)
            # the swap is the atomic publish: readers copy the active
            # buffer under this same lock, so none can be mid-copy of the
            # buffer just written, and none can observe the swap mid-read
            with self._cv:
                g.active = tgt
                g.gen += 1
                g.published_at = time.monotonic()
                g.trace = ((int(trace[0]), int(trace[1]))
                           if trace is not None else None)
                self._cv.notify_all()

    # --------------------------------------------------------------- read
    def read(self, group: str, names: Optional[Sequence[str]] = None, *,
             want_round: int = -1
             ) -> Tuple[int, List[Tuple[str, np.ndarray]]]:
        """Read leaves of ``group``'s current snapshot, all from one
        round.  ``names=None`` reads every leaf (sorted).  ``want_round >=
        0`` pins the round: raises :class:`RoundRolled` (retriable) if the
        table holds a different one.  Returns ``(round, [(name, copy),
        ...])``."""
        with self._mu:
            g = self._groups.get(group)
            if g is None or g.gen == 0:
                raise SnapshotUnavailable(
                    f"no snapshot published for group {group!r} yet")
            idx = g.active
            rnd = g.rounds[idx]
            if want_round >= 0 and rnd != want_round:
                raise RoundRolled(group, want_round, rnd)
            buf = g.buffers[idx]
            if names is None:
                picked = sorted(buf)
            else:
                missing = [n for n in names if n not in buf]
                if missing:
                    raise SnapshotUnavailable(
                        f"group {group!r} round {rnd} has no leaf "
                        f"{missing[0]!r} (has {sorted(buf)})")
                picked = list(names)
            # the copies happen under the lock: that is the torn-read
            # guarantee (the publisher's swap waits for us)
            out = [(n, buf[n].copy()) for n in picked]
        return rnd, out

    # --------------------------------------------------------- bookkeeping
    def current_round(self, group: str) -> int:
        """Latest published round of ``group`` (-1 = never published)."""
        with self._mu:
            g = self._groups.get(group)
            return g.rounds[g.active] if g is not None and g.gen else -1

    def generation(self, group: str) -> int:
        """Publish count of ``group`` (0 = never published)."""
        with self._mu:
            g = self._groups.get(group)
            return g.gen if g is not None else 0

    def wait_newer(self, group: str, gen: int,
                   timeout_s: Optional[float] = None) -> Optional[int]:
        """Block until ``group``'s generation differs from ``gen``: it
        exceeds it (new publishes), or sits below it, which means the
        group was dropped and re-created with a fresh counter (everything
        the revived group holds is newer than anything the caller
        consumed, so a sender parked on the old high generation must wake
        rather than starve).  Returns the current generation, or None on
        timeout."""
        def newer() -> bool:
            g = self._groups.get(group)
            return g is not None and g.gen != gen and g.gen > 0

        with self._cv:
            if not self._cv.wait_for(newer, timeout=timeout_s):
                return None
            return self._groups[group].gen

    def trace_ctx(self, group: str) -> Optional[Tuple[int, int]]:
        """The ``(trace_id, span_id)`` the latest publish of ``group``
        carried (None when the publisher was untraced): what a push
        sender parents its push span to."""
        with self._mu:
            g = self._groups.get(group)
            return g.trace if g is not None else None

    def groups(self) -> List[str]:
        with self._mu:
            return sorted(g for g, st in self._groups.items() if st.gen)

    def drop_group(self, group: str) -> bool:
        """Remove a group (job teardown, relay eviction); returns whether
        it existed.  Unblocks nothing: waiters time out on their own
        keepalive cadence."""
        with self._mu:
            return self._groups.pop(group, None) is not None

    def drop(self, group: str) -> None:
        """The original spelling of :meth:`drop_group` (the run teardown
        paths call it)."""
        self.drop_group(group)

    def sweep_idle(self, ttl_s: float, *,
                   now: Optional[float] = None) -> List[str]:
        """Drop every group idle for more than ``ttl_s`` seconds (no
        publish since; never-published groups age from creation) and
        return their names: what keeps a long-lived process (a relay
        whose upstream groups churn) from accumulating dead groups."""
        ttl = float(ttl_s)
        t = time.monotonic() if now is None else float(now)
        with self._mu:
            idle = [name for name, g in self._groups.items()
                    if t - (g.published_at or g.created_at) > ttl]
            for name in idle:
                del self._groups[name]
        return sorted(idle)


# one process-global table, like the window table: any WindowServer in the
# process serves what any loop in the process publishes
_TABLE = SnapshotTable()


def table() -> SnapshotTable:
    """The process-global snapshot table."""
    return _TABLE

"""Peer-fault tolerance primitives: health states, bounded backoff.

The port's copy of ``bluefog_tpu/runtime/resilience.py``: the vocabulary
the host runtime uses to survive a peer's failure in place.

- :class:`Backoff` — exponential backoff with deterministic (seedable)
  jitter and a mandatory retry budget or deadline.  Every reconnect /
  restart loop iterates one of these, so no retry loop hammers shared
  resources (checkpoint store, window-server ports) forever.
- :class:`PeerHealth` — the per-peer state machine
  ``HEALTHY -> SUSPECT -> DEAD -> REJOINED -> HEALTHY`` fed by transport
  evidence (acks, heartbeat replies, connect failures).  One instance
  per :class:`~bluefog_tpu_torch.runtime.window_server.DepositStream`;
  every transition is kept in :attr:`PeerHealth.transitions`.
- :class:`HealthBoard` — the same state machine for N co-located rank
  threads (:func:`~bluefog_tpu_torch.runtime.async_windows.
  run_async_dsgd`): ranks beat it once per round; a rank whose thread
  died (or stalls) stops beating and the survivors observe SUSPECT/DEAD
  by silence, exactly as a remote peer's ack silence reads.
- :class:`ResilienceConfig` — the one knob bag the async runners accept
  (``resilience=``): detection deadlines, reconnect budget, heartbeat
  interval.

The state machine, plainly::

            ok/beat                 silence > suspect_after_s
   HEALTHY <-------- SUSPECT  <--------------------- HEALTHY
      ^                 |  silence > dead_after_s
      | admit()         v  (or reconnect budget exhausted)
   REJOINED <-------- DEAD
            ok/beat

   LEFT  --------> JOINING --------> HEALTHY      (elastic membership)
       mark_joining()        admit()
   HEALTHY/SUSPECT -----------------> LEFT        (graceful drain)
                      mark_left()

A DEAD peer is healed out of the gossip (mixing weights re-normalized
over the survivors — :func:`bluefog_tpu_torch.topology.graphs.heal`); a
beat from a DEAD peer moves it to REJOINED, and the gossip loop
re-admits it at the next round boundary (``admit()`` completes the
cycle back to HEALTHY).  A slot that has not joined yet, or whose peer
drained gracefully, is LEFT (inert, never promoted by silence); a join
announcement moves it to JOINING, and the same round-boundary
``admit()`` completes admission.  A leaver's push-sum mass was handed
off to its out-neighbors, not written off, so the audit treats LEFT and
DEAD terminally differently.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

from bluefog_tpu_torch.blackbox import recorder as _bb
from bluefog_tpu_torch.metrics import comm as _mt
from bluefog_tpu_torch.utils import lockcheck as _lc

__all__ = [
    "HEALTHY",
    "SUSPECT",
    "DEAD",
    "REJOINED",
    "JOINING",
    "LEFT",
    "STATE_NAMES",
    "Backoff",
    "BudgetExhausted",
    "read_backoff",
    "PeerHealth",
    "HealthBoard",
    "ResilienceConfig",
]

# peer-health states
HEALTHY = 0
SUSPECT = 1
DEAD = 2
REJOINED = 3
# elastic membership (intentional change, the complement of failure):
# JOINING — a NEW peer announced itself and is warm-starting; like
# REJOINED it is sticky until the gossip loop's admit() at a round
# boundary (weights change between rounds, never inside one).  LEFT — a
# peer drained gracefully (mass handed off, not written off) or has not
# joined yet; sticky until a new join announcement.
JOINING = 4
LEFT = 5

STATE_NAMES = {HEALTHY: "healthy", SUSPECT: "suspect", DEAD: "dead",
               REJOINED: "rejoined", JOINING: "joining", LEFT: "left"}

# flight-recorder event of each transition into a state (HEALTHY's
# depends on where it came from; see PeerHealth._set)
_STATE_EVENT = {SUSPECT: "peer_suspect", DEAD: "peer_dead",
                REJOINED: "peer_rejoin", JOINING: "peer_join",
                LEFT: "peer_leave"}


class BudgetExhausted(RuntimeError):
    """A :class:`Backoff`'s retry budget (or deadline) ran out."""


def read_backoff(overrides=None) -> "Backoff":
    """The READ path's standard bounded retry schedule — one source of
    truth for the sync window client, the snapshot client, and the
    subscriber (all pure-read retries, so the same posture fits):
    0.05 s base doubling to a 1 s cap, ±50 % jitter, budget 6.
    ``overrides`` is a dict of :class:`Backoff` kwargs (what callers
    accept as their ``retry=``/``reconnect=`` knobs)."""
    return Backoff(**{**dict(base_s=0.05, cap_s=1.0, factor=2.0,
                             jitter=0.5, budget=6),
                      **(overrides or {})})


class Backoff:
    """Exponential backoff with jitter and a mandatory bound.

    Iterating yields the delay (seconds) to sleep before the NEXT
    attempt: ``base_s * factor**k``, capped at ``cap_s``, with uniform
    jitter of ``±jitter`` relative (a ``jitter`` of 0.5 scatters each
    delay over ``[0.5d, 1.5d]``).  Jitter is drawn from a private
    ``random.Random(seed)`` so a seeded schedule is exactly reproducible
    — the schedule tests rely on this.

    The bound is NOT optional: pass ``budget`` (max attempts) and/or
    ``deadline_s`` (wall-clock cap measured from the first ``next_delay``)
    — both default to sane values rather than to "forever".  Exhaustion
    raises :class:`BudgetExhausted` (iteration just stops), which is the
    caller's cue to declare the peer DEAD instead of retrying into the
    void.
    """

    def __init__(self, *, base_s: float = 0.05, cap_s: float = 2.0,
                 factor: float = 2.0, jitter: float = 0.5,
                 budget: Optional[int] = 8,
                 deadline_s: Optional[float] = None,
                 seed: Optional[int] = None):
        if budget is None and deadline_s is None:
            raise ValueError(
                "Backoff requires a bound: pass budget= and/or deadline_s= "
                "(an unbounded retry loop hammers its target forever)")
        if budget is not None and budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.factor = float(factor)
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self.budget = budget
        self.deadline_s = deadline_s
        self._rng = random.Random(seed)
        self.attempts = 0
        self._t0: Optional[float] = None

    def max_total_s(self) -> float:
        """Worst-case total sleep across the whole budget — the
        *configured detection deadline* a caller can quote (budget-bound
        form only; with a deadline the deadline itself is the answer)."""
        if self.budget is None:
            return float(self.deadline_s)  # type: ignore[arg-type]
        total = 0.0
        for k in range(self.budget):
            d = min(self.base_s * (self.factor ** k), self.cap_s)
            total += d * (1.0 + self.jitter)
        if self.deadline_s is not None:
            total = min(total, self.deadline_s)
        return total

    def next_delay(self) -> float:
        """The next delay to sleep, or raise :class:`BudgetExhausted`."""
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        if self.budget is not None and self.attempts >= self.budget:
            raise BudgetExhausted(
                f"retry budget of {self.budget} attempt(s) exhausted")
        if self.deadline_s is not None and now - self._t0 > self.deadline_s:
            raise BudgetExhausted(
                f"retry deadline of {self.deadline_s}s exhausted after "
                f"{self.attempts} attempt(s)")
        d = min(self.base_s * (self.factor ** self.attempts), self.cap_s)
        if self.jitter:
            d *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        self.attempts += 1
        return d

    def __iter__(self) -> Iterator[float]:
        while True:
            try:
                yield self.next_delay()
            except BudgetExhausted:
                return


class _HealthCore:
    """Shared transition bookkeeping for :class:`PeerHealth` /
    :class:`HealthBoard` entries: keeps a short transition log for
    tests and forensics.  ``fields`` of a transition are accepted for the
    reference's signatures and not recorded."""

    def __init__(self, label: str, suspect_after_s: float,
                 dead_after_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.label = label
        self.suspect_after_s = float(suspect_after_s)
        self.dead_after_s = float(dead_after_s)
        self._clock = clock
        self.state = HEALTHY
        self.last_ok = clock()
        self.transitions: List[Tuple[float, int, int]] = []  # (t, old, new)

    def _set(self, new: int, **fields) -> None:
        if new == self.state:
            return
        old = self.state
        self.state = new
        self.transitions.append((self._clock(), old, new))
        del self.transitions[:-64]  # bounded forensics, newest kept
        ev = _STATE_EVENT.get(new)
        if ev is None and new == HEALTHY:
            if old in (DEAD, REJOINED):
                ev = "peer_rejoin"
            elif old == SUSPECT:
                ev = "peer_recovered"
        if ev is not None:
            _bb.record(ev, peer=self.label, from_state=STATE_NAMES[old],
                       to_state=STATE_NAMES[new], **fields)
        _mt.set("bf_peer_state", float(new), peer=self.label)

    # ------------------------------------------------------------ evidence
    def note_ok(self) -> int:
        """Positive evidence (ack, heartbeat reply, beat) arrived."""
        self.last_ok = self._clock()
        if self.state == DEAD:
            self._set(REJOINED)
        elif self.state == SUSPECT:
            # SUSPECT -> HEALTHY recovery is a rejoin in the loose sense
            # (the peer answered again) but keeps its gossip weights, so
            # it maps back to HEALTHY directly
            self._set(HEALTHY, recovered_from="suspect")
        return self.state

    def poll(self, now: Optional[float] = None) -> int:
        """Time-based evaluation: silence promotes HEALTHY -> SUSPECT ->
        DEAD.  REJOINED and JOINING are sticky until :meth:`admit` (the
        gossip loop re-admits at a round boundary, not mid-round); LEFT
        is sticky until a new join announcement — an absent peer is not
        a silent one."""
        if self.state in (DEAD, REJOINED, JOINING, LEFT):
            return self.state
        now = self._clock() if now is None else now
        silent = now - self.last_ok
        if silent >= self.dead_after_s:
            self._set(DEAD, silent_s=round(silent, 3))
        elif silent >= self.suspect_after_s:
            self._set(SUSPECT, silent_s=round(silent, 3))
        return self.state

    def mark_dead(self, reason: str = "") -> None:
        """Hard evidence (reconnect budget exhausted, process reaped)."""
        self._set(DEAD, reason=reason)

    def mark_joining(self, **fields) -> None:
        """A join announcement arrived (membership record / first HELLO
        of a new peer): the slot enters the admission pipeline.  Sticky
        until the gossip loop's :meth:`admit` at a round boundary."""
        self.last_ok = self._clock()
        self._set(JOINING, **fields)

    def mark_left(self, **fields) -> None:
        """The peer drained gracefully (or the slot has not joined yet).
        Terminal-but-revivable: unlike DEAD, a LEFT peer's push-sum mass
        was handed off, not written off, and a later join announcement
        (:meth:`mark_joining`) revives the slot."""
        self._set(LEFT, **fields)

    def admit(self) -> None:
        """Complete a REJOINED/JOINING peer's cycle to HEALTHY (called
        by the gossip loop at the round boundary where it restores the
        peer's mixing weights)."""
        self.last_ok = self._clock()
        if self.state in (REJOINED, JOINING, DEAD, SUSPECT):
            self._set(HEALTHY, admitted=True)


class PeerHealth(_HealthCore):
    """Health of ONE remote peer, fed by its transport: every batch ack
    and heartbeat reply is :meth:`note_ok`; connect failures are
    :meth:`note_failure`; the stream's idle waits call :meth:`poll`."""

    def __init__(self, peer: str, *, suspect_after_s: float = 2.0,
                 dead_after_s: float = 20.0,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(peer, suspect_after_s, dead_after_s, clock)
        self.failures = 0

    def note_failure(self) -> int:
        """A connect/send attempt failed.  Failures do not mark DEAD by
        themselves (that is the reconnect budget's call) but promote
        HEALTHY straight to SUSPECT — an RST is stronger evidence than
        silence."""
        self.failures += 1
        if self.state == HEALTHY:
            self._set(SUSPECT, failures=self.failures)
        return self.state


class HealthBoard:
    """Shared health table for N co-located rank threads.

    Each rank calls :meth:`beat` once per gossip round; any rank may ask
    :meth:`poll` / :meth:`dead_ranks` about the others.  Detection is by
    *silence*, exactly like the wire path: a killed thread simply
    stops beating.  Thread-safe (one lock, O(1) per beat)."""

    def __init__(self, n_ranks: int, *, suspect_after_s: float = 0.5,
                 dead_after_s: float = 1.5,
                 clock: Callable[[], float] = time.monotonic,
                 members: Optional[Set[int]] = None):
        """``members`` (elastic runs) names the slots that participate
        from the start; the rest begin LEFT — capacity reserved for
        later joiners, never promoted to SUSPECT/DEAD by their silence.
        Default: every slot is a member (the fixed-fleet behavior)."""
        self._mu = _lc.lock("runtime.resilience.HealthBoard._mu")
        self._cores = [
            _HealthCore(f"rank{r}", suspect_after_s, dead_after_s, clock)
            for r in range(n_ranks)
        ]
        if members is not None:
            absent = set(range(n_ranks)) - {int(r) for r in members}
            for r in absent:
                self._cores[r].state = LEFT  # initial, not a transition

    def beat(self, rank: int) -> None:
        with self._mu:
            self._cores[rank].note_ok()

    def poll(self, rank: int) -> int:
        with self._mu:
            return self._cores[rank].poll()

    def state(self, rank: int) -> int:
        with self._mu:
            return self._cores[rank].state

    def states(self) -> Dict[int, int]:
        """One consistent snapshot of every slot's state under a single
        lock acquisition (N ``state()`` calls would each see a different
        instant)."""
        with self._mu:
            return {r: c.state for r, c in enumerate(self._cores)}

    def dead_ranks(self) -> Set[int]:
        """Ranks currently DEAD (REJOINED ranks are NOT in this set —
        the healer re-admits them)."""
        with self._mu:
            return {r for r, c in enumerate(self._cores)
                    if c.poll() == DEAD}

    def rejoined_ranks(self) -> Set[int]:
        with self._mu:
            return {r for r, c in enumerate(self._cores)
                    if c.state == REJOINED}

    def joining_ranks(self) -> Set[int]:
        with self._mu:
            return {r for r, c in enumerate(self._cores)
                    if c.state == JOINING}

    def left_ranks(self) -> Set[int]:
        with self._mu:
            return {r for r, c in enumerate(self._cores)
                    if c.state == LEFT}

    def admit(self, rank: int) -> None:
        with self._mu:
            self._cores[rank].admit()

    def mark_dead(self, rank: int, reason: str = "") -> None:
        with self._mu:
            self._cores[rank].mark_dead(reason)

    def mark_joining(self, rank: int) -> None:
        with self._mu:
            self._cores[rank].mark_joining()

    def mark_left(self, rank: int) -> None:
        with self._mu:
            self._cores[rank].mark_left()

    def transitions(self, rank: int) -> List[Tuple[float, int, int]]:
        with self._mu:
            return list(self._cores[rank].transitions)


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs for the fault-tolerant async runners (``resilience=``).

    ``None`` (the default everywhere) keeps the pre-resilience behavior:
    any peer failure is fatal to the run, exactly as before.

    Detection deadline: a SIGKILLed peer is declared DEAD after at most
    ``suspect``/``dead`` thresholds (thread mode, silence-based) or the
    reconnect budget's worst-case total sleep (wire mode) —
    :meth:`detection_deadline_s` quotes the configured bound."""

    # silence thresholds (thread-mode board AND wire-mode peer health)
    suspect_after_s: float = 0.5
    dead_after_s: float = 2.0
    # wire-mode reconnect policy (DepositStream)
    reconnect_base_s: float = 0.05
    reconnect_cap_s: float = 0.5
    reconnect_factor: float = 2.0
    reconnect_budget: int = 5
    reconnect_jitter: float = 0.5
    # lightweight peer-heartbeat wire op, ON by default (0 disables).
    # Health evidence otherwise comes only from deposit acks — and the
    # resilient dsgd loop WITHHOLDS deposits to a SUSPECT peer, so
    # without heartbeats suspicion could never clear and would escalate
    # a healthy-but-briefly-silent peer to DEAD.  An idle stream must be
    # able to prove the peer alive on its own.
    heartbeat_interval_s: float = 0.25
    # how long survivors wait at a rendezvous before treating the missing
    # ranks as dead (FileBarrier exclusion learning)
    barrier_timeout_s: float = 20.0
    # deterministic jitter for tests
    seed: Optional[int] = None

    def backoff_kwargs(self) -> dict:
        return dict(base_s=self.reconnect_base_s,
                    cap_s=self.reconnect_cap_s,
                    factor=self.reconnect_factor,
                    budget=self.reconnect_budget,
                    jitter=self.reconnect_jitter,
                    seed=self.seed)

    def detection_deadline_s(self) -> float:
        """The configured worst-case time to declare a dead peer DEAD."""
        wire = Backoff(**self.backoff_kwargs()).max_total_s()
        return max(self.dead_after_s, wire)

"""The chaos injector: trigger evaluation and fault execution.

Counterpart of ``bluefog_tpu/chaos/injector.py``.  Spec parsing lives in
:mod:`bluefog_tpu_torch.chaos.spec` (the one grammar); this module
re-exports ``Rule``, ``parse_spec`` and ``ChaosSpecError``.  Design notes:

- **Cheap when off.**  ``fire()`` is one module-level call with a None
  check; the environment variable is read once and cached
  (``configure``/``reset`` invalidate), so an instrumented hot path (one
  check per wire frame) costs nothing in production.
- **Deterministic.**  Triggers are per-rule counters over the traffic the
  site actually sees (``after_frames``/``every``), and ``prob``/``rate``
  draw from ``random.Random((seed << 8) ^ rule_index)``, the JAX
  package's seeding: the same traffic gives the same injection sequence
  in both packages.
- **Faults are executed where they are honest.**  Socket rules only
  return an action; the transport shim applies it (closing its socket,
  sleeping on its thread).  Process rules deliver real signals to the
  current process: a SIGKILLed rank dies as an OOM-killed one would.
  ``sigstop`` with ``for_s`` starts a detached helper child that sleeps
  and sends SIGCONT to the parent (a stopped process cannot resume
  itself).
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from bluefog_tpu_torch.chaos.spec import (ChaosSpecError, Rule, parse_spec)

__all__ = [
    "ChaosKill",
    "ChaosLeave",
    "ChaosSpecError",
    "Injector",
    "Rule",
    "arm",
    "check_step",
    "configure",
    "enabled",
    "fire",
    "get",
    "join_times",
    "parse_spec",
    "reset",
]

_ENV = "BLUEFOG_TPU_CHAOS"


class ChaosKill(Exception):
    """Raised by a ``die`` rule inside a rank loop — the thread-model
    analog of SIGKILL.  The resilient runners treat the raising thread
    as dead (no drain, no final publish); anything else propagating it
    is a test-harness bug, so it is a plain ``Exception``."""

    def __init__(self, rank: int, step: Optional[int] = None):
        super().__init__(f"chaos killed rank {rank} at step {step}")
        self.rank = rank
        self.step = step


class ChaosLeave(Exception):
    """Raised by a ``leave`` rule inside a rank loop — a *graceful drain*
    request, the membership-churn twin of :class:`ChaosKill`.  The
    elastic runners catch it and perform the full leave protocol (fence,
    hand push-sum mass to the out-neighbors, write the ``left`` record)
    instead of treating the rank as a corpse; anything else propagating
    it is a harness bug, so it is a plain ``Exception``."""

    def __init__(self, rank: int, step: Optional[int] = None):
        super().__init__(f"chaos drained rank {rank} at step {step}")
        self.rank = rank
        self.step = step


class Injector:
    """Evaluates the parsed rules against the traffic.  Thread-safe: the
    shims call in from server daemon threads, stream sender threads, and
    rank loops concurrently."""

    def __init__(self, spec: str):
        self.spec = spec
        self.rules = parse_spec(spec)
        self._mu = threading.Lock()
        self._counters: Dict[int, int] = {i: 0 for i in range(len(self.rules))}
        self._fired: Dict[int, int] = {i: 0 for i in range(len(self.rules))}
        self._rngs = [random.Random((r.seed << 8) ^ i)
                      for i, r in enumerate(self.rules)]
        self._armed: set = set()
        self._timers: List[threading.Timer] = []

    # ------------------------------------------------------------ triggers
    def _record(self, rule: Rule, idx: int, **ctx) -> None:
        # the flight-recorder event and the injection counter of the JAX
        # package are ROADMAP item 11a-iii
        self._fired[idx] += 1

    def fire(self, site: str, **ctx) -> Optional[Tuple]:
        """Socket shim entry: count this frame for every matching rule
        and return the first triggered action —
        ``('drop',) | ('truncate',) | ('delay', s) | ('stall', s)`` —
        or None.  Called per wire frame; must stay cheap."""
        action: Optional[Tuple] = None
        with self._mu:
            for i, r in enumerate(self.rules):
                # rank rules never match here: fire() sites are the
                # socket shims, and 'any' is defined as any SOCKET site
                if r.site != site and r.site != "any":
                    continue
                self._counters[i] += 1
                if action is not None:
                    continue  # keep counting other rules
                mx = r.max_fires()
                if mx and self._fired[i] >= mx:
                    continue
                hit = True
                if r.after_frames is not None:
                    hit = self._counters[i] == r.after_frames
                elif r.every is not None:
                    hit = self._counters[i] % max(r.every, 1) == 0
                elif r.prob is not None:
                    hit = self._rngs[i].random() < r.prob
                elif r.rate is not None:
                    # lossy link: an independent seeded coin per frame
                    hit = self._rngs[i].random() < r.rate
                if not hit:
                    continue
                self._record(r, i, **ctx)
                if r.fault == "drop":
                    action = ("drop",)
                elif r.fault == "truncate":
                    action = ("truncate",)
                elif r.fault == "delay":
                    action = ("delay", r.ms / 1000.0)
                else:  # stall
                    action = ("stall", r.s)
        return action

    # ------------------------------------------------------- process faults
    def _execute_rank_fault(self, rule: Rule, idx: int, rank: int,
                            step: Optional[int]) -> None:
        self._record(rule, idx, rank=rank, step=step if step is not None
                     else -1)
        if rule.fault == "die":
            raise ChaosKill(rank, step)
        if rule.fault == "leave":
            raise ChaosLeave(rank, step)
        if rule.fault == "stall":
            time.sleep(rule.s if rule.s > 0 else (rule.for_s or 0.0))
            return
        if rule.fault == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
            return  # unreachable
        if rule.fault == "sigstop":
            if rule.for_s:
                # a stopped process cannot SIGCONT itself: detach a tiny
                # helper that sleeps through the freeze and thaws us
                subprocess.Popen(
                    [sys.executable, "-c",
                     "import time,os,signal,sys;"
                     "time.sleep(float(sys.argv[1]));"
                     "os.kill(int(sys.argv[2]), signal.SIGCONT)",
                     str(rule.for_s), str(os.getpid())],
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            os.kill(os.getpid(), signal.SIGSTOP)

    def check_step(self, rank: int, step: int) -> None:
        """Rank-loop hook: execute any matured ``at_step`` fault for this
        rank.  ``die`` raises :class:`ChaosKill`; ``stall`` sleeps here;
        signals are delivered to the current process."""
        todo: List[Tuple[Rule, int]] = []
        with self._mu:
            for i, r in enumerate(self.rules):
                if r.site != "rank" or r.rank != rank or r.at_step is None:
                    continue
                mx = r.max_fires()
                if mx and self._fired[i] >= mx:
                    continue
                if step >= r.at_step:
                    todo.append((r, i))
        for r, i in todo:
            self._execute_rank_fault(r, i, rank, step)

    def arm(self, rank: int) -> None:
        """Arm wall-clock (``after_s``) faults for this rank.  Idempotent
        per rank; timers are daemon threads, so an armed fault cannot
        keep a finished process alive."""
        with self._mu:
            if rank in self._armed:
                return
            self._armed.add(rank)
            rules = [(r, i) for i, r in enumerate(self.rules)
                     if r.site == "rank" and r.rank == rank
                     and r.after_s is not None and r.fault != "join"]
        for r, i in rules:
            t = threading.Timer(
                r.after_s, self._execute_rank_fault, args=(r, i, rank, None))
            t.daemon = True
            t.start()
            with self._mu:
                self._timers.append(t)

    def join_times(self, rank: int) -> List[float]:
        """The ``after_s`` offsets of this rank's ``join`` rules, sorted —
        the elastic runners consult this ONCE at startup to schedule when
        the rank attaches (a flapping joiner is two+ join rules
        interleaved with leave rules).  Each call marks the rules fired,
        so the schedule is consumed exactly once per run."""
        out: List[float] = []
        with self._mu:
            for i, r in enumerate(self.rules):
                if (r.site == "rank" and r.rank == rank
                        and r.fault == "join" and r.after_s is not None):
                    mx = r.max_fires()
                    if mx and self._fired[i] >= mx:
                        continue
                    out.append(float(r.after_s))
                    self._record(r, i, rank=rank, step=-1)
        return sorted(out)

    def cancel(self) -> None:
        with self._mu:
            timers = list(self._timers)
            self._timers.clear()
        for t in timers:
            t.cancel()

    def stats(self) -> Dict[int, Tuple[int, int]]:
        """rule index -> (frames counted, times fired)."""
        with self._mu:
            return {i: (self._counters[i], self._fired[i])
                    for i in range(len(self.rules))}


# ---------------------------------------------------------------------------
# Process-global state (read lazily from the environment)
# ---------------------------------------------------------------------------

_injector: Optional[Injector] = None
_resolved = False
_state_mu = threading.Lock()


def configure(spec: Optional[str]) -> Optional[Injector]:
    """Install an injector from ``spec`` (None disables chaos and stops
    consulting the env until :func:`reset`)."""
    global _injector, _resolved
    with _state_mu:
        if _injector is not None:
            _injector.cancel()
        _injector = Injector(spec) if spec else None
        _resolved = True
        return _injector


def reset() -> None:
    """Drop any configured injector and re-read the env next time."""
    global _injector, _resolved
    with _state_mu:
        if _injector is not None:
            _injector.cancel()
        _injector = None
        _resolved = False


def get() -> Optional[Injector]:
    global _injector, _resolved
    if _resolved:
        return _injector
    with _state_mu:
        if not _resolved:
            spec = os.environ.get(_ENV, "").strip()
            _injector = Injector(spec) if spec else None
            _resolved = True
    return _injector


def enabled() -> bool:
    return get() is not None


def fire(site: str, **ctx) -> Optional[Tuple]:
    """Module-level socket shim (no-op unless chaos is configured)."""
    inj = get()
    return None if inj is None else inj.fire(site, **ctx)


def check_step(rank: int, step: int) -> None:
    """Module-level rank-loop shim (no-op unless chaos is configured)."""
    inj = get()
    if inj is not None:
        inj.check_step(rank, step)


def arm(rank: int) -> None:
    """Arm wall-clock process faults for this rank (no-op when off)."""
    inj = get()
    if inj is not None:
        inj.arm(rank)


def join_times(rank: int) -> List[float]:
    """This rank's scheduled join offsets (empty when chaos is off)."""
    inj = get()
    return [] if inj is None else inj.join_times(rank)

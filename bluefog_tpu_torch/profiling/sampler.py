"""In-process sampling profiler.

Counterpart of ``bluefog_tpu/profiling/sampler.py``.  Tracing names the
slow edge of a round; this module names the slow code.  A daemon thread
walks ``sys._current_frames()`` at a configurable rate (97 Hz by
default: prime, so the sampler does not phase-lock to loops with a
decimal cadence) and folds each thread's stack into a
``frame;frame;frame`` string, tagging every sample with the sampled
thread's current tracing context (innermost span name and round, read
lock-free from :func:`bluefog_tpu_torch.tracing.recorder.active_phases`,
the cross-thread mirror of the thread-local span stack).  Span names map
onto the ``{compute, gossip, publish, net-wait}`` phases the trace
analyzer names, so ``python -m bluefog_tpu_torch.profiling`` can say
which frames the gating edge's wall-clock went to.

Recording is off by default: no thread, and no import beyond this module
and the lock factories.  ``BLUEFOG_TPU_PROFILE=<dir>`` (read lazily; the
JAX package reads the same variable) or :func:`configure` arms it;
``BLUEFOG_TPU_PROFILE_HZ`` overrides the rate.  Samples aggregate in
dicts the sampler thread owns and land in ``profile-rank<k>.jsonl``
(``profile-pid<p>.jsonl`` for a rank-less process) as one record a
flush window, in the JAX package's format; a bounded deque also keeps
the last ~30 s of samples (:func:`recent_folded`).

The per-sample path, from ``sys._current_frames`` to the aggregation
dict, never acquires a package lock, performs IO, serialises JSON or
sleeps: the sampler samples threads that may hold any package lock, so
one acquire there is a latent deadlock against every lock in the
package.  All IO happens on the sampler thread between ticks (the
periodic flush), and cross-thread reads (``snapshot``,
``recent_folded``) rely on GIL-atomic dict and deque operations.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import sys
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

from bluefog_tpu_torch.utils import lockcheck as _lc

__all__ = [
    "PHASES",
    "Profiler",
    "configure",
    "enabled",
    "flush",
    "get",
    "phase_for_span",
    "reset",
    "set_rank",
]

#: the phase vocabulary — the trace analyzer's round decomposition plus
#: the wire-side wait states, collapsed to what a frame budget needs
PHASES = ("compute", "gossip", "publish", "net-wait")

#: span name -> phase.  Client + server tracing span names (see
#: tracing/analyze.py CLIENT_PHASES/SERVER_PHASES) and the dsgd loop's
#: own phase spans; anything unknown attributes to "other".
_SPAN_PHASE = {
    "compute": "compute",
    "round": "compute",
    "gossip": "gossip",
    "consume": "gossip",
    "apply": "gossip",
    "mix": "gossip",
    "snapshot": "gossip",
    "publish": "publish",
    "snapshot_publish": "publish",
    "fleet": "publish",
    "control": "publish",
    "wire": "net-wait",
    "ack_wait": "net-wait",
    "ack": "net-wait",
    "flush": "net-wait",
    "recv": "net-wait",
    "queue_wait": "net-wait",
    "enqueue": "net-wait",
    "coalesce": "net-wait",
}

#: frames deeper than this are truncated (the root side is kept)
_MAX_DEPTH = 64
#: recent-sample ring: ~30 s at the default rate, bounded regardless
_RECENT_MAXLEN = 4096
#: seconds of samples the recent window holds
RECENT_WINDOW_S = 30.0


def phase_for_span(name: Optional[str]) -> str:
    """Map a tracing span name to its profile phase ("other" when no
    span is open or the name is unknown)."""
    if name is None:
        return "other"
    return _SPAN_PHASE.get(name, "other")


def _default_hz() -> float:
    try:
        return float(os.environ.get("BLUEFOG_TPU_PROFILE_HZ", "") or 97.0)
    except ValueError:
        return 97.0


class Profiler:
    """One process's sampling profiler: sampler thread + JSONL writer.

    ``start()`` spawns the daemon sampler; ``stop()`` joins it after a
    final flush.  Aggregation dicts are owned by the sampler thread;
    every cross-thread read path uses GIL-atomic snapshots (``dict``
    swap, ``deque`` iteration), never a lock — see the module docstring
    for why.
    """

    #: sampler thread name — tests and the disabled-path bench key on it
    THREAD_NAME = "bf-prof-sampler"

    def __init__(self, directory: str, rank: Optional[int] = None,
                 hz: Optional[float] = None):
        self.directory = directory
        self.rank = rank
        self.hz = float(hz) if hz else _default_hz()
        if self.hz <= 0 or self.hz > 1000:
            raise ValueError(f"sampling rate must be in (0, 1000] Hz, "
                             f"got {self.hz}")
        self.samples = 0
        self.windows_flushed = 0
        self.dropped = 0
        # sampler-thread-owned aggregation: (phase, folded) -> count,
        # swapped out wholesale at flush time (GIL-atomic)
        self._agg: Dict[Tuple[str, str], int] = {}
        self._agg_round: Dict[str, int] = {}  # phase -> samples
        # last ~30 s of (wall_t, folded, phase, round): a bounded
        # deque, appends are GIL-atomic
        self._recent: Deque[Tuple[float, str, str, Optional[int]]] = \
            collections.deque(maxlen=_RECENT_MAXLEN)
        # code object -> "pkg/file.py:func" label (bounded by the
        # process's live code objects; grows once per function, not per
        # sample)
        self._labels: Dict[object, str] = {}
        self._stop = threading.Event()
        # serializes flush windows only (sampler-thread periodic flush
        # vs an explicit cross-thread flush()/stop()); NEVER touched on
        # the per-sample path
        self._io_lock = _lc.lock("profiling.sampler.Profiler._io_lock")
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.time()
        self._last_flush = self._t0
        self._flush_every_s = 1.0
        self._wrote_meta = False

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Profiler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name=self.THREAD_NAME, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop sampling and flush the tail window; idempotent."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        self._flush_window(final=True)

    # ------------------------------------------------------------- sampling
    def _run(self) -> None:
        # resolved ONCE, outside the tick loop: even a cached import
        # statement is sys.modules machinery the per-sample path must
        # not pay (or depend on — the import lock is a lock)
        from bluefog_tpu_torch.tracing.recorder import active_phases

        period = 1.0 / self.hz
        own = threading.get_ident()
        phases = active_phases()  # the live dict, read lock-free
        while not self._stop.wait(period):
            self._sample_once(own, phases)
            now = time.time()
            if now - self._last_flush >= self._flush_every_s:
                # IO strictly BETWEEN ticks, never on the sample path
                self._flush_window()

    def _sample_once(self, own_ident: int, phases: Dict) -> None:
        """Walk every thread's stack once.  The hot path: no locks, no
        IO, no JSON, no sleeps."""
        now = time.time()
        agg = self._agg
        agg_round = self._agg_round
        recent = self._recent
        labels = self._labels
        n = 0
        for ident, frame in sys._current_frames().items():
            if ident == own_ident:
                continue
            parts: List[str] = []
            depth = 0
            f = frame
            while f is not None and depth < _MAX_DEPTH:
                code = f.f_code
                lbl = labels.get(code)
                if lbl is None:
                    fn = code.co_filename
                    sep = fn.rfind(os.sep, 0, fn.rfind(os.sep))
                    lbl = f"{fn[sep + 1:]}:{code.co_name}"
                    labels[code] = lbl
                parts.append(lbl)
                f = f.f_back
                depth += 1
            parts.reverse()
            folded = ";".join(parts)
            ctx = phases.get(ident)
            if ctx is None:
                phase, rnd = "other", None
            else:
                phase = _SPAN_PHASE.get(ctx[0], "other")
                rnd = ctx[1]
            key = (phase, folded)
            agg[key] = agg.get(key, 0) + 1
            agg_round[phase] = agg_round.get(phase, 0) + 1
            recent.append((now, folded, phase, rnd))
            n += 1
        self.samples += n

    # ---------------------------------------------------------------- flush
    def _path(self) -> str:
        if self.rank is None:
            return os.path.join(self.directory,
                                f"profile-pid{os.getpid()}.jsonl")
        return os.path.join(self.directory,
                            f"profile-rank{self.rank}.jsonl")

    def _flush_window(self, final: bool = False) -> Optional[str]:
        """Swap the aggregation dicts out (GIL-atomic) and append one
        window record.  Runs on the sampler thread between ticks, or on
        a caller's thread via ``flush()``/``stop()``; the io lock
        serializes the two (it is never taken on the sample path)."""
        with self._io_lock:
            agg, self._agg = self._agg, {}
            phases, self._agg_round = self._agg_round, {}
            t1 = time.time()
            t0, self._last_flush = self._last_flush, t1
            if not agg and not final:
                return None
            rec = {"kind": "window", "t0": round(t0, 3),
                   "t1": round(t1, 3), "rank": self.rank, "hz": self.hz,
                   "samples": sum(agg.values()),
                   "phases": phases,
                   "stacks": [[ph, folded, n]
                              for (ph, folded), n in sorted(agg.items())]}
            try:
                os.makedirs(self.directory, exist_ok=True)
                with open(self._path(), "a") as f:
                    if not self._wrote_meta:
                        f.write(json.dumps(
                            {"kind": "meta", "rank": self.rank,
                             "pid": os.getpid(), "hz": self.hz,
                             "t0": round(self._t0, 3)}) + "\n")
                        self._wrote_meta = True
                    f.write(json.dumps(rec) + "\n")
            except OSError:
                self.dropped += sum(agg.values())
                return None
            self.windows_flushed += 1
            return self._path()

    # ------------------------------------------------------------ snapshots
    def recent_folded(self, seconds: float = RECENT_WINDOW_S) -> dict:
        """The last ``seconds`` of samples as ``{stacks, phases,
        samples}``.  Reads the bounded
        deque with GIL-atomic iteration (a sample landing mid-snapshot
        is either in or out, never torn); newest-first walk with an
        early stop."""
        cutoff = time.time() - float(seconds)
        stacks: Dict[str, int] = {}
        phases: Dict[str, int] = {}
        n = 0
        for t, folded, phase, _rnd in reversed(self._recent):
            if t < cutoff:
                break
            stacks[folded] = stacks.get(folded, 0) + 1
            phases[phase] = phases.get(phase, 0) + 1
            n += 1
        return {"window_s": float(seconds), "samples": n,
                "phases": phases, "stacks": stacks}


# ---------------------------------------------------------------------------
# Process-global profiler (lazy env activation, the tracing discipline)
# ---------------------------------------------------------------------------

_PROFILER: Optional[Profiler] = None
_state_lock = _lc.lock("profiling.sampler._state_lock")
_STOPPED = False
_atexit_armed = False


def enabled() -> bool:
    return get() is not None


def get() -> Optional[Profiler]:
    """The process profiler, or None when profiling is off.  Lazily
    honors ``BLUEFOG_TPU_PROFILE=<dir>``; an explicit :func:`reset`
    sticks."""
    global _PROFILER
    if _PROFILER is None:
        if _STOPPED:
            return None
        d = os.environ.get("BLUEFOG_TPU_PROFILE")
        if not d:
            return None
        with _state_lock:
            if _PROFILER is None and not _STOPPED:
                _configure_locked(d, None, None)
    return _PROFILER


def configure(directory: str, rank: Optional[int] = None,
              hz: Optional[float] = None) -> Profiler:
    """Install and start a profiler with explicit settings (replaces
    the lazy one); also un-sticks a previous :func:`reset`."""
    global _STOPPED
    with _state_lock:
        old = _PROFILER
        _STOPPED = False
        prof = _configure_locked(directory, rank, hz)
    if old is not None:
        old.stop()
    return prof


def _configure_locked(directory, rank, hz) -> Profiler:
    global _PROFILER, _atexit_armed
    from bluefog_tpu_torch.tracing import recorder as _tr

    prof = Profiler(directory, rank=rank, hz=hz)
    # phase-only context tracking: span() maintains the thread->phase
    # map even when tracing itself is off
    _tr.set_phase_tracking(True)
    _PROFILER = prof.start()
    if not _atexit_armed:
        _atexit_armed = True
        atexit.register(reset)
    return _PROFILER


def set_rank(rank: int) -> None:
    """Pin the file identity (the per-process DSGD body calls this);
    must happen before the first flush names the file."""
    prof = get()
    if prof is not None and prof.rank is None:
        prof.rank = int(rank)


def reset() -> None:
    """Stop the sampler and drop the profiler (tests, run teardown);
    sticky against the env var until :func:`configure` runs again."""
    global _PROFILER, _STOPPED
    with _state_lock:
        prof, _PROFILER = _PROFILER, None
        _STOPPED = True
    if prof is not None:
        prof.stop()
        from bluefog_tpu_torch.tracing import recorder as _tr

        _tr.set_phase_tracking(False)


def flush() -> None:
    prof = _PROFILER
    if prof is not None:
        prof._flush_window()

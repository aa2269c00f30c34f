"""Failure detection: the hang watchdog.

Counterpart of ``bluefog_tpu/utils/failure.py``: :class:`HangError`,
:class:`Heartbeat` and the process supervisor :func:`run_supervised`.  A job that hangs without dying (a collective waiting on
a wedged peer, a deadlocked host thread, a stuck IO) raises nothing, so a
watchdog must notice the silence: :class:`Heartbeat` is armed with a
deadline and beaten once per training step; on a missed deadline it logs
every thread's stack, then escalates:

- ``action='raise'``: inject :class:`HangError` into the training thread
  (``PyThreadState_SetAsyncExc``).  This interrupts Python-level hangs
  (polling loops, lock spins) and lets
  :func:`~bluefog_tpu_torch.utils.checkpoint.run_with_restart` recover in
  process from the checkpoint.  A thread blocked inside a C call (a CUDA
  synchronize on a wedged kernel, a gloo collective) runs no bytecode and
  cannot be interrupted this way, so if no beat arrives within ``grace_s``
  the watchdog falls through to
- ``action='exit'`` (or the raise path's escalation): terminate the process
  (SIGTERM, then SIGKILL) so a supervisor restarts it.

:func:`run_supervised` (``bfrun --supervise N``) is the recovery half: it
re-runs a failed script with a bounded backoff, and the script resumes from
its latest checkpoint.  With ``incident_dir`` it keeps each attempt's
flight-recorder dumps (:mod:`bluefog_tpu_torch.blackbox`) apart.

On a missed deadline the watchdog first counts the hang
(``bf_hangs_total{action}``, when metrics are on) and dumps the flight
recorder (reason ``heartbeat_timeout``, with the last-beat step), before
it escalates: once the process is killed or the loop unwinds, the
recorder is gone.
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
import traceback
from typing import Callable, List, Optional, Sequence

from bluefog_tpu_torch import blackbox as _bb
from bluefog_tpu_torch.metrics import comm as _mcomm
from bluefog_tpu_torch.metrics import health as _health

__all__ = ["HangError", "Heartbeat", "run_supervised"]

log = logging.getLogger("bluefog_tpu_torch")


class HangError(RuntimeError):
    """Raised (asynchronously) in the training thread when the heartbeat
    deadline passes; recoverable by ``run_with_restart``."""


def _async_raise(thread_ident: int, exc_type) -> bool:
    res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_ident), ctypes.py_object(exc_type))
    if res > 1:  # "we broke the interpreter": undo
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_ident), None)
    return res == 1


def _dump_stacks() -> str:
    frames = sys._current_frames()
    parts: List[str] = []
    for t in threading.enumerate():
        f = frames.get(t.ident)
        if f is None:
            continue
        parts.append(f"--- thread {t.name} ({t.ident}) ---\n"
                     + "".join(traceback.format_stack(f)))
    return "\n".join(parts)


class Heartbeat:
    """Deadline watchdog over training progress.

    Usage (what ``run_with_restart(heartbeat_timeout_s=...)`` does)::

        with Heartbeat(timeout_s=60) as hb:
            for step in ...:
                train_step(...)
                hb.beat(step)

    On a missed deadline: thread stacks are logged, ``on_hang`` (if given)
    is called, then per ``action``:

    - ``'raise'`` (default): inject :class:`HangError` into the monitored
      thread; if no beat or stop follows within ``grace_s`` (the thread is
      blocked in C), terminate the process so a supervisor can restart it.
    - ``'exit'``: terminate the process at once (SIGTERM, SIGKILL after
      5 s).
    - ``'callback'``: only ``on_hang`` runs (tests, custom policies).
    """

    def __init__(self, timeout_s: float, *, action: str = "raise",
                 grace_s: float = 30.0,
                 on_hang: Optional[Callable[[], None]] = None,
                 thread: Optional[threading.Thread] = None):
        if action not in ("raise", "exit", "callback"):
            raise ValueError(f"unknown action {action!r}")
        self.timeout_s = float(timeout_s)
        self.grace_s = float(grace_s)
        self.action = action
        self.on_hang = on_hang
        self._target = thread or threading.current_thread()
        self._last = time.monotonic()
        self._beats = 0
        self._step = None
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.hangs_detected = 0

    def beat(self, step=None) -> None:
        """Record progress (call once per training step; thread-safe: the
        monitor only compares the float store against the clock)."""
        self._last = time.monotonic()
        self._beats += 1
        self._step = step
        _bb.record("heartbeat_beat", step=step)

    @property
    def beats(self) -> int:
        return self._beats

    def start(self) -> "Heartbeat":
        if self._monitor is not None:
            raise RuntimeError("heartbeat already started")
        self._last = time.monotonic()
        self._stop.clear()
        self._monitor = threading.Thread(
            target=self._run, name="bf-heartbeat", daemon=True)
        self._monitor.start()
        # the heartbeat's age as a callback gauge (read at snapshot time,
        # so a scrape sees staleness grow during a hang, before the
        # watchdog fires); no-op when metrics are off
        _health.watch_heartbeat(self, name=self._target.name)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        _health.unwatch_heartbeat(name=self._target.name)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _run(self) -> None:
        poll = max(self.timeout_s / 4.0, 0.01)
        while not self._stop.wait(poll):
            silent_for = time.monotonic() - self._last
            if silent_for < self.timeout_s:
                continue
            self.hangs_detected += 1
            _mcomm.inc("bf_hangs_total", 1.0, action=self.action)
            _bb.dump("heartbeat_timeout", extra={
                "last_step": self._step,
                "silent_for_s": round(silent_for, 3),
                "beats": self._beats,
                "action": self.action,
            })
            log.error(
                "heartbeat: no progress for %.1fs (last step %r): hang "
                "detected.\n%s", silent_for, self._step, _dump_stacks())
            if self.on_hang is not None:
                try:
                    self.on_hang()
                except Exception as e:  # noqa: BLE001: the watchdog goes on
                    log.error("heartbeat on_hang callback failed: %s", e)
            if self.action == "callback":
                self._last = time.monotonic()  # re-arm
                continue
            if self.action == "raise" and self._target.is_alive():
                beats_before = self._beats
                if time.monotonic() - self._last < self.timeout_s:
                    # a beat landed while the stacks were dumped or on_hang
                    # ran: the step was slow, not hung
                    continue
                if _async_raise(self._target.ident, HangError):
                    log.warning("heartbeat: injected HangError into %s; "
                                "grace %.1fs", self._target.name,
                                self.grace_s)
                    deadline = time.monotonic() + self.grace_s
                    while time.monotonic() < deadline:
                        if self._stop.wait(0.05):
                            return  # recovered: stop() was called
                        if self._beats != beats_before:
                            break  # recovered: training progresses again
                    else:
                        log.error(
                            "heartbeat: thread did not respond to HangError "
                            "within %.1fs (blocked in native code): "
                            "terminating the process for the supervisor",
                            self.grace_s)
                        self._terminate()
                        return
                    continue
            self._terminate()
            return

    def _terminate(self) -> None:
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(5.0)
        os.kill(os.getpid(), signal.SIGKILL)


def _collect_incident(incident_dir: str, attempt: int, returncode: int,
                      uptime: float) -> None:
    """Layer attempt ``attempt``'s dumps into ``restart-<attempt>/`` and
    append its durable restart marker to ``supervisor.jsonl`` (the
    supervisor's own recorder is never dumped, so the marker lives in the
    incident tree, where the merge CLI reports it)."""
    moved = _bb.collect_attempt(incident_dir, attempt)
    if moved:
        log.info("supervisor: collected %d blackbox file(s) into "
                 "%s/restart-%d", moved, incident_dir, attempt)
    os.makedirs(incident_dir, exist_ok=True)
    with open(os.path.join(incident_dir, "supervisor.jsonl"), "a") as f:
        f.write(json.dumps({
            "supervisor_restart": True, "attempt": attempt,
            "returncode": returncode, "uptime_s": round(uptime, 3),
            "time": time.time()}) + "\n")


def run_supervised(
    argv: Sequence[str],
    *,
    max_restarts: int = 3,
    min_uptime_s: float = 0.0,
    env: Optional[dict] = None,
    incident_dir: Optional[str] = None,
    restart_backoff_s: float = 2.0,
    restart_backoff_cap_s: float = 30.0,
    restart_jitter: float = 0.25,
    restart_backoff_seed: Optional[int] = None,
) -> int:
    """Process-level supervisor: run ``argv`` until it exits 0, restarting
    it on failure up to ``max_restarts`` times (``bfrun --supervise N``).

    The recovery half of a peer's death and of the watchdog's kill
    escalation: the re-run script resumes from its latest checkpoint
    (``CheckpointManager.latest_step()``), so a crash or a wedged
    collective costs at most the progress since the last save.
    ``min_uptime_s`` guards against hot crash loops: a run that died
    faster than this earns no restart.

    Restarts back off (default ~2 s, doubling, capped at
    ``restart_backoff_cap_s``, ±``restart_jitter`` relative jitter) so a
    crash-looping job does not hammer shared resources: the checkpoint
    store it re-reads at every start, the window-server ports it re-binds,
    the store the whole gang re-registers with.  ``restart_backoff_s=0``
    restarts at once.

    Returns 0, or the last exit status once the restarts are spent.

    ``incident_dir``: flight-recorder forensics across restarts.  The
    child inherits it as ``BLUEFOG_TPU_BLACKBOX_DIR`` (so its watchdog and
    crash dumps land there), and between attempts the supervisor moves the
    dump files into ``restart-<n>/`` and appends a restart marker to
    ``supervisor.jsonl``, so a later attempt cannot overwrite the evidence
    of an earlier one: the whole tree is one incident that ``python -m
    bluefog_tpu_torch.blackbox`` reads recursively."""
    from bluefog_tpu_torch.runtime.resilience import Backoff

    backoff = None
    if restart_backoff_s > 0:
        backoff = Backoff(base_s=restart_backoff_s,
                          cap_s=restart_backoff_cap_s,
                          jitter=restart_jitter,
                          budget=max_restarts + 1,
                          seed=restart_backoff_seed)
    if incident_dir is not None:
        env = dict(env if env is not None else os.environ)
        # an explicit incident_dir wins over an ambient
        # BLUEFOG_TPU_BLACKBOX_DIR, or the children dump where the
        # supervisor does not collect
        env["BLUEFOG_TPU_BLACKBOX_DIR"] = incident_dir
    restarts = 0
    while True:
        t0 = time.monotonic()
        proc = subprocess.run(list(argv), env=env)
        uptime = time.monotonic() - t0
        if proc.returncode == 0:
            return 0
        restarts += 1
        if incident_dir is not None:
            _collect_incident(incident_dir, restarts, proc.returncode, uptime)
        if restarts > max_restarts:
            log.error("supervisor: giving up after %d restarts (last rc %d)",
                      max_restarts, proc.returncode)
            return proc.returncode
        if uptime < min_uptime_s:
            log.error("supervisor: died after %.1fs (< min uptime %.1fs); "
                      "not restarting a crash loop", uptime, min_uptime_s)
            return proc.returncode
        delay = backoff.next_delay() if backoff is not None else 0.0
        log.warning("supervisor: job exited rc %d after %.1fs; restart "
                    "%d/%d in %.1fs", proc.returncode, uptime, restarts,
                    max_restarts, delay)
        if delay > 0:
            time.sleep(delay)

"""Crash/hang dump machinery: write the flight recorder out on failure.

Counterpart of ``bluefog_tpu/blackbox/dump.py``, writing the same file
format, so either package's merge reads the other's dumps.  A wedged rank
cannot stream telemetry: the dump is the *survivors'* (and, for crashes,
the dying process's own) last word.  One JSONL file per rank
(``blackbox-rank<k>.jsonl``) containing, in order:

1. a ``{"header": ...}`` line: rank, pid, reason, wall time, world size;
2. one ``{"event": ...}`` line per ring-buffer entry (oldest first), after
   the recorder has settled the ends whose card work completed;
3. ``{"open_spans": [...]}``: rounds begun but never ended (the round a
   stuck rank is wedged in), from the recorder AND the timeline writer;
4. ``{"stacks": [...]}``: every thread's Python stack;
5. ``{"profile": ...}``: the continuous profiler's last ~30 s of
   phase-attributed folded stacks, when sampling is armed;
6. ``{"metrics": ...}``: a metrics-registry snapshot when metrics are on;
7. ``{"end": true, ...}``: the completeness marker (a dump without it was
   torn mid-write; :mod:`merge` still reads what landed).

Files are written to ``BLUEFOG_TPU_BLACKBOX_DIR`` (default ``blackbox/``)
via write-to-tmp + rename, so the merge CLI never parses a half-written
dump.  Triggers:

- ``Heartbeat`` deadline miss (``utils/failure.py`` dumps before
  escalating: reason ``heartbeat_timeout``, with the last-beat step);
- uncaught exceptions, including :class:`~bluefog_tpu_torch.utils.failure.
  HangError` (``install()`` chains ``sys.excepthook`` /
  ``threading.excepthook``);
- fatal signals: SIGTERM/SIGABRT handlers plus ``faulthandler`` armed at
  a per-rank log for the signals Python cannot run handlers for
  (SEGV/FPE/BUS);
- atexit-after-exception: if an exception was observed but no dump
  happened (a handler raced teardown), the atexit hook writes one.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import sys
import threading
import time
import traceback
from typing import List, Optional

from bluefog_tpu_torch.blackbox import recorder as _rec
from bluefog_tpu_torch.utils import lockcheck as _lc

__all__ = ["dump", "install", "incident_dir", "collect_attempt"]


def incident_dir() -> str:
    """Directory per-rank dumps land in (``BLUEFOG_TPU_BLACKBOX_DIR``)."""
    return os.environ.get("BLUEFOG_TPU_BLACKBOX_DIR", "blackbox")


def default_rank() -> int:
    """This process's rank for dump naming: ``BLUEFOG_TPU_RANK`` if set,
    else the launcher's ``RANK`` (``python -m bluefog_tpu_torch.runtime.
    launch`` and ``torchrun`` set it), else 0.  Environment only: a crash
    path must never start a device or a process group to learn it."""
    for var in ("BLUEFOG_TPU_RANK", "RANK"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def _thread_stacks() -> List[dict]:
    frames = sys._current_frames()
    out: List[dict] = []
    for t in threading.enumerate():
        f = frames.get(t.ident)
        if f is None:
            continue
        out.append({
            "thread": t.name,
            "ident": t.ident,
            "daemon": t.daemon,
            "frames": [
                f"{fr.filename}:{fr.lineno} {fr.name}: {(fr.line or '').strip()}"
                for fr in traceback.extract_stack(f)
            ],
        })
    return out


def _timeline_open_spans() -> List[dict]:
    try:
        from bluefog_tpu_torch.utils import timeline as _tl

        tl = _tl.current()
        if tl is not None:
            return tl.open_spans()
    except Exception:
        pass
    return []


def _profile_snapshot() -> Optional[dict]:
    # the sampler's last ~30s of folded stacks: what this rank was
    # BUSY with leading into the incident — complements the stacks
    # section (an instantaneous snapshot) with a time-weighted one.
    # Read from the in-memory recent ring, never the profile files:
    # the dump path must not do cross-file IO
    try:
        from bluefog_tpu_torch.profiling import sampler as _ps

        prof = _ps.get() if _ps.enabled() else None
        if prof is not None:
            return prof.recent_folded()
    except Exception:
        pass
    return None


def _metrics_snapshot() -> Optional[dict]:
    # the port's snapshot never waits on the card, so a watchdog thread
    # dumping while the main thread is wedged in a device call reads it
    try:
        from bluefog_tpu_torch.metrics import export as _mexp

        return _mexp.snapshot()
    except Exception:
        return None


# RLock, not Lock: a fatal-signal handler runs ON the thread it
# interrupts — if that thread is already inside dump(), a plain mutex
# would self-deadlock the process the tool exists to diagnose (the same
# bug class a non-reentrant engine lock has)
_dump_lock = _lc.rlock("blackbox.dump._dump_lock")
_dump_count = 0
# headers of earlier dumps this process wrote: escalation chains dump
# repeatedly to the SAME per-rank path (heartbeat_timeout, then the
# HangError excepthook, then the watchdog's SIGTERM), and the last
# writer would otherwise erase the FIRST dump's reason and last-beat
# step — the richest forensic record.  Each dump carries its
# predecessors' headers forward.
_prior_headers: List[dict] = []


def dump(reason: str, *, directory: Optional[str] = None,
         rank: Optional[int] = None, extra: Optional[dict] = None
         ) -> Optional[str]:
    """Write this rank's blackbox file; returns the path (None when
    recording is disabled).  Safe to call from any thread, including a
    watchdog monitor while the main thread is wedged; concurrent callers
    serialize and the last writer wins (the file carries its reason)."""
    global _dump_count
    if not _rec.enabled():
        return None
    rec = _rec.get()
    r = rank if rank is not None else (
        rec.rank if rec is not None and rec.rank is not None
        else default_rank())
    d = directory or incident_dir()
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        return None
    path = os.path.join(d, f"blackbox-rank{r}.jsonl")
    header = {"header": True, "rank": int(r), "pid": os.getpid(),
              "reason": reason, "time": time.time(),
              "argv": list(sys.argv)}
    world = os.environ.get("BLUEFOG_TPU_WORLD",
                           os.environ.get("WORLD_SIZE"))
    if world is not None:
        try:
            header["world"] = int(world)
        except ValueError:
            pass
    if extra:
        header.update(extra)
    with _dump_lock:
        if _prior_headers:
            header["previous_dumps"] = list(_prior_headers[-4:])
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps(header, default=str) + "\n")
                n = 0
                if rec is not None:
                    rec.settle()
                    for ev in rec.events():
                        f.write(json.dumps({"event": ev}, default=str) + "\n")
                        n += 1
                    f.write(json.dumps(
                        {"open_spans": rec.open_spans()
                         + _timeline_open_spans()}, default=str) + "\n")
                    dropped = rec.dropped
                else:
                    f.write(json.dumps({"open_spans":
                                        _timeline_open_spans()}) + "\n")
                    dropped = 0
                f.write(json.dumps({"stacks": _thread_stacks()},
                                   default=str) + "\n")
                prof = _profile_snapshot()
                if prof is not None:
                    f.write(json.dumps({"profile": prof}, default=str)
                            + "\n")
                snap = _metrics_snapshot()
                if snap is not None:
                    f.write(json.dumps({"metrics": snap}, default=str,
                                       allow_nan=True) + "\n")
                f.write(json.dumps({"end": True, "n_events": n,
                                    "dropped": dropped}) + "\n")
            os.replace(tmp, path)
        except OSError:
            return None
        _dump_count += 1
        _prior_headers.append({
            k: header[k] for k in header
            if k not in ("header", "argv", "previous_dumps")})
    try:
        from bluefog_tpu_torch.utils.logging import log

        log.error("blackbox: dumped flight recorder to %s (reason: %s)",
                  path, reason)
    except Exception:
        pass
    return path


# ---------------------------------------------------------------------------
# Trigger installation
# ---------------------------------------------------------------------------

_installed = False
_exception_seen = False
_fault_file = None  # keep the fd alive for faulthandler


def install(*, signals: bool = True, use_faulthandler: bool = True,
            excepthooks: bool = True) -> bool:
    """Arm the crash/hang dump triggers for this process.  Idempotent;
    returns False when recording is disabled.  The Heartbeat watchdog
    path needs no installation — ``utils/failure.py`` dumps directly."""
    global _installed, _fault_file
    if not _rec.enabled():
        return False
    if _installed:
        return True
    _installed = True

    if use_faulthandler:
        try:
            import faulthandler

            d = incident_dir()
            os.makedirs(d, exist_ok=True)
            _fault_file = open(os.path.join(
                d, f"faulthandler-rank{default_rank()}.log"), "w")
            faulthandler.enable(file=_fault_file, all_threads=True)
        except Exception:
            pass

    if excepthooks:
        prev_hook = sys.excepthook

        def _hook(tp, val, tb):
            global _exception_seen
            _exception_seen = True
            dump(f"exception:{tp.__name__}",
                 extra={"exception": repr(val)})
            prev_hook(tp, val, tb)

        sys.excepthook = _hook
        prev_thook = threading.excepthook

        def _thook(args):
            global _exception_seen
            _exception_seen = True
            dump(f"thread_exception:{args.exc_type.__name__}",
                 extra={"exception": repr(args.exc_value),
                        "thread": getattr(args.thread, "name", None)})
            prev_thook(args)

        threading.excepthook = _thook

        import atexit

        def _atexit_dump():
            # atexit-after-exception: a handler may have raced interpreter
            # teardown and never written — make sure the incident is on disk
            if _exception_seen and _dump_count == 0:
                dump("atexit_after_exception")

        atexit.register(_atexit_dump)

    if signals:
        import signal as _signal

        def _arm(sig):
            prev = _signal.getsignal(sig)

            def _on_signal(signum, frame):
                dump(f"signal:{_signal.Signals(signum).name}")
                # CHAIN, don't clobber: a training script's own SIGTERM
                # handler (checkpoint-on-preemption is standard on
                # preemptible machines) must still run after the dump —
                # the excepthooks above chain for the same reason
                if callable(prev):
                    prev(signum, frame)
                elif prev is _signal.SIG_IGN:
                    return
                else:
                    _signal.signal(signum, _signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

            _signal.signal(sig, _on_signal)

        for sig in (_signal.SIGTERM, _signal.SIGABRT):
            try:
                _arm(sig)
            except (ValueError, OSError):
                pass  # not the main thread / not settable here

    return True


def collect_attempt(incident: str, attempt: int) -> int:
    """Move the per-rank dump files at the top of ``incident`` into
    ``restart-<attempt>/`` so the next supervised attempt's dumps do not
    overwrite them (the supervisor calls this between restarts; the merge
    CLI reads the whole tree).  Returns the number of files moved."""
    moved = 0
    sub = os.path.join(incident, f"restart-{attempt}")
    for pattern in ("blackbox-rank*.jsonl", "faulthandler-rank*.log"):
        for path in glob.glob(os.path.join(incident, pattern)):
            os.makedirs(sub, exist_ok=True)
            shutil.move(path, os.path.join(sub, os.path.basename(path)))
            moved += 1
    return moved

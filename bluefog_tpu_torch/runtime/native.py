"""ctypes bindings for the port's native host runtime (``csrc/*.cc``).

Counterpart of ``bluefog_tpu/runtime/native.py``.  The library is the
port's own: ``csrc/logging.cc``, ``timeline.cc``, ``engine.cc`` and
``windows.cc`` (host C++, no CUDA), compiled with the host compiler at first
use into ``bluefog_tpu_torch/_build/libbf_torch_runtime-<hash>.so`` by
:mod:`bluefog_tpu_torch.utils.hostbuild` (file lock, atomic rename; the
hash covers the flags, the sources and ``bf_runtime.h``).  The JAX
package's library is never loaded.

Policy, unlike the JAX package's: a failed build or load **raises**.  The
JAX package returns ``None`` and runs on its pure-Python twins; here the
twins (:class:`PyEngine`, the Python window table and timeline writer) run
only when the caller asks for them: ``native=False`` where an entry point
takes it, or the environment variable ``BLUEFOG_TPU_TORCH_NO_NATIVE`` (the
counterpart of ``BLUEFOG_TPU_NO_NATIVE``), read by :func:`enabled`.
"""

from __future__ import annotations

import ctypes
import os
import queue as _queue
import threading
from pathlib import Path
from typing import Callable, Optional

from bluefog_tpu_torch.utils import hostbuild
from bluefog_tpu_torch.utils import lockcheck as _lc

__all__ = ["build", "load", "enabled", "TimelineWriter", "Engine",
           "PyEngine", "engine", "NO_NATIVE_ENV"]

NO_NATIVE_ENV = "BLUEFOG_TPU_TORCH_NO_NATIVE"

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_SOURCES = ("logging.cc", "timeline.cc", "engine.cc", "windows.cc")
_HEADER = "bf_runtime.h"
# -Bsymbolic: the library's calls into its own exported functions bind
# inside it, so a process that also holds another library exporting the
# same C names (the JAX package's, in the parity tests) never crosses them
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-shared", "-pthread", "-Wall",
             "-Wl,-Bsymbolic"]
# librt: shm_open/shm_unlink live there on pre-2.34 glibc
LINK = ["-lrt"]

_lib: Optional[ctypes.CDLL] = None
_load_lock = _lc.lock("runtime.native._load_lock")

_CALLBACK_T = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)


def enabled() -> bool:
    """False when ``BLUEFOG_TPU_TORCH_NO_NATIVE`` asks for the Python
    twins."""
    return not os.environ.get(NO_NATIVE_ENV)


def library_path() -> Path:
    return hostbuild.library_path(
        _BUILD_DIR, "bf_torch_runtime", [_CSRC / s for s in _SOURCES],
        CXX_FLAGS, [_CSRC / _HEADER])


def build() -> Path:
    """Compile the runtime library if its hash-named file is missing;
    returns its path.  Raises ``RuntimeError`` on failure."""
    return hostbuild.build_library(
        _BUILD_DIR, "bf_torch_runtime", [_CSRC / s for s in _SOURCES],
        CXX_FLAGS, headers=[_CSRC / _HEADER], link=LINK)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.bf_log_level.restype = ctypes.c_int
    lib.bf_set_log_level.argtypes = [ctypes.c_int]
    lib.bf_log.argtypes = [ctypes.c_int, ctypes.c_char_p]

    lib.bf_timeline_start.argtypes = [ctypes.c_char_p]
    lib.bf_timeline_start.restype = ctypes.c_int
    lib.bf_timeline_stop.restype = ctypes.c_int
    lib.bf_timeline_active.restype = ctypes.c_int
    for fn in (lib.bf_timeline_begin, lib.bf_timeline_end,
               lib.bf_timeline_async_begin, lib.bf_timeline_async_end):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64]
    lib.bf_timeline_instant.argtypes = [ctypes.c_char_p, ctypes.c_char_p]

    lib.bf_engine_start.restype = ctypes.c_int
    lib.bf_engine_shutdown.restype = ctypes.c_int
    lib.bf_engine_running.restype = ctypes.c_int
    lib.bf_enqueue.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, _CALLBACK_T, ctypes.c_void_p]
    lib.bf_enqueue.restype = ctypes.c_int
    lib.bf_poll.argtypes = [ctypes.c_int]
    lib.bf_poll.restype = ctypes.c_int
    lib.bf_wait.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.bf_wait.restype = ctypes.c_int
    lib.bf_clear.argtypes = [ctypes.c_int]
    lib.bf_wait_all.argtypes = [ctypes.c_int]
    lib.bf_wait_all.restype = ctypes.c_int
    lib.bf_pending_count.restype = ctypes.c_int

    geom = [ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    lib.bf_win_create.argtypes = geom
    lib.bf_win_create.restype = ctypes.c_int
    lib.bf_win_create_shm.argtypes = geom
    lib.bf_win_create_shm.restype = ctypes.c_int
    lib.bf_win_attach_shm.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.bf_win_attach_shm.restype = ctypes.c_int
    lib.bf_win_shm_unlink.argtypes = [ctypes.c_char_p]
    lib.bf_win_shm_unlink.restype = ctypes.c_int
    lib.bf_win_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    lib.bf_win_info.restype = ctypes.c_int
    lib.bf_win_exists.argtypes = [ctypes.c_char_p]
    lib.bf_win_exists.restype = ctypes.c_int
    lib.bf_win_free.argtypes = [ctypes.c_char_p]
    lib.bf_win_free.restype = ctypes.c_int
    lib.bf_win_deposit.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int]
    lib.bf_win_deposit.restype = ctypes.c_longlong
    lib.bf_win_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int]
    lib.bf_win_read.restype = ctypes.c_longlong
    lib.bf_win_fresh.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.bf_win_fresh.restype = ctypes.c_longlong
    lib.bf_win_set_self.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong]
    lib.bf_win_set_self.restype = ctypes.c_int
    lib.bf_win_read_self.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong]
    lib.bf_win_read_self.restype = ctypes.c_int
    lib.bf_win_num_slots.argtypes = [ctypes.c_char_p]
    lib.bf_win_num_slots.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """Build if needed and ``dlopen`` the runtime library.  Serialised on a
    lock, so concurrent first callers wait for one build.  Raises
    ``RuntimeError`` when the build or the load fails: nothing falls back
    quietly."""
    global _lib
    with _load_lock:
        if _lib is None:
            path = build()
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except (OSError, AttributeError) as e:
                raise RuntimeError(
                    f"loading the native runtime {path.name} failed: {e}"
                ) from e
        return _lib


class TimelineWriter:
    """The native chrome-trace writer (used by
    :class:`bluefog_tpu_torch.utils.timeline.Timeline`)."""

    def __init__(self, path: str):
        lib = load()
        if lib.bf_timeline_start(path.encode()) != 0:
            raise RuntimeError(f"bf_timeline_start({path!r}) failed")
        self._lib = lib

    def begin(self, name: bytes, cat: bytes, tid: int = 0):
        self._lib.bf_timeline_begin(name, cat, tid)

    def end(self, name: bytes, cat: bytes, tid: int = 0):
        self._lib.bf_timeline_end(name, cat, tid)

    def begin_async(self, name: bytes, cat: bytes, span_id: int):
        self._lib.bf_timeline_async_begin(name, cat, span_id)

    def end_async(self, name: bytes, cat: bytes, span_id: int):
        self._lib.bf_timeline_async_end(name, cat, span_id)

    def instant(self, name: bytes, cat: bytes):
        self._lib.bf_timeline_instant(name, cat)

    def close(self):
        if self._lib is not None:
            self._lib.bf_timeline_stop()
            self._lib = None


# Handle registry shared by every Engine instance: the C++ engine is
# process-global (one background thread, one handle space), so the Python
# bookkeeping that keeps ctypes trampolines alive and carries captured
# exceptions is process-global too.
_handles_lock = _lc.lock("runtime.native._handles_lock")
_handles: dict = {}  # handle -> (trampoline, holder)


class Engine:
    """Async host-op engine over the native background thread.

    ``enqueue(fn)`` runs ``fn`` on the engine thread (ctypes re-acquires the
    GIL there) and returns a handle with the reference's ``poll`` /
    ``synchronize`` (= WaitAndClear) semantics.  An exception in ``fn`` is
    captured and raised again at ``synchronize``.

    Instances are views over one process-global engine: handles are valid
    across instances and ``shutdown`` stops the shared thread.  Use the
    :func:`engine` accessor, which picks the Python twin when
    ``BLUEFOG_TPU_TORCH_NO_NATIVE`` is set.
    """

    native = True

    def __init__(self):
        self._lib = load()
        self._lib.bf_engine_start()

    def enqueue(self, fn: Callable[[], object], *, op: str = "host_op",
                name: str = "") -> int:
        holder = {}

        def trampoline(_arg) -> int:
            try:
                fn()
                return 0
            except BaseException as e:  # surfaced at synchronize()
                holder["err"] = e
                return 1

        cb = _CALLBACK_T(trampoline)
        # enqueue and registration are atomic under _handles_lock: the
        # handle cannot reach a racing synchronize() (which pops _handles)
        # before both have happened, and a failed enqueue registers nothing
        with _handles_lock:
            self._lib.bf_engine_start()  # restartable after shutdown()
            handle = self._lib.bf_enqueue(op.encode(), name.encode(), cb,
                                          None)
            if handle >= 0:
                _handles[handle] = (cb, holder)
        if handle < 0:
            raise RuntimeError("engine not running")
        return handle

    def poll(self, handle: int) -> bool:
        return self._lib.bf_poll(handle) == 1

    def synchronize(self, handle: int, timeout_s: Optional[float] = None):
        """Block until done, clear the handle, raise any exception again."""
        timeout_ms = -1 if timeout_s is None else int(timeout_s * 1000)
        status = ctypes.c_int(0)
        rc = self._lib.bf_wait(handle, timeout_ms, ctypes.byref(status))
        if rc == -2:
            raise TimeoutError(f"handle {handle} still pending")
        if rc == -1:
            raise KeyError(f"unknown handle {handle}")
        self._lib.bf_clear(handle)
        with _handles_lock:
            entry = _handles.pop(handle, None)
        if entry is not None and "err" in entry[1]:
            raise entry[1]["err"]
        return status.value

    def wait_all(self, timeout_s: Optional[float] = None):
        """Drain every known pending op, clearing the handles and raising
        the first captured exception again."""
        with _handles_lock:
            outstanding = list(_handles.keys())
        first_err = None
        for h in outstanding:
            try:
                self.synchronize(h, timeout_s=timeout_s)
            except KeyError:
                pass  # cleared by a concurrent synchronize
            except BaseException as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def pending_count(self) -> int:
        return self._lib.bf_pending_count()

    def shutdown(self):
        self._lib.bf_engine_shutdown()


class PyEngine:
    """The pure-Python twin of :class:`Engine`, with the same semantics."""

    native = False

    def __init__(self):
        self._q: _queue.Queue = _queue.Queue()
        self._results: dict = {}
        self._cv = _lc.condition("runtime.native.PyEngine._cv")
        self._next = 0
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, args=(self._q,), daemon=True)
        self._thread.start()

    def _loop(self, q):
        # consumes its own queue (passed in, not read off self): a restart
        # swaps in a fresh queue, so a stale shutdown sentinel only ever
        # stops the old thread it was meant for
        while True:
            item = q.get()
            if item is None:
                return
            handle, fn = item
            try:
                fn()
                result = 0
            except BaseException as e:
                result = e
            with self._cv:
                self._results[handle] = result
                self._cv.notify_all()

    def enqueue(self, fn, *, op="host_op", name="") -> int:
        with self._cv:
            # restartable after shutdown(), as the native engine is
            if self._stop:
                self._stop = False
                self._q = _queue.Queue()
                self._thread = threading.Thread(
                    target=self._loop, args=(self._q,), daemon=True)
                self._thread.start()
            handle = self._next
            self._next += 1
            self._results[handle] = None  # pending
            q = self._q
        q.put((handle, fn))
        return handle

    def poll(self, handle: int) -> bool:
        with self._cv:
            return self._results.get(handle) is not None

    def synchronize(self, handle: int, timeout_s=None):
        with self._cv:
            if handle not in self._results:
                raise KeyError(f"unknown handle {handle}")
            ok = self._cv.wait_for(
                lambda: self._results[handle] is not None, timeout=timeout_s)
            if not ok:
                raise TimeoutError(f"handle {handle} still pending")
            result = self._results.pop(handle)
        if isinstance(result, BaseException):
            raise result
        return 0

    def wait_all(self, timeout_s=None):
        """Drain all outstanding handles, raising the first exception."""
        with self._cv:
            outstanding = list(self._results.keys())
        first_err = None
        for h in outstanding:
            try:
                self.synchronize(h, timeout_s=timeout_s)
            except KeyError:
                pass  # cleared by a concurrent synchronize
            except BaseException as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def pending_count(self) -> int:
        with self._cv:
            return sum(1 for v in self._results.values() if v is None)

    def shutdown(self):
        with self._cv:
            if self._stop:
                return  # idempotent: never post a second sentinel
            self._stop = True
            q, t = self._q, self._thread
        q.put(None)
        t.join(timeout=5)


_engine_lock = _lc.lock("runtime.native._engine_lock")
_ENGINE = None
_PY_ENGINE: Optional[PyEngine] = None


def engine(native: Optional[bool] = None):
    """The process-wide engine: the native one, or its Python twin when
    ``native=False`` or ``BLUEFOG_TPU_TORCH_NO_NATIVE`` asks for it."""
    global _ENGINE, _PY_ENGINE
    use_native = enabled() if native is None else native
    with _engine_lock:
        if use_native:
            if _ENGINE is None:
                _ENGINE = Engine()
            return _ENGINE
        if _PY_ENGINE is None:
            _PY_ENGINE = PyEngine()
        return _PY_ENGINE

"""The port's native host runtime (``bluefog_tpu_torch/csrc/*.cc``,
``runtime/native.py``) against the JAX package's (``bluefog_tpu/csrc``,
``bluefog_tpu/runtime/native.py``), following ``tests/test_native_runtime.py``:

- the library builds from the port's own sources into
  ``bluefog_tpu_torch/_build/`` under a hash name, also from two processes at
  once, and a process of the port never maps the JAX package's library;
- a failed build, or a missing compiler, raises: nothing falls back;
- the engine runs the same scripts as the JAX package's native engine with
  the same outcomes (FIFO order, poll/synchronize, an exception raised
  again, a wait timeout, ``wait_all`` raising and clearing, restart after
  shutdown, an unknown handle), and so does its Python twin;
- the timeline writes valid chrome-trace JSON, native and Python;
- the host-op API of ``parallel/api.py``.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import pytest
import torch

from bluefog_tpu.runtime import native as jnative
from bluefog_tpu_torch.parallel import api as papi
from bluefog_tpu_torch.runtime import native
from bluefog_tpu_torch.utils import hostbuild
from bluefog_tpu_torch.utils import timeline as ptl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    """One torch thread, as the other port test modules pin theirs: the
    host runtime runs no tensor math, and a low count keeps the load
    beside the other test workers low."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _env():
    env = dict(os.environ)
    env.pop(native.NO_NATIVE_ENV, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


# ------------------------------------------------------------------ build --


def test_library_builds_from_the_ports_own_sources():
    lib = native.load()
    path = native.library_path()
    assert path.exists()
    assert path.parent == native._BUILD_DIR
    assert path.name.startswith("libbf_torch_runtime-")
    assert native._CSRC.parent.name == "bluefog_tpu_torch"
    for src in native._SOURCES:
        assert (native._CSRC / src).exists()
    assert lib.bf_win_num_slots(b"no-such-window") == -1


def test_a_process_of_the_port_never_maps_the_jax_packages_library():
    code = (
        "import numpy as np\n"
        "from bluefog_tpu_torch.runtime import native, async_windows as aw\n"
        "native.load()\n"
        "w = aw.AsyncWindow('nomap', 1, 4)\n"
        "e = native.engine(); e.synchronize(e.enqueue(lambda: None), 5)\n"
        "w.free()\n"
        "maps = open('/proc/self/maps').read()\n"
        "print('PORT', 'libbf_torch_runtime-' in maps)\n"
        "print('JAX', 'libbf_runtime' in maps, 'bluefog_tpu/' in maps)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "PORT True" in r.stdout
    assert "JAX False False" in r.stdout


def test_editing_a_source_or_the_header_changes_the_library_name(
        tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(native._CSRC, csrc)
    monkeypatch.setattr(native, "_CSRC", csrc)
    first = native.library_path()
    assert first.name == native.library_path().name
    (csrc / "windows.cc").write_text((csrc / "windows.cc").read_text()
                                     + "\n// edited\n")
    second = native.library_path()
    (csrc / "bf_runtime.h").write_text((csrc / "bf_runtime.h").read_text()
                                       + "\n// edited\n")
    third = native.library_path()
    assert len({first, second, third}) == 3


def test_two_processes_building_at_once_load_one_whole_library(tmp_path):
    code = (
        "import pathlib\n"
        "from bluefog_tpu_torch.runtime import native\n"
        f"native._BUILD_DIR = pathlib.Path({str(tmp_path)!r})\n"
        "lib = native.load()\n"
        "assert lib.bf_engine_start() == 0\n"
        "print(native.library_path().name)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=_env(),
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    names = {o[0].strip() for o in outs}
    assert len(names) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(names)


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    from bluefog_tpu_torch.runtime import async_windows as aw

    csrc = tmp_path / "csrc"
    shutil.copytree(native._CSRC, csrc)
    # a missing include in the shared header stops every source at once
    (csrc / "bf_runtime.h").write_text('#include "missing_on_purpose.h"\n')
    monkeypatch.setattr(native, "_CSRC", csrc)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_ENGINE", None)
    monkeypatch.delenv(native.NO_NATIVE_ENV, raising=False)
    with pytest.raises(RuntimeError, match="failed"):
        native.load()
    with pytest.raises(RuntimeError, match="failed"):
        native.engine()
    with pytest.raises(RuntimeError, match="failed"):
        aw.AsyncWindow("never-created", 1, 4)
    with pytest.raises(RuntimeError, match="failed"):
        ptl.Timeline(str(tmp_path / "t.json"))
    assert native._lib is None and native._ENGINE is None
    assert not list((tmp_path / "build").glob("*.so"))


def test_no_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(hostbuild, "compiler", lambda: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.load()


def test_the_python_twins_run_only_when_asked(monkeypatch):
    from bluefog_tpu_torch.runtime import async_windows as aw

    monkeypatch.delenv(native.NO_NATIVE_ENV, raising=False)
    assert native.engine().native
    w = aw.AsyncWindow(f"twin-{os.getpid()}", 1, 2)
    assert w.native
    w.free()
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    assert not native.engine().native
    w = aw.AsyncWindow(f"twin-{os.getpid()}", 1, 2)
    assert not w.native
    w.free()
    with pytest.raises(RuntimeError, match="native table"):
        aw.AsyncWindow(f"twin-shm-{os.getpid()}", 1, 2, shm=True)


def test_log_level_roundtrip():
    lib = native.load()
    old = lib.bf_log_level()
    try:
        lib.bf_set_log_level(2)
        assert lib.bf_log_level() == 2
        lib.bf_log(2, b"info message from test")
        lib.bf_log(0, b"suppressed trace message")
        lib.bf_set_log_level(9)
        assert lib.bf_log_level() == 5
    finally:
        lib.bf_set_log_level(old)


def test_callback_status_does_not_collide_with_sentinels():
    """A raw status of -2 must not read as a timeout: bf_wait reports the
    callback's status out of band."""
    lib = native.load()
    lib.bf_engine_start()
    status = ctypes.c_int(123)
    cb = native._CALLBACK_T(lambda _arg: -2)
    h = lib.bf_enqueue(b"test", b"neg_status", cb, None)
    assert h >= 0
    assert lib.bf_wait(h, 5000, ctypes.byref(status)) == 0
    assert status.value == -2
    lib.bf_clear(h)


# ----------------------------------------------------------------- engine --
# Each script drives an engine and returns what it observed; the port's
# engines must observe what the JAX package's native engine observes.


def _fifo(eng):
    order = []
    hs = [eng.enqueue((lambda i=i: order.append(i)), name=f"op{i}")
          for i in range(32)]
    return [eng.synchronize(h, timeout_s=5) for h in hs] + [order]


def _poll_synchronize(eng):
    ran = threading.Event()
    h = eng.enqueue(ran.set, op="test", name="set_event")
    st = eng.synchronize(h, timeout_s=5)
    return [st, ran.is_set(), eng.poll(h)]  # a cleared handle reads not-done


def _exception(eng):
    def boom():
        raise ValueError("host op failed")

    try:
        eng.synchronize(eng.enqueue(boom), timeout_s=5)
    except ValueError as e:
        return ["ValueError", str(e)]
    return ["no raise"]


def _wait_timeout(eng):
    release = threading.Event()
    h = eng.enqueue(lambda: release.wait(timeout=10), name="slow")
    out = []
    try:
        eng.synchronize(h, timeout_s=0.05)
    except TimeoutError:
        out.append("TimeoutError")
    out.append(eng.poll(h))
    release.set()
    out.append(eng.synchronize(h, timeout_s=5))
    return out


def _wait_all_raises_and_clears(eng):
    def boom():
        raise OSError("disk full")

    counter = []
    eng.enqueue(lambda: counter.append(1))
    eng.enqueue(boom)
    eng.enqueue(lambda: counter.append(2))
    out = []
    try:
        eng.wait_all(timeout_s=5)
    except OSError as e:
        out.append(["OSError", str(e)])
    eng.wait_all(timeout_s=5)  # drained: the error is not raised twice
    return out + [counter, eng.pending_count()]


def _restart_after_shutdown(eng):
    eng.shutdown()
    out = []
    h = eng.enqueue(lambda: out.append(1))  # starts the thread again
    return [eng.synchronize(h, timeout_s=5), out]


def _unknown_handle(eng):
    try:
        eng.synchronize(99_999)
    except KeyError:
        return ["KeyError"]
    return ["no raise"]


def _overlap(eng):
    started, release = threading.Event(), threading.Event()

    def blocker():
        started.set()
        release.wait(timeout=10)

    h = eng.enqueue(blocker, name="blocker")
    out = [started.wait(timeout=5), eng.poll(h), eng.pending_count() >= 1]
    release.set()
    eng.synchronize(h, timeout_s=5)
    return out + [eng.pending_count()]


SCRIPTS = [_fifo, _poll_synchronize, _exception, _wait_timeout,
           _wait_all_raises_and_clears, _restart_after_shutdown,
           _unknown_handle, _overlap]


@pytest.mark.parametrize("kind", ["native", "python"])
@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__[1:])
def test_engine_matches_the_jax_packages_engine(script, kind):
    ref = jnative.Engine()
    assert ref.native
    want = script(ref)
    if kind == "native":
        eng = native.engine(native=True)
        assert eng.native and isinstance(eng, native.Engine)
        got = script(eng)
        with native._handles_lock:
            assert not native._handles  # no trampoline leak
    else:
        eng = native.PyEngine()
        try:
            got = script(eng)
        finally:
            eng.shutdown()
    assert got == want


def test_handles_valid_across_engine_instances():
    a, b = native.Engine(), native.Engine()

    def boom():
        raise ValueError("cross-instance")

    with pytest.raises(ValueError, match="cross-instance"):
        b.synchronize(a.enqueue(boom), timeout_s=5)


def test_py_engine_double_shutdown_then_enqueue():
    """A stale shutdown sentinel must not stop the restarted worker."""
    eng = native.PyEngine()
    eng.shutdown()
    eng.shutdown()
    out = []
    eng.synchronize(eng.enqueue(lambda: out.append(1)), timeout_s=5)
    assert out == [1]
    eng.shutdown()


def test_host_op_api_on_the_engine():
    out = []
    h = papi.enqueue_host_op(lambda: out.append("io"), op="checkpoint",
                             name="step_1")
    assert papi.synchronize(h, timeout_s=5) == 0
    assert out == ["io"]
    assert papi.poll(h) is False
    for i in range(4):
        papi.enqueue_host_op(lambda i=i: out.append(i))
    papi.wait_all_host_ops(timeout_s=5)
    assert out == ["io", 0, 1, 2, 3]


# --------------------------------------------------------------- timeline --


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
def test_timeline_writes_valid_chrome_trace(tmp_path, use_native):
    path = tmp_path / "trace.json"
    ptl.timeline_start(str(path), native=use_native)
    try:
        tl = ptl.current()
        assert tl is not None and tl.native == use_native
        assert ptl.timeline_active()
        with ptl.timeline_context("step", "train"):
            tl.begin("neighbor_allreduce.grad", "comm", 1)
            time.sleep(0.002)
            tl.end("neighbor_allreduce.grad", "comm", 1)
            a = tl.begin_async("stage", "gossip", 2)
            b = tl.begin_async("stage", "gossip", 2)
            assert tl.end_async("stage", "gossip", 2) == a  # first in,
            assert tl.end_async("stage", "gossip", 2) == b  # first out
            tl.instant("mark", "marker")
    finally:
        ptl.timeline_stop()
    assert ptl.current() is None
    events = json.loads(path.read_text())
    assert [e["ph"] for e in events] == ["B", "B", "E", "b", "b", "e", "e",
                                         "i", "E"]
    assert events[0]["name"] == "step" and events[0]["cat"] == "train"
    b, e = events[1], events[2]
    assert b["name"] == "neighbor_allreduce.grad" and b["cat"] == "comm"
    assert b["tid"] == 1 and e["ts"] >= b["ts"]
    ids = [ev["id"] for ev in events[3:7]]
    assert ids[0] != ids[1] and ids[2:] == ids[:2]


def test_native_timeline_double_start_fails(tmp_path):
    lib = native.load()
    w = native.TimelineWriter(str(tmp_path / "t.json"))
    try:
        assert lib.bf_timeline_start(str(tmp_path / "t2.json").encode()) != 0
        with pytest.raises(RuntimeError, match="bf_timeline_start"):
            native.TimelineWriter(str(tmp_path / "t3.json"))
    finally:
        w.close()
    assert json.loads((tmp_path / "t.json").read_text()) == []

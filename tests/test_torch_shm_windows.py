"""The port's cross-process windows in named shared memory
(``bluefog_tpu_torch/csrc/windows.cc``, shm mode), following
``tests/test_shm_windows.py``: a deposit crosses a process boundary with no
participation of the owner; the self buffer is visible across processes;
concurrent accumulates from two processes lose nothing; a fuzz of the shm
window against the port's Python twin of the table; an attach timeout is
loud; a stale segment is recovered; and two skewed processes run
``run_async_dsgd_rank`` with an exact mass audit.  The port's segments carry
their own name prefix, so a window name the JAX package's table also uses
never attaches across the two."""

import os
import subprocess
import sys
import tempfile
import uuid

import numpy as np
import pytest
import torch

from bluefog_tpu.runtime.async_windows import AsyncWindow as JAsyncWindow
from bluefog_tpu_torch.runtime.async_windows import (AsyncWindow,
                                                     shm_unlink_window)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    """One torch thread here and in the workers: the windows are host
    memory, and the workers' loads sit beside other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _name(tag):
    return f"{tag}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


HEAD = ("import numpy as np, sys\n"
        "from bluefog_tpu_torch.runtime.async_windows import AsyncWindow\n")


def _run(code: str, *args, timeout=120) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", HEAD + code, *args],
                          capture_output=True, text=True, env=_env(),
                          cwd=REPO, timeout=timeout)


def test_deposit_crosses_process_boundary():
    """A subprocess attaches this process's window and deposits; the owner
    reads the payload without taking part in the transfer."""
    name = _name("tshm_basic")
    win = AsyncWindow(name, n_slots=2, n_elems=5, dtype=np.float64, shm=True)
    # the JAX package's table, same window name: a segment of its own
    jwin = JAsyncWindow(name, n_slots=2, n_elems=5, dtype=np.float64,
                        shm=True)
    try:
        payload = np.arange(5, dtype=np.float64) + 0.25
        out = _run(
            f"w = AsyncWindow({name!r}, attach=True)\n"
            "assert w.n_slots == 2 and w.n_elems == 5\n"
            "assert w.dtype == np.float64\n"
            "p = np.arange(5, dtype=np.float64) + 0.25\n"
            "w.deposit(1, p, accumulate=True)\n"
            "w.deposit(1, p, accumulate=True)\n"  # accumulates: 2x payload
            "w.deposit(0, 10 * p, accumulate=False)\n"  # put: replaces
            "w.free()\n"
            "print('DEPOSITED')\n")
        assert out.returncode == 0, out.stdout + out.stderr
        assert "DEPOSITED" in out.stdout
        buf, fresh = win.read(1, consume=True)
        assert fresh == 2
        np.testing.assert_array_equal(buf, 2 * payload)
        buf, fresh = win.read(0, consume=False)
        assert fresh == 1
        np.testing.assert_array_equal(buf, 10 * payload)
        # consumed exactly once: slot 1 was zero-filled by the read
        buf, fresh = win.read(1, consume=False)
        assert fresh == 0 and not buf.any()
        for k in range(2):  # nothing crossed into the JAX package's segment
            buf, fresh = jwin.read(k, consume=False)
            assert fresh == 0 and not buf.any()
    finally:
        win.free()
        jwin.free()


def test_self_buffer_visible_across_processes():
    name = _name("tshm_self")
    win = AsyncWindow(name, n_slots=1, n_elems=3, dtype=np.float32, shm=True)
    try:
        out = _run(f"w = AsyncWindow({name!r}, attach=True)\n"
                   "w.set_self(np.array([7, 8, 9], np.float32))\n"
                   "w.free()\n")
        assert out.returncode == 0, out.stdout + out.stderr
        np.testing.assert_array_equal(win.read_self(), [7.0, 8.0, 9.0])
    finally:
        win.free()


def test_concurrent_cross_process_accumulates_never_lose_updates():
    """Two writer processes hammer one slot; the process-shared mutex
    serialises the read-modify-writes exactly."""
    name = _name("tshm_race")
    reps = 300
    win = AsyncWindow(name, n_slots=1, n_elems=8, dtype=np.float64, shm=True)
    code = HEAD + (f"w = AsyncWindow({name!r}, attach=True)\n"
                   "p = np.full(8, float(sys.argv[1]))\n"
                   f"for _ in range({reps}):\n"
                   "    w.deposit(0, p, accumulate=True)\n"
                   "w.free()\n")
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(v)], env=_env(), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for v in (1.0, 3.0)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=120)[0])
        finally:
            for p in procs:  # never orphan a writer against a freed segment
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
        buf, fresh = win.read(0, consume=True)
        assert fresh == 2 * reps
        np.testing.assert_array_equal(buf, np.full(8, reps * (1.0 + 3.0)))
    finally:
        win.free()


def test_fuzz_against_the_python_twin():
    """A seeded sequence of operations on the shm window and on the same
    window in the Python twin of the table: every deposit count, freshness
    count and buffer bit-equal."""
    name = _name("tshm_fuzz")
    rng = np.random.default_rng(3)
    k, n = 3, 5
    win = AsyncWindow(name, n_slots=k, n_elems=n, dtype=np.float64, shm=True)
    twin = AsyncWindow(name, n_slots=k, n_elems=n, dtype=np.float64,
                       native=False)
    try:
        for step in range(300):
            slot = int(rng.integers(k))
            if rng.random() < 0.6:
                v = rng.standard_normal(n)
                acc = bool(rng.random() < 0.7)
                assert (win.deposit(slot, v, accumulate=acc)
                        == twin.deposit(slot, v, accumulate=acc)), step
            else:
                consume = bool(rng.random() < 0.5)
                a, fa = win.read(slot, consume=consume)
                b, fb = twin.read(slot, consume=consume)
                assert fa == fb and a.tobytes() == b.tobytes(), step
    finally:
        win.free()
        twin.free()


def test_attach_timeout_is_loud():
    with pytest.raises(RuntimeError, match="did not publish"):
        AsyncWindow(_name("tshm_nobody"), attach=True, attach_timeout_s=0.05)


def test_stale_segment_recovery():
    """A crashed owner (os._exit skips destructors) leaves its segment;
    creating again names the stale segment, and shm_unlink_window
    recovers."""
    name = _name("tshm_stale")
    out = _run(f"AsyncWindow({name!r}, 1, 4, np.float32, shm=True)\n"
               "import os; os._exit(0)\n")  # no free, no atexit, no dtors
    assert out.returncode == 0, out.stdout + out.stderr
    with pytest.raises(ValueError, match="stale"):
        AsyncWindow(name, 1, 4, np.float32, shm=True)
    assert shm_unlink_window(name) is True
    win = AsyncWindow(name, 1, 4, np.float32, shm=True)
    win.free()
    assert shm_unlink_window(name) is False  # free already unlinked


WORKER = """
import os, sys
import numpy as np, torch
from bluefog_tpu_torch.runtime.async_windows import (FileBarrier,
                                                     run_async_dsgd_rank)
from bluefog_tpu_torch.topology import RingGraph

torch.set_num_threads(1)
rank, n, bdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
skew = float(sys.argv[4]) / 1000.0
# per-rank quadratic 0.5 ||w - c_r||^2: the mean optimum is mean(c_r)
targets = np.stack([np.full(4, float(r + 1)) for r in range(n)])
t = torch.from_numpy(targets)


def loss_and_grad(r, step, params):
    diff = params["w"].double() - t[r]
    return 0.5 * float(diff @ diff), {"w": diff}


report = run_async_dsgd_rank(
    RingGraph(n), rank, {"w": torch.zeros(4)}, loss_and_grad,
    barrier=FileBarrier(bdir, n, rank), lr=0.05, duration_s=2.0,
    skew_s=skew, name="tdsgd_mp_" + os.path.basename(bdir))
if rank == 0:
    assert abs(report.total_mass - n) < 1e-9 * n, report.total_mass
    steps = report.steps_per_rank
    assert min(steps) >= 5 and steps[0] > 1.5 * steps[-1], steps
    c_mean = targets.mean(0)
    for p in report.final_params:
        w = p["w"].double().numpy()
        assert np.abs(w - c_mean).max() < 0.35 * np.abs(
            targets - c_mean).max(), (w, steps)
    assert report.consensus_gap < 0.2, report.consensus_gap
print("ASYNC_MP_OK", rank, flush=True)
"""


def test_async_dsgd_two_skewed_processes():
    """Two OS processes run skewed asynchronous DSGD through the shm
    windows; rank 0 checks the exact mass audit, the skew and the
    convergence to the mean optimum."""
    with tempfile.TemporaryDirectory() as bdir:
        # a 5x skew that dominates the host's own step time: at 0.5 vs
        # 2.5 ms a contended host's few-ms step floor flattened the
        # realized ratio below the 1.5x the worker asserts
        skews_ms = ["2.0", "10.0"]
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), "2", bdir, skews_ms[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(), cwd=REPO) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            pytest.fail("async MP workers timed out:\n" + "\n".join(
                o or "" for o in outs))
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"worker {r} failed:\n{out}"
            assert f"ASYNC_MP_OK {r}" in out, f"worker {r}:\n{out}"

"""The port's launcher (``python -m bluefog_tpu_torch.runtime.launch``,
``bfrun``) and ``initialize_cluster``, against the policies of the JAX
package's: ``tests/test_launch.py`` (environment propagation, script
arguments, a bare ``-x`` of an unset variable) and
``tests/test_multiprocess.py::test_rendezvous_exception_policy`` (a
rendezvous the caller asked for fails loudly; only a fully auto-detected one
may stay single-process).  Every launch here starts fresh interpreters that
import torch, so each test takes a few seconds."""

import os
import socket
import subprocess
import sys
import time

import pytest
import torch.distributed as dist

from bluefog_tpu_torch.runtime import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "LOCAL_RANK")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in CLUSTER_ENV}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _bfrun(args, *, timeout=120, cwd=REPO, **extra):
    return subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.runtime.launch",
         "--no-build", *args], capture_output=True, text=True,
        timeout=timeout, env=_env(**extra), cwd=cwd)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# each process writes its line in one write, so lines of processes sharing
# the pipe do not interleave
PROBE = (
    "import os, sys\n"
    "e = os.environ\n"
    "sys.stdout.write(f\"RANK {e['RANK']} WORLD {e['WORLD_SIZE']} LOCAL \"\n"
    "                 f\"{e['LOCAL_RANK']} ADDR {e['MASTER_ADDR']} VAR \"\n"
    "                 f\"{e.get('BF_TEST_VAR')} ARGS {sys.argv[1:]}\\n\")\n"
    "sys.stdout.flush()\n")


def test_env_propagation_and_script_args(tmp_path):
    script = tmp_path / "probe.py"
    script.write_text(PROBE)
    r = _bfrun(["-np", "2", "-x", "BF_TEST_VAR=hello", str(script), "--lr",
                "0.1", "-x", "kept"])
    assert r.returncode == 0, r.stderr
    for rank in (0, 1):
        assert (f"RANK {rank} WORLD 2 LOCAL {rank} ADDR 127.0.0.1 VAR hello "
                f"ARGS ['--lr', '0.1', '-x', 'kept']") in r.stdout, r.stdout


def test_module_target_and_bare_env_flag(tmp_path):
    (tmp_path / "probe_mod.py").write_text(PROBE)
    r = _bfrun(["-np", "1", "-x", "BF_TEST_VAR", "-m", "probe_mod",
                "--device", "cpu"], BF_TEST_VAR="from-env",
               PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}")
    assert r.returncode == 0, r.stderr
    assert ("RANK 0 WORLD 1 LOCAL 0 ADDR 127.0.0.1 VAR from-env ARGS "
            "['--device', 'cpu']") in r.stdout, r.stdout


def test_bare_env_flag_requires_existing_var(tmp_path):
    script = tmp_path / "probe.py"
    script.write_text("print('ran')\n")
    r = _bfrun(["-np", "2", "-x", "BF_DEFINITELY_UNSET_VAR", str(script)])
    assert r.returncode != 0
    assert "not set" in r.stderr + r.stdout
    assert "ran" not in r.stdout


def test_usage_errors():
    assert _bfrun(["-np", "2"]).returncode != 0  # no target
    assert _bfrun(["-np", "0", "x.py"]).returncode != 0


def test_a_failed_process_stops_the_others(tmp_path):
    """One process exits 3 at once while its peer would sleep a minute:
    the launcher stops the sleeper and exits with the failure's status."""
    script = tmp_path / "fail.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['RANK'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n"
        "print('SLEEPER FINISHED')\n")
    t0 = time.monotonic()
    r = _bfrun(["-np", "2", str(script)], timeout=60)
    assert r.returncode == 3
    assert time.monotonic() - t0 < 30
    assert "SLEEPER FINISHED" not in r.stdout
    assert "process 1 exited with status 3" in r.stderr


def test_children_join_one_gloo_group(tmp_path):
    script = tmp_path / "group.py"
    script.write_text(
        "import torch, torch.distributed as dist\n"
        "from bluefog_tpu_torch.runtime.launch import initialize_cluster\n"
        "initialize_cluster()\n"
        "t = torch.tensor([float(dist.get_rank() + 1)])\n"
        "dist.all_reduce(t)\n"
        "import sys\n"
        "sys.stdout.write(f'SUM {dist.get_rank()} {dist.get_world_size()} '\n"
        "                 f'{float(t[0])}\\n')\n")
    r = _bfrun(["-np", "3", str(script)])
    assert r.returncode == 0, r.stderr
    for rank in range(3):
        assert f"SUM {rank} 3 6.0" in r.stdout, r.stdout


def test_joining_registers_an_orderly_exit(monkeypatch):
    """A process that joins the cluster leaves it before the interpreter's
    teardown: a gloo group left to the static destructors at exit aborted
    a child now and then ("terminate called without an active exception",
    status -6) after its work was done."""
    registered = []
    monkeypatch.setattr(launch.atexit, "register", registered.append)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: None)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    launch.initialize_cluster("127.0.0.1:1", 2, 0)
    assert registered == [launch._leave_cluster]


def test_leave_cluster_destroys_the_group():
    assert not dist.is_initialized()
    launch._leave_cluster()  # no group: nothing to do
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        launch._leave_cluster()
        assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_initialize_cluster_single_process_is_a_noop(monkeypatch):
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    launch.initialize_cluster(num_processes=1)
    launch.initialize_cluster("127.0.0.1:1", 1, 0)
    # fully auto-detected with no cluster in the environment: single-process
    launch.initialize_cluster()
    assert not dist.is_initialized()


def test_initialize_cluster_incomplete_explicit_request_raises(monkeypatch):
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="rendezvous failed"):
        launch.initialize_cluster(num_processes=2)
    assert not dist.is_initialized()


CALL = (
    "import logging, sys\n"
    "logging.basicConfig(level=logging.WARNING)\n"
    "import torch.distributed as dist\n"
    "from bluefog_tpu_torch.runtime.launch import initialize_cluster\n"
    "try:\n"
    "    {call}\n"
    "except RuntimeError as e:\n"
    "    print('RAISED', str(e)[:200])\n"
    "    sys.exit(0)\n"
    "print('INITIALIZED', dist.is_initialized())\n")


@pytest.mark.parametrize("process_id", [0, 1])
def test_explicit_rendezvous_failure_is_loud(process_id):
    """A cluster the caller asked for whose peers never come: process 0
    (the store's host) waits for them, process 1 for the store; both raise
    after the timeout and never run on alone."""
    call = (f"initialize_cluster('127.0.0.1:{_free_port()}', 2, "
            f"{process_id}, initialization_timeout=2)")
    r = subprocess.run([sys.executable, "-c", CALL.format(call=call)],
                       capture_output=True, text=True, timeout=90,
                       env=_env(), cwd=REPO)
    assert "RAISED cluster rendezvous failed" in r.stdout, (r.stdout,
                                                            r.stderr)
    assert "INITIALIZED" not in r.stdout


def test_auto_detected_rendezvous_failure_stays_single_process():
    """Every argument from the environment (as bfrun sets it), and the
    rendezvous fails: the reference's policy logs a warning and stays
    single-process."""
    call = "initialize_cluster(initialization_timeout=2)"
    r = subprocess.run(
        [sys.executable, "-c", CALL.format(call=call)], capture_output=True,
        text=True, timeout=90, cwd=REPO,
        env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                 WORLD_SIZE="2", RANK="1"))
    assert "INITIALIZED False" in r.stdout, (r.stdout, r.stderr)
    assert "rendezvous skipped" in r.stderr


# ---------------------------------------------------------------------------
# --supervise, --timeline, --simulate and ibfrun (the JAX package's
# bfrun-tpu options and ibfrun-tpu, tests/test_launch.py and
# tests/test_failure.py::TestSupervisor)
# ---------------------------------------------------------------------------

CRASH_ONCE = (
    "import os, sys\n"
    "marker = os.path.join(sys.argv[1], 'crashed.' + os.environ['RANK'])\n"
    "if os.environ['RANK'] == '1' and not os.path.exists(marker):\n"
    "    open(marker, 'w').close()\n"
    "    sys.exit(7)\n"
    "sys.stdout.write(f\"DONE {os.environ['RANK']}\\n\")\n")


def test_supervise_restarts_the_group_until_it_succeeds(tmp_path):
    script = tmp_path / "crash_once.py"
    script.write_text(CRASH_ONCE)
    r = _bfrun(["-np", "2", "--supervise", "2", "--restart-backoff", "0",
                str(script), str(tmp_path)])
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("DONE 1") == 1  # only the second attempt's rank 1
    assert "restart 1/2" in r.stderr


def test_supervise_gives_up_with_the_last_status(tmp_path):
    script = tmp_path / "always.py"
    script.write_text("import sys; sys.exit(5)\n")
    r = _bfrun(["-np", "1", "--supervise", "1", "--restart-backoff=0",
                str(script)])
    assert r.returncode == 5, (r.returncode, r.stderr)
    assert "giving up after 1 restarts" in r.stderr
    # a crash faster than --min-uptime earns no restart
    r = _bfrun(["-np", "1", "--supervise", "3", "--restart-backoff", "0",
                "--min-uptime", "60", str(script)])
    assert r.returncode == 5 and "not restarting" in r.stderr


SIM = (
    "import json, sys\n"
    "import torch\n"
    "import bluefog_tpu_torch as bf\n"
    "from bluefog_tpu_torch.utils import timeline\n"
    "ctx = bf.init()\n"
    "with timeline.timeline_context('step'):\n"
    "    x = bf.neighbor_allreduce(bf.rank_stack(torch.ones(3)))\n"
    "timeline.timeline_stop()\n"
    "print('SIM', ctx.size, ctx.device.type, float(x.sum()))\n")


def test_simulate_and_timeline(tmp_path):
    import json

    script = tmp_path / "sim.py"
    script.write_text(SIM)
    trace = tmp_path / "tl.json"
    r = _bfrun(["-np", "1", "--simulate", "4", "--timeline", str(trace),
                str(script)])
    assert r.returncode == 0, r.stderr
    assert "SIM 4 cpu 12.0" in r.stdout, r.stdout
    events = json.loads(trace.read_text())
    # the gossip call's own span (device_stage), inside the user's
    assert [(e["name"], e["ph"]) for e in events] == [
        ("step", "B"), ("bf.neighbor_allreduce", "b"),
        ("bf.neighbor_allreduce", "e"), ("step", "E")]


def test_timeline_path_per_process():
    assert launch._timeline_path("/t/tl.json", 0, 1) == "/t/tl.json"
    assert launch._timeline_path("/t/tl.json", 1, 2) == "/t/tl.rank1.json"
    assert launch._timeline_path("/t/tl", 3, 4) == "/t/tl.rank3"
    assert launch._without_supervise(
        ["-np", "2", "--supervise", "3", "--restart-backoff=1",
         "--min-uptime", "2", "--timeline", "x"]) == [
        "-np", "2", "--timeline", "x"]


@pytest.mark.parametrize("topology,size", [("ring", 4), ("full", 3)])
def test_ibfrun_session_reads_stdin(topology, size):
    r = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.runtime.ibfrun",
         "--simulate", str(size), "--topology", topology],
        input="print('IB', ctx.size, ctx.device.type, "
              "ctx.topology.name)\n",
        capture_output=True, text=True, timeout=90, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert f"IB {size} cpu" in r.stdout, (r.stdout, r.stderr)

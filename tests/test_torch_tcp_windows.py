"""The port's asynchronous runners over TCP, with faults and membership
change, held to the exact mass audit as the JAX package's are
(``tests/test_window_transport.py``, ``test_resilience.py:735-849``,
``test_membership.py:313-402``).

Across processes: ``run_async_dsgd_rank`` over ``tcp`` (plain, striped with
the same-host shm route) and ``tcp-sync`` with 2 processes; a job whose rank
0 is a port process and rank 1 a JAX-package process (the wire, the barrier
and the windows are one protocol); and, through the ``async_dsgd_mp``
example, a SIGKILLed rank healed out and a rank joining while another
drains.  In threads: a killed rank written off, a stalled rank declared
dead and re-admitted, push-sum with a death, a join, a graceful leave and a
flapping member, each with the audit exact, and ``elastic_membership`` at
its defaults.  At most 3 processes a test, one torch thread each."""

import json
import os
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest
import torch

from bluefog_tpu_torch import topology as T
from bluefog_tpu_torch.runtime import async_windows as aw
from bluefog_tpu_torch.runtime import resilience as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _name(tag):
    return f"{tag}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


_WORKER = r'''
import json, os, sys
import numpy as np

rank, n, bdir, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
opts = json.loads(sys.argv[5])
targets = np.stack([np.full(4, float(r + 1)) for r in range(n)])
if mode == "ref":
    # a JAX-package rank in the same job
    from bluefog_tpu.runtime.async_windows import (FileBarrier,
                                                   run_async_dsgd_rank)
    from bluefog_tpu.topology import RingGraph

    params0 = {"w": np.zeros(4, np.float32)}

    def loss_and_grad(r, step, params):
        diff = np.asarray(params["w"], np.float64) - targets[r]
        return 0.5 * float(diff @ diff), {"w": diff}
else:
    import torch

    torch.set_num_threads(1)
    from bluefog_tpu_torch.runtime.async_windows import (
        FileBarrier, run_async_dsgd_rank)
    from bluefog_tpu_torch.topology import RingGraph

    params0 = {"w": torch.zeros(4)}
    tt = torch.from_numpy(targets)

    def loss_and_grad(r, step, params):
        diff = params["w"].double() - tt[r]
        return 0.5 * float(diff @ diff), {"w": diff}

rep = run_async_dsgd_rank(
    RingGraph(n), rank, params0, loss_and_grad,
    barrier=FileBarrier(bdir, n, rank), lr=0.05,
    duration_s=opts.pop("duration_s"), skew_s=0.001 * (1 + 3 * rank),
    name="tcpw_" + os.path.basename(bdir), tcp_bind="127.0.0.1", **opts)
if rank == 0:
    with open(os.path.join(bdir, "report.json"), "w") as f:
        json.dump({"steps": rep.steps_per_rank, "mass": rep.total_mass,
                   "gap": rep.consensus_gap,
                   "wire_bytes": getattr(rep, "wire_bytes", 0),
                   "phase": rep.phase_s[0] if rep.phase_s else {},
                   "loss": [rep.losses[0][0], rep.losses[0][-1]]}, f)
print(f"TCPW_OK {rank}", flush=True)
'''


def _run_job(tmp_path, modes, **opts):
    """One job of ``len(modes)`` rank processes; rank 0's report."""
    script = tmp_path / "w.py"
    script.write_text(_WORKER)
    bdir = tmp_path / "b"
    bdir.mkdir()
    opts.setdefault("duration_s", 1.5)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(len(modes)), str(bdir),
         m, json.dumps(opts)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env(), cwd=REPO)
        for r, m in enumerate(modes)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"TCPW_OK {r}" in out, out
    return json.loads((bdir / "report.json").read_text())


@pytest.mark.parametrize("transport,extra", [
    ("tcp", {}), ("tcp-sync", {}),
    ("tcp", {"stream_options": {"stripes": 2, "shm": True}})],
    ids=["tcp", "tcp-sync", "tcp-striped-shm"])
def test_dsgd_rank_over_tcp_two_processes_audit_exact(tmp_path, transport,
                                                      extra):
    rep = _run_job(tmp_path, ["port", "port"], transport=transport, **extra)
    assert abs(rep["mass"] - 2.0) <= 1e-9 * 2, rep["mass"]
    assert min(rep["steps"]) >= 5, rep["steps"]
    assert rep["loss"][1] < 0.5 * rep["loss"][0], rep["loss"]
    assert set(rep["phase"]) == {"consume", "unpack", "loss_and_grad",
                                 "pack", "deposit", "harvest"}
    if transport == "tcp" and not extra:
        # every deposit rode the wire: d + 1 = 5 f64 per step
        assert rep["wire_bytes"] == rep["steps"][0] * 5 * 8
    if extra:
        assert rep["wire_bytes"] == 0  # same host: the shm route took all


def test_port_and_jax_package_ranks_share_one_job(tmp_path):
    """Rank 0 is a port process and rank 1 a JAX-package process: the
    barrier files, the window addresses and the wire are one protocol, and
    the mass audit over both is exact."""
    rep = _run_job(tmp_path, ["port", "ref"], transport="tcp")
    assert abs(rep["mass"] - 2.0) <= 1e-9 * 2, rep["mass"]
    assert min(rep["steps"]) >= 5, rep["steps"]


def _example(*args, timeout=150):
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.examples.async_dsgd_mp",
         "--device", "cpu", *args], capture_output=True, text=True,
        env=_env(), cwd=REPO, timeout=timeout)
    return out.returncode, out.stdout + out.stderr


def test_sigkilled_rank_is_healed_out_audit_exact():
    """One of three rank processes is SIGKILLed mid-run by a chaos spec
    (``python -m bluefog_tpu_torch.chaos``); the survivors' streams
    exhaust their reconnect budget, declare it dead, heal, hold the
    rendezvous, and rank 0's audit over the survivors equals the post-heal
    baseline exactly (the example asserts it)."""
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.chaos", "--spec",
         "rank2:sigkill:at_step=12", "--", sys.executable, "-m",
         "bluefog_tpu_torch.examples.async_dsgd_mp", "--device", "cpu",
         "--ranks", "3", "--transport", "tcp", "--resilient",
         "--duration", "3"], capture_output=True, text=True, env=_env(),
        cwd=REPO, timeout=150)
    rc, out = out.returncode, out.stdout + out.stderr
    assert rc == 0, out
    assert "survived peer death over tcp" in out, out
    assert "dead=[2]" in out, out


def test_join_and_drain_across_processes_audit_exact():
    """Capacity 3: ranks 0 and 1 start, rank 2 joins mid-run from a
    member's window, rank 1 drains; the audit over {0, 2} is exact."""
    rc, out = _example("--ranks", "3", "--elastic", "--duration", "5")
    assert rc == 0, out
    assert "joined=[2] left=[1]" in out, out


def test_process_runner_argument_checks(tmp_path):
    b = aw.FileBarrier(str(tmp_path), 1, 0)
    p0 = {"w": torch.zeros(2)}
    lag = lambda r, s, p: (0.0, p)  # noqa: E731
    with pytest.raises(ValueError, match="requires transport='tcp'"):
        aw.run_async_dsgd_rank(T.RingGraph(2), 0, p0, lag, barrier=b,
                               transport="shm", join=True)
    with pytest.raises(ValueError, match="pipelined tcp"):
        aw.run_async_dsgd_rank(T.RingGraph(2), 0, p0, lag, barrier=b,
                               transport="shm", wire_codec="f32")
    # the control plane rides the tcp transport's telemetry
    from bluefog_tpu_torch.control import ControlConfig

    with pytest.raises(ValueError, match="tcp transport"):
        aw.run_async_dsgd_rank(T.RingGraph(2), 0, p0, lag, barrier=b,
                               transport="shm", control=ControlConfig())
    with pytest.raises(ValueError, match="rank 0 is the reporting rank"):
        aw.run_async_dsgd_rank(
            T.RingGraph(2), 0, p0, lag, barrier=b, transport="tcp",
            tcp_bind="127.0.0.1",
            resilience=R.ResilienceConfig(), leave_after_s=1.0,
            name=_name("argchk"))
    with pytest.raises(ValueError, match="resilience"):
        aw.run_async_dsgd_rank(
            T.RingGraph(2), 1, p0, lag, barrier=b, transport="tcp",
            tcp_bind="127.0.0.1",
            join=True, name=_name("argchk"))
    with pytest.raises(ValueError, match="transport must be"):
        aw.run_async_dsgd_rank(T.RingGraph(2), 0, p0, lag, barrier=b,
                               transport="udp")


# ---------------------------------------------------------------------------
# thread runners: deaths, stalls, joins and leaves
# ---------------------------------------------------------------------------


def _quadratic(n):
    targets = torch.stack([torch.full((4,), float(r + 1), dtype=torch.float64)
                           for r in range(n)])

    def loss_and_grad(r, step, params):
        diff = params["w"].double() - targets[r]
        return 0.5 * float(diff @ diff), {"w": diff}

    return loss_and_grad


def _kill(rank, step):
    def hook(r, s):
        if r == rank and s == step:
            raise aw.RankKilled()
    return hook


def test_dsgd_kill_one_of_three_exact_audit_over_survivors():
    rep = aw.run_async_dsgd(
        T.FullyConnectedGraph(3), {"w": torch.zeros(4)}, _quadratic(3),
        duration_s=2.0, skew=[0.001, 0.002, 0.003], name=_name("res_kill"),
        resilience=R.ResilienceConfig(suspect_after_s=0.1, dead_after_s=0.3),
        step_hook=_kill(2, 8))
    assert rep.dead_ranks == [2]
    assert abs(rep.total_mass + rep.died_mass - 3.0) < 1e-9
    assert 0.0 < rep.died_mass < 1.5
    assert rep.steps_per_rank[2] == 8
    assert min(rep.steps_per_rank[0], rep.steps_per_rank[1]) > 50
    assert rep.consensus_gap < 0.5, rep.consensus_gap
    assert rep.final_params[2] is None


def test_dsgd_stall_is_dead_then_rejoined_mass_exact():
    def stall(r, s):
        if r == 1 and s == 6:
            time.sleep(0.8)

    rep = aw.run_async_dsgd(
        T.FullyConnectedGraph(3), {"w": torch.zeros(4)}, _quadratic(3),
        duration_s=2.5, skew=[0.001] * 3, name=_name("res_stall"),
        resilience=R.ResilienceConfig(suspect_after_s=0.15,
                                      dead_after_s=0.35),
        step_hook=stall)
    assert rep.dead_ranks == []
    assert abs(rep.total_mass - 3.0) < 1e-9, rep.total_mass
    assert rep.steps_per_rank[1] > 6 + 10, rep.steps_per_rank
    seq = [(a, b) for (_, a, b) in rep.health_transitions[1]]
    assert seq.index((R.SUSPECT, R.DEAD)) < seq.index((R.DEAD, R.REJOINED)) \
        < seq.index((R.REJOINED, R.HEALTHY)), seq


def test_pushsum_kill_one_survivor_consensus_and_exact_mass():
    rep = aw.run_async_pushsum(
        T.FullyConnectedGraph(3), np.array([[1.0], [2.0], [9.0]]), tol=1e-4,
        timeout_s=10.0, name=_name("res_ps"),
        resilience=R.ResilienceConfig(suspect_after_s=0.1, dead_after_s=0.3),
        step_hook=_kill(2, 5))
    assert rep.dead_ranks == [2]
    assert abs(rep.total_mass + rep.died_mass - 3.0) < 1e-9
    assert rep.converged, (rep.max_abs_err, rep.steps_per_rank)
    spread = np.abs(rep.estimates[:2] - rep.estimates[:2].mean(axis=0)).max()
    assert spread < 1e-3


def test_join_midrun_warmstarts_and_audit_exact():
    rep = aw.run_async_dsgd(
        T.FullyConnectedGraph(4), {"w": torch.zeros(4)}, _quadratic(4),
        duration_s=2.0, skew=[0.001] * 4, name=_name("mem_join"),
        resilience=R.ResilienceConfig(suspect_after_s=0.2, dead_after_s=0.6),
        join_at_s={3: 0.4})
    assert rep.joined_ranks == [3]
    assert rep.left_ranks == [] and rep.dead_ranks == []
    assert rep.baseline_mass == 4.0
    assert abs(rep.total_mass - 4.0) < 1e-9, rep.total_mass
    assert rep.steps_per_rank[3] > 20, rep.steps_per_rank
    assert rep.consensus_gap < 0.5, rep.consensus_gap
    seq = [(a, b) for (_, a, b) in rep.health_transitions[3]]
    assert (R.LEFT, R.JOINING) in seq and (R.JOINING, R.HEALTHY) in seq


def test_graceful_leave_hands_mass_off():
    rep = aw.run_async_dsgd(
        T.FullyConnectedGraph(3), {"w": torch.zeros(4)}, _quadratic(3),
        duration_s=1.6, skew=[0.001] * 3, name=_name("mem_leave"),
        resilience=R.ResilienceConfig(suspect_after_s=0.2, dead_after_s=0.6),
        leave_at_s={2: 0.7})
    assert rep.left_ranks == [2]
    assert rep.dead_ranks == [] and rep.died_mass == 0.0
    assert rep.baseline_mass == 3.0
    assert abs(rep.total_mass - 3.0) < 1e-9, rep.total_mass
    assert rep.final_params[2] is None
    seq = [(a, b) for (_, a, b) in rep.health_transitions[2]]
    assert (R.HEALTHY, R.LEFT) in seq, seq


def test_flapping_member_joins_leaves_and_rejoins():
    """Rank 2 joins at 0.3 s, drains at 0.9 s and rejoins at 1.4 s: two
    admissions, one handoff, the audit exact throughout (the JAX package
    drives the same churn through chaos rules)."""
    rep = aw.run_async_dsgd(
        T.FullyConnectedGraph(3), {"w": torch.zeros(4)}, _quadratic(3),
        duration_s=2.2, skew=[0.001] * 3, name=_name("mem_flap"),
        resilience=R.ResilienceConfig(suspect_after_s=0.2, dead_after_s=0.6),
        join_at_s={2: [0.3, 1.4]}, leave_at_s={2: 0.9})
    assert rep.joined_ranks == [2]
    assert 2 not in rep.left_ranks  # it came back
    assert rep.baseline_mass == 4.0, rep.baseline_mass
    assert abs(rep.total_mass + rep.died_mass - 4.0) < 1e-9
    assert rep.final_params[2] is not None


def test_overlap_with_a_death_keeps_the_audit_exact():
    """The harvester's staged take joins a killed rank's last will."""
    rep = aw.run_async_dsgd(
        T.FullyConnectedGraph(3), {"w": torch.zeros(4)}, _quadratic(3),
        duration_s=1.5, skew=[0.001] * 3, name=_name("res_ov"),
        resilience=R.ResilienceConfig(suspect_after_s=0.1, dead_after_s=0.3),
        step_hook=_kill(1, 20), overlap=True)
    assert rep.dead_ranks == [1]
    assert abs(rep.total_mass + rep.died_mass - 3.0) < 1e-9


def test_elastic_membership_example_at_its_defaults(capsys):
    from bluefog_tpu_torch.examples import elastic_membership

    assert elastic_membership.main(["--device", "cpu"]) == 0
    assert "elastic_membership: OK" in capsys.readouterr().out


def test_thread_runner_elastic_needs_an_initial_member():
    with pytest.raises(ValueError, match="initial member"):
        aw.run_async_dsgd(T.RingGraph(2), {"w": torch.zeros(2)},
                          _quadratic(2), join_at_s={0: 0.1, 1: 0.1},
                          name=_name("noinit"))

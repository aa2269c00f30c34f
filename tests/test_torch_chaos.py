"""The port's chaos package (``bluefog_tpu_torch/chaos``) and its fault
sites, held against the JAX package's (``bluefog_tpu/chaos``).

1. The grammar: every spec line of the reference package's docstring and
   grammar text, the ``TestChaosSpec`` and churn cases of
   ``tests/test_resilience.py`` and ``tests/test_membership.py``, valid
   and invalid, parse to equal ``Rule`` fields in both packages or fail
   with the same error.
2. The injector: over 400 frames of mixed sites, seeded ``prob=``,
   ``rate=``, ``every=`` and ``after_frames=`` rules fire at exactly the
   same frames in both packages; ``check_step``, ``join_times`` and
   ``arm`` behave the same; a ``sigstop`` with ``for_s`` freezes a child
   process and its helper thaws it, in both packages; the CLI runs as a
   subprocess.
3. The wire sites (``TestStreamReconnectReplay``, ``test_resilience.py``):
   reconnect and replay exactly once under ``server:drop``, ``ack:drop``
   and ``client:truncate`` in the three pairings of
   ``test_torch_window_server.py``, with the read-back, the apply count
   and the reconnect count equal to the JAX package's own run; a stale
   epoch refused by both servers; a spent reconnect budget marking the
   peer DEAD in both clients; the read and shm sites.
4. The runners under chaos (``TestSelfHealingGossip`` and the chaos churn
   of ``tests/test_membership.py``), in threads: ``rank2:die`` and
   ``rank1:stall`` with exact audits and the health transitions of the
   JAX package's run, push-sum with a death, and a flapping member driven
   by ``join:after_s`` and ``leave:at_step``.

The spec is applied to both packages at once (``configure`` on each), as
``BLUEFOG_TPU_CHAOS`` would in a mixed job; every site belongs to one
side of a connection, so a rule counts only the traffic its site sees.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest
import torch

from bluefog_tpu import chaos as RC
from bluefog_tpu.runtime import async_windows as RA
from bluefog_tpu.runtime import window_server as RW
from bluefog_tpu_torch import chaos as PC
from bluefog_tpu_torch.runtime import async_windows as PA
from bluefog_tpu_torch.runtime import resilience as PR
from bluefog_tpu_torch.runtime import window_server as PW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIDES = {"port": (PA, PW), "ref": (RA, RW)}
PAIRS = [("port", "port"), ("ref", "port"), ("port", "ref")]
PAIR_IDS = ["port-port", "refserver-portclient", "portserver-refclient"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _chaos_isolated():
    PC.reset()
    RC.reset()
    yield
    PC.reset()
    RC.reset()


def _both(spec):
    PC.configure(spec)
    RC.configure(spec)


def _name(tag):
    return f"{tag}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


# ---------------------------------------------------------------------------
# 1. the grammar
# ---------------------------------------------------------------------------

VALID = [
    # the reference package's docstring examples
    "server:drop:after_frames=40",
    "ack:drop:after_frames=3",
    "client:truncate:after_frames=5",
    "server:delay:ms=20:prob=0.1:seed=7",
    "server:drop:rate=0.05:seed=3",
    "read:truncate:every=7",
    "sub:stall:s=1:every=13",
    "rank2:sigkill:at_step=8",
    "rank1:sigstop:after_s=0.8:for_s=1",
    "rank2:die:at_step=8",
    "rank1:stall:at_step=6:s=1.5",
    "rank1:leave:at_step=20",
    "rank3:join:after_s=0.5",
    "rank3:join:after_s=0.5;rank3:leave:at_step=10;rank3:join:after_s=2",
    # the grammar text's further examples
    "read:stall:s=2:prob=0.05",
    "sub:drop:after_frames=10",
    "relay:drop:every=9",
    "relay:truncate:after_frames=20",
    # TestChaosSpec and TestChurnFaults
    "server:drop:after_frames=3; ack:delay:ms=20:prob=0.5:seed=9; "
    "rank2:sigkill:at_step=8; rank1:sigstop:after_s=0.5:for_s=1.0",
    "server:delay:ms=5:prob=0.3:seed=42:times=0",
    "server:drop:rate=0.25:seed=7",
    "server:stall:s=1",
    "rank1:leave:at_step=20; rank3:join:after_s=0.5",
    # every key, case and spacing the parser normalizes
    "ANY:Delay:MS=3:Every=2:Times=4",
    " client : stall : s=0.25 : after_frames=2 ;; ",
    "rank0:stall:after_s=0.2:for_s=0.1",
    "rank12:sigstop:at_step=3",
]

INVALID = [
    "", "server", "server:frobnicate", "rank:die:at_step=1",
    "rankX:die:at_step=1", "server:drop:nonsense=1",
    "server:delay:prob=2.0", "rank1:die", "rank1:sigkill",
    "bogus:drop:after_frames=1",
    "server:drop:rate=1.5", "server:drop:rate=0.1:prob=0.1",
    "rank1:die:at_step=3:rate=0.1",
    "rank1:leave", "rank1:leave:after_s=1", "rank1:join",
    "rank1:join:at_step=1", "server:leave:after_frames=1",
    "server:drop:after_frames=x", "server:drop:every", ";;",
    "rank1:sigkill:at_step=2:prob=-0.5",
]


@pytest.mark.parametrize("spec", VALID)
def test_valid_specs_parse_to_the_reference_rules(spec):
    got = [dataclasses.asdict(r) for r in PC.parse_spec(spec)]
    want = [dataclasses.asdict(r) for r in RC.parse_spec(spec)]
    assert got == want
    assert [r.max_fires() for r in PC.parse_spec(spec)] == \
        [r.max_fires() for r in RC.parse_spec(spec)]


@pytest.mark.parametrize("spec", INVALID)
def test_invalid_specs_fail_with_the_reference_error(spec):
    with pytest.raises(RC.ChaosSpecError) as want:
        RC.parse_spec(spec)
    with pytest.raises(PC.ChaosSpecError) as got:
        PC.parse_spec(spec)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


# ---------------------------------------------------------------------------
# 2. the injector
# ---------------------------------------------------------------------------

FIRE_SPECS = [
    "server:delay:ms=5:prob=0.3:seed=42:times=0",
    "server:drop:rate=0.25:seed=7",
    "server:drop:rate=0.05:seed=3;ack:drop:after_frames=3;"
    "client:truncate:every=7",
    "any:stall:s=0.5:prob=0.1;server:delay:ms=20:rate=0.95:seed=1;"
    "server:drop:rate=0.01:seed=2",
    "client:delay:ms=1:every=4:times=20;read:drop:prob=0.5",
    "server:drop:after_frames=40;server:truncate:every=9:times=3",
]
SITES = ("server", "ack", "client", "read", "sub")


@pytest.mark.parametrize("spec", FIRE_SPECS)
def test_fire_sequences_equal_the_reference_over_400_frames(spec):
    pi, ri = PC.Injector(spec), RC.Injector(spec)
    order = np.random.default_rng(0).integers(0, len(SITES), 400)
    seq_p = [pi.fire(SITES[k]) for k in order]
    seq_r = [ri.fire(SITES[k]) for k in order]
    assert seq_p == seq_r
    assert pi.stats() == ri.stats()


def test_lossy_link_rate_loses_its_share():
    inj = PC.Injector("server:drop:rate=0.25:seed=7")
    losses = sum(inj.fire("server") is not None for _ in range(400))
    assert 60 <= losses <= 140, losses


def test_env_is_read_lazily_and_reset(monkeypatch):
    monkeypatch.setenv("BLUEFOG_TPU_CHAOS", "server:drop:after_frames=1")
    PC.reset()
    assert PC.enabled()
    assert PC.fire("server") == ("drop",)
    PC.configure(None)
    assert not PC.enabled() and PC.fire("server") is None
    PC.reset()
    assert PC.get().spec == "server:drop:after_frames=1"


def _step_outcomes(mod, spec, calls):
    mod.configure(spec)
    out = []
    for rank, step in calls:
        t0 = time.perf_counter()
        try:
            mod.check_step(rank, step)
            out.append("ok")
        except mod.ChaosKill as e:
            out.append(("kill", e.rank, e.step))
        except mod.ChaosLeave as e:
            out.append(("leave", e.rank, e.step))
        if time.perf_counter() - t0 >= 0.04:
            out[-1] = "stalled"
    mod.reset()
    return out


def test_check_step_matches_the_reference():
    spec = ("rank1:die:at_step=5;rank2:leave:at_step=3;"
            "rank0:stall:at_step=2:s=0.05;rank3:die:at_step=1:times=2")
    calls = [(1, 4), (0, 99), (1, 5), (1, 6), (2, 2), (2, 3), (2, 4),
             (0, 1), (0, 2), (0, 3), (3, 0), (3, 1), (3, 2), (3, 3)]
    got = _step_outcomes(PC, spec, calls)
    assert got == _step_outcomes(RC, spec, calls)
    assert got[2] == ("kill", 1, 5) and got[3] == "ok"
    # a matured at_step fires at any later step of its rank, once
    assert got[1] == "stalled" and got[8] == "ok"
    assert got[12] == ("kill", 3, 2) and got[13] == "ok"


def test_join_times_are_consumed_once_as_in_the_reference():
    spec = "rank3:join:after_s=2.0; rank3:join:after_s=0.5; " \
           "rank1:leave:at_step=4"
    for mod in (PC, RC):
        mod.configure(spec)
    assert PC.join_times(3) == RC.join_times(3) == [0.5, 2.0]
    assert PC.join_times(3) == RC.join_times(3) == []
    assert PC.join_times(1) == RC.join_times(1) == []


def test_arm_runs_wall_clock_faults_once():
    PC.configure("rank0:stall:after_s=0.05:s=0.01;rank1:stall:after_s=5:s=1")
    inj = PC.get()
    PC.arm(0)
    PC.arm(0)  # idempotent per rank
    time.sleep(0.3)
    assert inj.stats()[0] == (0, 1)
    assert inj.stats()[1] == (0, 0)  # rank 1 never armed
    PC.reset()  # cancels the timers


_SIGSTOP_CHILD = r'''
import sys, time
pkg = sys.argv[1]
mod = __import__(pkg + ".chaos", fromlist=["configure"])
mod.configure("rank0:sigstop:after_s=0.2:for_s=0.6")
mod.arm(0)
t0 = time.monotonic()
last, gap = t0, 0.0
while time.monotonic() - t0 < 1.6:
    now = time.monotonic()
    gap = max(gap, now - last)
    last = now
    time.sleep(0.005)
print(f"GAP {gap:.3f}", flush=True)
'''


@pytest.mark.parametrize("pkg", ["bluefog_tpu_torch", "bluefog_tpu"])
def test_sigstop_for_s_freezes_and_thaws_a_child(pkg):
    """A ``sigstop`` with ``for_s`` stops the process and its helper child
    sends SIGCONT: the child's loop sees one gap of about ``for_s`` and
    the process runs on to its end, in both packages."""
    out = subprocess.run([sys.executable, "-c", _SIGSTOP_CHILD, pkg],
                         capture_output=True, text=True, env=_env(),
                         cwd=REPO, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    gap = float(out.stdout.split("GAP ")[1])
    assert 0.45 <= gap <= 3.0, gap


def test_cli_explain_grammar_exit_code_and_env_passthrough():
    cli = [sys.executable, "-m", "bluefog_tpu_torch.chaos"]
    env = _env()
    out = subprocess.run(
        cli + ["--spec", "server:drop:after_frames=2", "--explain"],
        capture_output=True, text=True, env=env, cwd=REPO)
    assert out.returncode == 0 and "drop" in out.stdout
    gram = subprocess.run(cli + ["--grammar"], capture_output=True,
                          text=True, env=env, cwd=REPO)
    assert gram.returncode == 0 and "rank<N>" in gram.stdout
    bad = subprocess.run(cli + ["--spec", "nope", "--explain"],
                         capture_output=True, text=True, env=env, cwd=REPO)
    assert bad.returncode == 2 and "bad spec" in bad.stderr
    run = subprocess.run(
        cli + ["--spec", "server:stall:s=1", "--", sys.executable, "-c",
               "import os, sys; print(os.environ['BLUEFOG_TPU_CHAOS']); "
               "sys.exit(3)"],
        capture_output=True, text=True, env=env, cwd=REPO)
    assert run.returncode == 3  # the command's own exit code
    assert "server:stall:s=1" in run.stdout


# ---------------------------------------------------------------------------
# 3. the wire sites
# ---------------------------------------------------------------------------

_FAST = dict(base_s=0.02, cap_s=0.2, budget=6, seed=0)


def _replay_run(srv_side, cli_side, spec, rounds):
    """``rounds`` deposits, each flushed, through a resuming stream under
    ``spec``; returns (read-back, apply count, reconnects)."""
    aw, ws = SIDES[srv_side]
    cli = SIDES[cli_side][1]
    name = _name("chaos_replay")
    win = aw.AsyncWindow(name, 1, 8, np.float64)
    srv = ws.WindowServer()
    _, port = srv.start("127.0.0.1")
    _both(spec)
    st = cli.DepositStream(("127.0.0.1", port), reconnect=_FAST)
    try:
        for i in range(rounds):
            st.deposit_async(name.encode(), 0, np.full(8, float(i + 1)),
                             accumulate=True)
            st.flush(timeout_s=30)
        got, fresh = win.read(0, consume=False)
        return np.array(got), int(fresh), int(st.reconnects)
    finally:
        st.close()
        PC.reset()
        RC.reset()
        srv.stop()
        win.free()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("spec,rounds", [
    ("server:drop:after_frames=6", 20),
    ("ack:drop:after_frames=3", 10),
    ("client:truncate:after_frames=4", 12)],
    ids=["server-drop", "ack-drop", "client-truncate"])
def test_reconnect_replays_exactly_once(pair, spec, rounds):
    got, fresh, recon = _replay_run(*pair, spec, rounds)
    want, want_fresh, want_recon = _replay_run("ref", "ref", spec, rounds)
    total = sum(np.full(8, float(i + 1)) for i in range(rounds))
    np.testing.assert_array_equal(got, total)
    np.testing.assert_array_equal(got, want)
    assert fresh == want_fresh == rounds  # applied once, never twice
    assert recon == want_recon >= 1


def test_server_drop_health_dips_and_recovers():
    aw, ws = SIDES["port"]
    name = _name("chaos_health")
    win = aw.AsyncWindow(name, 1, 8, np.float64)
    srv = ws.WindowServer()
    _, port = srv.start("127.0.0.1")
    PC.configure("server:drop:after_frames=6")
    st = PW.DepositStream(("127.0.0.1", port), reconnect=_FAST)
    try:
        for i in range(20):
            st.deposit_async(name.encode(), 0, np.ones(8))
            st.flush(timeout_s=30)
        seq = [(a, b) for (_, a, b) in st.health.transitions]
        assert (PR.HEALTHY, PR.SUSPECT) in seq
        assert st.health.state == PR.HEALTHY
    finally:
        st.close()
        srv.stop()
        win.free()


@pytest.mark.parametrize("srv_side", ["port", "ref"])
def test_stale_epoch_cannot_steal_a_stream(srv_side):
    aw, ws = SIDES[srv_side]
    name = _name("chaos_epoch")
    win = aw.AsyncWindow(name, 1, 8, np.float64)
    srv = ws.WindowServer()
    _, port = srv.start("127.0.0.1")
    w = PW  # the frame layouts are the JAX package's, byte for byte
    socks = []
    try:
        rcs = []
        for epoch in (2, 2, 1, 3):
            s = socket.create_connection(("127.0.0.1", port), timeout=10)
            socks.append(s)
            s.sendall(w._HDR.pack(w._MAGIC, w._OP_HELLO, 0)
                      + w._HELLO.pack(w.PROTOCOL_VERSION,
                                      w.FEATURE_BATCH | w.FEATURE_RESUME))
            s.recv(8)
            s.sendall(w._HDR.pack(w._MAGIC, w._OP_STREAM_ATTACH, 0)
                      + w._ATTACH.pack(4242, epoch))
            (rc,) = w._STATUS.unpack(s.recv(8))
            rcs.append(rc)
        assert rcs == [0, w._ERR_STALE_EPOCH, w._ERR_STALE_EPOCH, 0]
        assert w._ERR_STALE_EPOCH == RW._ERR_STALE_EPOCH
    finally:
        for s in socks:
            s.close()
        srv.stop()
        win.free()


@pytest.mark.parametrize("cli_side", ["port", "ref"])
def test_spent_budget_marks_the_peer_dead(cli_side):
    cli = SIDES[cli_side][1]
    res = PR if cli_side == "port" else __import__(
        "bluefog_tpu.runtime.resilience", fromlist=["DEAD"])
    name = _name("chaos_dead")
    srv = PW.WindowServer()
    _, port = srv.start("127.0.0.1")
    st = cli.DepositStream(("127.0.0.1", port),
                           reconnect=dict(base_s=0.01, cap_s=0.05,
                                          budget=3, seed=0))
    try:
        srv.stop()  # the peer is gone for good
        st.deposit_async(name.encode(), 0, np.ones(8))
        with pytest.raises(RuntimeError, match="unreachable"):
            st.flush(timeout_s=30)
        assert st.health.state == res.DEAD == PR.DEAD
        with pytest.raises(RuntimeError):
            st.deposit_async(name.encode(), 0, np.ones(8))
    finally:
        st.close()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("spec", ["read:truncate:after_frames=1",
                                  "read:drop:after_frames=2"])
def test_read_site_faults_are_retried_on_a_fresh_connection(pair, spec):
    """A sync read reply torn or dropped by the server's ``read`` site:
    the pipelined window's sync reads retry on a fresh connection, so the
    reader gets the right value."""
    srv_side, cli_side = pair
    aw, ws = SIDES[srv_side]
    cli = SIDES[cli_side][1]
    name = _name("chaos_read")
    win = aw.AsyncWindow(name, 2, 6, np.float64)
    win.set_self(np.arange(6.0))
    win.deposit(1, np.full(6, 2.5))
    srv = ws.WindowServer()
    _, port = srv.start("127.0.0.1")
    _both(spec)
    rw = cli.PipelinedRemoteWindow(("127.0.0.1", port), name,
                                   sync_retry=_FAST)
    try:
        np.testing.assert_array_equal(rw.read_self(6, np.float64),
                                      np.arange(6.0))
        buf, fresh = rw.read(1, 6, np.float64, consume=False)
        np.testing.assert_array_equal(buf, np.full(6, 2.5))
        assert fresh == 1
        inj = (PC if srv_side == "port" else RC).get()
        assert inj.stats()[0][1] == 1  # the fault fired once
    finally:
        rw.close()
        srv.stop()
        win.free()


@pytest.mark.parametrize("srv_side", ["port", "ref"])
def test_sync_overwrite_is_retried_and_accumulate_is_not(srv_side):
    """A ``server:drop`` on a sync deposit: the overwrite
    (``accumulate=False``, the runner's final meta record) is idempotent,
    so the port's client retries it on a fresh connection and it lands;
    an accumulating deposit is never re-issued and raises, with nothing
    applied.  Against a port server and a JAX-package server."""
    aw, ws = SIDES[srv_side]
    name = _name("chaos_overwrite")
    win = aw.AsyncWindow(name, 2, 4, np.float64)
    srv = ws.WindowServer()
    _, port = srv.start("127.0.0.1")
    try:
        _both("server:drop:after_frames=1")
        rw = PW.RemoteWindow(("127.0.0.1", port), name, retry=_FAST)
        rw.deposit(0, np.arange(4.0), accumulate=False)
        rw.deposit(0, np.arange(4.0), accumulate=False)
        rw.close()
        got, _ = win.read(0, consume=False)
        np.testing.assert_array_equal(got, np.arange(4.0))
        inj = (PC if srv_side == "port" else RC).get()
        assert inj.stats()[0][1] == 1  # the first frame was cut

        _both("server:drop:after_frames=1")
        rw = PW.RemoteWindow(("127.0.0.1", port), name, retry=_FAST)
        with pytest.raises(ConnectionError):
            rw.deposit(1, np.ones(4), accumulate=True)
        rw.close()
        got, fresh = win.read(1, consume=False)
        np.testing.assert_array_equal(got, np.zeros(4))
        assert fresh == 0
    finally:
        srv.stop()
        win.free()


@pytest.mark.parametrize("srv_side", ["port", "ref"])
def test_resuming_stream_retries_a_dropped_handshake(srv_side):
    """``server:drop`` on a stream's first HELLO: a resuming stream takes
    its reconnect budget for the first connect too, then deposits exactly
    once; a stream without ``reconnect=`` raises as before."""
    aw, ws = SIDES[srv_side]
    name = _name("chaos_hello")
    win = aw.AsyncWindow(name, 1, 8, np.float64)
    srv = ws.WindowServer()
    _, port = srv.start("127.0.0.1")
    try:
        _both("server:drop:after_frames=1")
        with pytest.raises((OSError, ConnectionError)):
            PW.DepositStream(("127.0.0.1", port))
        _both("server:drop:after_frames=1")
        st = PW.DepositStream(("127.0.0.1", port), reconnect=_FAST)
        try:
            for i in range(3):
                st.deposit_async(name.encode(), 0, np.full(8, i + 1.0))
            st.flush(timeout_s=30)
        finally:
            st.close()
        got, fresh = win.read(0, consume=False)
        np.testing.assert_array_equal(got, np.full(8, 6.0))
        assert fresh == 3
    finally:
        srv.stop()
        win.free()


def test_shm_route_client_fault_falls_back_to_tcp_exactly_once():
    """``client:drop`` at the same-host shm route tears the write before
    the atomic table accumulate: nothing applied, the deposit goes over
    TCP, and every deposit lands once, as in the JAX package."""
    results = {}
    for side in ("port", "ref"):
        aw, ws = SIDES[side]
        name = _name("chaos_shm")
        win = aw.AsyncWindow(name, 1, 8, np.float64, shm=True)
        srv = ws.WindowServer()
        _, port = srv.start("127.0.0.1")
        _both("client:drop:after_frames=1")
        st = ws.DepositStream(("127.0.0.1", port), shm=True,
                              reconnect=_FAST)
        try:
            for i in range(6):
                st.deposit_async(name.encode(), 0, np.full(8, i + 1.0))
            st.flush(timeout_s=30)
            got, fresh = win.read(0, consume=False)
            results[side] = (np.array(got), int(fresh), st.shm_deposits)
        finally:
            st.close()
            PC.reset()
            RC.reset()
            srv.stop()
            win.free()
    got, fresh, shm = results["port"]
    np.testing.assert_array_equal(got, np.full(8, 21.0))
    np.testing.assert_array_equal(got, results["ref"][0])
    assert fresh == results["ref"][1] == 6
    assert shm == results["ref"][2] == 0  # the route latched off


# ---------------------------------------------------------------------------
# 4. the runners under chaos
# ---------------------------------------------------------------------------


def _port_quadratic(n):
    targets = torch.stack([torch.full((4,), float(r + 1), dtype=torch.float64)
                           for r in range(n)])

    def loss_and_grad(r, step, params):
        diff = params["w"].double() - targets[r]
        return 0.5 * float(diff @ diff), {"w": diff}

    return loss_and_grad


def _ref_quadratic(n):
    targets = np.stack([np.full(4, float(r + 1)) for r in range(n)])

    def loss_and_grad(r, step, params):
        diff = np.asarray(params["w"], np.float64) - targets[r]
        return 0.5 * float(diff @ diff), {"w": diff}

    return loss_and_grad


def _dsgd_both(spec, n, **kw):
    """The same run under the same spec in the port and in the JAX
    package (the spec is configured anew before each)."""
    from bluefog_tpu import topology as RT
    from bluefog_tpu.runtime.resilience import ResilienceConfig as RCfg
    from bluefog_tpu_torch import topology as PT

    res = kw.pop("resilience")
    PC.configure(spec)
    port = PA.run_async_dsgd(
        PT.FullyConnectedGraph(n), {"w": torch.zeros(4)},
        _port_quadratic(n), name=_name("chaos_p"),
        resilience=PR.ResilienceConfig(**res), **kw)
    PC.reset()
    RC.configure(spec)
    ref = RA.run_async_dsgd(
        RT.FullyConnectedGraph(n), {"w": np.zeros(4, np.float32)},
        _ref_quadratic(n), name=_name("chaos_r"),
        resilience=RCfg(**res), **kw)
    RC.reset()
    return port, ref


def _transitions(rep, r):
    return [(a, b) for (_, a, b) in rep.health_transitions[r]]


@pytest.mark.chaos
def test_dsgd_chaos_die_exact_audit_as_the_reference():
    port, ref = _dsgd_both(
        "rank2:die:at_step=8", 3, duration_s=2.0,
        skew=[0.001, 0.002, 0.003],
        resilience=dict(suspect_after_s=0.1, dead_after_s=0.3))
    for rep in (port, ref):
        assert rep.dead_ranks == [2]
        assert abs(rep.total_mass + rep.died_mass - 3.0) < 1e-9
        assert 0.0 < rep.died_mass < 1.5
        assert rep.steps_per_rank[2] == 8
        assert min(rep.steps_per_rank[:2]) > 50
        assert rep.consensus_gap < 0.5
        assert rep.final_params[2] is None
    assert _transitions(port, 2) == _transitions(ref, 2)


@pytest.mark.chaos
def test_dsgd_chaos_stall_dead_then_rejoined_as_the_reference():
    port, ref = _dsgd_both(
        "rank1:stall:at_step=6:s=0.8", 3, duration_s=2.5,
        skew=[0.001] * 3,
        resilience=dict(suspect_after_s=0.15, dead_after_s=0.35))
    for rep in (port, ref):
        assert rep.dead_ranks == []
        assert abs(rep.total_mass - 3.0) < 1e-9, rep.total_mass
        assert rep.steps_per_rank[1] > 6 + 10, rep.steps_per_rank
    want = [(PR.SUSPECT, PR.DEAD), (PR.DEAD, PR.REJOINED),
            (PR.REJOINED, PR.HEALTHY)]
    for rep in (port, ref):
        seq = _transitions(rep, 1)
        assert [t for t in seq if t in want][:3] == want, seq


@pytest.mark.chaos
def test_pushsum_chaos_die_survivor_consensus_and_exact_mass():
    from bluefog_tpu import topology as RT
    from bluefog_tpu.runtime.resilience import ResilienceConfig as RCfg
    from bluefog_tpu_torch import topology as PT

    x0 = np.array([[1.0], [2.0], [9.0]])
    _both("rank2:die:at_step=5")
    port = PA.run_async_pushsum(
        PT.FullyConnectedGraph(3), x0, tol=1e-4, timeout_s=10.0,
        name=_name("chaos_ps"),
        resilience=PR.ResilienceConfig(suspect_after_s=0.1,
                                       dead_after_s=0.3))
    ref = RA.run_async_pushsum(
        RT.FullyConnectedGraph(3), x0, tol=1e-4, timeout_s=10.0,
        name=_name("chaos_psr"),
        resilience=RCfg(suspect_after_s=0.1, dead_after_s=0.3))
    for rep in (port, ref):
        assert rep.dead_ranks == [2]
        assert abs(rep.total_mass + rep.died_mass - 3.0) < 1e-9
        assert rep.converged, (rep.max_abs_err, rep.steps_per_rank)
        assert rep.steps_per_rank[2] == 5


@pytest.mark.chaos
def test_chaos_driven_flapping_member_as_the_reference():
    """``rank2:join:after_s=0.3; rank2:leave:at_step=25;
    rank2:join:after_s=1.4``: two admissions, one handoff, the audit exact
    throughout, in both packages."""
    port, ref = _dsgd_both(
        "rank2:join:after_s=0.3; rank2:leave:at_step=25; "
        "rank2:join:after_s=1.4", 3, duration_s=2.2, skew=[0.001] * 3,
        resilience=dict(suspect_after_s=0.2, dead_after_s=0.6))
    for rep in (port, ref):
        assert rep.joined_ranks == [2]
        assert 2 not in rep.left_ranks
        assert rep.baseline_mass == 4.0, rep.baseline_mass
        assert abs(rep.total_mass + rep.died_mass - 4.0) < 1e-9
        assert rep.steps_per_rank[2] > 25, rep.steps_per_rank


@pytest.mark.chaos
def test_chaos_leave_at_step_drains_the_rank():
    from bluefog_tpu_torch import topology as PT

    PC.configure("rank1:leave:at_step=20")
    rep = PA.run_async_dsgd(
        PT.FullyConnectedGraph(3), {"w": torch.zeros(4)},
        _port_quadratic(3), duration_s=1.2, skew=[0.001] * 3,
        name=_name("chaos_leave"),
        resilience=PR.ResilienceConfig(suspect_after_s=0.2,
                                       dead_after_s=0.6))
    assert rep.left_ranks == [1] and rep.dead_ranks == []
    assert rep.steps_per_rank[1] == 20
    assert rep.baseline_mass == 3.0
    assert abs(rep.total_mass - 3.0) < 1e-9, rep.total_mass


def test_chaos_leave_rule_needs_an_elastic_process_job(tmp_path):
    from bluefog_tpu_torch import topology as PT

    PC.configure("rank1:leave:at_step=3")
    with pytest.raises(ValueError, match="elastic job"):
        PA.run_async_dsgd_rank(
            PT.RingGraph(2), 1, {"w": torch.zeros(2)},
            lambda r, s, p: (0.0, p),
            barrier=PA.FileBarrier(str(tmp_path), 2, 1), transport="tcp",
            tcp_bind="127.0.0.1", name=_name("chaos_lv"))

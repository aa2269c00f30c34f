"""The port's snapshot relays (``bluefog_tpu_torch/relay``) and the group
lifecycle of its snapshot table, against the JAX package's.

The cases of ``tests/test_relay.py`` on the port, but for the lint
(``TestRelayLint``, ROADMAP item 11c), the reader-tree simulator
(``TestReaderTreeSim``, item 11b) and the metrics gauge
(``test_group_gauge_tracks_census``, item 11a); its ``TestDeltaCodec`` is
in ``test_torch_delta.py``, its ``TestDeltaWire`` in
``test_torch_serving.py`` over the three pairs, and
``test_relay_actuates_plan_at_boundary`` beside ``TestTreePlan`` in
``test_torch_control.py``.

- ``SnapshotTable`` group lifecycle: ``drop_group``, the idle-TTL sweep,
  ``wait_newer`` across a sweep and revive, the atomic fan-out
  reservation;
- two-tier relay chains: exact stamps and strictly increasing rounds at
  the leaf, a mid-tree relay killed (the child re-parents to the root with
  nothing lost), the chaos matrix (``read:``/``sub:``/``relay:``); each
  chain also with the port's relays between a JAX-package trainer server
  and a JAX-package leaf, and a JAX-package relay between port ends;
- the self-loop refusal, the idle sweep of a relay, and
  ``python -m bluefog_tpu_torch.relay`` serving a group.
"""

import os
import socket
import subprocess
import sys
import threading
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from bluefog_tpu import chaos as RC
from bluefog_tpu.relay import node as RN
from bluefog_tpu.runtime import delta as RD
from bluefog_tpu.runtime import window_server as RW
from bluefog_tpu.serving import client as RCl
from bluefog_tpu.serving import snapshots as RSn
from bluefog_tpu.serving import subscriber as RSub
from bluefog_tpu_torch import chaos as PC
from bluefog_tpu_torch.relay import node as PN
from bluefog_tpu_torch.runtime import delta as PD
from bluefog_tpu_torch.runtime import window_server as PW
from bluefog_tpu_torch.runtime import wire_status as PS
from bluefog_tpu_torch.serving import client as PCl
from bluefog_tpu_torch.serving import snapshots as PSn
from bluefog_tpu_torch.serving import subscriber as PSub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIDES = {
    "port": SimpleNamespace(ws=PW, snap=PSn, sub=PSub, node=PN, delta=PD,
                            client=PCl),
    "ref": SimpleNamespace(ws=RW, snap=RSn, sub=RSub, node=RN, delta=RD,
                           client=RCl),
}
# (ends: the trainer's server and the leaf subscriber; relays)
CHAINS = [("port", "port"), ("ref", "port"), ("port", "ref")]
CHAIN_IDS = ["port-ends-port-relays", "ref-ends-port-relays",
             "port-ends-ref-relays"]


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


def _uniq(tag):
    return f"{tag}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


def _serve(side, tbl=None, delta=None):
    srv = side.ws.WindowServer(snapshots=tbl, delta=delta)
    addr = srv.start("127.0.0.1")
    return srv, addr


def _stamped(rnd, dim=256, base=None):
    v = float(rnd)
    x = np.full(dim, v) if base is None else np.asarray(base, float)
    return {"x": x, "p": np.array([v + 1.0]), "round": np.array([v])}


def _wait(cond, timeout_s=10.0, dt=0.01):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(dt)
    return cond()


# ---------------------------------------------------------------------------
# SnapshotTable group lifecycle (long-lived processes)
# ---------------------------------------------------------------------------

class TestGroupLifecycle:
    def test_drop_group_reports_existence(self):
        tbl = PSn.SnapshotTable()
        g = _uniq("lcg")
        tbl.publish(g, 0, _stamped(0))
        assert g in tbl.groups()
        assert tbl.drop_group(g) is True
        assert tbl.drop_group(g) is False
        assert g not in tbl.groups()

    def test_idle_ttl_sweep_drops_only_idle_groups(self):
        tbl = PSn.SnapshotTable()
        fresh, stale = _uniq("fresh"), _uniq("stale")
        tbl.publish(stale, 0, _stamped(0))
        t_mid = time.monotonic() + 100.0
        tbl.publish(fresh, 0, _stamped(0))
        # pin the fresh group's publish time after the virtual "now" minus
        # the ttl: a sweep at +100 with ttl 50 drops only `stale`
        with tbl._mu:
            tbl._groups[fresh].published_at = t_mid - 1.0
        assert tbl.sweep_idle(50.0, now=t_mid) == [stale]
        assert tbl.groups() == [fresh]
        assert tbl.sweep_idle(50.0, now=t_mid) == []

    def test_sweep_ages_never_published_groups_from_creation(self):
        tbl = PSn.SnapshotTable()
        g = _uniq("neverpub")
        tbl._group(g)  # created (a subscriber waiting), never published
        assert tbl.sweep_idle(3600.0) == []
        assert g in tbl.sweep_idle(0.001, now=time.monotonic() + 10.0)

    def test_wait_newer_wakes_on_generation_regression(self):
        """A swept and revived group restarts its generation counter: a
        sender parked on the old high generation wakes on the revived
        group's first publish."""
        tbl = PSn.SnapshotTable()
        g = _uniq("regen")
        for rnd in range(50):
            tbl.publish(g, rnd, _stamped(rnd))
        high = tbl.generation(g)
        assert high == 50
        assert tbl.sweep_idle(1.0, now=time.monotonic() + 100) == [g]
        tbl.publish(g, 50, _stamped(50))
        assert tbl.wait_newer(g, high, timeout_s=2.0) == 1
        assert tbl.read(g)[0] == 50
        # and a wait with nothing new times out with None
        assert tbl.wait_newer(g, 1, timeout_s=0.05) is None

    def test_subscriber_survives_sweep_and_revive(self):
        tbl = PSn.SnapshotTable()
        srv, addr = _serve(SIDES["port"], tbl)
        g = _uniq("revive")
        for rnd in range(20):
            tbl.publish(g, rnd, _stamped(rnd))
        got = []
        sub = PSub.Subscriber(addr, g, on_snapshot=lambda s: got.append(s))
        try:
            assert _wait(lambda: sub.cursor == 19)
            tbl.sweep_idle(1.0, now=time.monotonic() + 100)
            tbl.publish(g, 20, _stamped(20))
            assert _wait(lambda: sub.cursor == 20), \
                "the sender starved after a sweep and revive"
            rounds = [s.round for s in got]
            assert rounds == sorted(set(rounds))
        finally:
            sub.close()
            srv.stop()

    def test_fanout_reservation_is_atomic(self):
        """8 concurrent claims against one free slot: exactly one wins."""
        srv, _ = _serve(SIDES["port"], PSn.SnapshotTable())
        srv.set_fanout_limit(1)
        inner = srv._server
        wins = []
        start = threading.Barrier(8)

        def claim():
            start.wait()
            if inner.sub_reserve():
                wins.append(1)

        threads = [threading.Thread(target=claim) for _ in range(8)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert sum(wins) == 1
            inner.note_sub(-1)
            assert inner.sub_reserve()  # the released slot re-admits
            srv.set_fanout_limit(None)
            assert inner.sub_limit is None
        finally:
            srv.stop()

    def test_superseded_subscriber_epoch_is_refused(self):
        """SUBSCRIBE with an epoch not newer than the lineage's live one
        gets ``-105``; a newer one quiesces the old push connection."""
        tbl = PSn.SnapshotTable()
        srv, addr = _serve(SIDES["port"], tbl)
        g = _uniq("epoch").encode()
        tbl.publish(g.decode(), 1, _stamped(1))

        def subscribe(epoch):
            s = socket.create_connection(addr, timeout=10)
            s.sendall(PW._HDR.pack(PW._MAGIC, PW._OP_HELLO, 0)
                      + PW._HELLO.pack(2, PW.FEATURE_SUBSCRIBE))
            s.recv(8)
            s.sendall(PW._HDR.pack(PW._MAGIC, PW._OP_SUBSCRIBE, len(g)) + g
                      + PW._SUB_REQ.pack(42, epoch, 1, -1))
            (rc,) = PW._STATUS.unpack(s.recv(8))
            return s, rc

        try:
            s2, rc2 = subscribe(2)
            assert rc2 == 0
            s1, rc1 = subscribe(1)
            assert rc1 == PS.ERR_STALE_EPOCH == -105
            s3, rc3 = subscribe(3)
            assert rc3 == 0
            # the epoch-2 connection was quiesced: it reads its pushes up
            # to the cut, then EOF
            s2.settimeout(5)
            while s2.recv(65536):
                pass
            for s in (s1, s2, s3):
                s.close()
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# two-tier relay chains
# ---------------------------------------------------------------------------

def _publish_rounds(tbl, g, x, rng, start, stop_, dt=0.04):
    for rnd in range(start, stop_):
        np.add(x, 0.01 * rng.standard_normal(x.size), out=x)
        tbl.publish(g, rnd, {"x": x, "p": np.array([float(rnd + 1)]),
                             "round": np.array([float(rnd)])})
        time.sleep(dt)


@pytest.fixture(params=CHAINS, ids=CHAIN_IDS)
def chain(request):
    ends, relays = request.param
    return SIDES[ends], SIDES[relays]


class TestRelayChain:
    def _chain(self, rel, addr, g, **t2_kw):
        dc = rel.delta.DeltaConfig(full_every=4, min_delta_elems=64)
        t1 = rel.node.RelayNode(addr, [g], tier=1, delta=dc)
        t2 = rel.node.RelayNode(t1.address, [g], tier=2, delta=dc, **t2_kw)
        return t1, t2

    def test_two_tier_chain_exact_stamps_strictly_increasing(
            self, chain, monkeypatch):
        ends, rel = chain
        # the port's push senders' frame bodies: (server, kind, bytes)
        pushes = []
        body_of = PW._SubSender._payload_views

        def payload_views(sender, rnd, leaves):
            body = body_of(sender, rnd, leaves)
            kind = (PW._DELTA_HDR.unpack(body[0])[0] if sender._delta_on
                    else 0)
            pushes.append((sender._handler.server, kind,
                           sum(memoryview(v).nbytes for v in body)))
            return body

        monkeypatch.setattr(PW._SubSender, "_payload_views", payload_views)
        tbl = ends.snap.SnapshotTable()
        srv, addr = _serve(ends, tbl)
        g = _uniq("chain")
        rng = np.random.default_rng(4)
        x = rng.standard_normal(512)
        tbl.publish(g, 0, {"x": x, "p": np.array([1.0]),
                           "round": np.array([0.0])})
        t1 = t2 = leaf = None
        try:
            t1, t2 = self._chain(rel, addr, g)
            got = []
            leaf = ends.sub.Subscriber(t2.address, g, delta=True,
                                       on_snapshot=lambda s: got.append(s))
            _publish_rounds(tbl, g, x, rng, 1, 16)
            assert _wait(lambda: got and got[-1].round == 15, 15.0, 0.02)
            rounds = [s.round for s in got]
            assert rounds == sorted(set(rounds))
            for s in got:  # the leaf-level exact stamp audit
                assert float(s["round"][0]) == s.round
                assert float(s["p"][0]) == s.round + 1.0
            assert t1.landed > 0 and t2.landed > 0
            assert leaf.delta_frames > 0
            assert t1.rounds() == {g: 15} and t2.rounds() == {g: 15}
            if rel is SIDES["port"]:
                # the leaf's pushes, as the tier-2 relay's server sent
                # them: deltas far smaller than the full frames
                mine = [(k, b) for s, k, b in pushes
                        if s is t2.server._server]
                delta = [b for k, b in mine if k == PW._OP_DELTA]
                full = [b for k, b in mine if k == 0]
                assert len(delta) >= leaf.delta_frames and full
                assert np.mean(delta) < np.mean(full)
        finally:
            for closer in (leaf, t2, t1):
                if closer is not None:
                    closer.close()
            srv.stop()

    def test_mid_tree_kill_children_reparent_nothing_lost(self, chain):
        ends, rel = chain
        tbl = ends.snap.SnapshotTable()
        srv, addr = _serve(ends, tbl)
        g = _uniq("kill")
        rng = np.random.default_rng(5)
        x = rng.standard_normal(512)
        tbl.publish(g, 0, {"x": x, "p": np.array([1.0]),
                           "round": np.array([0.0])})
        t1 = t2 = leaf = None
        try:
            t1, t2 = self._chain(
                rel, addr, g, fallbacks=[addr],
                reconnect=dict(base_s=0.05, budget=3, seed=0))
            got = []
            leaf = ends.sub.Subscriber(t2.address, g, delta=True,
                                       on_snapshot=lambda s: got.append(s))
            _publish_rounds(tbl, g, x, rng, 1, 10)
            # kill the mid-tree relay: t2 exhausts its uplink budget,
            # re-parents to the root (cursor kept), and the leaf's
            # delivered rounds stay strictly increasing
            t1.close()
            t1 = None
            _publish_rounds(tbl, g, x, rng, 10, 26, dt=0.06)
            assert _wait(lambda: got and got[-1].round == 25, 30.0, 0.05), \
                [s.round for s in got][-5:]
            rounds = [s.round for s in got]
            assert rounds == sorted(set(rounds)), \
                f"duplicated or regressed after the re-parent: {rounds}"
            assert t2.reparents >= 1
            for s in got:
                assert float(s["round"][0]) == s.round
        finally:
            for closer in (leaf, t2, t1):
                if closer is not None:
                    closer.close()
            srv.stop()

    def test_chaos_matrix_on_two_tier_chain(self, chain):
        """``read:``/``sub:``/``relay:`` faults against the whole tree: torn
        pushes, stalled re-publishes, dropped relay lands; delivered rounds
        stay strictly increasing with exact stamps at the leaf."""
        ends, rel = chain
        tbl = ends.snap.SnapshotTable()
        srv, addr = _serve(ends, tbl)
        g = _uniq("cmx")
        rng = np.random.default_rng(6)
        x = rng.standard_normal(512)
        tbl.publish(g, 0, {"x": x, "p": np.array([1.0]),
                           "round": np.array([0.0])})
        _both("sub:truncate:every=9;relay:drop:every=7;"
              "relay:delay:ms=20:every=5;read:stall:s=0.1:every=11")
        t1 = t2 = leaf = None
        try:
            t1, t2 = self._chain(
                rel, addr, g, fallbacks=[addr],
                reconnect=dict(base_s=0.05, budget=6, seed=0))
            got = []
            leaf = ends.sub.Subscriber(
                t2.address, g, delta=True,
                reconnect=dict(base_s=0.05, budget=8, seed=1),
                on_snapshot=lambda s: got.append(s))
            _publish_rounds(tbl, g, x, rng, 1, 30, dt=0.05)
            assert _wait(lambda: got and got[-1].round >= 27, 30.0, 0.05), \
                [s.round for s in got][-5:]
            rounds = [s.round for s in got]
            assert rounds == sorted(set(rounds)), rounds
            for s in got:
                assert float(s["round"][0]) == s.round
                assert float(s["p"][0]) == s.round + 1.0
        finally:
            for closer in (leaf, t2, t1):
                if closer is not None:
                    closer.close()
            srv.stop()

    def test_relay_refuses_self_loop(self):
        # a relay configured with its own serving address as upstream (a
        # mis-wired tree closing a cycle): refused with the registry's
        # -110 before any wire traffic
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with pytest.raises(RuntimeError, match=str(PS.ERR_RELAY_LOOP)):
            PN.RelayNode(("127.0.0.1", port), ["g"], tier=1,
                         host="127.0.0.1", port=port)
        with pytest.raises(ValueError, match="at least one group"):
            PN.RelayNode(("127.0.0.1", port), [])

    def test_relay_sweeps_idle_groups(self):
        tbl = PSn.SnapshotTable()
        srv, addr = _serve(SIDES["port"], tbl)
        g = _uniq("sweep")
        tbl.publish(g, 1, _stamped(1))
        node = None
        try:
            node = PN.RelayNode(addr, [g], tier=1, idle_ttl_s=0.4)
            node.wait_ready(timeout_s=15)
            # nothing published upstream for longer than the ttl: the
            # relay's sweep evicted the idle group
            assert _wait(lambda: g not in node.table.groups(), 10.0, 0.1)
        finally:
            if node is not None:
                node.close()
            srv.stop()

    def test_relay_drops_replayed_rounds_and_counts_them(self):
        """The land path's forward guard: an upstream replay at or below
        the relay's cursor is dropped, never re-published."""
        tbl = PSn.SnapshotTable()
        srv, addr = _serve(SIDES["port"], tbl)
        g = _uniq("guard")
        tbl.publish(g, 4, _stamped(4))
        node = None
        try:
            node = PN.RelayNode(addr, [g])
            assert node.wait_ready(10) == {g: 4}
            from bluefog_tpu_torch.serving.client import Snapshot

            node._land(g, Snapshot(g, 3, _stamped(3)))
            node._land(g, Snapshot(g, 4, _stamped(4)))
            assert node.dropped_rounds == 2
            assert node.rounds() == {g: 4}
            node._land(g, Snapshot(g, 5, _stamped(5)))
            assert node.rounds() == {g: 5}
        finally:
            if node is not None:
                node.close()
            srv.stop()


def test_relay_cli_runs_and_serves():
    """The standalone relay process: a RELAY_READY line, serves the group,
    exits 0 at --duration."""
    tbl = PSn.SnapshotTable()
    srv, addr = _serve(SIDES["port"], tbl)
    g = _uniq("cli")
    tbl.publish(g, 7, _stamped(7))
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("BLUEFOG_TPU_CHAOS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "bluefog_tpu_torch.relay",
         f"{addr[0]}:{addr[1]}", "--group", g, "--host", "127.0.0.1",
         "--duration", "4", "--degree", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    try:
        line = proc.stdout.readline().strip().split()
        assert line[:1] == ["RELAY_READY"], line
        raddr = (line[1], int(line[2]))
        # both packages' clients read the relayed round
        with PCl.SnapshotClient(raddr, g) as c:
            snap = c.snapshot(min_round=7, wait_s=10.0)
            assert snap.round == 7 and float(snap["round"][0]) == 7.0
        with RCl.SnapshotClient(raddr, g) as c:
            assert c.snapshot(min_round=7, wait_s=10.0).round == 7
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0, out
    finally:
        if proc.poll() is None:
            proc.kill()
        srv.stop()


def test_relay_cli_usage_errors():
    from bluefog_tpu_torch.relay import cli

    with pytest.raises(SystemExit) as ei:
        cli.main(["not-an-address", "--group", "g"])
    assert ei.value.code == 2
    # a bad delta config is a usage error (exit 2), not a crash
    assert cli.main(["127.0.0.1:1", "--group", "g",
                     "--topk-ratio", "0"]) == 2

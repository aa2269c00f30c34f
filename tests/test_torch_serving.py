"""The port's serve-while-training read path (``bluefog_tpu_torch/serving``
and the SNAPSHOT/SUBSCRIBE/DELTA ops of its window server) against the JAX
package's.

The cases of ``tests/test_serving.py`` and the sharded replica of
``tests/test_sharding.py`` on the port.  Every wire case runs over three
pairs: the port on both ends, a port client against a JAX-package server,
and a JAX-package client against a port server (ops 8, 9 and 10; the
pattern of ``test_torch_window_server.py``).  Then:

- the snapshot table's contract (round-consistent reads, pinning, copies
  isolated from later publishes) and the torn-read fuzzer, whose seeded
  races never yield mixed-round leaves;
- the sync-read resilience cases (deadline, bounded retry, latched error,
  no silent re-consume) on the port's ``RemoteWindow``;
- subscriptions: the every-Nth stride, reconnect with every promised
  round delivered exactly once, slow-reader skip, late subscriber,
  keepalives, fast failure, a fuzz of malformed read-path frames;
- the replicas: served parameters bit-equal to the JAX package's
  ``TreePacker.unpack`` of ``x / p``, on the template's device; the
  sharded replica round-consistent under skew and bit-equal to the
  reference's;
- the runners' ``snapshot_every``: the thread runner, and
  ``run_async_dsgd_rank`` over 2 tcp processes under reader chaos with
  port subscriber processes (the reference's acceptance scenario cut to 2
  ranks and 2 readers) and over shm; the example.
"""

import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bluefog_tpu import chaos as RC
from bluefog_tpu.runtime import async_windows as RA
from bluefog_tpu.runtime import delta as RD
from bluefog_tpu.runtime import window_server as RW
from bluefog_tpu.serving import client as RCl
from bluefog_tpu.serving import replica as RRep
from bluefog_tpu.serving import snapshots as RSn
from bluefog_tpu.serving import subscriber as RSub
from bluefog_tpu_torch import chaos as PC
from bluefog_tpu_torch import serving as PServing
from bluefog_tpu_torch import topology as PT
from bluefog_tpu_torch.runtime import async_windows as PA
from bluefog_tpu_torch.runtime import delta as PD
from bluefog_tpu_torch.runtime import window_server as PW
from bluefog_tpu_torch.serving import client as PCl
from bluefog_tpu_torch.serving import replica as PRep
from bluefog_tpu_torch.serving import snapshots as PSn
from bluefog_tpu_torch.serving import subscriber as PSub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_serving_worker.py")

SIDES = {
    "port": SimpleNamespace(ws=PW, snap=PSn, client=PCl, sub=PSub, rep=PRep,
                            delta=PD, chaos=PC),
    "ref": SimpleNamespace(ws=RW, snap=RSn, client=RCl, sub=RSub, rep=RRep,
                           delta=RD, chaos=RC),
}
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


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def pair(request):
    """(server side, client side) of one pairing."""
    srv, cli = request.param
    return SIDES[srv], SIDES[cli]


def _uniq(tag):
    return f"{tag}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


def _serve(side, delta_kw=None):
    """A server of ``side`` over a private snapshot table of its package."""
    tbl = side.snap.SnapshotTable()
    delta = side.delta.DeltaConfig(**delta_kw) if delta_kw else None
    srv = side.ws.WindowServer(snapshots=tbl, delta=delta)
    addr = srv.start("127.0.0.1")
    return srv, addr, tbl


def _both(spec):
    PC.configure(spec)
    RC.configure(spec)


def _stamped(rnd, dim=64, base=None):
    v = float(rnd)
    x = np.full(dim, v) if base is None else np.asarray(base, float)
    return {"x": x, "p": np.array([v + 1.0]), "round": np.array([v])}


def _wait(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _recv_exactly(sock, n):
    buf = b""
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        assert got, "server closed mid-reply"
        buf += got
    return buf


# ---------------------------------------------------------------------------
# the snapshot table
# ---------------------------------------------------------------------------

class TestSnapshotTable:
    def test_publish_read_round_consistent(self):
        tbl = PSn.SnapshotTable()
        g = _uniq("tbl")
        with pytest.raises(PSn.SnapshotUnavailable):
            tbl.read(g)
        tbl.publish(g, 3, _stamped(3))
        rnd, leaves = tbl.read(g)
        assert rnd == 3
        got = dict(leaves)
        assert (got["x"] == 3.0).all() and got["round"][0] == 3.0
        assert [n for n, _ in leaves] == ["p", "round", "x"]  # sorted
        rnd, leaves = tbl.read(g, ["p"])
        assert rnd == 3 and leaves[0][0] == "p"
        with pytest.raises(PSn.SnapshotUnavailable):
            tbl.read(g, ["nope"])
        # pin the live round: fine; pin a stale one: a retriable roll
        assert tbl.read(g, want_round=3)[0] == 3
        tbl.publish(g, 4, _stamped(4))
        with pytest.raises(PSn.RoundRolled) as ei:
            tbl.read(g, want_round=3)
        assert ei.value.current_round == 4
        assert tbl.current_round(g) == 4
        assert tbl.generation(g) == 2
        tbl.drop(g)
        assert tbl.current_round(g) == -1 and tbl.generation(g) == 0

    def test_non_float_leaves_rejected(self):
        with pytest.raises(TypeError, match="f32/f64"):
            PSn.table().publish(_uniq("tbl_dtype"), 0,
                                {"x": np.arange(4, dtype=np.int32)})
        with pytest.raises(ValueError, match="at least one leaf"):
            PSn.table().publish(_uniq("tbl_empty"), 0, {})

    def test_reader_copy_is_isolated_from_later_publishes(self):
        tbl = PSn.table()
        g = _uniq("tbl_copy")
        tbl.publish(g, 0, _stamped(0))
        _, leaves = tbl.read(g)
        held = dict(leaves)["x"]
        for rnd in range(1, 4):
            tbl.publish(g, rnd, _stamped(rnd))
        assert (held == 0.0).all()  # a served copy can never mutate
        tbl.drop(g)

    def test_reads_match_the_reference_table(self):
        """The same publishes into both packages' tables read back the
        same rounds, leaves, generations and errors."""
        tables = [PSn.SnapshotTable(), RSn.SnapshotTable()]
        rng = np.random.default_rng(3)
        g = "same"
        for rnd in range(5):
            leaves = {"x": rng.standard_normal(7),
                      "w": rng.standard_normal(3).astype(np.float32),
                      "round": np.array([float(rnd)])}
            if rnd == 3:
                del leaves["w"]  # a leaf set that shrinks
            for t in tables:
                t.publish(g, rnd, leaves)
            got = [t.read(g) for t in tables]
            assert got[0][0] == got[1][0] == rnd
            assert [n for n, _ in got[0][1]] == [n for n, _ in got[1][1]]
            for (_, a), (_, b) in zip(got[0][1], got[1][1]):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert [t.generation(g) for t in tables] == [5, 5]
        assert [t.groups() for t in tables] == [[g], [g]]
        assert tables[0].trace_ctx(g) is None

    def test_default_server_serves_the_process_global_table(self):
        g = _uniq("global")
        srv = PW.WindowServer()
        addr = srv.start("127.0.0.1")
        try:
            assert srv.snapshots is PServing.table()
            PServing.table().publish(g, 2, _stamped(2))
            with PCl.SnapshotClient(addr, g) as c:
                assert c.snapshot().round == 2
        finally:
            srv.stop()
            PServing.table().drop(g)


# ---------------------------------------------------------------------------
# SNAPSHOT (op 8) over the three pairs
# ---------------------------------------------------------------------------

class TestSnapshotWire:
    def test_snapshot_roundtrip_and_min_round(self, pair):
        srv_side, cli_side = pair
        srv, addr, tbl = _serve(srv_side)
        g = _uniq("wire")
        try:
            c = cli_side.client.SnapshotClient(addr, g)
            # nothing published yet: retriable
            with pytest.raises(cli_side.snap.SnapshotUnavailable):
                c.snapshot()
            tbl.publish(g, 5, _stamped(5))
            snap = c.snapshot()
            assert snap.round == 5
            assert (snap["x"] == 5.0).all()
            assert int(snap["round"][0]) == 5
            assert sorted(snap.leaves) == ["p", "round", "x"]
            # a leaf subset, in the order asked
            sub = c.snapshot(names=["round", "p"])
            assert list(sub.leaves) == ["round", "p"] and sub.round == 5
            # min_round: stale serves rejected after the wait budget
            with pytest.raises(cli_side.snap.SnapshotUnavailable,
                               match="stale"):
                c.snapshot(min_round=9, wait_s=0.2)
            tbl.publish(g, 9, _stamped(9))
            assert c.snapshot(min_round=9).round == 9
            c.close()
        finally:
            srv.stop()

    def test_pinned_read_rolls_retriably(self, pair):
        srv_side, cli_side = pair
        srv, addr, tbl = _serve(srv_side)
        g = _uniq("pin")
        try:
            tbl.publish(g, 1, _stamped(1))
            c = cli_side.client.SnapshotClient(addr, g)
            assert c.snapshot(pin_round=1).round == 1
            tbl.publish(g, 2, _stamped(2))
            with pytest.raises(cli_side.snap.RoundRolled):
                c.snapshot(pin_round=1)
            # the protocol: re-pin at the new round and continue
            assert c.snapshot(pin_round=2).round == 2
            c.close()
        finally:
            srv.stop()

    def test_torn_read_fuzzer_never_mixes_rounds(self, pair):
        """A publisher rolling rounds as fast as it can races concurrent
        SNAPSHOT reads; every reply must be entirely one round (every leaf
        value equals the reply's round stamp).  60 seeded interleavings."""
        srv_side, cli_side = pair
        srv, addr, tbl = _serve(srv_side)
        g = _uniq("fuzz_torn")
        dim = 512
        reads = [0]
        try:
            c = cli_side.client.SnapshotClient(addr, g)
            for seed in range(60):
                rng = np.random.default_rng(seed)
                rounds = int(rng.integers(10, 40))

                def publisher():
                    for rnd in range(rounds):
                        v = float(rnd)
                        tbl.publish(g, rnd, {
                            "x": np.full(dim, v), "p": np.array([v]),
                            "round": np.array([v])})
                        if rng.random() < 0.3:
                            time.sleep(float(rng.random()) * 5e-4)

                t = threading.Thread(target=publisher)
                t.start()
                while t.is_alive():
                    try:
                        snap = c.snapshot()
                    except cli_side.snap.SnapshotUnavailable:
                        continue
                    r = float(snap.round)
                    x = snap["x"]
                    # all of one round, exactly: a torn mix would break
                    # one of these equalities
                    assert float(snap["round"][0]) == r, seed
                    assert float(snap["p"][0]) == r, seed
                    assert x[0] == r and (x == x[0]).all(), seed
                    reads[0] += 1
                t.join()
                tbl.drop(g)  # the next seed restarts its round counter
            assert reads[0] >= 120, f"only {reads[0]} racing reads"
            c.close()
        finally:
            srv.stop()

    def test_client_survives_torn_reply(self, pair):
        """Chaos ``read:truncate`` tears the reply mid-frame: the client
        recovers on a fresh connection and never consumes the fragment."""
        srv_side, cli_side = pair
        srv, addr, tbl = _serve(srv_side)
        g = _uniq("torn_reply")
        try:
            tbl.publish(g, 7, _stamped(7))
            _both("read:truncate:after_frames=1")
            c = cli_side.client.SnapshotClient(
                addr, g, retry=dict(base_s=0.01, cap_s=0.05, budget=5,
                                    seed=0))
            snap = c.snapshot()
            assert snap.round == 7 and (snap["x"] == 7.0).all()
            assert srv_side.chaos.get().stats()[0][1] == 1
            c.close()
        finally:
            srv.stop()

    def test_snapshot_replies_are_byte_equal_across_servers(self):
        """The same request against a port and a JAX-package server over
        the same snapshot: the same reply bytes, the statuses included."""
        rng = np.random.default_rng(11)
        leaves = {"x": rng.standard_normal(33),
                  "w": rng.standard_normal(5).astype(np.float32),
                  "round": np.array([4.0])}
        replies = []
        for side in (SIDES["port"], SIDES["ref"]):
            srv, addr, tbl = _serve(side)
            tbl.publish("g:0", 4, leaves)
            try:
                got = []
                for pin, names in ((-1, ()), (4, ("w", "round")),
                                   (3, ()), (-1, ("nope",))):
                    with socket.create_connection(addr, timeout=10) as s:
                        s.sendall(PW._HDR.pack(PW._MAGIC, PW._OP_HELLO, 0)
                                  + PW._HELLO.pack(2, PW.FEATURE_SNAPSHOT))
                        _recv_exactly(s, 8)
                        req = (PW._HDR.pack(PW._MAGIC, PW._OP_SNAPSHOT, 3)
                               + b"g:0" + PW._SNAP_REQ.pack(pin, len(names)))
                        for n in names:
                            req += PW._LEAF_NAME.pack(len(n)) + n.encode()
                        s.sendall(req)
                        (rc,) = PW._STATUS.unpack(_recv_exactly(s, 8))
                        body = b""
                        if rc >= 0:
                            s.shutdown(socket.SHUT_WR)
                            while True:
                                chunk = s.recv(65536)
                                if not chunk:
                                    break
                                body += chunk
                        got.append((rc, body))
                replies.append(got)
            finally:
                srv.stop()
        assert replies[0] == replies[1]
        assert [rc for rc, _ in replies[0]] == [4, 4, -107, -108]


# ---------------------------------------------------------------------------
# sync reads: deadline, bounded retry, latched errors (the port's
# RemoteWindow against its server's read site)
# ---------------------------------------------------------------------------

class TestSyncReadResilience:
    def _win(self, name, val=3.5):
        win = PA.AsyncWindow(name, 1, 4, np.float64)
        win.set_self(np.full(4, val))
        return win

    def _serve_port(self):
        srv = PW.WindowServer()
        return srv, srv.start("127.0.0.1")

    def test_wedged_owner_times_out_not_hangs(self):
        name = _uniq("sync_stall")
        win = self._win(name)
        srv, addr = self._serve_port()
        try:
            PC.configure("read:stall:s=30:after_frames=1")
            rw = PW.RemoteWindow(addr, name, timeout_s=0.6)
            t0 = time.monotonic()
            with pytest.raises(TimeoutError, match="wedged owner"):
                rw.read_self(4)
            assert time.monotonic() - t0 < 10  # a deadline, not a hang
            # and the error latched: the next call refuses at once
            with pytest.raises(RuntimeError, match="latched"):
                rw.read_self(4)
            rw.close()
        finally:
            PC.reset()
            srv.stop()
            win.free()

    def test_idempotent_read_retries_through_stall(self):
        name = _uniq("sync_retry")
        win = self._win(name, 9.25)
        srv, addr = self._serve_port()
        try:
            # the first reply stalls past the deadline; the retry's fresh
            # connection is frame 2 and sails through
            PC.configure("read:stall:s=30:after_frames=1")
            rw = PW.RemoteWindow(addr, name, timeout_s=0.6,
                                 retry=dict(base_s=0.01, cap_s=0.05,
                                            budget=4, seed=0))
            np.testing.assert_allclose(rw.read_self(4), 9.25)
            # a truncated reply is recovered the same way
            PC.configure("read:truncate:after_frames=1")
            got, fresh = rw.read(0, 4, consume=False)
            assert fresh == 0
            rw.close()
        finally:
            PC.reset()
            srv.stop()
            win.free()

    def test_budget_exhaustion_latches(self):
        name = _uniq("sync_latch")
        win = self._win(name)
        srv, addr = self._serve_port()
        try:
            PC.configure("read:drop:every=1")  # every read reply dies
            rw = PW.RemoteWindow(addr, name, timeout_s=1.0,
                                 retry=dict(base_s=0.01, cap_s=0.02,
                                            budget=2, seed=0))
            with pytest.raises(RuntimeError, match="budget"):
                rw.read_self(4)
            with pytest.raises(RuntimeError, match="latched"):
                rw.read_self(4)
            rw.close()
        finally:
            PC.reset()
            srv.stop()
            win.free()

    def test_consuming_read_is_never_silently_retried(self):
        name = _uniq("sync_consume")
        win = self._win(name)
        srv, addr = self._serve_port()
        try:
            PC.configure("read:drop:after_frames=1")
            rw = PW.RemoteWindow(addr, name, timeout_s=1.0,
                                 retry=dict(base_s=0.01, budget=4))
            # a consume read is not idempotent: the drop surfaces as a
            # connection error instead of a silent re-consume
            with pytest.raises((ConnectionError, RuntimeError)):
                rw.read(0, 4, consume=True)
            rw.close()
        finally:
            PC.reset()
            srv.stop()
            win.free()


# ---------------------------------------------------------------------------
# SUBSCRIBE (op 9) and DELTA (op 10) over the three pairs
# ---------------------------------------------------------------------------

class TestSubscriptions:
    def test_every_nth_round_stride(self, pair):
        srv_side, cli_side = pair
        srv, addr, tbl = _serve(srv_side)
        g = _uniq("sub_nth")
        got = []
        try:
            sub = cli_side.sub.Subscriber(
                addr, g, every=3, on_snapshot=lambda s: got.append(s.round))
            time.sleep(0.2)
            for rnd in range(30):
                tbl.publish(g, rnd, _stamped(rnd))
                time.sleep(0.01)
            time.sleep(0.5)
            sub.close()
            assert got, "no rounds delivered"
            assert got == sorted(set(got))  # strictly increasing
            for a, b in zip(got, got[1:]):
                assert b - a >= 3, got  # the promised stride
        finally:
            srv.stop()

    def test_reconnect_resumes_exactly_once_per_promised_round(self, pair):
        """Chaos cuts the push channel repeatedly; the cursor and the epoch
        quiesce make delivery exactly once: rounds strictly increasing
        across every resume, and delivery goes on after each cut."""
        srv_side, cli_side = pair
        srv, addr, tbl = _serve(srv_side)
        g = _uniq("sub_resume")
        got = []
        try:
            _both("sub:drop:every=5")
            sub = cli_side.sub.Subscriber(
                addr, g, every=1, on_snapshot=lambda s: got.append(s.round),
                reconnect=dict(base_s=0.02, cap_s=0.1, budget=8, seed=1),
                idle_timeout_s=2.0)
            time.sleep(0.2)
            for rnd in range(40):
                tbl.publish(g, rnd, _stamped(rnd))
                time.sleep(0.03)
            time.sleep(1.0)
            resumes, err = sub.resumes, sub.error
            sub.close()
            assert err is None, err
            assert resumes >= 1, "chaos never forced a resume"
            assert len(got) >= 8, got
            assert got == sorted(set(got)), (
                f"duplicated or regressed rounds across resumes: {got}")
            assert got[-1] >= 30, got  # delivery continued after the cuts
        finally:
            srv.stop()

    def test_slow_reader_skips_but_never_blocks_publisher(self, pair):
        srv_side, cli_side = pair
        srv, addr, tbl = _serve(srv_side)
        g = _uniq("sub_slow")
        got = []
        rounds = 20
        # model-sized frames: small ones vanish into the kernel's socket
        # buffers and a lagging reader is invisible
        big = np.zeros(1 << 20, np.float64)

        def slow(snap):
            got.append(snap.round)
            time.sleep(0.05)  # a consumer ~10x slower than the publisher

        try:
            sub = cli_side.sub.Subscriber(addr, g, every=1, on_snapshot=slow,
                                          queue_max=2)
            time.sleep(0.2)
            t0 = time.monotonic()
            for rnd in range(rounds):
                v = float(rnd)
                big[0] = v
                tbl.publish(g, rnd, {"x": big, "p": np.array([v]),
                                     "round": np.array([v])})
                time.sleep(0.005)
            publish_wall = time.monotonic() - t0
            # skip-to-latest: the publisher keeps its own cadence
            assert publish_wall < 2.0, publish_wall
            time.sleep(1.5)
            skipped = sub.skipped_rounds
            sub.close()
            assert got == sorted(set(got)), got
            assert skipped > 0, "the slow reader never skipped"
            assert len(got) < rounds, "a slow consumer cannot see all"
        finally:
            srv.stop()

    def test_late_subscriber_catches_up_to_current_round(self, pair):
        srv_side, cli_side = pair
        srv, addr, tbl = _serve(srv_side)
        g = _uniq("sub_late")
        try:
            for rnd in range(6):
                tbl.publish(g, rnd, _stamped(rnd))
            # all publishing is done before the subscriber exists
            sub = cli_side.sub.Subscriber(addr, g, every=1)
            snap = sub.get(timeout_s=5.0)
            assert snap is not None and snap.round == 5, snap
            sub.close()
        finally:
            srv.stop()

    def test_keepalives_flow_while_pushes_not_due(self, pair):
        """A steady stream of publishes that are not due (a large stride)
        must not starve the keepalive cadence."""
        srv_side, cli_side = pair
        srv, addr, tbl = _serve(srv_side)
        g = _uniq("sub_idle")
        try:
            sub = cli_side.sub.Subscriber(
                addr, g, every=1000, idle_timeout_s=1.2,
                reconnect=dict(base_s=0.02, budget=4))
            deadline = time.monotonic() + 3.0
            rnd = 0
            while time.monotonic() < deadline:
                tbl.publish(g, rnd, _stamped(rnd))
                rnd += 1
                time.sleep(0.15)  # publishes flow, pushes are never due
            assert sub.error is None, sub.error
            assert sub.resumes == 0, \
                "the idle timeout tripped on a healthy connection"
            sub.close()
        finally:
            srv.stop()

    def test_delta_subscription_stays_round_exact(self, pair):
        srv_side, cli_side = pair
        srv, addr, tbl = _serve(srv_side, dict(full_every=4, codec="topk",
                                               min_delta_elems=64))
        g = _uniq("dwire")
        rng = np.random.default_rng(2)
        x = rng.standard_normal(1024)
        tbl.publish(g, 0, _stamped(0, base=x))
        got = []
        sub = cli_side.sub.Subscriber(addr, g, delta=True,
                                      on_snapshot=lambda s: got.append(s))
        try:
            for rnd in range(1, 12):
                x = x + 0.01 * rng.standard_normal(1024)
                tbl.publish(g, rnd, _stamped(rnd, base=x))
                time.sleep(0.03)
            assert _wait(lambda: got and got[-1].round == 11)
            rounds = [s.round for s in got]
            assert rounds == sorted(set(rounds))
            assert sub.delta_frames > 0, "deltas never engaged"
            for s in got:
                # the exactness floor: the stamp and the mass ride dense
                assert float(s["round"][0]) == s.round
                assert float(s["p"][0]) == s.round + 1.0
        finally:
            sub.close()
            srv.stop()

    def test_delta_stream_reconstruction_is_bit_equal_to_the_encoders(
            self, pair):
        """Every round of a delta stream, as the subscriber delivers it, is
        bit-equal to a local encoder-applier pair of the server's package
        fed the same sequence (the whole stream pushed, none skipped)."""
        srv_side, cli_side = pair
        kw = dict(full_every=3, codec="topk", topk_ratio=0.1,
                  min_delta_elems=32)
        srv, addr, tbl = _serve(srv_side, kw)
        g = _uniq("dbits")
        rng = np.random.default_rng(5)
        x = rng.standard_normal(700)
        seq = []
        got = []
        sub = cli_side.sub.Subscriber(addr, g, delta=True, queue_max=64,
                                      on_snapshot=lambda s: got.append(s))
        try:
            for rnd in range(10):
                x = x + 0.02 * rng.standard_normal(700)
                leaves = _stamped(rnd, base=x)
                seq.append((rnd, leaves))
                tbl.publish(g, rnd, leaves)
                # one push a round: wait for it before the next publish
                assert _wait(lambda: got and got[-1].round == rnd), rnd
        finally:
            sub.close()
            srv.stop()
        enc = srv_side.delta.DeltaEncoder()
        app = srv_side.delta.DeltaApplier(g)
        cfg = srv_side.delta.DeltaConfig(**kw)
        for (rnd, leaves), snap in zip(seq, got):
            lv = sorted(leaves.items())
            kind, base, items = enc.step(rnd, lv, cfg)
            if kind == 0:
                app.anchor(rnd, dict(lv))
                want = {n: np.ascontiguousarray(a).reshape(-1)
                        for n, a in lv}
            else:
                want = app.apply(rnd, base, [
                    (n, d, c, ne, memoryview(b"".join(bytes(v) for v in vs)))
                    for (n, d, c, ne, vs, _w) in items])
            assert snap.round == rnd
            for n, a in want.items():
                assert snap[n].tobytes() == a.tobytes(), (rnd, n)
        assert sub.delta_frames > 0

    def test_torn_delta_never_advances_cursor_and_resyncs(self, pair):
        srv_side, cli_side = pair
        srv, addr, tbl = _serve(srv_side, dict(full_every=100,
                                               min_delta_elems=64))
        g = _uniq("dtorn")
        rng = np.random.default_rng(3)
        x = rng.standard_normal(2048)
        tbl.publish(g, 0, _stamped(0, base=x))
        got = []
        # tear the push channel mid-frame on the 4th push: with
        # full_every=100 the torn frame is a delta; the cursor must not
        # move, and the resumed stream resyncs through a full anchor
        _both("sub:truncate:after_frames=4")
        sub = cli_side.sub.Subscriber(
            addr, g, delta=True, reconnect=dict(base_s=0.05, budget=8,
                                                seed=0),
            on_snapshot=lambda s: got.append(s))
        try:
            for rnd in range(1, 14):
                x = x + 0.01 * rng.standard_normal(2048)
                tbl.publish(g, rnd, _stamped(rnd, base=x))
                time.sleep(0.05)
            assert _wait(lambda: got and got[-1].round == 13, 15.0)
            rounds = [s.round for s in got]
            assert rounds == sorted(set(rounds)), \
                f"duplicate or regressed delivery: {rounds}"
            assert sub.resumes >= 1, "the cut never resumed"
            for s in got:
                assert float(s["round"][0]) == s.round
        finally:
            sub.close()
            srv.stop()

    def test_plain_subscriber_unaffected_by_delta_server(self, pair):
        srv_side, cli_side = pair
        srv, addr, tbl = _serve(srv_side, dict(full_every=2))
        g = _uniq("dplain")
        tbl.publish(g, 3, _stamped(3))
        got = []
        sub = cli_side.sub.Subscriber(addr, g,
                                      on_snapshot=lambda s: got.append(s))
        try:
            assert _wait(lambda: got)
            assert got[0].round == 3 and (got[0]["x"] == 3.0).all()
            assert sub.delta_frames == 0
        finally:
            sub.close()
            srv.stop()

    def test_fanout_limit_refuses_retriably(self, pair):
        srv_side, cli_side = pair
        srv, addr, tbl = _serve(srv_side)
        srv.set_fanout_limit(1)
        g = _uniq("fanout")
        tbl.publish(g, 1, _stamped(1))
        first = cli_side.sub.Subscriber(addr, g)
        got = []
        try:
            assert _wait(lambda: first.cursor >= 1)
            # the second subscription is over the degree limit: refused
            # with ERR_BUSY (retriable); with reconnect off it latches as
            # an error, never a crash
            second = cli_side.sub.Subscriber(
                addr, g, reconnect=False, on_snapshot=lambda s: got.append(s))
            assert _wait(lambda: second.error is not None)
            assert not got
            second.close()
            # a freed slot admits the next reader
            first.close()
            third = cli_side.sub.Subscriber(addr, g)
            assert _wait(lambda: third.cursor == 1)
            third.close()
        finally:
            first.close()
            srv.stop()


class TestSubscriberFailures:
    def test_replica_surfaces_subscription_failure_fast(self):
        srv = PW.WindowServer()
        addr = srv.start("127.0.0.1")
        srv.stop()  # nothing listening: the subscription must die fast
        rep = PRep.ServingReplica(addr, _uniq("rep_dead"),
                                  reconnect=dict(base_s=0.01, cap_s=0.02,
                                                 budget=2))
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="failed before"):
            rep.wait_ready(timeout_s=30.0)
        assert time.monotonic() - t0 < 10  # promptly, not at the timeout
        rep.close()

    def test_subscriber_latches_when_trainer_gone(self):
        srv = PW.WindowServer()
        addr = srv.start("127.0.0.1")
        srv.stop()  # nothing listening any more
        sub = PSub.Subscriber(addr, _uniq("sub_dead"),
                              reconnect=dict(base_s=0.01, cap_s=0.02,
                                             budget=3, seed=0))
        with pytest.raises(RuntimeError, match="budget|unreachable"):
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                sub.get(timeout_s=0.5)
        sub.close()

    def test_subscription_is_refused_by_a_server_without_the_feature(self):
        """A server that does not grant FEATURE_SUBSCRIBE (a HELLO reply
        without bit 64) latches a loud rejection, never a retry loop."""
        lsock = socket.socket()
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(1)
        addr = lsock.getsockname()

        def old_server():
            conn, _ = lsock.accept()
            with conn:
                _recv_exactly(conn, PW._HDR.size + PW._HELLO.size)
                conn.sendall(PW._STATUS.pack(PW.FEATURE_BATCH))
                time.sleep(0.5)

        t = threading.Thread(target=old_server, daemon=True)
        t.start()
        sub = PSub.Subscriber(addr, "g")
        try:
            assert _wait(lambda: sub.error is not None)
            assert "does not serve subscriptions" in sub.error
        finally:
            sub.close()
            lsock.close()
            t.join(timeout=5)


# ---------------------------------------------------------------------------
# malformed / truncated read-path frames
# ---------------------------------------------------------------------------

def _valid_snapshot_request(group_b):
    return (PW._HDR.pack(PW._MAGIC, PW._OP_SNAPSHOT, len(group_b))
            + group_b + PW._SNAP_REQ.pack(-1, 2)
            + PW._LEAF_NAME.pack(1) + b"x" + PW._LEAF_NAME.pack(1) + b"p")


def _valid_subscribe_request(group_b):
    return (PW._HDR.pack(PW._MAGIC, PW._OP_SUBSCRIBE, len(group_b))
            + group_b + PW._SUB_REQ.pack(77, 1, 1, -1))


def test_fuzz_malformed_snapshot_and_subscribe_frames():
    """Truncated, bit-flipped and absurd-length SNAPSHOT/SUBSCRIBE frames
    never take the serving process down: at worst the one connection
    drops, and a fresh reader right after works."""
    srv, addr, tbl = _serve(SIDES["port"])
    g = _uniq("fuzz_frames")
    gb = g.encode()
    rng = np.random.default_rng(23)
    tbl.publish(g, 4, _stamped(4))
    try:
        for trial in range(60):
            base = (_valid_snapshot_request(gb) if trial % 2 == 0
                    else _valid_subscribe_request(gb))
            blob = bytearray(base)
            mode = trial % 3
            if mode == 0:  # truncate anywhere
                blob = blob[:int(rng.integers(1, len(blob)))]
            elif mode == 1:  # flip bytes after the magic
                for _ in range(int(rng.integers(1, 6))):
                    i = int(rng.integers(PW._HDR.size, len(blob)))
                    blob[i] = int(rng.integers(0, 256))
            else:  # absurd claimed leaf counts
                off = PW._HDR.size + len(gb)
                blob[off:off + PW._SNAP_REQ.size] = PW._SNAP_REQ.pack(
                    int(rng.integers(-1, 2)), 0xFFFF)
            with socket.create_connection(addr, timeout=10) as s:
                s.settimeout(5)
                try:
                    s.sendall(blob)
                    s.shutdown(socket.SHUT_WR)
                    while s.recv(4096):
                        pass
                except OSError:
                    pass  # a torn connection either way: allowed
        with PCl.SnapshotClient(addr, g) as c:
            snap = c.snapshot(min_round=4)
            assert snap.round == 4 and (snap["x"] == 4.0).all()
    finally:
        srv.stop()


def test_reader_recv_bounds_reject_lying_headers():
    """A leaf header claiming more than the bound, an unknown dtype or an
    unknown codec is refused before any allocation, by both readers."""
    a, b = socket.socketpair()
    try:
        for frame, recv in (
                (PW._SNAP_LEAF.pack(1, 1, (1 << 31) // 8 + 1),
                 PW._recv_leaves),
                (PW._SNAP_LEAF.pack(1, 9, 4), PW._recv_leaves),
                (PW._DELTA_LEAF.pack(1, 1, 7, 4, 32), PW._recv_delta_leaves),
                (PW._DELTA_LEAF.pack(1, 1, 0, 4, 1 << 20),
                 PW._recv_delta_leaves)):
            a.sendall(frame)
            with pytest.raises(ValueError, match="out of bounds"):
                recv(b, 1)
    finally:
        a.close()
        b.close()


def test_chaos_spec_covers_reader_sites():
    """The port's chaos grammar validates the read-path sites."""
    from bluefog_tpu_torch.chaos import cli, parse_spec

    rules = parse_spec("read:truncate:every=7;sub:stall:s=0.25:every=3;"
                       "read:stall:s=2:prob=0.05;sub:drop:after_frames=9;"
                       "relay:drop:every=4")
    assert [r.site for r in rules] == ["read", "sub", "read", "sub", "relay"]
    assert cli.main(["--spec", "read:drop:every=4;sub:truncate:every=6",
                     "--explain"]) == 0
    assert cli.main(["--spec", "reed:drop", "--explain"]) == 2


# ---------------------------------------------------------------------------
# the replicas
# ---------------------------------------------------------------------------

def _tree_template():
    """A small conv net's parameters, keys in sorted order (JAX's leaf
    order, so both packages lay the vector out alike)."""
    rng = np.random.default_rng(9)
    shapes = {"bias": (4,), "conv": (4, 3, 3, 3), "fc": (10, 4)}
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}


@pytest.mark.parametrize("srv_name", ["port", "ref"])
def test_replica_params_bit_equal_to_the_reference_unpack(srv_name):
    """A port replica's served parameters, for a dsgd snapshot served by
    either package, are bit-equal to the JAX package's ``TreePacker``
    unpack of ``x / p``, and lie on the template's device."""
    srv, addr, tbl = _serve(SIDES[srv_name])
    g = _uniq("rep_bits")
    template = _tree_template()
    n = sum(v.numel() for v in template.values())
    rng = np.random.default_rng(4)
    rep = PRep.ServingReplica(addr, g, template)
    try:
        for rnd in range(3):
            x = rng.standard_normal(n) * 3.0
            p = float(0.5 + rng.random())
            tbl.publish(g, rnd, {"x": x, "p": np.array([p]),
                                 "round": np.array([float(rnd)])})
            assert _wait(lambda: rep.round == rnd)
            served_round, z = rep.served()
            assert served_round == rnd
            np.testing.assert_array_equal(z, x / p)
            got = rep.params()
            want = RA.TreePacker({k: v.numpy() for k, v in template.items()},
                                 np.float64).unpack(x / p, as_jax=False)
            for k in template:
                assert isinstance(got[k], torch.Tensor)
                assert got[k].device == template[k].device
                assert got[k].dtype == template[k].dtype
                assert got[k].numpy().tobytes() == np.asarray(
                    want[k]).tobytes(), k
        # a template-free replica serves the flat z
        flat = PRep.ServingReplica(addr, g)
        try:
            flat.wait_ready(10)
            np.testing.assert_array_equal(flat.params(), rep.served()[1])
        finally:
            flat.close()
        assert rep.staleness_rounds(5) == 3
    finally:
        rep.close()
        srv.stop()


def test_replica_params_match_the_reference_replica():
    """The port's and the JAX package's replicas on one port server serve
    the same model for the same rounds (the reference's unpacked to numpy,
    the port's to tensors): bit-equal."""
    srv, addr, tbl = _serve(SIDES["port"])
    g = _uniq("rep_pair")
    template = _tree_template()
    n = sum(v.numel() for v in template.values())
    ptmpl = template
    rtmpl = {k: v.numpy() for k, v in template.items()}
    reps = [PRep.ServingReplica(addr, g, ptmpl, delta=True),
            RRep.ServingReplica(addr, g, rtmpl, delta=True)]
    rng = np.random.default_rng(6)
    try:
        for rnd in range(4):
            x = rng.standard_normal(n)
            tbl.publish(g, rnd, {"x": x, "p": np.array([2.0]),
                                 "round": np.array([float(rnd)])})
            assert _wait(lambda: all(r.round == rnd for r in reps))
            pg, rg = reps[0].params(), reps[1].params(as_jax=False)
            for k in template:
                assert pg[k].numpy().tobytes() == np.asarray(
                    rg[k]).tobytes(), (rnd, k)
    finally:
        for r in reps:
            r.close()
        srv.stop()


AXES = {"fsdp": 2, "tp": 2}


def _shard_params():
    """The reference sharding test's tree (keys sorted: JAX's order)."""
    rng = np.random.default_rng(7)
    return {
        "blk": {
            "down": {"kernel": rng.standard_normal((8, 4))},
            "ln": {"count": np.zeros(()), "scale": np.ones((4,))},
            "up": {"bias": rng.standard_normal((8,)),
                   "kernel": rng.standard_normal((4, 8))},
        },
        "emb": {"kernel": rng.standard_normal((8, 4))},
    }


def _shard_rules(Pc):
    return [(r"up/kernel$", Pc(None, "tp")), (r"down/kernel$", Pc("tp", None)),
            (r"emb/kernel$", Pc("fsdp", None)), (".*", Pc())]


def _flat_tree(tree):
    from torch.utils import _pytree as pytree

    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in pytree.tree_leaves(tree)])


class TestShardedServingReplica:
    def _publish(self, tbl, group, rnd, template, specs, scale=1.0,
                 coords=None):
        from bluefog_tpu_torch.sharding import ShardView, inner_coords

        scaled = {k: v * scale for k, v in _flat_items(template)}
        for ci, coord in enumerate(inner_coords(AXES)):
            if coords is not None and ci not in coords:
                continue
            view = ShardView(specs=specs, axes=AXES, coord=coord)
            vec = PA.TreePacker(template, np.float64, sharding=view).pack(
                _unflat(template, scaled))
            tbl.publish(f"{group}:{ci}", rnd,
                        {"x": vec, "p": np.array([1.0]),
                         "round": np.array([float(rnd)])})

    def test_round_consistent_reassembly_under_skew(self):
        from bluefog_tpu_torch.sharding import RuleTable
        from bluefog_tpu_torch.sharding import PartitionSpec as P

        template = _torch_tree(_shard_params())
        rules = RuleTable(_shard_rules(P), axes=AXES)
        specs = rules.resolve_tree(template)
        srv, addr, tbl = _serve(SIDES["port"])
        g = _uniq("shard_replica")
        rep = None
        try:
            self._publish(tbl, g, 5, template, specs)
            rep = PRep.ShardedServingReplica(addr, g, template, rules, AXES,
                                             timeout_s=5.0)
            assert rep.wait_ready(20.0) == 5
            np.testing.assert_array_equal(_flat_tree(rep.params()),
                                          _flat_tree(template))
            # skew: one coordinate advances to round 6; serving never
            # mixes rounds, so the served round stays 5
            self._publish(tbl, g, 6, template, specs, scale=2.0, coords={0})
            time.sleep(0.5)
            assert rep.round == 5
            np.testing.assert_array_equal(_flat_tree(rep.params()),
                                          _flat_tree(template))
            # the stragglers land: round 6 is complete and serves
            self._publish(tbl, g, 6, template, specs, scale=2.0)
            assert _wait(lambda: rep.round == 6, 20.0)
            got = rep.params()
            np.testing.assert_array_equal(_flat_tree(got),
                                          _flat_tree(template) * 2.0)
            for v in _flat_items(got):
                assert isinstance(v[1], torch.Tensor)
            assert rep.staleness_rounds(8) == 2
        finally:
            if rep is not None:
                rep.close()
            srv.stop()

    def test_reassembly_bit_equal_to_the_reference_replica(self):
        """The JAX package's sharded replica against the same port server
        reassembles the same tree, bit for bit."""
        from jax.sharding import PartitionSpec as JP

        from bluefog_tpu.sharding import RuleTable as JTable
        from bluefog_tpu_torch.sharding import RuleTable
        from bluefog_tpu_torch.sharding import PartitionSpec as P

        base = _shard_params()
        template = _torch_tree(base)
        rules = RuleTable(_shard_rules(P), axes=AXES)
        specs = rules.resolve_tree(template)
        srv, addr, tbl = _serve(SIDES["port"])
        g = _uniq("shard_pair")
        reps = []
        try:
            self._publish(tbl, g, 3, template, specs, scale=1.5)
            reps = [PRep.ShardedServingReplica(addr, g, template, rules,
                                               AXES),
                    RRep.ShardedServingReplica(
                        addr, g, base, JTable(_shard_rules(JP), axes=AXES),
                        AXES)]
            assert [r.wait_ready(20.0) for r in reps] == [3, 3]
            a, b = (_flat_tree(r.params()) for r in reps)
            assert a.tobytes() == b.tobytes()
        finally:
            for r in reps:
                r.close()
            srv.stop()


def _flat_items(tree, prefix=""):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _flat_items(v, prefix + k + "/")
        else:
            out.append((prefix + k, v))
    return out


def _unflat(template, flat):
    def walk(t, prefix):
        return {k: walk(v, prefix + k + "/") if isinstance(v, dict)
                else flat[prefix + k] for k, v in t.items()}
    return walk(template, "")


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.asarray(v, np.float64).copy())
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the runners' snapshot_every
# ---------------------------------------------------------------------------

def test_thread_dsgd_publishes_round_stamped_snapshots():
    """``run_async_dsgd(snapshot_every=)`` publishes atomically per round; a
    concurrent wire reader (the port's and the JAX package's clients) sees
    only stamped, self-consistent (x, p, round) triples, the mass audit
    stays exact, and the groups are dropped at the end."""
    name = _uniq("thread_pub")
    srv = PW.WindowServer()
    addr = srv.start("127.0.0.1")
    seen = {"port": [], "ref": []}
    stop = threading.Event()

    def reader(kind, cl):
        c = cl.SnapshotClient(addr, f"{name}:0",
                              retry=dict(base_s=0.01, budget=4, seed=0))
        while not stop.is_set():
            try:
                snap = c.snapshot()
            except (RuntimeError, OSError):
                time.sleep(0.01)
                continue
            assert int(snap["round"][0]) == snap.round, snap.round
            assert float(snap["p"][0]) > 0.0
            seen[kind].append(snap.round)
            time.sleep(0.01)
        c.close()

    threads = [threading.Thread(target=reader, args=("port", PCl)),
               threading.Thread(target=reader, args=("ref", RCl))]
    for t in threads:
        t.start()
    try:
        def loss_and_grad(r, step, params):
            w = params["w"].double()
            return 0.5 * float(w @ w), {"w": w}

        report = PA.run_async_dsgd(
            PT.RingGraph(3), {"w": torch.ones(6)}, loss_and_grad, lr=0.01,
            duration_s=1.5, skew=[0.002] * 3, name=name, snapshot_every=1)
        assert abs(report.total_mass - 3.0) < 1e-9
        assert report.phase_s[0]["publish"] > 0
        assert PServing.table().current_round(f"{name}:0") == -1  # dropped
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        srv.stop()
    for kind, rounds in seen.items():
        assert rounds and rounds == sorted(rounds), (kind, rounds[:10])
        assert rounds[-1] > rounds[0], f"{kind} saw no progress"


def test_thread_dsgd_snapshot_every_stride():
    """``snapshot_every=3`` publishes rounds 0, 3, 6, ... only."""
    name = _uniq("thread_stride")
    tbl = PServing.table()
    rounds = set()
    orig = tbl.publish

    def spy(group, rnd, leaves, **kw):
        if group == f"{name}:1":
            rounds.add(rnd)
            assert leaves["round"][0] == rnd
        return orig(group, rnd, leaves, **kw)

    tbl.publish = spy
    try:
        rep = PA.run_async_dsgd(
            PT.RingGraph(2), {"w": torch.zeros(3)},
            lambda r, s, p: (0.0, {"w": p["w"] - 1.0}), lr=0.1,
            duration_s=1.0, skew=[0.002] * 2, name=name, snapshot_every=3)
    finally:
        del tbl.publish
    assert rounds and all(r % 3 == 0 for r in rounds), sorted(rounds)
    assert rounds >= {0, 3, 6}
    assert abs(rep.total_mass - 2.0) < 1e-12
    with pytest.raises(ValueError, match="snapshot_every"):
        PA.run_async_dsgd(PT.RingGraph(2), {"w": torch.zeros(3)},
                          lambda r, s, p: (0.0, p), name=_uniq("neg"),
                          snapshot_every=-1)


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("BLUEFOG_TPU_CHAOS", None)
    return env


_READER_CHAOS = ("read:truncate:every=5;read:stall:s=0.2:every=9;"
                 "sub:truncate:every=17;sub:stall:s=0.25:every=7")


def test_chaos_acceptance_serving_under_reader_faults():
    """The reference's acceptance scenario at a size inside the guard: 2
    tcp ranks of ``run_async_dsgd_rank(snapshot_every=1)`` publishing
    every round under reader chaos on the serving hosts, 2 port subscriber
    processes, one SIGSTOPped and thawed, the other SIGKILLed.  Every
    delivered snapshot passes the exact round-stamp audit in the
    subscriber processes, the survivor resumed with nothing missed or
    duplicated, and the training audit is exact (total == n, nobody
    dead)."""
    n = 2
    with tempfile.TemporaryDirectory() as bdir:
        name = _uniq("serve_mp")
        tr_env = _env()
        tr_env["BLUEFOG_TPU_CHAOS"] = _READER_CHAOS
        trainers = [subprocess.Popen(
            [sys.executable, WORKER, "train", str(r), str(n), bdir, "3.0",
             name], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=tr_env, cwd=REPO) for r in range(n)]
        subs = [subprocess.Popen(
            [sys.executable, WORKER, "subscribe", str(i), str(n), bdir,
             "2.0", name, str(i)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=_env(), cwd=REPO)
            for i in range(2)]
        try:
            deadline = time.monotonic() + 60
            while not os.path.exists(os.path.join(bdir, "created.0")):
                assert time.monotonic() < deadline, "trainers never started"
                assert all(p.poll() is None for p in trainers), \
                    "a trainer exited before training"
                time.sleep(0.05)
            time.sleep(1.0)
            subs[1].kill()                           # reader death
            os.kill(subs[0].pid, signal.SIGSTOP)     # reader stall...
            time.sleep(0.8)
            os.kill(subs[0].pid, signal.SIGCONT)     # ...and thaw
            t_out = [p.communicate(timeout=60)[0] for p in trainers]
            s_out = [p.communicate(timeout=60)[0] for p in subs]
        except subprocess.TimeoutExpired:
            for p in trainers + subs:
                p.kill()
            pytest.fail("serving acceptance timed out")
    for r, (p, out) in enumerate(zip(trainers, t_out)):
        assert p.returncode == 0, f"trainer {r} failed:\n{out}"
        assert f"TRAIN_OK {r}" in out, out
    assert "AUDIT mass=" in t_out[0], t_out[0]
    assert subs[1].returncode == -9, subs[1].returncode
    assert subs[0].returncode == 0, f"subscriber 0 failed:\n{s_out[0]}"
    assert "SERVE_OK 0" in s_out[0], s_out[0]
    resumed = sum(int(tok.split("=")[1]) for tok in s_out[0].split()
                  if tok.startswith("resumes="))
    # the sub-site chaos cut the push channel: the survivor resumed (and,
    # asserted in the worker, missed and duplicated nothing)
    assert resumed >= 1, s_out[0]


def test_rank_runner_over_shm_serves_from_a_window_server_it_starts():
    """``run_async_dsgd_rank(snapshot_every=1)`` over shm: each rank process
    starts its own ``WindowServer`` over the process-global table, and an
    in-process subscriber audits every frame's stamp; the mass audit is
    exact."""
    n = 2
    with tempfile.TemporaryDirectory() as bdir:
        name = _uniq("serve_shm")
        procs = [subprocess.Popen(
            [sys.executable, WORKER, "train_shm", str(r), str(n), bdir, "2.0",
             name], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=_env(), cwd=REPO) for r in range(n)]
        outs = [p.communicate(timeout=60)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert f"SHM_OK {r} frames=" in out, out
    assert "AUDIT mass=" in outs[0], outs[0]


def test_serving_replica_example_self_asserts():
    """The example is the acceptance demo of the staleness bound, here on
    the CPU: every delivered snapshot round-consistent, the served model
    at most K rounds stale while training progresses, served on the
    device asked for."""
    from bluefog_tpu_torch.examples import serving_replica

    res = serving_replica.main(["--device", "cpu", "--duration", "2.5",
                                "--name", _uniq("ex")])
    assert res["ok"], res["failures"]
    assert res["audit"]["mismatches"] == 0 and res["audit"]["frames"] >= 3


def test_serving_replica_example_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from bluefog_tpu_torch.examples import serving_replica

    with pytest.raises(RuntimeError, match="cuda"):
        serving_replica.main([])

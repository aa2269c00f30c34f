"""The port's TCP window transport (``bluefog_tpu_torch/runtime/
window_server.py``, wire v2) against the JAX package's.

The cases of ``tests/test_window_server.py`` and
``tests/test_window_transport.py`` on the port, each client-server case run
over three pairs: the port on both ends, a port client against a JAX-package
server, and a JAX-package client against a port server, with the window
contents compared bit for bit.  Then the raw-protocol cases on the port's
server (v1 magic and wrong HELLO versions rejected loudly, codec
negotiation, per-item error isolation, deferred acks, a fuzz of malformed
frames, ops 8 and 9 refused with ``ERR_BAD_OP``), the reconnect replay that
applies once (both ways across the packages), the striped and same-host shm
routes, and the signature parity of the one-loop-body transports."""

import inspect
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest

from bluefog_tpu.runtime import async_windows as RA
from bluefog_tpu.runtime import window_server as RW
from bluefog_tpu_torch.runtime import async_windows as PA
from bluefog_tpu_torch.runtime import resilience as PR
from bluefog_tpu_torch.runtime import window_server as PW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (window table and server, client) modules of each pair
SIDES = {"port": (PA, PW), "ref": (RA, RW)}
PAIRS = [("port", "port"), ("ref", "port"), ("port", "ref")]
PAIR_IDS = ["port-port", "refserver-portclient", "portserver-refclient"]


def _name(tag):
    return f"{tag}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def pair(request):
    srv_side, cli_side = request.param
    return SIDES[srv_side][0], SIDES[srv_side][1], SIDES[cli_side][1]


def _serve(ws_mod):
    srv = ws_mod.WindowServer()
    _, port = srv.start("127.0.0.1")
    return srv, port


def _recv_exactly(sock, n):
    buf = b""
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        assert got, "server closed mid-reply"
        buf += got
    return buf


# ---------------------------------------------------------------------------
# client-server cases over the three pairs
# ---------------------------------------------------------------------------


def test_remote_deposit_roundtrip_same_process(pair):
    aw, ws, cli = pair
    name = _name("ws_local")
    win = aw.AsyncWindow(name, n_slots=2, n_elems=6, dtype=np.float64)
    srv, port = _serve(ws)
    try:
        rw = cli.RemoteWindow(("127.0.0.1", port), name)
        p = np.arange(6, dtype=np.float64)
        assert rw.deposit(0, p, accumulate=True) == 1
        assert rw.deposit(0, p, accumulate=True) == 2
        rw.deposit(1, 5 * p, accumulate=False)
        buf, fresh = win.read(0, consume=True)
        assert fresh == 2
        np.testing.assert_array_equal(buf, 2 * p)
        out, fresh = rw.read(1, 6, np.float64, consume=True)
        assert fresh == 1
        np.testing.assert_array_equal(out, 5 * p)
        out2, fresh2 = rw.read(1, 6, np.float64, consume=False)
        assert fresh2 == 0
        np.testing.assert_array_equal(out2, 0.0)
        win.set_self(np.full(6, 9.0))
        np.testing.assert_array_equal(rw.read_self(6, np.float64), 9.0)
        rw.close()
    finally:
        srv.stop()
        win.free()


def test_remote_errors_are_loud(pair):
    aw, ws, cli = pair
    name = _name("ws_err")
    win = aw.AsyncWindow(name, n_slots=1, n_elems=4, dtype=np.float32)
    srv, port = _serve(ws)
    try:
        rw = cli.RemoteWindow(("127.0.0.1", port), "no_such_window")
        with pytest.raises(RuntimeError, match="failed"):
            rw.deposit(0, np.ones(4, np.float32))
        rw.close()
        rw2 = cli.RemoteWindow(("127.0.0.1", port), name)
        with pytest.raises(RuntimeError, match="mismatch|failed"):
            rw2.deposit(0, np.ones(99, np.float32))  # wrong size
        rw2.close()
        rw3 = cli.RemoteWindow(("127.0.0.1", port), name)
        with pytest.raises(TypeError):
            rw3.deposit(0, np.ones(4, np.int32))
        # a lying dtype on a read is rejected before any buffer exists
        with pytest.raises(RuntimeError, match="failed"):
            rw3.read_self(4, np.float64)  # the window is f32
        win.set_self(np.full(4, 2.5, np.float32))
        np.testing.assert_array_equal(rw3.read_self(4, np.float32), 2.5)
        rw3.close()
    finally:
        srv.stop()
        win.free()


def test_stop_quiesces_live_connections(pair):
    aw, ws, cli = pair
    name = _name("ws_stop")
    win = aw.AsyncWindow(name, n_slots=1, n_elems=3, dtype=np.float64)
    srv, port = _serve(ws)
    try:
        rw = cli.RemoteWindow(("127.0.0.1", port), name)
        rw.deposit(0, np.ones(3))
        srv.stop()
        with pytest.raises((RuntimeError, OSError, ConnectionError)):
            rw.deposit(0, np.ones(3))
        rw.close()
        buf, fresh = win.read(0, consume=True)
        assert fresh == 1  # only the deposit before the stop landed
    finally:
        win.free()


def test_fuzz_protocol_against_reference_model(pair):
    """A seeded op stream over one connection against a Python model:
    any framing or desync bug shows as a mismatched counter or buffer."""
    aw, ws, cli = pair
    name = _name("ws_fuzz")
    rng = np.random.default_rng(5)
    k, n = 2, 4
    win = aw.AsyncWindow(name, n_slots=k, n_elems=n, dtype=np.float64)
    srv, port = _serve(ws)
    model = {s: {"buf": np.zeros(n), "dep": 0, "fresh": 0} for s in range(k)}
    self_model = np.zeros(n)
    try:
        rw = cli.RemoteWindow(("127.0.0.1", port), name)
        for step in range(200):
            r = rng.random()
            slot = int(rng.integers(k))
            if r < 0.45:
                v = rng.standard_normal(n)
                acc = bool(rng.random() < 0.7)
                got = rw.deposit(slot, v, accumulate=acc)
                m = model[slot]
                m["buf"] = m["buf"] + v if acc else v.copy()
                m["dep"] += 1
                m["fresh"] += 1
                assert got == m["dep"], step
            elif r < 0.8:
                consume = bool(rng.random() < 0.5)
                buf, fresh = rw.read(slot, n, np.float64, consume=consume)
                m = model[slot]
                assert fresh == m["fresh"], step
                np.testing.assert_array_equal(buf, m["buf"],
                                              err_msg=f"step {step}")
                if consume:
                    m["buf"] = np.zeros(n)
                    m["fresh"] = 0
            elif r < 0.9:
                self_model = rng.standard_normal(n)
                win.set_self(self_model)
            else:
                np.testing.assert_array_equal(rw.read_self(n, np.float64),
                                              self_model)
        rw.close()
    finally:
        srv.stop()
        win.free()


def test_concurrent_remote_writers_never_lose_updates(pair):
    aw, ws, cli = pair
    name = _name("ws_race")
    reps = 100
    win = aw.AsyncWindow(name, n_slots=1, n_elems=6, dtype=np.float64)
    srv, port = _serve(ws)
    errors = []
    try:
        def writer(value):
            try:
                rw = cli.RemoteWindow(("127.0.0.1", port), name)
                p = np.full(6, value)
                for _ in range(reps):
                    rw.deposit(0, p, accumulate=True)
                rw.close()
            except BaseException as e:
                errors.append(e)

        ts = [threading.Thread(target=writer, args=(v,)) for v in (1.0, 5.0)]
        for t in ts:
            t.start()
        for _ in range(20):
            win.read(0, consume=False)  # the owner peeks mid-race
        for t in ts:
            t.join(timeout=60)
        assert not errors, errors
        buf, fresh = win.read(0, consume=True)
        assert fresh == 2 * reps
        np.testing.assert_array_equal(buf, np.full(6, reps * 6.0))
    finally:
        srv.stop()
        win.free()


def test_batch_multi_window_roundtrip(pair):
    """One DepositStream batches deposits for several windows and slots
    of one peer into shared frames; each lands exactly once."""
    aw, ws, cli = pair
    n1, n2 = _name("wt_a"), _name("wt_b")
    wa = aw.AsyncWindow(n1, 2, 4, np.float64)
    wb = aw.AsyncWindow(n2, 1, 6, np.float64)
    srv, port = _serve(ws)
    try:
        st = cli.DepositStream(("127.0.0.1", port))
        pa = np.arange(4, dtype=np.float64)
        pb = np.ones(6)
        for _ in range(5):
            st.deposit_async(n1.encode(), 0, pa)
            st.deposit_async(n1.encode(), 1, 2 * pa, accumulate=False)
            st.deposit_async(n2.encode(), 0, pb)
        st.flush(timeout_s=30)
        buf, fresh = wa.read(0, consume=True)
        assert fresh == 5
        np.testing.assert_array_equal(buf, 5 * pa)
        buf, fresh = wa.read(1, consume=True)
        assert fresh == 5
        np.testing.assert_array_equal(buf, 2 * pa)  # a put
        buf, fresh = wb.read(0, consume=True)
        assert fresh == 5
        np.testing.assert_array_equal(buf, 5.0)
        st.close()
    finally:
        srv.stop()
        wa.free()
        wb.free()


def test_pipelined_snapshot_semantics_and_fence(pair):
    """The caller reuses one payload buffer, changing it right after
    deposit_async: the wire carries the value at enqueue, and flush() is
    a fence (the owner sees every deposit once it returns)."""
    aw, ws, cli = pair
    name = _name("wt_snap")
    win = aw.AsyncWindow(name, 1, 8, np.float64)
    srv, port = _serve(ws)
    try:
        pw = cli.PipelinedRemoteWindow(("127.0.0.1", port), name)
        buf = np.zeros(8)
        expect = np.zeros(8)
        for k in range(100):
            buf[:] = k
            pw.deposit_async(0, buf, accumulate=True)
            expect += k
        pw.flush(timeout_s=30)
        got, fresh = win.read(0, consume=True)
        assert fresh == 100
        np.testing.assert_array_equal(got, expect)
        pw.close()
    finally:
        srv.stop()
        win.free()


def test_pipelined_errors_surface_at_fence(pair):
    _, ws, cli = pair
    srv, port = _serve(ws)
    try:
        st = cli.DepositStream(("127.0.0.1", port))
        st.deposit_async(b"no_such_window", 0, np.ones(4))
        with pytest.raises(RuntimeError, match="no such window|failed"):
            st.flush(timeout_s=30)
        st.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("ratio", [0.25, 0.1])
def test_wire_codecs_end_to_end(pair, ratio):
    """f32 reads back as the f32 cast; top-k reads back as the port's
    ``decode(encode(x))`` (both codecs byte-equal across the packages)."""
    from bluefog_tpu_torch.runtime import wire_codec as wc

    aw, ws, cli = pair
    name = _name("wt_codec")
    win = aw.AsyncWindow(name, 2, 64, np.float64)
    srv, port = _serve(ws)
    x = np.random.default_rng(3).standard_normal(64)
    try:
        st = cli.DepositStream(("127.0.0.1", port), codec="f32")
        st.deposit_async(name.encode(), 0, x, accumulate=False)
        st.flush(timeout_s=30)
        got, fresh = win.read(0, consume=True)
        assert fresh == 1
        np.testing.assert_array_equal(got, x.astype(np.float32))
        st.close()

        st = cli.DepositStream(("127.0.0.1", port), codec="topk",
                               topk_ratio=ratio)
        st.deposit_async(name.encode(), 1, x, accumulate=False)
        st.flush(timeout_s=30)
        got, fresh = win.read(1, consume=True)
        assert fresh == 1
        views, _ = wc.encode(x, wc.CODEC_TOPK, topk_ratio=ratio)
        want = wc.decode(wc.CODEC_TOPK,
                         memoryview(b"".join(bytes(v) for v in views)),
                         64, np.float64)
        np.testing.assert_array_equal(got, want)
        assert np.count_nonzero(got) == wc.kept(64, ratio)
        st.close()
    finally:
        srv.stop()
        win.free()


def _chaos_ack_drop(ws_mod, srv, n):
    """One applied-but-unacked batch on the given server: the port's
    fault drill, or the JAX package's chaos rule."""
    if ws_mod is PW:
        srv.drop_next_acks(n)
        return None
    from bluefog_tpu import chaos

    chaos.configure(f"ack:drop:after_frames={n}")
    return chaos


def test_forced_reconnect_replay_applies_once(pair):
    """The applied-but-unacked ambiguity across the packages: the server
    applies a batch and the connection dies before its ack; the resumed
    stream's STREAM_ATTACH reply (the applied high-water mark) retires it,
    so every deposit applies exactly once and the value is bit-exact."""
    aw, ws, cli = pair
    name = _name("res_ackdrop")
    win = aw.AsyncWindow(name, 1, 8, np.float64)
    srv, port = _serve(ws)
    chaos = _chaos_ack_drop(ws, srv, 3)
    st = cli.DepositStream(("127.0.0.1", port),
                           reconnect=dict(base_s=0.02, cap_s=0.2, budget=6,
                                          seed=0))
    try:
        total = np.zeros(8)
        for i in range(10):
            v = np.full(8, float(i + 1))
            st.deposit_async(name.encode(), 0, v, accumulate=True)
            total += v
            st.flush(timeout_s=30)
        assert st.reconnects >= 1
        got, fresh = win.read(0, consume=False)
        np.testing.assert_array_equal(got, total)
        assert fresh == 10  # the ambiguous batch applied once
    finally:
        st.close()
        if chaos is not None:
            chaos.reset()
        srv.stop()
        win.free()


def test_deposit_crosses_process_boundary():
    """An owner process serves a port window; this process deposits over
    TCP from a port client and a JAX-package client; the owner observes
    the mass with no participation."""
    name = _name("ws_mp")
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from bluefog_tpu_torch.runtime.async_windows import AsyncWindow\n"
        "from bluefog_tpu_torch.runtime.window_server import WindowServer\n"
        f"w = AsyncWindow({name!r}, 1, 5, np.float64)\n"
        "srv = WindowServer()\n"
        "_, port = srv.start('127.0.0.1')\n"
        "print(f'PORT {port}', flush=True)\n"
        "sys.stdin.readline()\n"
        "buf, fresh = w.read(0, consume=True)\n"
        "assert fresh == 4, fresh\n"
        "assert (buf == 4 * np.arange(5)).all(), buf\n"
        "srv.stop(); w.free()\n"
        "print('OWNER_OK', flush=True)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=REPO)
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("PORT "):
                port = int(line.split()[1])
                break
        assert port, "the owner never published its port"
        p = np.arange(5, dtype=np.float64)
        for mod in (PW, RW):
            rw = mod.RemoteWindow(("127.0.0.1", port), name)
            for _ in range(2):
                rw.deposit(0, p, accumulate=True)
            rw.close()
        proc.stdin.write("done\n")
        proc.stdin.flush()
        out = proc.stdout.read()
        assert proc.wait(timeout=60) == 0, out
        assert "OWNER_OK" in out, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# raw protocol against the port's server
# ---------------------------------------------------------------------------


def test_v1_client_is_rejected_loudly():
    name = _name("wt_v1")
    win = PA.AsyncWindow(name, 1, 4, np.float64)
    srv, port = _serve(PW)
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            nb = name.encode()
            msg = (struct.pack("<IBH", 0xBF_51_0E_01, 0, len(nb)) + nb
                   + struct.pack("<iBBq", 0, 1, 1, 4) + np.ones(4).tobytes())
            s.sendall(msg)
            (rc,) = struct.unpack("<q", _recv_exactly(s, 8))
            assert rc == -101, rc
            assert s.recv(1) == b""  # the server dropped the connection
        assert win.read(0, consume=True)[1] == 0
    finally:
        srv.stop()
        win.free()


@pytest.mark.parametrize("version", [1, 3, 0xFFFF])
def test_hello_wrong_version_rejected(version):
    srv, port = _serve(PW)
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(PW._HDR.pack(PW._MAGIC, PW._OP_HELLO, 0)
                      + PW._HELLO.pack(version, 0))
            (rc,) = PW._STATUS.unpack(_recv_exactly(s, 8))
            assert rc == -101, rc
            assert s.recv(1) == b""
    finally:
        srv.stop()


def test_hello_grants_only_the_ported_features():
    srv, port = _serve(PW)
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(PW._HDR.pack(PW._MAGIC, PW._OP_HELLO, 0)
                      + PW._HELLO.pack(2, 0x1FF))
            (granted,) = PW._STATUS.unpack(_recv_exactly(s, 8))
        assert granted == (PW.FEATURE_BATCH | PW.FEATURE_CODEC_F32
                           | PW.FEATURE_CODEC_TOPK | PW.FEATURE_HEARTBEAT
                           | PW.FEATURE_RESUME)
        # the constants are the reference's, bit for bit
        for f in ("FEATURE_BATCH", "FEATURE_CODEC_F32", "FEATURE_CODEC_TOPK",
                  "FEATURE_HEARTBEAT", "FEATURE_RESUME", "FEATURE_SNAPSHOT",
                  "FEATURE_SUBSCRIBE", "FEATURE_TRACE", "FEATURE_DELTA",
                  "PROTOCOL_VERSION", "_MAGIC", "_FLAG_DRAIN"):
            assert getattr(PW, f) == getattr(RW, f), f
        for st in ("_HDR", "_BODY", "_STATUS", "_SELF_HDR", "_HELLO",
                   "_BATCH_HDR", "_ITEM", "_ACK", "_ATTACH", "_HB"):
            assert getattr(PW, st).format == getattr(RW, st).format, st
    finally:
        srv.stop()


@pytest.mark.parametrize("op", [8, 9])
def test_snapshot_and_subscribe_ops_refused(op):
    """Ops 8 and 9 (the serving read path, ROADMAP item 10) get one
    ``ERR_BAD_OP`` and the connection drops; the server serves on."""
    name = _name("wt_op89")
    win = PA.AsyncWindow(name, 1, 4, np.float64)
    srv, port = _serve(PW)
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            grp = b"group:0"
            body = (RW._SNAP_REQ.pack(-1, 0) if op == 8
                    else RW._SUB_REQ.pack(7, 1, 1, -1))
            s.sendall(PW._HDR.pack(PW._MAGIC, op, len(grp)) + grp + body)
            (rc,) = PW._STATUS.unpack(_recv_exactly(s, 8))
            assert rc == -100, rc
            assert s.recv(1) == b""
        rw = PW.RemoteWindow(("127.0.0.1", port), name)
        assert rw.deposit(0, np.ones(4)) == 1
        rw.close()
    finally:
        srv.stop()
        win.free()


def test_codec_requires_negotiation():
    name = _name("wt_nego")
    win = PA.AsyncWindow(name, 1, 8, np.float64)
    srv, port = _serve(PW)
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            nb = name.encode()
            payload = np.ones(8, np.float32)
            item = PW._ITEM.pack(len(nb), 0, 1, 1, 1, 8, payload.nbytes)
            s.sendall(PW._HDR.pack(PW._MAGIC, PW._OP_DEPOSIT_BATCH, 0)
                      + PW._BATCH_HDR.pack(7, 1) + item + nb
                      + payload.tobytes())
            seq, rc = PW._ACK.unpack(_recv_exactly(s, 12))
            assert seq == 7 and rc == -102, (seq, rc)
        assert win.read(0, consume=True)[1] == 0  # nothing landed
    finally:
        srv.stop()
        win.free()


def test_batch_bad_item_does_not_desync_good_items():
    name = _name("wt_mix")
    win = PA.AsyncWindow(name, 1, 4, np.float64)
    srv, port = _serve(PW)
    try:
        nb = name.encode()
        good = np.full(4, 2.0)
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            frames = [PW._HDR.pack(PW._MAGIC, PW._OP_DEPOSIT_BATCH, 0),
                      PW._BATCH_HDR.pack(1, 3)]
            for wname in (nb, b"missing_win", nb):
                frames.append(PW._ITEM.pack(len(wname), 0, 1, 1, 0, 4,
                                            good.nbytes))
                frames.append(wname)
                frames.append(good.tobytes())
            s.sendall(b"".join(frames))
            seq, rc = PW._ACK.unpack(_recv_exactly(s, 12))
            assert seq == 1 and rc == -3, (seq, rc)
        buf, fresh = win.read(0, consume=True)
        assert fresh == 2
        np.testing.assert_array_equal(buf, 4.0)
    finally:
        srv.stop()
        win.free()


def _valid_batch_bytes(name_b, arr, seq=9):
    return (PW._HDR.pack(PW._MAGIC, PW._OP_DEPOSIT_BATCH, 0)
            + PW._BATCH_HDR.pack(seq, 1)
            + PW._ITEM.pack(len(name_b), 0, 1, 1, 0, arr.size, arr.nbytes)
            + name_b + arr.tobytes())


def test_dense_item_wire_bytes_must_match_exactly():
    name = _name("wt_exact")
    win = PA.AsyncWindow(name, 1, 8, np.float64)
    srv, port = _serve(PW)
    arr = np.ones(8)
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            for bad_wire in (56, 72):  # -8 and +8 against the true 64
                s.sendall(PW._HDR.pack(PW._MAGIC, PW._OP_DEPOSIT_BATCH, 0)
                          + PW._BATCH_HDR.pack(5, 1)
                          + PW._ITEM.pack(len(name.encode()), 0, 1, 1, 0,
                                          8, bad_wire)
                          + name.encode() + b"x" * bad_wire)
                seq, rc = PW._ACK.unpack(_recv_exactly(s, 12))
                assert seq == 5 and rc == -2, (bad_wire, seq, rc)
            s.sendall(_valid_batch_bytes(name.encode(), arr, seq=6))
            seq, rc = PW._ACK.unpack(_recv_exactly(s, 12))
            assert seq == 6 and rc == 1, (seq, rc)
        buf, fresh = win.read(0, consume=True)
        assert fresh == 1
        np.testing.assert_array_equal(buf, arr)
    finally:
        srv.stop()
        win.free()


def test_deferred_ack_singles_and_flush_op():
    name = _name("wt_defer")
    win = PA.AsyncWindow(name, 1, 4, np.float64)
    srv, port = _serve(PW)
    try:
        nb = name.encode()
        p = np.ones(4)
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            def dep(target):
                s.sendall(PW._HDR.pack(PW._MAGIC, PW._OP_DEPOSIT, len(target))
                          + target + PW._BODY.pack(
                              0, PW._FLAG_ACCUMULATE | PW._FLAG_DEFERRED_ACK,
                              1, 4) + p.tobytes())

            def flush():
                s.sendall(PW._HDR.pack(PW._MAGIC, PW._OP_FLUSH, 0))
                (rc,) = PW._STATUS.unpack(_recv_exactly(s, 8))
                return rc

            dep(nb)
            dep(nb)
            dep(nb)
            assert flush() == 3
            assert flush() == 0
            dep(b"missing_win")  # latches -3, the payload is eaten
            dep(nb)
            assert flush() == -3
            assert flush() == 0
        buf, fresh = win.read(0, consume=True)
        assert fresh == 4
        np.testing.assert_array_equal(buf, 4.0)
    finally:
        srv.stop()
        win.free()


def test_fuzz_malformed_and_truncated_batch_frames():
    name = _name("wt_fuzz")
    win = PA.AsyncWindow(name, 1, 8, np.float64)
    srv, port = _serve(PW)
    rng = np.random.default_rng(11)
    arr = np.ones(8)
    base = _valid_batch_bytes(name.encode(), arr)
    try:
        for trial in range(60):
            blob = bytearray(base)
            mode = trial % 3
            if mode == 0:
                blob = blob[:int(rng.integers(1, len(blob)))]
            elif mode == 1:
                for _ in range(int(rng.integers(1, 6))):
                    i = int(rng.integers(PW._HDR.size, len(blob)))
                    blob[i] = int(rng.integers(0, 256))
            else:
                off = PW._HDR.size + PW._BATCH_HDR.size
                blob[off:off + PW._ITEM.size] = PW._ITEM.pack(
                    len(name.encode()), 0, 1, 1, 0,
                    int(rng.integers(1, 1 << 40)),
                    int(rng.integers(1, 1 << 40)))
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=10) as s:
                s.settimeout(5)
                try:
                    s.sendall(blob)
                    s.shutdown(socket.SHUT_WR)
                    while s.recv(4096):
                        pass
                except OSError:
                    pass
        rw = PW.RemoteWindow(("127.0.0.1", port), name)
        win.read(0, consume=True)  # discard what the fuzz landed
        assert rw.deposit(0, arr, accumulate=True) >= 1
        buf, fresh = win.read(0, consume=True)
        assert fresh == 1
        np.testing.assert_array_equal(buf, arr)
        rw.close()
    finally:
        srv.stop()
        win.free()


def test_truncated_payload_never_applies_partially():
    name = _name("wt_trunc")
    win = PA.AsyncWindow(name, 1, 1024, np.float64)
    srv, port = _serve(PW)
    try:
        full = _valid_batch_bytes(name.encode(), np.ones(1024))
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(full[:len(full) - 512])
        time.sleep(0.2)
        assert win.read(0, consume=True)[1] == 0
    finally:
        srv.stop()
        win.free()


def test_handcrafted_duplicate_batch_is_deduped_server_side():
    name = _name("res_dup")
    win = PA.AsyncWindow(name, 1, 8, np.float64)
    srv, port = _serve(PW)
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        s.sendall(PW._HDR.pack(PW._MAGIC, PW._OP_HELLO, 0)
                  + PW._HELLO.pack(2, PW.FEATURE_BATCH | PW.FEATURE_RESUME))
        assert PW._STATUS.unpack(_recv_exactly(s, 8))[0] >= 0
        s.sendall(PW._HDR.pack(PW._MAGIC, PW._OP_STREAM_ATTACH, 0)
                  + PW._ATTACH.pack(12345, 1))
        assert PW._STATUS.unpack(_recv_exactly(s, 8))[0] == 0
        payload = np.full(8, 3.0).tobytes()
        nb = name.encode()
        frame = (PW._HDR.pack(PW._MAGIC, PW._OP_DEPOSIT_BATCH, 0)
                 + PW._BATCH_HDR.pack(1, 1)
                 + PW._ITEM.pack(len(nb), 0, 1, 1, 0, 8, len(payload))
                 + nb + payload)
        s.sendall(frame)
        assert struct.unpack("<Iq", _recv_exactly(s, 12)) == (1, 1)
        s.sendall(frame)  # the duplicate, verbatim
        seq, status = struct.unpack("<Iq", _recv_exactly(s, 12))
        assert seq == 1 and status >= 0
        got, fresh = win.read(0, consume=False)
        np.testing.assert_array_equal(got, np.full(8, 3.0))
        assert fresh == 1  # one apply, not two
        # a stale epoch can never steal the stream back
        s2 = socket.create_connection(("127.0.0.1", port), timeout=10)
        s2.sendall(PW._HDR.pack(PW._MAGIC, PW._OP_HELLO, 0)
                   + PW._HELLO.pack(2, PW.FEATURE_BATCH | PW.FEATURE_RESUME))
        _recv_exactly(s2, 8)
        s2.sendall(PW._HDR.pack(PW._MAGIC, PW._OP_STREAM_ATTACH, 0)
                   + PW._ATTACH.pack(12345, 1))
        assert PW._STATUS.unpack(_recv_exactly(s2, 8))[0] == -105
        s2.close()
        s.close()
    finally:
        srv.stop()
        win.free()


_FAST = dict(base_s=0.02, cap_s=0.2, budget=6, seed=0)


def test_latched_batch_error_survives_connection_death():
    name = _name("res_latch")
    win = PA.AsyncWindow(name, 1, 8, np.float64)
    srv, port = _serve(PW)
    srv.drop_next_acks(1)
    st = PW.DepositStream(("127.0.0.1", port), reconnect=_FAST)
    try:
        st.deposit_async(b"res_no_such_window", 0, np.ones(8))
        with pytest.raises(RuntimeError, match="no such window"):
            st.flush(timeout_s=30)
    finally:
        st.close()
        srv.stop()
        win.free()


def test_budget_exhaustion_marks_peer_dead():
    name = _name("res_dead")
    win = PA.AsyncWindow(name, 1, 8, np.float64)
    srv, port = _serve(PW)
    st = PW.DepositStream(("127.0.0.1", port),
                          reconnect=dict(base_s=0.01, cap_s=0.05, budget=3,
                                         seed=0))
    try:
        srv.stop()  # the peer is gone for good
        st.deposit_async(name.encode(), 0, np.ones(8))
        with pytest.raises(RuntimeError, match="unreachable"):
            st.flush(timeout_s=30)
        assert st.health.state == PR.DEAD
        with pytest.raises(RuntimeError):
            st.deposit_async(name.encode(), 0, np.ones(8))
    finally:
        st.close()
        win.free()


def test_heartbeat_keeps_idle_stream_health_fresh():
    name = _name("res_hb")
    win = PA.AsyncWindow(name, 1, 8, np.float64)
    srv, port = _serve(PW)
    st = PW.DepositStream(("127.0.0.1", port), reconnect=_FAST,
                          heartbeat_interval_s=0.05, suspect_after_s=0.5,
                          dead_after_s=10.0)
    try:
        time.sleep(0.6)  # idle: several heartbeat round trips
        assert st.health.state == PR.HEALTHY
        assert st.ack_ewma() is not None  # heartbeat RTTs folded in
    finally:
        st.close()
        srv.stop()
        win.free()


def test_transient_server_restart_replays_exactly_once():
    """The connection dies under the stream (the server drops every live
    connection); the resumed stream replays its unacked batches, and
    every deposit applies once."""
    name = _name("res_drop")
    win = PA.AsyncWindow(name, 1, 8, np.float64)
    srv, port = _serve(PW)
    st = PW.DepositStream(("127.0.0.1", port), reconnect=_FAST)
    try:
        total = np.zeros(8)
        for i in range(20):
            v = np.full(8, float(i + 1))
            st.deposit_async(name.encode(), 0, v, accumulate=True)
            total += v
            if i == 6:
                srv._server.close_connections()
            st.flush(timeout_s=30)
        got, fresh = win.read(0, consume=False)
        np.testing.assert_array_equal(got, total)
        assert fresh == 20
        assert st.reconnects >= 1
        seq = [(a, b) for (_, a, b) in st.health.transitions]
        assert (PR.HEALTHY, PR.SUSPECT) in seq
        assert st.health.state == PR.HEALTHY
    finally:
        st.close()
        srv.stop()
        win.free()


def test_drain_flagged_deposits_are_counted_by_the_owner():
    name = _name("ws_drain")
    win = PA.AsyncWindow(name, 2, 4, np.float64)
    srv, port = _serve(PW)
    try:
        pw = PW.PipelinedRemoteWindow(("127.0.0.1", port), name)
        pw.deposit_async(0, np.ones(4), drain=True)
        pw.deposit_async(1, np.ones(4))
        pw.flush(timeout_s=30)
        assert srv.drain_deposits == 1
        # the drain flag changes no value: still an accumulate
        assert win.read(0, consume=True)[1] == 1
        pw.close()
    finally:
        srv.stop()
        win.free()


# ---------------------------------------------------------------------------
# striped and same-host shm routes
# ---------------------------------------------------------------------------


def test_stripe_of_matches_the_reference():
    for i in range(64):
        nm = f"w:{i}:{i % 7}".encode()
        for n in (1, 2, 3, 4, 16):
            assert PW.stripe_of(nm, n) == RW.stripe_of(nm, n)


@pytest.mark.parametrize("stripes", [2, 4])
def test_striped_stream_lands_every_deposit(stripes):
    names = [_name(f"ws_stripe{i}") for i in range(6)]
    wins = [PA.AsyncWindow(nm, 1, 16, np.float64) for nm in names]
    srv, port = _serve(PW)
    try:
        st = PW.StripedDepositStream(("127.0.0.1", port), n_stripes=stripes)
        assert st.n_stripes == stripes
        for k in range(3):
            for i, nm in enumerate(names):
                st.deposit_async(nm.encode(), 0, np.full(16, i + k + 1.0))
        st.flush(timeout_s=30)
        for i, w in enumerate(wins):
            buf, fresh = w.read(0, consume=True)
            assert fresh == 3
            np.testing.assert_array_equal(buf, np.full(16, 3 * i + 6.0))
        assert st.wire_bytes == 18 * 16 * 8
        # a TransportPlan resizes the pool at a round boundary; what the
        # closed stripes carried still counts
        from bluefog_tpu_torch.control import TransportPlan

        st.apply_plan(TransportPlan(version=1, stripes=1))
        assert st.n_stripes == 1 and st.plan_version == 1
        assert st.wire_bytes == 18 * 16 * 8
        st.close()
    finally:
        srv.stop()
        for w in wins:
            w.free()


def test_shm_route_in_process_and_across_processes(tmp_path):
    """``shm=True`` with the owner in this process takes the local table
    (no frame); with the owner in another process it attaches the owner's
    shm window.  Both count as shm deposits and land exactly."""
    name = _name("ws_shmloc")
    win = PA.AsyncWindow(name, 1, 8, np.float64)
    srv, port = _serve(PW)
    try:
        st = PW.DepositStream(("127.0.0.1", port), shm=True)
        for _ in range(3):
            st.deposit_async(name.encode(), 0, np.ones(8))
        st.flush(timeout_s=30)
        assert st.shm_deposits == 3 and st.wire_bytes == 0
        buf, fresh = win.read(0, consume=True)
        assert fresh == 3
        np.testing.assert_array_equal(buf, 3.0)
        st.close()
    finally:
        srv.stop()
        win.free()

    shm_name = _name("ws_shmmp")
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from bluefog_tpu_torch.runtime.async_windows import AsyncWindow\n"
        "from bluefog_tpu_torch.runtime.window_server import WindowServer\n"
        f"w = AsyncWindow({shm_name!r}, 1, 8, np.float64, shm=True)\n"
        "srv = WindowServer()\n"
        "_, port = srv.start('127.0.0.1')\n"
        "print(f'PORT {port}', flush=True)\n"
        "sys.stdin.readline()\n"
        "buf, fresh = w.read(0, consume=True)\n"
        "assert fresh == 2 and (buf == 2.0).all(), (fresh, buf)\n"
        "srv.stop(); w.free()\n"
        "print('OWNER_OK', flush=True)\n")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("PORT "):
                port = int(line.split()[1])
                break
        assert port
        st = PW.DepositStream(("127.0.0.1", port), shm=True)
        st.deposit_async(shm_name.encode(), 0, np.ones(8))
        st.deposit_async(shm_name.encode(), 0, np.ones(8))
        st.flush(timeout_s=30)
        assert st.shm_deposits == 2
        st.close()
        proc.stdin.write("done\n")
        proc.stdin.flush()
        out = proc.stdout.read()
        assert proc.wait(timeout=60) == 0, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_shm_route_falls_back_to_tcp_for_a_non_shm_owner():
    """An owner whose window is not shm-backed in another table: the
    stream's attach fails once and every deposit rides the wire."""
    name = _name("ws_noshm")
    win = RA.AsyncWindow(name, 1, 8, np.float64)  # the JAX package's table
    srv, port = _serve(RW)
    try:
        st = PW.DepositStream(("127.0.0.1", port), shm=True)
        st.deposit_async(name.encode(), 0, np.ones(8))
        st.flush(timeout_s=30)
        assert st.shm_deposits == 0 and st.wire_bytes == 64
        assert win.read(0, consume=True)[1] == 1
        st.close()
    finally:
        srv.stop()
        win.free()


# ---------------------------------------------------------------------------
# one loop body on every transport
# ---------------------------------------------------------------------------


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("method", ["deposit_async", "flush"])
def test_signature_parity(method):
    want = _params(getattr(PW.PipelinedRemoteWindow, method))
    assert _params(getattr(PA.AsyncWindow, method)) == want
    assert _params(getattr(PA._RemoteHandle, method)) == want
    assert want == _params(getattr(RW.PipelinedRemoteWindow, method))


def test_window_server_serving_arguments_wait_for_item_10():
    with pytest.raises(NotImplementedError, match="item 10"):
        PW.WindowServer(snapshots=object())

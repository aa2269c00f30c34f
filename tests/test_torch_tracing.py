"""The port's causal tracing (``bluefog_tpu_torch/tracing/``) and the wire
trace context of its window server against the JAX package's, following
``tests/test_tracing.py``:

- ``TestRecorder``'s cases on the port's recorder, and its files read by
  the JAX package's analyzer;
- ``TestAnalyzer``'s cases on the port's analyzer; seeded trace
  directories through both analyzers give equal reports, and each
  package's analyzer reads the other's files;
- ``TestWirePropagation`` over three pairings (port with port, a port
  client against a JAX-package server, and the reverse): the owner-side
  spans parent to the sender's wire span across the packages, the
  extended acks give ``phase_ewma()`` its ``{net, queue, apply}``, a
  snapshot read and a subscription push carry their context, a relay
  hop parents into the trainer's trace, and with tracing off a stream
  degrades silently;
- two rank processes of ``run_async_dsgd_rank`` over tcp, armed by
  ``BLUEFOG_TPU_TRACE`` and ``BLUEFOG_TPU_PROFILE``: the rank body's
  spans, the cross-process parents, the streams' phase split;
- with tracing off, the HELLO and every deposit and snapshot frame a
  port client sends are byte-equal to the JAX package's client's;
- ``TestTraceHeaderFuzz``'s 60 malformed and truncated headers on the
  port's server;
- in place of the JAX package's slow-marked ``TestChaosCriticalPathE2E``:
  one process, a port rank and a JAX-package rank depositing to each
  other, a ``server:delay`` rule on the JAX package's server; both
  analyzers name the edge into that server as the critical path.

Left out: ``TestHLOIdentity`` (jitted programs; the port runs eagerly and
its spans are host time).
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest

import bluefog_tpu.tracing.analyze as RAN
import bluefog_tpu_torch.tracing.analyze as PAN
from bluefog_tpu import chaos as RC
from bluefog_tpu.runtime import async_windows as RA
from bluefog_tpu.runtime import window_server as RW
from bluefog_tpu.serving import client as RSC
from bluefog_tpu.serving import snapshots as RS
from bluefog_tpu.serving import subscriber as RSUB
from bluefog_tpu.tracing import recorder as RT
from bluefog_tpu_torch import chaos as PC
from bluefog_tpu_torch.relay import node as PN
from bluefog_tpu_torch.runtime import async_windows as PA
from bluefog_tpu_torch.runtime import window_server as PW
from bluefog_tpu_torch.serving import client as PSC
from bluefog_tpu_torch.serving import snapshots as PS
from bluefog_tpu_torch.serving import subscriber as PSUB
from bluefog_tpu_torch.tracing import recorder as PT
from tests._util import REPO, clean_env

SIDES = {
    "port": dict(aw=PA, ws=PW, tr=PT, an=PAN, snap=PS, cli=PSC, sub=PSUB),
    "ref": dict(aw=RA, ws=RW, tr=RT, an=RAN, snap=RS, cli=RSC, sub=RSUB),
}
PAIRS = [("port", "port"), ("ref", "port"), ("port", "ref")]
PAIR_IDS = ["port-port", "refserver-portclient", "portserver-refclient"]


@pytest.fixture(autouse=True)
def _fresh_state():
    """Every case starts and ends with no live recorder and no chaos rule
    in either package."""
    for mod in (PT, RT, PC, RC):
        mod.reset()
    yield
    for mod in (PT, RT, PC, RC):
        mod.reset()


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def pair(request):
    """(server side, client side) of one pairing."""
    return SIDES[request.param[0]], SIDES[request.param[1]]


def _name(tag):
    return f"{tag}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


def _serve(ws_mod):
    srv = ws_mod.WindowServer()
    _, port = srv.start("127.0.0.1")
    return srv, port


def _arm(pair_, directory):
    """Arm the client's recorder as rank 0 and, when the server is the
    other package, the server's as rank 1 (one recorder a package)."""
    srv, cli = pair_
    cli["tr"].configure(str(directory), rank=0, job="trc")
    if srv["tr"] is not cli["tr"]:
        srv["tr"].configure(str(directory), rank=1, job="trc")


def _flush_all():
    PT.flush()
    RT.flush()


def _recv_exactly(s, n):
    buf = b""
    while len(buf) < n:
        got = s.recv(n - len(buf))
        if not got:
            raise ConnectionError("closed")
        buf += got
    return buf


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


# ---------------------------------------------------------------------------
# 1. recorder semantics
# ---------------------------------------------------------------------------


def test_disabled_path_is_null():
    assert not PT.enabled()
    assert PT.get() is None
    assert PT.wire_ctx() is None
    with PT.span("x") as sp:
        assert sp is None  # the null context manager


def test_lazy_env_activation(tmp_path, monkeypatch):
    monkeypatch.setenv("BLUEFOG_TPU_TRACE", str(tmp_path))
    # reset() sticks against the variable; undo the stick to take the
    # lazy path
    PT._STOPPED = False
    PT._RECORDER = None
    assert PT.enabled()
    assert PT.get().directory == str(tmp_path)
    PT.reset()
    assert PT.get() is None  # sticky again


def test_span_context_nesting_and_wire_ctx(tmp_path):
    rec = PT.configure(str(tmp_path), rank=3, job="jobA")
    with rec.span("round", "dsgd", round_=17) as outer:
        tid, sid, rnd = PT.wire_ctx()
        assert (tid, sid, rnd) == (outer.tid, outer.sid, 17)
        assert tid == PT.trace_id_for("jobA") == RT.trace_id_for("jobA")
        with rec.span("gossip", "dsgd") as inner:
            assert inner.par == outer.sid
            assert inner.round == 17  # inherited through the stack
    assert PT.current_ctx() is None
    rec.flush()
    for an in (PAN, RAN):  # each package's analyzer reads the file
        spans = an.load_traces(str(tmp_path))
        by_name = {s["name"]: s for s in spans}
        assert by_name["gossip"]["par"] == by_name["round"]["sid"]
        assert by_name["gossip"]["rank"] == 3
        assert not any(s.get("open") for s in spans)


def test_open_span_snapshot_survives_flush(tmp_path):
    """A begun but unfinished span appears as open: true at every flush
    without being discharged."""
    rec = PT.configure(str(tmp_path), rank=0)
    sp = rec.begin_span("wire", "tcp", round_=4)
    rec.flush()
    (open_sp,) = [s for s in PAN.load_traces(str(tmp_path))
                  if s["name"] == "wire"]
    assert open_sp.get("open") is True and open_sp["round"] == 4
    assert open_sp["sid"] == sp.sid
    t = threading.Thread(target=sp.finish)  # finished from another thread
    t.start()
    t.join()
    rec.flush()
    for an in (PAN, RAN):
        (closed,) = [s for s in an.load_traces(str(tmp_path))
                     if s["name"] == "wire"]
        assert not closed.get("open") and closed["sid"] == sp.sid


def test_trace_id_is_coordination_free():
    assert PT.trace_id_for("job") == PT.trace_id_for("job")
    assert PT.trace_id_for("job") != PT.trace_id_for("job2")
    for job in ("job", "bf", "a:b", ""):
        assert PT.trace_id_for(job) == RT.trace_id_for(job)


def test_rankless_process_writes_pid_file(tmp_path):
    PT.configure(str(tmp_path))  # no rank
    with PT.span("read", "tcp"):
        pass
    PT.flush()
    (path,) = tmp_path.glob("trace-pid*.jsonl")
    assert f"pid{os.getpid()}" in path.name
    assert not list(tmp_path.glob("trace-rank*.jsonl"))
    assert [s["name"] for s in RAN.load_traces(str(tmp_path))] == ["read"]


def test_set_rank_pins_before_first_flush(tmp_path):
    PT.configure(str(tmp_path))
    PT.set_rank(5)
    with PT.span("x"):
        pass
    PT.flush()
    assert (tmp_path / "trace-rank5.jsonl").exists()
    PT.set_rank(6)  # later calls do not rename the identity
    assert PT.get().rank == 5


def test_auto_flush_every_1024_spans(tmp_path):
    rec = PT.configure(str(tmp_path), rank=0)
    for i in range(PT._FLUSH_EVERY):
        rec.emit("e", "t", t0=float(i), dur=0.0)
    assert len(PAN.load_traces(str(tmp_path))) == PT._FLUSH_EVERY
    assert rec.spans_recorded == PT._FLUSH_EVERY


def test_record_fields_match_the_jax_package(tmp_path):
    """Both recorders write the same keys for the same spans."""
    recs = {}
    for tag, tr in (("p", PT), ("r", RT)):
        d = tmp_path / tag
        rec = tr.configure(str(d), rank=2, job="fmt")
        with rec.span("round", "dsgd", round_=7, step=7):
            rec.emit("apply", "tcp_srv", t0=1.0, dur=0.5, items=3)
        rec.begin_span("wire", "tcp", seq=1)  # left open
        rec.flush()
        tr.reset()
        recs[tag] = sorted((s["name"], tuple(sorted(s)))
                           for s in PAN.load_traces(str(d)))
    assert recs["p"] == recs["r"]


# ---------------------------------------------------------------------------
# 2. the analyzer
# ---------------------------------------------------------------------------


def _ground_truth_spans(rounds=5):
    """Two ranks; rank 1's deposits gate rank 0's rounds, queue wait
    dominant (the JAX package's test's ground truth)."""
    spans = []
    sid = 1
    for k in range(rounds):
        r1 = dict(sid=sid, par=0, tid=9, name="round", cat="dsgd",
                  rank=1, round=k, t0=float(k), dur=0.4)
        comp = dict(sid=sid + 1, par=r1["sid"], tid=9, name="compute",
                    cat="dsgd", rank=1, round=k, t0=k + 0.1, dur=0.2)
        wire = dict(sid=sid + 2, par=r1["sid"], tid=9, name="wire",
                    cat="tcp", rank=1, round=k, t0=k + 0.1, dur=0.62,
                    dst="w:0", seq=k)
        qw = dict(sid=sid + 3, par=wire["sid"], tid=9, name="queue_wait",
                  cat="tcp_srv", rank=0, round=k, t0=k + 0.2, dur=0.45)
        ap = dict(sid=sid + 4, par=wire["sid"], tid=9, name="apply",
                  cat="tcp_srv", rank=0, round=k, t0=k + 0.65, dur=0.1)
        r0 = dict(sid=sid + 5, par=0, tid=9, name="round", cat="dsgd",
                  rank=0, round=k, t0=float(k), dur=0.8)
        sid += 6
        spans += [r1, comp, wire, qw, ap, r0]
    return spans


def test_edge_phase_decomposition():
    er = PAN.edge_report(PAN.build_graph(_ground_truth_spans()))
    assert set(er) == {"1->0"}
    e = er["1->0"]
    assert e["batches"] == 5
    assert e["wire_mean_s"] == pytest.approx(0.62)
    assert e["phase_mean_s"]["queue_wait"] == pytest.approx(0.45)
    assert e["phase_mean_s"]["apply"] == pytest.approx(0.1)
    assert e["phase_mean_s"]["net"] == pytest.approx(0.07)
    assert max(e["phase_frac"], key=e["phase_frac"].get) == "queue_wait"


def test_critical_path_names_gating_edge_and_phase():
    cp = PAN.critical_path(PAN.build_graph(_ground_truth_spans()))
    assert cp["gating_edge"] == [1, 0]
    assert cp["gating_rounds"] == 5
    assert cp["dominant_phase"] == "queue_wait"
    assert cp["dominant_frac"] == pytest.approx(0.45 / 0.62)


def test_straggler_ranking_and_overlap():
    graph = PAN.build_graph(_ground_truth_spans())
    rr = PAN.round_report(graph)
    assert rr["straggler_ranking"] == [0, 1]
    assert rr["per_rank"][0]["round_mean_s"] == pytest.approx(0.8)
    # compute [k+.1, k+.3] hides 0.2 s of the 0.62 s wire span
    assert PAN.overlap_report(graph)[1] == pytest.approx(0.2 / 0.62)


def test_extended_ack_fallback_without_server_spans():
    spans = [dict(sid=1, par=0, tid=9, name="wire", cat="tcp", rank=1,
                  round=0, t0=0.1, dur=0.62, dst="w:0", queue_s=0.45,
                  apply_s=0.1)]
    er = PAN.edge_report(PAN.build_graph(spans))
    assert set(er) == {"1->0"}
    assert er["1->0"]["phase_mean_s"]["queue_wait"] == pytest.approx(0.45)


def test_ack_backpressure_gate():
    spans = []
    for k in range(4):
        spans.append(dict(sid=10 + k, par=0, tid=9, name="round",
                          cat="dsgd", rank=0, round=k, t0=float(k),
                          dur=0.9))
        spans.append(dict(sid=100 + k, par=0, tid=9, name="wire",
                          cat="tcp", rank=0, round=k, t0=k + 0.05, dur=0.8,
                          dst="w:2", seq=k))
    cp = PAN.critical_path(PAN.build_graph(spans))
    assert cp["gating_edge"] == [0, 2]
    assert cp["gating_rounds"] >= 3


def test_torn_tail_and_open_dedup(tmp_path):
    with open(tmp_path / "trace-rank0.jsonl", "w") as f:
        f.write(json.dumps(dict(sid=1, name="a", rank=0, t0=0.0,
                                dur=1.0)) + "\n")
        f.write(json.dumps(dict(sid=2, name="b", rank=0, t0=0.0,
                                open=True)) + "\n")
        f.write(json.dumps(dict(sid=2, name="b", rank=0, t0=0.0, open=True,
                                newest=True)) + "\n")
        f.write('{"sid": 3, "name": "torn')  # a crashed writer
    spans = PAN.load_traces(str(tmp_path))
    assert len(spans) == 2
    (b,) = [s for s in spans if s["name"] == "b"]
    assert b.get("newest") is True  # the newest open snapshot wins


def test_open_record_superseded_by_close(tmp_path):
    with open(tmp_path / "trace-rank0.jsonl", "w") as f:
        f.write(json.dumps(dict(sid=7, name="w", rank=0, t0=0.0,
                                open=True)) + "\n")
        f.write(json.dumps(dict(sid=7, name="w", rank=0, t0=0.0,
                                dur=2.0)) + "\n")
    spans = PAN.load_traces(str(tmp_path))
    assert len(spans) == 1 and not spans[0].get("open")


def test_chrome_trace_causal_flow_arrows():
    events = PAN.chrome_trace(_ground_truth_spans(rounds=1))
    flows = [e for e in events if e.get("cat") == "flow"]
    assert {e["ph"] for e in flows} == {"s", "f"}
    assert len([e for e in flows if e["ph"] == "s"]) == 2
    assert {e["pid"] for e in events if e.get("ph") == "X"} == {0, 1}


def test_cli_report_and_json(tmp_path):
    with open(tmp_path / "trace-rank0.jsonl", "w") as f:
        for s in _ground_truth_spans():
            f.write(json.dumps(s) + "\n")
    trace_out = str(tmp_path / "merged.json")
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.tracing", str(tmp_path),
         "--trace", trace_out],
        capture_output=True, text=True, timeout=120, env=clean_env(),
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "CRITICAL PATH: rank 1 -> rank 0" in proc.stdout
    assert "queue_wait" in proc.stdout
    assert "straggler ranking (slowest first): 0, 1" in proc.stdout
    assert json.load(open(trace_out))  # a valid chrome trace
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.tracing", str(tmp_path),
         "--json"],
        capture_output=True, text=True, timeout=120, env=clean_env(),
        cwd=REPO)
    rep = json.loads(proc.stdout)
    assert rep["critical_path"]["gating_edge"] == [1, 0]


def test_cli_empty_dir_fails_loud(tmp_path):
    assert PAN.main([str(tmp_path)]) == 1


def _seeded_trace_dir(directory, seed):
    """A seeded job: 3 ranks, 6 rounds of round/gossip/compute spans,
    every rank depositing to the next with owner-side spans (some edges
    only with the extended-ack fields), an open wire span and a torn
    tail."""
    rng = np.random.default_rng(seed)
    sid = iter(range(1, 1 << 20))
    by_rank = {r: [] for r in range(3)}
    for k in range(6):
        for r in range(3):
            t0 = k + float(rng.uniform(0, 0.05))
            dur = float(rng.uniform(0.3, 0.9))
            rnd = dict(sid=next(sid), par=0, tid=5, name="round",
                       cat="dsgd", rank=r, round=k, t0=t0, dur=dur,
                       overlap=round(float(rng.uniform()), 4))
            comp = dict(sid=next(sid), par=rnd["sid"], tid=5,
                        name="compute", cat="dsgd", rank=r, round=k,
                        t0=t0 + 0.05, dur=dur * 0.4)
            goss = dict(sid=next(sid), par=rnd["sid"], tid=5, name="gossip",
                        cat="dsgd", rank=r, round=k, t0=t0 + dur * 0.5,
                        dur=dur * 0.3)
            wdur = float(rng.uniform(0.05, 0.5))
            dst = (r + 1) % 3
            wire = dict(sid=next(sid), par=goss["sid"], tid=5, name="wire",
                        cat="tcp", rank=r, round=k, t0=goss["t0"], dur=wdur,
                        dst=f"job:{dst}", seq=k, send_s=wdur * 0.1)
            by_rank[r] += [rnd, comp, goss, wire]
            if rng.uniform() < 0.3:
                wire.update(queue_s=wdur * 0.2, apply_s=wdur * 0.3)
                continue
            base = wire["t0"] + float(rng.uniform(0, 0.01))
            for name, frac in (("recv", 0.1), ("queue_wait", 0.4),
                               ("apply", 0.3), ("ack", 0.05)):
                d = wdur * frac
                by_rank[dst].append(dict(
                    sid=next(sid), par=wire["sid"], tid=5, name=name,
                    cat="tcp_srv", rank=dst, round=k, t0=base, dur=d,
                    seq=k))
                base += d
    by_rank[1].append(dict(sid=next(sid), par=0, tid=5, name="wire",
                           cat="tcp", rank=1, round=6, t0=6.1, open=True,
                           dst="job:2", seq=6))
    for r, spans in by_rank.items():
        with open(os.path.join(directory, f"trace-rank{r}.jsonl"), "w") as f:
            for s in spans:
                f.write(json.dumps(s) + "\n")
            if r == 2:
                f.write('{"sid": 99, "na')


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_directory_gives_equal_reports_in_both_analyzers(tmp_path,
                                                               seed):
    _seeded_trace_dir(str(tmp_path), seed)
    got = json.loads(json.dumps(PAN.analyze(str(tmp_path)), default=str))
    want = json.loads(json.dumps(RAN.analyze(str(tmp_path)), default=str))
    assert got == want
    assert got["critical_path"].get("gating_edge")
    assert PAN._format_report(PAN.analyze(str(tmp_path)), "d") == \
        RAN._format_report(RAN.analyze(str(tmp_path)), "d")
    spans = PAN.load_traces(str(tmp_path))
    assert PAN.chrome_trace(spans) == RAN.chrome_trace(spans)


# ---------------------------------------------------------------------------
# 3. wire propagation through the live transport, three pairings
# ---------------------------------------------------------------------------


def test_deposit_spans_link_across_the_wire(pair, tmp_path):
    srv_side, cli_side = pair
    _arm(pair, tmp_path)
    name = _name("trc_wire")
    win = srv_side["aw"].AsyncWindow(name, n_slots=1, n_elems=8,
                                     dtype=np.float64)
    srv, port = _serve(srv_side["ws"])
    try:
        rw = cli_side["ws"].PipelinedRemoteWindow(("127.0.0.1", port), name)
        assert rw.stream._trace_on  # HELLO was granted FEATURE_TRACE
        arr = np.arange(8.0)
        with cli_side["tr"].span("round", "dsgd", round_=11):
            rw.deposit_async(0, arr, accumulate=True)
        rw.flush()
        buf, fresh = win.read(0, consume=True)
        assert fresh == 1  # exactly once
        np.testing.assert_array_equal(buf, arr)
        phases = rw.phase_ewma()
        assert phases is not None and set(phases) == {"net", "queue",
                                                      "apply"}
        assert all(v >= 0 for v in phases.values())
        rw.close()
    finally:
        srv.stop()
        win.free()
    _flush_all()
    spans = PAN.load_traces(str(tmp_path))
    assert sorted(map(json.dumps, spans)) == sorted(
        map(json.dumps, RAN.load_traces(str(tmp_path))))
    by_name = _by_name(spans)
    for expected in ("round", "snapshot", "enqueue", "coalesce", "wire",
                     "ack_wait", "recv", "queue_wait", "apply", "ack"):
        assert expected in by_name, (expected, sorted(by_name))
    (wire,) = by_name["wire"]
    (rnd,) = by_name["round"]
    assert wire["par"] == rnd["sid"] and wire["round"] == 11
    # the owner-side spans parent to the wire span (the propagated
    # context), in the server package's file when that is the other one
    srv_rank = 0 if srv_side is cli_side else 1
    for srv_name in ("recv", "queue_wait", "apply", "ack"):
        (sp,) = by_name[srv_name]
        assert sp["par"] == wire["sid"] and sp["round"] == 11, srv_name
        assert sp["rank"] == srv_rank and sp["tid"] == wire["tid"]
    assert wire["queue_s"] >= 0 and wire["apply_s"] >= 0
    assert not any(s.get("open") for s in spans)
    if srv_rank == 1:
        er = PAN.edge_report(PAN.build_graph(spans))
        assert set(er) == {"0->1"} and er["0->1"]["batches"] == 1


def test_tracing_off_degrades_silently(pair, tmp_path):
    srv_side, cli_side = pair
    name = _name("trc_off")
    win = srv_side["aw"].AsyncWindow(name, n_slots=1, n_elems=4,
                                     dtype=np.float64)
    srv, port = _serve(srv_side["ws"])
    try:
        rw = cli_side["ws"].PipelinedRemoteWindow(("127.0.0.1", port), name)
        assert not rw.stream._trace_on
        rw.deposit_async(0, np.ones(4), accumulate=True)
        rw.flush()
        _, fresh = win.read(0, consume=True)
        assert fresh == 1
        assert rw.phase_ewma() is None
        rw.close()
    finally:
        srv.stop()
        win.free()
    assert not list(tmp_path.glob("trace-*.jsonl"))


@pytest.mark.parametrize("srv_name,cli_name", [("ref", "port"),
                                               ("port", "ref")],
                         ids=PAIR_IDS[1:])
def test_traced_client_against_an_untraced_owner(tmp_path, srv_name,
                                                 cli_name):
    """The owner's package does not trace: it still grants the feature,
    its acks still carry the timings, so the sender's phase split and the
    analyzer's extended-ack decomposition hold without owner spans."""
    srv_side, cli_side = SIDES[srv_name], SIDES[cli_name]
    cli_side["tr"].configure(str(tmp_path), rank=0, job="trc")
    name = _name("trc_half") + ":1"
    win = srv_side["aw"].AsyncWindow(name, n_slots=1, n_elems=16,
                                     dtype=np.float64)
    srv, port = _serve(srv_side["ws"])
    try:
        rw = cli_side["ws"].PipelinedRemoteWindow(("127.0.0.1", port), name)
        for k in range(3):
            with cli_side["tr"].span("round", "dsgd", round_=k):
                rw.deposit_async(0, np.full(16, float(k)), accumulate=True)
            rw.flush()
        assert set(rw.phase_ewma()) == {"net", "queue", "apply"}
        rw.close()
    finally:
        srv.stop()
        win.free()
    _flush_all()
    spans = PAN.load_traces(str(tmp_path))
    assert not [s for s in spans if s.get("cat") == "tcp_srv"]
    er = PAN.edge_report(PAN.build_graph(spans))
    assert set(er) == {"0->1"} and er["0->1"]["batches"] == 3
    assert "queue_wait" in er["0->1"]["phase_mean_s"]


def test_snapshot_read_propagates_context(pair, tmp_path):
    srv_side, cli_side = pair
    _arm(pair, tmp_path)
    srv, port = _serve(srv_side["ws"])
    group = _name("trc_snap")
    try:
        srv_side["snap"].table().publish(group, 3, {"w": np.arange(4.0)})
        cli = cli_side["cli"].SnapshotClient(("127.0.0.1", port), group)
        got = cli.snapshot()
        assert got.round == 3
        np.testing.assert_array_equal(got["w"], np.arange(4.0))
        cli.close()
    finally:
        srv.stop()
        srv_side["snap"].table().drop(group)
    _flush_all()
    by_name = {s["name"]: s for s in PAN.load_traces(str(tmp_path))}
    assert by_name["snapshot_serve"]["par"] == \
        by_name["snapshot_read"]["sid"]
    assert by_name["snapshot_serve"]["served_round"] == 3


def test_subscription_push_carries_context(pair, tmp_path):
    """The server's push span travels in the push frame's trace header:
    the reader's consume span parents to it, and the delivered snapshot
    carries it for a relay to parent into."""
    srv_side, cli_side = pair
    _arm(pair, tmp_path)
    srv, port = _serve(srv_side["ws"])
    group = _name("trc_sub")
    sub = None
    try:
        srv_side["snap"].table().publish(group, 5, {"w": np.arange(6.0)})
        sub = cli_side["sub"].Subscriber(("127.0.0.1", port), group)
        snap = sub.get(timeout_s=10.0)
        assert snap is not None and snap.round == 5
        assert snap.trace is not None
    finally:
        if sub is not None:
            sub.close()
        srv.stop()
        srv_side["snap"].table().drop(group)
    _flush_all()
    by_name = _by_name(PAN.load_traces(str(tmp_path)))
    (push,) = [s for s in by_name["push"] if s["round"] == 5]
    (consume,) = [s for s in by_name["consume"] if s["round"] == 5]
    assert consume["par"] == push["sid"]
    assert snap.trace == (push["tid"], push["sid"])


def test_relay_hop_parents_to_the_upstream_push(tmp_path):
    """A relay re-publishes under a span parented to the upstream push,
    and its own push senders parent to that relay span (the port's
    ``SnapshotTable.trace_ctx``)."""
    PT.configure(str(tmp_path), rank=0, job="trc")
    srv, port = _serve(PW)
    group = _name("trc_relay")
    relay = sub = None
    try:
        PS.table().publish(group, 2, {"w": np.arange(5.0)})
        relay = PN.RelayNode(("127.0.0.1", port), [group], tier=1)
        relay.wait_ready(timeout_s=10.0)
        ctx = relay.table.trace_ctx(group)
        assert ctx is not None
        sub = PSUB.Subscriber(relay.address, group)
        got = sub.get(timeout_s=10.0)
        assert got is not None and got.round == 2
    finally:
        for x in (sub, relay):
            if x is not None:
                x.close()
        srv.stop()
        PS.table().drop(group)
    PT.flush()
    spans = PAN.load_traces(str(tmp_path))
    by_sid = {s["sid"]: s for s in spans}
    (hop,) = [s for s in spans if s["name"] == "relay"]
    assert by_sid[hop["par"]]["name"] == "push"
    assert ctx == (hop["tid"], hop["sid"])
    assert [s for s in spans if s["name"] == "push"
            and s["par"] == hop["sid"]]


def test_rank_runner_traces_and_profiles_over_processes(tmp_path):
    """Two rank processes over tcp (``examples.async_dsgd_mp``) armed by
    the variables alone: each writes its trace and profile file; the rank
    body's round, gossip and compute spans are there, every owner-side
    span parents to the other process's wire span, each rank's streams
    report a phase split, and the critical path names a gating edge."""
    env = clean_env()
    env["BLUEFOG_TPU_TRACE"] = str(tmp_path / "t")
    env["BLUEFOG_TPU_PROFILE"] = str(tmp_path / "p")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.examples.async_dsgd_mp",
         "--ranks", "2", "--transport", "tcp", "--device", "cpu",
         "--duration", "1.0"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "'phase_s': {" in proc.stdout  # the streams' split, both ranks
    spans = PAN.load_traces(str(tmp_path / "t"))
    by_sid = {s["sid"]: s for s in spans}
    for r in (0, 1):
        names = {s["name"] for s in spans if s["rank"] == r}
        assert {"round", "gossip", "compute", "wire", "recv", "apply"} <= \
            names, (r, names)
    owner = [s for s in spans if s.get("cat") == "tcp_srv"]
    assert owner
    for sp in owner:
        par = by_sid[sp["par"]]
        assert par["name"] == "wire" and par["rank"] == 1 - sp["rank"]
    rep = PAN.analyze(str(tmp_path / "t"))
    assert rep["critical_path"].get("gating_edge") in ([0, 1], [1, 0])
    assert rep == RAN.analyze(str(tmp_path / "t"))
    assert sorted(os.listdir(tmp_path / "p")) == ["profile-rank0.jsonl",
                                                  "profile-rank1.jsonl"]


# ---------------------------------------------------------------------------
# 4. with tracing off the frames are the JAX package's, byte for byte
# ---------------------------------------------------------------------------


def _recording_proxy(upstream_port):
    """A one-connection TCP relay to ``upstream_port`` that keeps every
    byte the client sends."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    seen = bytearray()

    def pump(a, b, sink):
        try:
            while True:
                d = a.recv(1 << 16)
                if not d:
                    break
                if sink is not None:
                    sink += d
                b.sendall(d)
        except OSError:
            pass
        try:
            b.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def run():
        c, _ = lsock.accept()
        u = socket.create_connection(("127.0.0.1", upstream_port))
        back = threading.Thread(target=pump, args=(u, c, None))
        back.start()
        pump(c, u, seen)
        back.join(timeout=10)
        c.close()
        u.close()
        lsock.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return lsock.getsockname()[1], seen, t


def _stream_bytes(ws_mod, port, name):
    pport, seen, t = _recording_proxy(port)
    st = ws_mod.DepositStream(("127.0.0.1", pport))
    for k in range(3):
        st.deposit_async(name.encode(), 0, np.full(8, float(k)))
        st.flush()  # one batch a deposit: the frames do not depend on timing
    st.close()
    t.join(timeout=10)
    return bytes(seen)


def _snapshot_bytes(cli_mod, port, group):
    pport, seen, t = _recording_proxy(port)
    cli = cli_mod.SnapshotClient(("127.0.0.1", pport), group)
    cli.snapshot()
    cli.snapshot(["w"])
    cli.close()
    t.join(timeout=10)
    return bytes(seen)


@pytest.mark.parametrize("traced", [False, True], ids=["off", "on"])
def test_client_frames_match_the_jax_package(tmp_path, traced):
    """Off: the port's HELLO, DEPOSIT_BATCH and SNAPSHOT frames are the
    JAX package's byte for byte, with no FEATURE_TRACE want and no trace
    header.  On: the same frames, each with the 20-byte header."""
    name = _name("trc_bytes")
    group = _name("trc_bytes_g")
    win = PA.AsyncWindow(name, n_slots=1, n_elems=8, dtype=np.float64)
    srv, port = _serve(PW)
    PS.table().publish(group, 1, {"w": np.arange(3.0)})
    try:
        got = {}
        for tag, ws_mod, cli_mod, tr in (("port", PW, PSC, PT),
                                         ("ref", RW, RSC, RT)):
            if traced:
                tr.configure(str(tmp_path / tag), rank=0)
            with tr.span("round", "dsgd", round_=4):
                got[tag] = (_stream_bytes(ws_mod, port, name),
                            _snapshot_bytes(cli_mod, port, group))
            tr.reset()
    finally:
        srv.stop()
        win.free()
        PS.table().drop(group)
    hello = PW._HDR.size + PW._HELLO.size
    for i in range(2):
        p, r = got["port"][i], got["ref"][i]
        assert p[:hello] == r[:hello]  # the same HELLO
        (want,) = [PW._HELLO.unpack(p[PW._HDR.size:hello])[1]]
        assert bool(want & PW.FEATURE_TRACE) == traced
        if traced:
            assert len(p) == len(r)  # span ids differ, the layout does not
        else:
            assert p == r
    frame = (PW._HDR.size + PW._BATCH_HDR.size + PW._ITEM.size + len(name)
             + 64 + (PW._TRACE_HDR.size if traced else 0))
    assert len(got["port"][0]) == hello + 3 * frame


# ---------------------------------------------------------------------------
# 5. trace-header fuzz on the port's server
# ---------------------------------------------------------------------------


def test_60_case_trace_header_fuzz(tmp_path):
    """Malformed and truncated trace headers across 60 connections: the
    server survives every case, valid frames apply exactly once, invalid
    ones apply nothing, and a peer without the feature bit works
    untraced."""
    ws = PW
    PT.configure(str(tmp_path), rank=0)  # server-side spans live
    name = _name("trc_fuzz")
    win = PA.AsyncWindow(name, n_slots=1, n_elems=8, dtype=np.float64)
    srv, port = _serve(PW)
    rng = np.random.default_rng(17)
    arr = np.ones(8)
    name_b = name.encode()
    item = ws._ITEM.pack(len(name_b), 0, 1, 1, 0, arr.size, arr.nbytes)

    def hello(s, features):
        s.sendall(ws._HDR.pack(ws._MAGIC, ws._OP_HELLO, 0)
                  + ws._HELLO.pack(ws.PROTOCOL_VERSION, features))
        (granted,) = ws._STATUS.unpack(_recv_exactly(s, ws._STATUS.size))
        return granted

    def batch(seq, thdr):
        return (ws._HDR.pack(ws._MAGIC, ws._OP_DEPOSIT_BATCH, 0) + thdr
                + ws._BATCH_HDR.pack(seq, 1) + item + name_b
                + arr.tobytes())

    def drain(s):
        s.shutdown(socket.SHUT_WR)
        while s.recv(4096):
            pass

    want = ws.FEATURE_BATCH | ws.FEATURE_TRACE
    applied = 0
    try:
        for trial in range(60):
            mode = trial % 5
            should_apply = mode in (1, 3)
            try:
                with socket.create_connection(("127.0.0.1", port),
                                              timeout=10) as s:
                    s.settimeout(5)
                    if mode == 0:
                        # header granted but absent: the server misparses
                        # the batch as a header; at worst this connection
                        # dies
                        assert hello(s, want) & ws.FEATURE_TRACE
                        s.sendall(batch(1, b""))
                        drain(s)
                    elif mode == 1:
                        # garbage ids (sid 0 half the time): the header
                        # parses, the frame applies once, with a timed ack
                        hello(s, want)
                        thdr = ws._TRACE_HDR.pack(
                            int(rng.integers(0, 1 << 63)),
                            int(rng.integers(0, 2))
                            * int(rng.integers(1, 1 << 63)),
                            int(rng.integers(0, 1 << 32)))
                        s.sendall(batch(1, thdr))
                        ack = _recv_exactly(
                            s, ws._ACK.size + ws._ACK_TIMES.size)
                        assert ws._ACK.unpack(ack[:ws._ACK.size]) == (1, 1)
                    elif mode == 2:
                        # truncated inside the trace header
                        hello(s, want)
                        cut = int(rng.integers(1, ws._TRACE_HDR.size))
                        full = batch(1, ws._TRACE_HDR.pack(7, 7, 7))
                        s.sendall(full[:ws._HDR.size + cut])
                        drain(s)
                    elif mode == 3:
                        # a peer without FEATURE_TRACE: no header, the
                        # plain 12-byte ack
                        assert hello(s, ws.FEATURE_BATCH) & ws.FEATURE_BATCH
                        s.sendall(batch(1, b""))
                        assert ws._ACK.unpack(
                            _recv_exactly(s, ws._ACK.size)) == (1, 1)
                    else:
                        # a header sent without the bit: 20 bytes of junk
                        # ops, the connection drops, nothing applies
                        hello(s, ws.FEATURE_BATCH)
                        s.sendall(batch(1, ws._TRACE_HDR.pack(9, 9, 9)))
                        drain(s)
            except OSError:
                pass  # a torn connection is an allowed outcome
            buf, fresh = win.read(0, consume=True)
            if should_apply:
                applied += 1
                assert fresh == 1, (trial, mode, fresh)
                np.testing.assert_array_equal(buf, arr)
            else:
                assert fresh == 0, (trial, mode, fresh)
        assert applied == 24
        # the server is healthy for a fresh traced client
        rw = PW.PipelinedRemoteWindow(("127.0.0.1", port), name)
        try:
            rw.deposit_async(0, arr, accumulate=True)
            rw.flush()
            assert win.read(0, consume=True)[1] == 1
        finally:
            rw.close()
    finally:
        srv.stop()
        win.free()


# ---------------------------------------------------------------------------
# 6. a server:delay rule: the analyzers name the edge into that server
# ---------------------------------------------------------------------------


def _rank_loop(tr, my_win, peer, rounds, compute_s, errors):
    try:
        for k in range(rounds):
            with tr.span("round", "dsgd", round_=k):
                with tr.span("gossip", "dsgd", round_=k):
                    my_win.read(0, consume=True)
                with tr.span("compute", "dsgd", round_=k):
                    time.sleep(compute_s)
                with tr.span("gossip", "dsgd", round_=k):
                    peer.deposit_async(0, np.full(64, float(k)),
                                       accumulate=True)
                    peer.flush()
    except BaseException as e:  # noqa: BLE001 (reported by the test)
        errors.append(e)


def test_server_delay_names_the_edge_into_the_delayed_server(tmp_path):
    """Rank 0 runs on the port, rank 1 on the JAX package, in one process
    (one recorder a package).  Rank 1's window server delays every
    inbound frame by 40 ms (``server:delay``, on the JAX package's
    injector only); both analyzers name rank 0 -> rank 1 as the critical
    path, with a phase split."""
    job = _name("trc_chaos")
    PT.configure(str(tmp_path), rank=0, job=job)
    RT.configure(str(tmp_path), rank=1, job=job)
    RC.configure("server:delay:ms=40")
    w0 = PA.AsyncWindow(f"{job}:0", n_slots=1, n_elems=64, dtype=np.float64)
    w1 = RA.AsyncWindow(f"{job}:1", n_slots=1, n_elems=64, dtype=np.float64)
    s0, p0 = _serve(PW)
    s1, p1 = _serve(RW)
    errors = []
    c01 = c10 = None
    try:
        c01 = PW.PipelinedRemoteWindow(("127.0.0.1", p1), f"{job}:1")
        c10 = RW.PipelinedRemoteWindow(("127.0.0.1", p0), f"{job}:0")
        threads = [
            threading.Thread(target=_rank_loop,
                             args=(PT, w0, c01, 10, 0.005, errors)),
            threading.Thread(target=_rank_loop,
                             args=(RT, w1, c10, 10, 0.010, errors))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors
        assert c01.phase_ewma() is not None
    finally:
        for c in (c01, c10):
            if c is not None:
                c.close()
        s0.stop()
        s1.stop()
        w0.free()
        w1.free()
    _flush_all()
    reports = [an.analyze(str(tmp_path)) for an in (PAN, RAN)]
    for rep in reports:
        cp = rep["critical_path"]
        assert cp["gating_edge"] == [0, 1], cp
        assert rep["edges"]["0->1"]["wire_mean_s"] >= 0.04
        assert set(rep["edges"]["0->1"]["phase_mean_s"]) >= {
            "recv", "queue_wait", "apply", "net"}
    assert json.dumps(reports[0], default=str) == json.dumps(
        reports[1], default=str)

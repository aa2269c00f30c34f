"""The port's flight recorder (``bluefog_tpu_torch/blackbox``) against the
JAX package's (``bluefog_tpu/blackbox``), following ``tests/test_blackbox.py``:

- ``TestRecorder``'s and ``TestDump``'s cases on the port;
- ``TestMerge``'s incidents written by each package's recorder and read by
  each package's merge, with equal diagnoses;
- ``collect_attempt`` across restarts, and ``run_supervised(incident_dir=)``
  collecting a dump across one restart;
- the lock-order tripwire's ``lock_order_cycle`` event in the ring;
- the per-call collective events: one ``collective_begin``/``_end`` pair a
  call with ``BLUEFOG_TPU_BLACKBOX=jit``, none in the default host mode;
- the thread DSGD loop under the tripwire, cycle-free;
- the SIGSTOP forensics round trip over the port's TCP windows (``slow``,
  as the JAX package's).

The JAX package's jitted-program cases (identical jaxprs, unordered
callbacks, the lint) have no counterpart: the port runs eagerly.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bluefog_tpu.blackbox import merge as RM
from bluefog_tpu.blackbox import recorder as RREC
from bluefog_tpu_torch import blackbox
from bluefog_tpu_torch.blackbox import merge, recorder
from tests._util import REPO, clean_env, uniq

N = 8


@pytest.fixture(autouse=True)
def _blackbox_clean(monkeypatch, tmp_path):
    """Every case starts with pristine recorders in both packages and no
    ambient blackbox variables; stray dumps land in the case's tmp dir."""
    for var in ("BLUEFOG_TPU_BLACKBOX", "BLUEFOG_TPU_BLACKBOX_CAPACITY",
                "BLUEFOG_TPU_RANK", "BLUEFOG_TPU_WORLD", "RANK",
                "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("BLUEFOG_TPU_BLACKBOX_DIR",
                       str(tmp_path / "ambient-blackbox"))
    dmods = [sys.modules["bluefog_tpu_torch.blackbox.dump"]]
    for rec in (recorder, RREC):
        rec.reset()
    for d in dmods:
        d._prior_headers.clear()
    yield
    for rec in (recorder, RREC):
        rec.reset()
    for d in dmods:
        d._prior_headers.clear()


def _read_dump(path):
    return [json.loads(line) for line in open(path) if line.strip()]


# ---------------------------------------------------------------------------
# 1. the ring
# ---------------------------------------------------------------------------


class TestRecorder:
    def test_ring_is_bounded_and_ordered(self):
        rec = recorder.FlightRecorder(capacity=16)
        for i in range(100):
            rec.record("e", i=i)
        assert [e["i"] for e in rec.events()] == list(range(84, 100))
        assert rec.dropped == 84

    def test_begin_end_tracks_open_spans(self):
        rec = recorder.FlightRecorder(capacity=64)
        rec.begin("collective", key=("c", 0), op="g", step=0)
        rec.begin("collective", key=("c", 1), op="g", step=1)
        rec.end("collective", key=("c", 0), op="g", step=0)
        (open_ev,) = rec.open_spans()
        assert open_ev["step"] == 1
        assert [e["kind"] for e in rec.events()] == [
            "collective_begin", "collective_begin", "collective_end"]
        rec2 = recorder.FlightRecorder(capacity=8)
        for i in range(2000):
            rec2.begin("collective", key=("c", i), i=i)
        assert len(rec2.open_spans()) <= recorder._MAX_OPEN

    def test_occurrence_pairing_is_fifo(self):
        rec = recorder.FlightRecorder(capacity=64)
        k = ("na#0", 3)
        o1, o2 = rec.begin_occurrence(k), rec.begin_occurrence(k)
        assert o1 != o2
        assert rec.end_occurrence(k) == o1
        assert rec.end_occurrence(k) == o2
        assert rec.end_occurrence(k) not in (o1, o2)

    def test_snapshot_survives_held_lock(self):
        rec = recorder.FlightRecorder(capacity=8)
        rec.record("e", i=1)
        rec._lock.acquire()
        try:
            t0 = time.monotonic()
            assert [e["i"] for e in rec.events()] == [1]
            assert time.monotonic() - t0 < 5.0
        finally:
            rec._lock.release()

    def test_env_capacity_and_off_switch(self, monkeypatch):
        monkeypatch.setenv("BLUEFOG_TPU_BLACKBOX_CAPACITY", "5")
        assert recorder.FlightRecorder().capacity == 5
        monkeypatch.setenv("BLUEFOG_TPU_BLACKBOX", "0")
        assert not recorder.enabled() and recorder.get() is None
        recorder.record("e")  # a silent no-op
        x = torch.ones(4)
        assert recorder.traced_event(x, "e") is x
        assert blackbox.dump("test") is None

    def test_on_by_default_host_mode_only(self):
        assert recorder.enabled() and not recorder.jit_enabled()
        recorder.record("e", k=1)
        (ev,) = recorder.get().events()
        assert ev["kind"] == "e" and ev["k"] == 1

    def test_always_on_host_paths_feed_the_ring(self):
        from bluefog_tpu_torch.runtime.async_windows import AsyncWindow

        name = uniq("tbbx_unit_win")
        win = AsyncWindow(name, 1, 4, np.float64)
        try:
            win.deposit(0, np.ones(4))
            win.read(0, consume=True)
        finally:
            win.free()
        evs = recorder.get().events()
        kinds = [e["kind"] for e in evs]
        assert "window_deposit" in kinds and "window_read" in kinds
        dep = [e for e in evs if e["kind"] == "window_deposit"][0]
        assert dep["window"] == name and dep["bytes"] == 32


# ---------------------------------------------------------------------------
# 2. per-call collective events
# ---------------------------------------------------------------------------


class TestPerCallEvents:
    def _gossip(self, calls=2):
        from bluefog_tpu_torch.ops.collectives import neighbor_allreduce
        from bluefog_tpu_torch.topology import RingGraph, build_schedule

        sched = build_schedule(RingGraph(N))
        x = torch.ones(N, 4)
        for _ in range(calls):
            x = neighbor_allreduce(x, sched)
        return x

    def test_none_in_host_mode(self):
        self._gossip()
        assert not [e for e in recorder.get().events()
                    if e["kind"].startswith("collective_")]

    def test_one_pair_per_call_in_jit_mode(self, monkeypatch):
        monkeypatch.setenv("BLUEFOG_TPU_BLACKBOX", "jit")
        out = self._gossip(calls=3)
        rec = recorder.get()
        begins = [e for e in rec.events() if e["kind"] == "collective_begin"]
        ends = [e for e in rec.events() if e["kind"] == "collective_end"]
        assert len(begins) == len(ends) == 3
        assert [e["op"] for e in begins] == ["neighbor_allreduce"] * 3
        assert len({e["cid"] for e in begins}) == 3  # one id a call
        assert begins[0]["bytes"] == 16  # one rank's 4 f32
        assert rec.open_spans() == []
        # nothing changes a result
        monkeypatch.setenv("BLUEFOG_TPU_BLACKBOX", "0")
        assert torch.equal(self._gossip(calls=3), out)

    def test_window_and_optimizer_events(self, monkeypatch):
        from bluefog_tpu_torch.ops import windows as W
        from bluefog_tpu_torch.optim import (
            DistributedNeighborAllreduceOptimizer)
        from bluefog_tpu_torch.topology import RingGraph, build_schedule

        monkeypatch.setenv("BLUEFOG_TPU_BLACKBOX", "jit")
        sched = build_schedule(RingGraph(4))
        st = W.win_create(torch.ones(4, 3), sched, name="bbwin")
        W.win_put(st, torch.ones(4, 3))
        w = torch.nn.Parameter(torch.ones(4, 3))
        opt = DistributedNeighborAllreduceOptimizer(
            torch.optim.SGD([w], lr=0.1), topology=RingGraph(4))
        w.grad = torch.ones(4, 3)
        opt.step()
        evs = recorder.get().events()
        assert [e["op"] for e in evs if e["kind"] == "collective_begin"] \
            == ["win_put", "neighbor_allreduce"]
        (step,) = [e for e in evs if e["kind"] == "optimizer_step"]
        assert step["step"] == 0 and step["opt"] == "neighbor.allreduce"
        assert recorder.get().open_spans() == []

    def test_deferred_end_waits_for_its_event(self):
        """On the card an end enters the ring only once its recorded
        event completes: a pending end is held until settle sees it."""

        class Ev:
            done = False

            def query(self):
                return self.done

        rec = recorder.FlightRecorder(capacity=16)
        base = ("g#0", None)
        rec.begin("collective", key=base + (rec.begin_occurrence(base),),
                  op="g", cid="g#0")
        ev = Ev()
        rec.defer_end(ev, "collective", base, None, {"op": "g", "cid": "g#0"})
        assert rec.settle() == 1 and len(rec.open_spans()) == 1
        ev.done = True
        assert rec.settle() == 0 and rec.open_spans() == []
        assert [e["kind"] for e in rec.events()] == ["collective_begin",
                                                     "collective_end"]


# ---------------------------------------------------------------------------
# 3. dumps
# ---------------------------------------------------------------------------


class TestDump:
    def test_dump_file_structure(self, tmp_path):
        rec = recorder.configure(capacity=32, rank=3)
        rec.begin("collective", key=("c", 0), op="g", cid="g#0", step=7)
        path = blackbox.dump("unit_test", directory=str(tmp_path),
                             extra={"note": "x"})
        assert path and path.endswith("blackbox-rank3.jsonl")
        lines = _read_dump(path)
        hdr = lines[0]
        assert hdr["header"] and hdr["rank"] == 3 \
            and hdr["reason"] == "unit_test" and hdr["note"] == "x"
        (spans,) = [l["open_spans"] for l in lines if "open_spans" in l]
        assert spans and spans[0]["step"] == 7
        (stacks,) = [l["stacks"] for l in lines if "stacks" in l]
        assert any("MainThread" in s["thread"] for s in stacks)
        assert lines[-1]["end"] is True

    def test_dump_embeds_metrics_snapshot(self, tmp_path):
        from bluefog_tpu_torch.metrics import registry as mreg

        try:
            mreg.metrics_start().counter("bf_test_total").inc(5)
            path = blackbox.dump("with_metrics", directory=str(tmp_path))
            (metrics,) = [l["metrics"] for l in _read_dump(path)
                          if "metrics" in l]
            assert metrics["bf_test_total"] == 5
        finally:
            mreg.metrics_stop()
            mreg._STOPPED = False

    def test_default_rank_reads_the_launcher(self, monkeypatch):
        assert blackbox.default_rank() == 0
        monkeypatch.setenv("RANK", "3")
        assert blackbox.default_rank() == 3
        monkeypatch.setenv("BLUEFOG_TPU_RANK", "5")
        assert blackbox.default_rank() == 5

    def test_watchdog_dumps_with_last_step_and_counts_the_hang(
            self, tmp_path, monkeypatch):
        from bluefog_tpu_torch.metrics import registry as mreg
        from bluefog_tpu_torch.utils.failure import Heartbeat

        monkeypatch.setenv("BLUEFOG_TPU_BLACKBOX_DIR", str(tmp_path))
        monkeypatch.setenv("BLUEFOG_TPU_RANK", "5")
        try:
            reg = mreg.metrics_start()
            path = tmp_path / "blackbox-rank5.jsonl"
            with Heartbeat(0.25, action="callback") as hb:
                hb.beat(123)
                deadline = time.monotonic() + 10.0
                while not path.exists() and time.monotonic() < deadline:
                    time.sleep(0.05)
            assert path.exists(), "watchdog never dumped"
            lines = _read_dump(path)
            hdr = lines[0]
            assert (hdr["reason"], hdr["last_step"], hdr["beats"]) == (
                "heartbeat_timeout", 123, 1)
            assert any(l.get("event", {}).get("kind") == "heartbeat_beat"
                       for l in lines)
            assert reg.snapshot()['bf_hangs_total{action="callback"}'] >= 1
        finally:
            mreg.metrics_stop()
            mreg._STOPPED = False

    def test_install_excepthook_dumps_on_uncaught(self, tmp_path):
        script = tmp_path / "crasher.py"
        script.write_text(
            "from bluefog_tpu_torch import blackbox\n"
            "assert blackbox.install()\n"
            "from bluefog_tpu_torch.blackbox import recorder\n"
            "recorder.record('optimizer_step', step=9)\n"
            "raise RuntimeError('boom')\n")
        env = clean_env()
        env["BLUEFOG_TPU_BLACKBOX_DIR"] = str(tmp_path / "inc")
        env["RANK"] = "4"
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=120,
                              env=env, cwd=REPO)
        assert proc.returncode != 0
        path = tmp_path / "inc" / "blackbox-rank4.jsonl"
        assert path.exists(), proc.stderr
        hdr = _read_dump(path)[0]
        assert hdr["reason"] == "exception:RuntimeError"
        assert "boom" in hdr["exception"]

    def test_signal_handler_chains_user_handler(self, tmp_path):
        script = tmp_path / "sig.py"
        script.write_text(
            "import os, signal, sys\n"
            "marker = sys.argv[1]\n"
            "def user_handler(signum, frame):\n"
            "    open(marker, 'w').close()\n"
            "    os._exit(0)\n"
            "signal.signal(signal.SIGTERM, user_handler)\n"
            "from bluefog_tpu_torch import blackbox\n"
            "assert blackbox.install()\n"
            "os.kill(os.getpid(), signal.SIGTERM)\n"
            "import time; time.sleep(30)\n")
        marker = tmp_path / "user_handler_ran"
        env = clean_env()
        env["BLUEFOG_TPU_BLACKBOX_DIR"] = str(tmp_path / "inc")
        env["BLUEFOG_TPU_RANK"] = "6"
        proc = subprocess.run([sys.executable, str(script), str(marker)],
                              capture_output=True, text=True, timeout=120,
                              env=env, cwd=REPO)
        assert proc.returncode == 0, (proc.returncode, proc.stderr)
        assert marker.exists()
        path = tmp_path / "inc" / "blackbox-rank6.jsonl"
        assert _read_dump(path)[0]["reason"] == "signal:SIGTERM"

    def test_install_is_wired_into_init(self):
        import bluefog_tpu_torch as bf

        dmod = sys.modules["bluefog_tpu_torch.blackbox.dump"]
        prev = dmod._installed
        try:
            dmod._installed = False
            bf.init(size=2, device="cpu")
            assert dmod._installed
        finally:
            dmod._installed = prev
            bf.shutdown()

    def test_later_dump_carries_earlier_headers_forward(self, tmp_path):
        recorder.configure(capacity=16, rank=0)
        blackbox.dump("heartbeat_timeout", directory=str(tmp_path),
                      extra={"last_step": 77})
        path = blackbox.dump("signal:SIGTERM", directory=str(tmp_path))
        hdr = _read_dump(path)[0]
        assert hdr["reason"] == "signal:SIGTERM"
        (prev,) = [p for p in hdr["previous_dumps"]
                   if p["reason"] == "heartbeat_timeout"]
        assert prev["last_step"] == 77

    def test_collect_attempt_layers_restarts(self, tmp_path):
        recorder.configure(capacity=8, rank=0)
        blackbox.dump("attempt1", directory=str(tmp_path))
        assert blackbox.collect_attempt(str(tmp_path), 1) == 1
        blackbox.dump("attempt2", directory=str(tmp_path))
        for mod in (merge, RM):  # newest wins per rank, in both merges
            assert mod.load_incident(str(tmp_path))[0].header["reason"] \
                == "attempt2"
        layered = tmp_path / "restart-1" / "blackbox-rank0.jsonl"
        assert _read_dump(layered)[0]["reason"] == "attempt1"

    def test_supervisor_collects_a_dump_across_a_restart(self, tmp_path):
        from bluefog_tpu_torch.utils.failure import run_supervised

        incident = str(tmp_path / "incident")
        script = tmp_path / "worker.py"
        script.write_text(
            "import os\n"
            f"marker = {str(tmp_path / 'crashed_once')!r}\n"
            "from bluefog_tpu_torch import blackbox\n"
            "from bluefog_tpu_torch.blackbox import recorder\n"
            "recorder.get().record('optimizer_step', step=1)\n"
            "if not os.path.exists(marker):\n"
            "    open(marker, 'w').close()\n"
            "    blackbox.dump('simulated_crash')\n"
            "    os._exit(17)\n"
            "print('WORKER_DONE')\n")
        env = clean_env()
        # an explicit incident_dir beats an ambient variable
        env["BLUEFOG_TPU_BLACKBOX_DIR"] = str(tmp_path / "wrong-dir")
        assert run_supervised([sys.executable, str(script)], max_restarts=2,
                              env=env, incident_dir=incident,
                              restart_backoff_s=0.05) == 0
        layered = os.path.join(incident, "restart-1", "blackbox-rank0.jsonl")
        assert _read_dump(layered)[0]["reason"] == "simulated_crash"
        for mod in (merge, RM):
            (marker,) = mod.load_supervisor_restarts(incident)
            assert marker["attempt"] == 1 and marker["returncode"] == 17
        assert not os.path.exists(tmp_path / "wrong-dir")


# ---------------------------------------------------------------------------
# 4. merge: each package reads the other's dumps to the same diagnosis
# ---------------------------------------------------------------------------


def _simulate_incident(rec_mod, bb_dump, directory, world=3, wedged=2,
                       stop_at=3, dump_wedged=True, step_field=True):
    """Per-rank dumps of a ring run wedged at round ``stop_at`` (the JAX
    package's fixture), written by ``rec_mod``'s recorder and dump."""
    for r in range(world):
        rec = rec_mod.configure(capacity=128, rank=r)
        for step in range(stop_at + 1):
            fields = dict(op="ring", cid="ring#0", rank=r,
                          peers=[(r - 1) % world, (r + 1) % world])
            if step_field:
                fields["step"] = step
            rec.begin("collective", key=("c", r, step), **fields)
            if step == stop_at and (r == wedged or not dump_wedged):
                break
            fields.pop("peers")
            rec.end("collective", key=("c", r, step), **fields)
        if r != wedged or dump_wedged:
            bb_dump("sim", directory=directory, rank=r)
    rec_mod.reset()


def _writers():
    import bluefog_tpu.blackbox as rbb

    return {"port": (recorder, blackbox.dump), "jax": (RREC, rbb.dump)}


def _comparable(report):
    return json.loads(json.dumps(report, default=str))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("shape", [
    dict(),
    dict(wedged=1, dump_wedged=False),
    dict(world=2, wedged=1, step_field=False),
    dict(world=2, wedged=5),
], ids=["wedged", "sigstop", "stepless", "clean"])
def test_each_merge_diagnoses_the_others_dumps_equally(tmp_path, writer,
                                                      shape):
    rec_mod, dump = _writers()[writer]
    _simulate_incident(rec_mod, dump, str(tmp_path), **shape)
    world = shape.get("world", 3)
    reports = [_comparable(mod.diagnose(mod.load_incident(str(tmp_path)),
                                        expect_ranks=world))
               for mod in (merge, RM)]
    assert reports[0] == reports[1]
    traces = [mod.chrome_trace(mod.load_incident(str(tmp_path)))
              for mod in (merge, RM)]
    assert traces[0] == traces[1]
    if shape.get("wedged") == 5:
        assert not reports[0]["stuck_rounds"]
        assert not reports[0]["suspect_ranks"]
    elif shape.get("dump_wedged") is False:
        assert reports[0]["suspect_ranks"] == [1]
    else:
        assert reports[0]["suspect_ranks"] == [shape.get("wedged", 2)]


class TestMerge:
    def test_orphan_end_and_eviction_caveats(self, tmp_path):
        rec = recorder.configure(capacity=64, rank=0)
        rec.record("collective_end", op="na", cid="na#0", rank=0)
        for _ in range(2):
            rec.record("collective_begin", op="na", cid="na#0", rank=0)
            rec.record("collective_end", op="na", cid="na#0", rank=0)
        blackbox.dump("trunc", directory=str(tmp_path / "a"), rank=0)
        assert not merge.diagnose(merge.load_incident(
            str(tmp_path / "a")))["stuck_rounds"]
        rec = recorder.configure(capacity=4, rank=0)
        for i in range(10):
            rec.record("e", i=i)
        blackbox.dump("evict", directory=str(tmp_path / "b"), rank=0)
        (path,) = (tmp_path / "b").glob("blackbox-rank0.jsonl")
        with open(path, "a") as f:
            f.write('{"event": {"kind": "collec')  # a torn line
        (caveat,) = merge.diagnose(merge.load_incident(
            str(tmp_path / "b")))["caveats"]
        assert "evicted 6 event(s)" in caveat
        assert "1 torn line(s)" in caveat

    def test_cli_round_trip_with_trace_export(self, tmp_path):
        _simulate_incident(recorder, blackbox.dump, str(tmp_path), wedged=1,
                           dump_wedged=False)
        trace = str(tmp_path / "merged.json")
        proc = subprocess.run(
            [sys.executable, "-m", "bluefog_tpu_torch.blackbox",
             str(tmp_path), "--expect-ranks", "3", "--trace", trace],
            capture_output=True, text=True, timeout=120, env=clean_env(),
            cwd=REPO)
        assert proc.returncode == 0, proc.stderr
        assert "suspect rank(s): [1]" in proc.stdout
        assert "HANG" in proc.stdout and "ring#0" in proc.stdout
        pids = {e["pid"] for e in json.load(open(trace))
                if e.get("ph") in ("b", "e")}
        assert pids == {0, 2}
        assert merge.main([str(tmp_path / "empty")]) == 1


# ---------------------------------------------------------------------------
# 5. the tripwire's event and the runtime under it
# ---------------------------------------------------------------------------


def test_lock_order_cycle_is_recorded_in_the_ring():
    from bluefog_tpu_torch.utils import lockcheck

    recorder.configure()
    try:
        lockcheck.enable(raise_on_cycle=False)
        a, b = lockcheck.lock("bb.a"), lockcheck.lock("bb.b")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        evts = [e for e in recorder.get().events()
                if e["kind"] == "lock_order_cycle"]
        assert evts and evts[0]["held"] == "bb.b", evts
    finally:
        lockcheck.disable()
        lockcheck.reset()


def test_thread_dsgd_loop_is_cycle_free():
    """``TestRuntimeUnderTripwire.test_thread_dsgd_loop_is_cycle_free`` on
    the port's thread runner: raise-on-cycle armed for a whole run."""
    from bluefog_tpu_torch import topology as T
    from bluefog_tpu_torch.runtime.async_windows import run_async_dsgd
    from bluefog_tpu_torch.utils import lockcheck

    lockcheck.reset()
    lockcheck.enable()
    try:
        report = run_async_dsgd(
            T.RingGraph(3), {"w": torch.ones(6)},
            lambda r, s, p: (0.0, {k: torch.zeros_like(v)
                                   for k, v in p.items()}),
            lr=0.01, duration_s=1.0, skew=[0.002] * 3,
            name=uniq("tlc_dsgd"))
        assert abs(report.total_mass - 3.0) < 1e-9
        assert lockcheck.violations() == []
        assert [c for c in lockcheck.cycles() if len(c) > 1] == []
        # tracking was live for the whole run
        probe_a, probe_b = lockcheck.lock("probe.a"), lockcheck.lock("probe.b")
        with probe_a:
            with probe_b:
                pass
        assert ("probe.a", "probe.b") in lockcheck.edges()
    finally:
        lockcheck.disable()
        lockcheck.reset()


# ---------------------------------------------------------------------------
# 6. end-to-end forensics over processes (SIGSTOP)
# ---------------------------------------------------------------------------


@pytest.mark.slow
class TestSigstopForensics:
    WORLD = 3
    VICTIM = 1

    def test_sigstop_rank_is_named_with_its_round(self, tmp_path):
        incident = str(tmp_path / "incident")
        barrier = str(tmp_path / "barrier")
        os.makedirs(incident)
        env = clean_env()
        env["BLUEFOG_TPU_BLACKBOX_DIR"] = incident
        procs = []
        try:
            for r in range(self.WORLD):
                procs.append(subprocess.Popen(
                    [sys.executable,
                     os.path.join(REPO, "tests", "_torch_blackbox_worker.py"),
                     str(r), str(self.WORLD), barrier, "50",
                     str(self.VICTIM)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, env=env, cwd=REPO))
            victim = procs[self.VICTIM]
            seen = 0
            deadline = time.monotonic() + 120
            for line in victim.stdout:
                if line.startswith("STEP "):
                    seen = int(line.split()[1])
                    if seen >= 2:
                        break
                assert time.monotonic() < deadline, "victim never started"
            os.kill(victim.pid, signal.SIGSTOP)
            want = [os.path.join(incident, f"blackbox-rank{r}.jsonl")
                    for r in range(self.WORLD) if r != self.VICTIM]
            deadline = time.monotonic() + 90
            while not all(os.path.exists(p) for p in want):
                assert time.monotonic() < deadline, \
                    f"survivors never dumped: {os.listdir(incident)}"
                time.sleep(0.25)
            proc = subprocess.run(
                [sys.executable, "-m", "bluefog_tpu_torch.blackbox",
                 incident, "--expect-ranks", str(self.WORLD)],
                capture_output=True, text=True, timeout=120, env=env,
                cwd=REPO)
            assert proc.returncode == 0, proc.stderr
            out = proc.stdout
            assert f"missing dumps from ranks [{self.VICTIM}]" in out
            assert f"suspect rank(s): [{self.VICTIM}]" in out
            assert "ring_round#0" in out
            report = merge.diagnose(merge.load_incident(incident),
                                    expect_ranks=self.WORLD)
            stuck = report["stuck_rounds"][0]
            assert stuck["cid"] == "ring_round#0"
            assert stuck["step"] in (seen + 1, seen + 2), (stuck, seen)
            assert all(self.VICTIM in s["peers_of_stuck"]
                       for s in report["stuck_rounds"])
            # the JAX package's merge reads the port's dumps the same way
            assert _comparable(RM.diagnose(RM.load_incident(incident),
                                           expect_ranks=self.WORLD)) \
                == _comparable(report)
        finally:
            for p in procs:
                try:
                    os.kill(p.pid, signal.SIGCONT)
                except OSError:
                    pass
                p.kill()
                p.wait()
                if p.stdout:
                    p.stdout.close()

"""The port's metrics package (``bluefog_tpu_torch/metrics``) against the JAX
package's (``bluefog_tpu/metrics``), following ``tests/test_metrics.py``:

- ``TestRegistry``'s cases on the port, and the two registries' snapshots
  equal after the same updates;
- ``TestCommAccounting``'s cases as parity: the same schedule and tree go
  through the JAX collective under its CPU mesh with its registry on, then
  through the port's with its registry on, and every series is equal (the
  port's ``'plain'`` route carries the JAX package's ``backend="xla"``
  label; its K1 route the label ``"pallas"`` and the chunk counter);
- the health gauges: ``consensus_distance`` and
  ``consensus_distance_stacked`` against the JAX forms, the
  ``MixingTracker`` gauges and the heartbeat age;
- the exports: Prometheus text byte-equal, and each package's dash
  summarizing the other's JSONL the same;
- hooks that are the identity when off, and a ResNet step with metrics on
  bit-equal to one with them off.

The JAX package's jitted-callback cases (its ``TestDisabledOverheadAndLint``)
have no counterpart: the port's hooks are host calls.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu.metrics import dash as RD
from bluefog_tpu.metrics import export as RE
from bluefog_tpu.metrics import health as RH
from bluefog_tpu.metrics import registry as RRG
from bluefog_tpu.parallel.api import shard_map
from bluefog_tpu.topology import (FullyConnectedGraph as RFull,
                                  RingGraph as RRing,
                                  build_schedule as r_build)
from bluefog_tpu_torch.metrics import comm as PC
from bluefog_tpu_torch.metrics import dash as PD
from bluefog_tpu_torch.metrics import export as PE
from bluefog_tpu_torch.metrics import health as PH
from bluefog_tpu_torch.metrics import registry as PRG
from bluefog_tpu_torch.topology import (FullyConnectedGraph as PFull,
                                        RingGraph as PRing,
                                        build_schedule as p_build)
from tests._util import REPO, clean_env, uniq

N = 8


def _stop_all():
    os.environ.pop("BLUEFOG_TPU_METRICS", None)
    for reg in (RRG, PRG):
        reg.metrics_stop()
        reg._STOPPED = False


@pytest.fixture(autouse=True)
def _metrics_clean():
    """Every case starts and ends with both packages' metrics off."""
    _stop_all()
    yield
    _stop_all()


def _smap(fn):
    mesh = Mesh(np.array(jax.devices()[:N]), ("bf",))
    return shard_map(fn, mesh=mesh, in_specs=(P("bf"),), out_specs=P("bf"),
                     check_vma=False)


def _ref_snapshot(fn, x):
    """Run ``fn`` under the JAX package's CPU mesh with its registry on;
    its snapshot."""
    reg = RRG.metrics_start()
    jax.jit(_smap(fn))(jnp.asarray(x))
    jax.effects_barrier()
    snap = reg.snapshot()
    RRG.metrics_stop()
    return snap


def _port_snapshot(fn, x):
    reg = PRG.metrics_start()
    fn(torch.from_numpy(np.asarray(x)))
    snap = reg.snapshot()
    PRG.metrics_stop()
    return snap


# ---------------------------------------------------------------------------
# 1. registry semantics
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_counter_accumulates_per_label_set(self):
        reg = PRG.MetricsRegistry()
        c = reg.counter("bytes_total")
        c.inc(10, op="a")
        c.inc(5, op="a")
        c.inc(1, op="b")
        c.inc(2)
        snap = reg.snapshot()
        assert snap['bytes_total{op="a"}'] == 15
        assert snap['bytes_total{op="b"}'] == 1
        assert snap["bytes_total"] == 2

    def test_label_order_and_kind_conflicts(self):
        reg = PRG.MetricsRegistry()
        reg.counter("c").inc(1, a="1", b="2")
        reg.counter("c").inc(1, b="2", a="1")
        assert reg.snapshot() == {'c{a="1",b="2"}': 2.0}
        with pytest.raises(ValueError, match="cannot decrease"):
            reg.counter("c").inc(-1)
        with pytest.raises(TypeError, match="already registered as counter"):
            reg.gauge("c")

    def test_histogram_and_gauges(self):
        reg = PRG.MetricsRegistry()
        h = reg.histogram("h")
        for v in range(1, 101):
            h.observe(float(v))
        reg.gauge("g").set(1.0)
        reg.gauge("g").set(4.5)
        box = {"v": 1.0}
        reg.gauge_fn("age", lambda: box["v"])
        reg.gauge_fn("boom", lambda: 1 / 0)
        box["v"] = 7.0
        snap = reg.snapshot()
        assert (snap["h_count"], snap["h_sum"], snap["h_min"], snap["h_max"],
                snap["h_p50"], snap["h_p99"]) == (100, 5050, 1, 100, 50, 99)
        assert snap["g"] == 4.5 and snap["age"] == 7.0
        assert np.isnan(snap["boom"])

    def test_same_updates_same_snapshot_as_the_jax_package(self):
        snaps = []
        for mod in (RRG, PRG):
            reg = mod.MetricsRegistry()
            reg.counter("x_total").inc(3, op="a")
            reg.gauge("g").set(2.5, rank="1")
            for v in (0.5, 0.25, 4.0):
                reg.histogram("lat_seconds").observe(v, peer="p")
            snaps.append(reg.snapshot())
        assert snaps[0] == snaps[1]
        assert RRG.quantile([1.0, 2.0, 3.0], 0.5) == PRG.quantile(
            [1.0, 2.0, 3.0], 0.5)
        assert RRG.median([4, 1, 3, 2]) == PRG.median([4, 1, 3, 2])

    def test_thread_safety_exact_total(self):
        import threading

        reg = PRG.MetricsRegistry()
        c = reg.counter("c")
        threads = [threading.Thread(
            target=lambda: [c.inc(1, t="x") for _ in range(1000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert reg.snapshot()['c{t="x"}'] == 8000

    def test_off_by_default_and_env_var_lazily_activates(self, tmp_path):
        assert PRG.current() is None and not PRG.metrics_active()
        os.environ["BLUEFOG_TPU_METRICS"] = str(tmp_path / "m.jsonl")
        assert PRG.current() is not None

    def test_stop_is_sticky_under_env_var(self, tmp_path):
        path = tmp_path / "m.jsonl"
        os.environ["BLUEFOG_TPU_METRICS"] = str(path)
        PRG.current().counter("c").inc(1)
        PE.step(0)
        PRG.metrics_stop()
        size_after_stop = path.stat().st_size
        assert size_after_stop > 0
        PC.inc("c", 1)  # a host hook must not resurrect the registry
        assert PRG.current() is None
        assert path.stat().st_size == size_after_stop
        PRG.metrics_start(str(path))  # an explicit restart appends
        PE.step(1)
        assert path.stat().st_size > size_after_stop

    def test_remove_gauge_fn_drops_stale_value(self):
        reg = PRG.metrics_start()
        reg.gauge_fn("age", lambda: 3.0)
        assert reg.snapshot()["age"] == 3.0
        reg.remove_gauge_fn("age")
        assert "age" not in reg.snapshot()


# ---------------------------------------------------------------------------
# 2. comm accounting: every series equal to the JAX package's
# ---------------------------------------------------------------------------


class TestCommAccounting:
    def test_neighbor_allreduce_ring_equals_the_jax_package(self):
        from bluefog_tpu.ops.collectives import neighbor_allreduce as r_na
        from bluefog_tpu_torch.ops.collectives import neighbor_allreduce

        rs, ps = r_build(RRing(N)), p_build(PRing(N))
        x = np.random.default_rng(0).standard_normal((N, 16)).astype(
            np.float32)

        def twice_ref(v):
            return r_na(r_na(v, rs, "bf"), rs, "bf")

        def twice_port(v):
            return neighbor_allreduce(neighbor_allreduce(
                v, ps, backend="plain"), ps, backend="plain")

        ref, port = _ref_snapshot(twice_ref, x), _port_snapshot(twice_port, x)
        assert port == ref
        key = (f'bf_comm_bytes_total{{backend="xla",'
               f'op="neighbor_allreduce",schedule="{rs.name}"}}')
        assert port[key] == 2 * N * rs.num_slots * 16 * 4

    def test_k1_route_labels_pallas_and_counts_its_launches(self):
        from bluefog_tpu_torch.ops.collectives import neighbor_allreduce

        ps = p_build(PRing(N))
        tree = {"a": torch.ones(N, 16), "b": torch.ones(N, 3, 2)}
        reg = PRG.metrics_start()
        neighbor_allreduce(tree, ps, backend="kernel")
        snap = reg.snapshot()
        lbl = (f'{{backend="pallas",op="neighbor_allreduce",'
               f'schedule="{ps.name}"}}')
        assert snap["bf_comm_rounds_total" + lbl] == N
        assert snap["bf_comm_bytes_total" + lbl] == N * ps.num_slots * 22 * 4
        assert snap["bf_comm_messages_total" + lbl] == N * 2 * ps.num_slots
        assert snap["bf_comm_pallas_chunks_total" + lbl] == N * 2

    def test_dynamic_records_taken_branch_cost(self):
        from bluefog_tpu.ops.collectives import (
            neighbor_allreduce_dynamic as r_dyn)
        from bluefog_tpu_torch.ops.collectives import (
            neighbor_allreduce_dynamic)

        rs = [r_build(RRing(N)), r_build(RFull(N))]
        ps = [p_build(PRing(N)), p_build(PFull(N))]
        x = np.ones((N, 4), np.float32)
        for step in (0, 1):
            ref = _ref_snapshot(lambda v: r_dyn(v, rs, step, "bf"), x)
            port = _port_snapshot(lambda v: neighbor_allreduce_dynamic(
                v, ps, step, backend="plain"), x)
            assert port == ref, step
            key = ('bf_comm_bytes_total{backend="xla",'
                   'op="neighbor_allreduce_dynamic",schedule="dynamic[2]"}')
            assert port[key] == N * ps[step].num_slots * 16

    def test_window_deliver_accounts_bytes(self):
        from bluefog_tpu.ops import windows as RW
        from bluefog_tpu_torch.ops import windows as PW

        rs, ps = r_build(RRing(N)), p_build(PRing(N))
        x = np.random.default_rng(1).standard_normal((N, 8)).astype(
            np.float32)

        def ref_body(xs):
            st = RW.win_create(xs, rs, "bf", name="mwin")
            st = RW.win_put(st, xs, "bf")
            out, _ = RW.win_update(st, "bf")
            return out

        def port_body(xs):
            st = PW.win_create(xs, ps, name="mwin")
            PW.win_put(st, xs, backend="plain")
            PW.win_update(st)

        ref, port = _ref_snapshot(ref_body, x), _port_snapshot(port_body, x)
        assert port == ref
        (bkey,) = [k for k in port if k.startswith("bf_comm_bytes_total")]
        assert port[bkey] == N * rs.num_slots * 8 * 4

    def test_choco_records_compression_ratio(self):
        from bluefog_tpu.ops import compression as RCP
        from bluefog_tpu_torch.ops import compression as PCP

        rs, ps = r_build(RRing(N)), p_build(PRing(N))
        x = np.ones((N, 64), np.float32)

        def ref_body(xs):
            st = RCP.choco_init(xs, rs)
            out, _ = RCP.choco_gossip(xs, st, rs, "bf",
                                      compressor=RCP.random_block_k(0.25))
            return out

        def port_body(xs):
            PCP.choco_gossip(xs, PCP.choco_init(xs, ps), ps,
                             compressor=PCP.random_block_k(0.25))

        ref, port = _ref_snapshot(ref_body, x), _port_snapshot(port_body, x)
        assert port.keys() == ref.keys()
        for k in ref:
            assert port[k] == pytest.approx(ref[k], rel=1e-6), k
        assert port['bf_compression_ratio{compressor="random_block_k"}'] \
            == pytest.approx(0.25)

    def test_async_window_staleness_metrics(self):
        from bluefog_tpu.runtime.async_windows import AsyncWindow as RAW
        from bluefog_tpu_torch.runtime.async_windows import AsyncWindow

        snaps = []
        for mod, win_cls in ((RRG, RAW), (PRG, AsyncWindow)):
            reg = mod.metrics_start()
            win = win_cls(uniq("tmetrics_win"), 2, 4, np.float64)
            try:
                win.deposit(0, np.ones(4))
                win.read(0, consume=True)   # 1 fresh
                win.read(0, consume=True)   # stale
                snaps.append({k.replace(win.name, "W"): v
                              for k, v in reg.snapshot().items()})
            finally:
                win.free()
            mod.metrics_stop()
        assert snaps[1] == snaps[0]
        assert snaps[1]['bf_window_deposit_bytes_total{transport="local",'
                        'window="W"}'] == 32
        assert snaps[1]['bf_window_stale_reads_total{window="W"}'] == 1

    def test_allreduce_and_hierarchical_equal_the_jax_package(self):
        from bluefog_tpu.ops.collectives import allreduce as r_ar
        from bluefog_tpu.ops.collectives import (
            hierarchical_neighbor_allreduce as r_hier)
        from bluefog_tpu_torch.ops.collectives import (
            allreduce, hierarchical_neighbor_allreduce)

        x = np.random.default_rng(2).standard_normal((N, 6)).astype(
            np.float32)
        ref = _ref_snapshot(lambda v: r_ar(v, "bf"), x)
        port = _port_snapshot(allreduce, x)
        assert port == ref
        rm, pm = r_build(RRing(4)), p_build(PRing(4))
        ref = _ref_snapshot(
            lambda v: r_hier(v, rm, "bf", local_size=2), x)
        port = _port_snapshot(lambda v: hierarchical_neighbor_allreduce(
            v, pm, local_size=2, backend="plain"), x)
        assert port == ref

    def test_optimizer_step_counters(self):
        import optax

        from bluefog_tpu.optim import (
            DistributedNeighborAllreduceOptimizer as RNA)
        from bluefog_tpu_torch.optim import (
            DistributedNeighborAllreduceOptimizer as PNA)

        x = np.random.default_rng(3).standard_normal((N, 4)).astype(
            np.float32)
        ropt = RNA(optax.sgd(0.1), topology=RRing(N), axis_name="bf")

        def ref_body(xs):
            st = ropt.init(xs)
            upd, _ = ropt.update(xs, st, xs)
            return optax.apply_updates(xs, upd)

        ref = _ref_snapshot(ref_body, x)
        reg = PRG.metrics_start()
        w = torch.nn.Parameter(torch.from_numpy(x.copy()))
        popt = PNA(torch.optim.SGD([w], lr=0.1), topology=PRing(N),
                   backend="plain")
        w.grad = torch.from_numpy(x.copy())
        popt.step()
        port = reg.snapshot()
        opt_keys = [k for k in ref if k.startswith("bf_optimizer")]
        assert opt_keys and {k: port[k] for k in opt_keys} == {
            k: ref[k] for k in opt_keys}

    def test_hooks_are_identity_when_disabled(self):
        x = torch.ones(4)
        assert PC.record_collective(
            x, op="o", bytes_per_round=1, messages_per_round=1) is x
        assert PC.count(x, [("c", 1.0)]) is x
        assert PRG.current() is None
        assert PC.tree_bytes({"a": torch.ones(3, 2), "b": np.ones(4)}) \
            == 3 * 2 * 4 + 4 * 8
        assert PC.backend_label("kernel") == "pallas"
        assert PC.backend_label("plain") == "xla"


# ---------------------------------------------------------------------------
# 3. health gauges
# ---------------------------------------------------------------------------


class TestHealth:
    def test_consensus_distance_matches_the_mesh_form(self):
        x = np.random.default_rng(4).standard_normal((N, 5)).astype(
            np.float32)
        ref = np.asarray(jax.jit(_smap(
            lambda v: RH.consensus_distance(v, "bf")[None]))(jnp.asarray(x)))
        port = PH.consensus_distance({"w": torch.from_numpy(x)}).numpy()
        np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-6)
        want = np.abs(np.arange(N) - 3.5) * np.sqrt(2)
        got = PH.consensus_distance(
            torch.arange(N, dtype=torch.float32)[:, None]
            * torch.ones(N, 2)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_consensus_distance_stacked_matches_the_jax_package(self):
        x = np.random.default_rng(5).standard_normal((N, 5))
        tree_np = {"w": x.astype(np.float32), "b": x[:, :2]}
        ref = RH.consensus_distance_stacked(tree_np)
        port = PH.consensus_distance_stacked(
            {k: torch.from_numpy(v) for k, v in tree_np.items()})
        assert port == pytest.approx(ref, rel=1e-6, abs=1e-6)
        assert PH.consensus_distance_stacked(tree_np) == pytest.approx(
            ref, rel=1e-12)

    def test_mixing_tracker_gauges_equal_the_jax_package(self):
        snaps = []
        for reg_mod, hmod, ring in ((RRG, RH, RRing), (PRG, PH, PRing)):
            reg = reg_mod.metrics_start()
            t = hmod.MixingTracker(ring(6), window="w")
            assert t.update(10.0) is None
            assert t.update(6.0) == pytest.approx(0.6)
            snaps.append(reg.snapshot())
            reg_mod.metrics_stop()
        assert snaps[1].keys() == snaps[0].keys()
        for k in snaps[0]:
            assert snaps[1][k] == pytest.approx(snaps[0][k], rel=1e-9), k
        assert snaps[1]['bf_consensus_distance{window="w"}'] == 6.0

    def test_heartbeat_age_gauge(self):
        """A running Heartbeat exports its age (a callback gauge named by
        its thread), and its stop retires it."""
        from bluefog_tpu_torch.utils.failure import Heartbeat

        reg = PRG.metrics_start()
        with Heartbeat(timeout_s=60, action="callback") as hb:
            hb.beat(0)
            (key,) = [k for k in reg.snapshot()
                      if k.startswith("bf_heartbeat_age_seconds")]
            assert 0.0 <= reg.snapshot()[key] < 60.0
        assert not any(k.startswith("bf_heartbeat_age")
                       for k in reg.snapshot())
        hb2 = Heartbeat(timeout_s=60, action="callback")
        PH.watch_heartbeat(hb2, name="train")
        assert 'bf_heartbeat_age_seconds{thread="train"}' in reg.snapshot()
        PH.unwatch_heartbeat("train")
        assert not reg.snapshot()


# ---------------------------------------------------------------------------
# 4. exports: Prometheus text and the dash, across packages
# ---------------------------------------------------------------------------


def _fill(reg):
    reg.counter("bf_comm_bytes_total", "bytes shipped").inc(64, op="x")
    reg.gauge("bf_consensus_distance").set(1.5)
    reg.gauge("weird").set(2.0, name='a"b\\c')
    for v in (0.1, 0.3):
        reg.histogram("bf_tcp_ack_latency_seconds").observe(v, peer="p0")


class TestExportAndDash:
    def test_prometheus_text_is_byte_equal(self):
        texts = []
        for reg_mod, exp in ((RRG, RE), (PRG, PE)):
            reg = reg_mod.MetricsRegistry()
            _fill(reg)
            texts.append(exp.prometheus_text(reg))
        assert texts[1] == texts[0]
        assert "# TYPE bf_comm_bytes_total counter" in texts[1]
        assert PE.prometheus_text() == RE.prometheus_text()  # both off

    def test_write_prometheus_and_step_noop_when_disabled(self, tmp_path):
        assert PE.step(0) is None and PE.snapshot() is None
        reg = PRG.MetricsRegistry()
        _fill(reg)
        PE.write_prometheus(str(tmp_path / "m.prom"), reg)
        assert (tmp_path / "m.prom").read_text() == PE.prometheus_text(reg)

    @staticmethod
    def _run(reg_mod, exp, path):
        reg = reg_mod.metrics_start(path)
        for s in range(4):
            reg.counter("bf_comm_bytes_total").inc(256, op="na")
            reg.gauge("bf_consensus_distance").set(8.0 / (s + 1))
            reg.histogram("bf_tcp_ack_latency_seconds").observe(
                0.01 * (s + 1), peer="p0")
            exp.step(s)
        reg_mod.metrics_stop()  # flush + summary line

    def test_each_dash_reads_the_other_packages_jsonl(self, tmp_path):
        rpath, ppath = str(tmp_path / "r.jsonl"), str(tmp_path / "p.jsonl")
        self._run(RRG, RE, rpath)
        self._run(PRG, PE, ppath)

        def rows(dash, path, **kw):
            steps, series, summary = dash.load_series(path)
            return dash.summarize(steps, series, summary, **kw)

        for path in (rpath, ppath):
            for kw in ({}, {"since": 2}):
                assert rows(PD, path, **kw) == rows(RD, path, **kw)
        # the counters agree across the two files (times aside)
        assert rows(PD, ppath)[0]["total"] == rows(RD, rpath)[0]["total"]

    def test_dash_cli_round_trip(self, tmp_path):
        path = str(tmp_path / "m.jsonl")
        self._run(PRG, PE, path)
        outs = []
        for mod in ("bluefog_tpu_torch.metrics.dash",
                    "bluefog_tpu.metrics.dash"):
            proc = subprocess.run(
                [sys.executable, "-m", mod, path, "--json"],
                capture_output=True, text=True, timeout=120, cwd=REPO,
                env=clean_env())
            assert proc.returncode == 0, proc.stderr
            outs.append(json.loads(proc.stdout))
        assert outs[0] == outs[1]
        by = {r["series"]: r for r in outs[0]}
        assert by['bf_comm_bytes_total{op="na"}']["total"] == 1024
        assert by['bf_tcp_ack_latency_seconds{peer="p0"}']["type"] == "hist"
        assert PD.main([str(tmp_path / "missing.jsonl")]) == 2


# ---------------------------------------------------------------------------
# 5. nothing changes a result
# ---------------------------------------------------------------------------


def test_metrics_on_step_is_bit_equal_to_metrics_off():
    """One ResNet step with metrics off, then the same step from the same
    state with metrics on: parameters bit-equal, and the comm counters
    filled."""
    from bluefog_tpu_torch.examples import synthetic_benchmark as sb

    def fresh():
        return sb.build("resnet18", "neighbor", "ring", size=2, batch_size=1,
                        image_size=32, num_classes=10, num_filters=4,
                        dtype=torch.float32, device="cpu")

    off = fresh()
    off.step()
    reg = PRG.metrics_start()
    on = fresh()
    on.step()
    for k, v in off.state().items():
        assert torch.equal(v, on.state()[k]), k
    snap = reg.snapshot()
    assert any(k.startswith('bf_comm_bytes_total{backend="pallas",'
                            'op="neighbor_allreduce"') for k in snap)
    (steps,) = [v for k, v in snap.items()
                if k.startswith("bf_optimizer_steps_total")]
    assert steps == 2  # one step of each of the two ranks

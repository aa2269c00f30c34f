"""The port's sharding subsystem (gossip of meshes) against the JAX
package's.

The classes mirror the reference's ``tests/test_sharding.py`` that this
port covers; each runs the JAX function and the port's on the same seeded
numpy inputs and compares:

- ``TestShardGeometry``: shard shapes, slices, ratios, coordinates,
  ``ShardView`` and ``GossipMesh`` (its mesh against the reference's
  ``make_hybrid_mesh`` on the conftest's 8-device CPU mesh); exact.
- ``TestHostShardGather``: ``shard_tree`` / ``gather_tree`` and
  ``reassemble_vectors`` (from the reference ``TreePacker``'s vectors), and
  ``make_shard_and_gather_fns`` against ``jax.device_put`` under
  ``NamedSharding`` (each device's shard is the port's row); exact.
- ``TestOptStateInheritance``: ``optimizer_state_specs`` of a torch AdamW
  against the reference's of ``optax.adamw`` (``exp_avg``/``exp_avg_sq``
  against ``mu``/``nu``), and ``shard_optimizer_state``; exact.
- ``TestOneRuleGovernsAllThree``: one rule change re-shards the parameter,
  its AdamW moments and its window, as in the reference.
- ``TestShardedNeighborAllreduce``: the gossip on a ``(bf 4, tp 2)`` mesh
  against the reference under ``shard_map``, bit for bit on the fully
  connected graph (weights 1/4: every product exact) and to one f32 ulp
  (rtol 1e-6) on the ring and Exponential-2 (weights 1/3; XLA's CPU code
  contracts some products into FMAs); the contract's errors; the
  decentralized optimizer through the rule table bit-equal to the plain
  one from the same state (a TP GPT of 2 layers, width 64).
- ``TestWindowPartition``: the declaration and its readback.
"""

import numpy as np
import pytest
import torch

from bluefog_tpu_torch import sharding as S
from bluefog_tpu_torch.sharding import PartitionSpec as P

AXES = {"fsdp": 2, "tp": 2}


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params():
    """The reference test's transformer-shaped tree: 2-d kernels, 1-d
    biases, a scalar (keys in sorted order: JAX's leaf order)."""
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


def _rules(Pc):
    return [(r"up/kernel$", Pc(None, "tp")), (r"down/kernel$", Pc("tp", None)),
            (r"emb/kernel$", Pc("fsdp", None)), (".*", Pc())]


def _table(axes=AXES):
    return S.RuleTable(_rules(P), axes=axes)


def _jtable(axes=AXES):
    from jax.sharding import PartitionSpec as JP

    from bluefog_tpu.sharding import RuleTable

    return RuleTable(_rules(JP), axes=axes)


def _flat(tree):
    from torch.utils import _pytree as pytree

    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in pytree.tree_leaves(tree)])


def _same(p, j):
    assert tuple(p) == tuple(j), (p, j)


class TestShardGeometry:
    @pytest.mark.parametrize("spec", [(None, "tp"), ("tp", None),
                                      (("fsdp", "tp"),), ("fsdp", "tp"), (),
                                      ("tp",)])
    def test_shapes_slices_ratios_match_reference(self, spec):
        from jax.sharding import PartitionSpec as JP

        from bluefog_tpu.sharding import mesh as jm

        for axes in (AXES, {}, {"tp": 2}):
            ps, js = P(*spec), JP(*spec)
            assert S.shard_shape((8, 4), ps, axes) == jm.shard_shape(
                (8, 4), js, axes)
            assert S.shard_size_ratio(ps, axes) == jm.shard_size_ratio(
                js, axes)
            for coord in S.inner_coords(axes):
                assert S.shard_slices((8, 4), ps, axes, coord) == (
                    jm.shard_slices((8, 4), js, axes, coord))

    def test_ragged_shard_refused(self):
        with pytest.raises(ValueError, match="not divisible"):
            S.shard_shape((7,), P("tp"), AXES)

    def test_slices_tile_exactly(self):
        for spec in (P("tp", None), P(None, "fsdp"), P(("fsdp", "tp")),
                     P("fsdp", "tp")):
            hits = np.zeros((8, 4), np.int32)
            for coord in S.inner_coords(AXES):
                hits[S.shard_slices((8, 4), spec, AXES, coord)] += 1
            want = S.num_shards(AXES) // S.shard_size_ratio(spec, AXES)
            assert (hits == want).all(), spec

    def test_inner_coords_row_major_like_reference(self):
        from bluefog_tpu.sharding import mesh as jm

        for axes in ({"a": 2, "b": 3}, {}, AXES):
            assert S.inner_coords(axes) == jm.inner_coords(axes)
            assert S.num_shards(axes) == jm.num_shards(axes)

    def test_shard_view_validates_coord(self):
        with pytest.raises(ValueError):
            S.ShardView(specs=P(), axes=AXES, coord={"tp": 0})
        with pytest.raises(ValueError):
            S.ShardView(specs=P(), axes=AXES, coord={"tp": 2, "fsdp": 0})

    def test_gossip_mesh_matches_reference(self, devices8):
        from bluefog_tpu.sharding import GossipMesh as JGM

        gm, jg = S.GossipMesh(4, {"tp": 2}), JGM(4, {"tp": 2})
        assert gm.axis_sizes == jg.axis_sizes and gm.inner_size == 2
        assert gm.coords() == jg.coords() and repr(gm) == repr(jg)
        mesh = gm.mesh(ranks=range(8))
        jmesh = jg.jax_mesh(devices8)
        assert mesh.axis_names == jmesh.axis_names
        np.testing.assert_array_equal(
            mesh.ranks, np.vectorize(lambda d: d.id)(jmesh.devices))
        assert mesh.axis("tp").dim == 1
        assert mesh.owned() == (slice(0, 4), slice(0, 2))
        with pytest.raises(ValueError):
            S.GossipMesh(0, {})
        with pytest.raises(ValueError):
            S.GossipMesh(2, {"bf": 2})


class TestHostShardGather:
    def test_shard_tree_matches_reference_and_roundtrips(self):
        from bluefog_tpu.sharding import ShardView as JView
        from bluefog_tpu.sharding import shard_tree as jshard

        params = _params()
        specs, jspecs = _table().resolve_tree(params), _jtable(
        ).resolve_tree(params)
        shards, tshards = {}, {}
        for coord in S.inner_coords(AXES):
            key = tuple(coord[n] for n in AXES)
            got = S.shard_tree(params, S.ShardView(specs, AXES, coord))
            want = jshard(params, JView(jspecs, AXES, coord))
            np.testing.assert_array_equal(_flat(got), _flat(want))
            shards[key] = got
            tshards[key] = S.shard_tree(
                {k: torch.as_tensor(v) for k, v in _leaves(params)},
                S.ShardView(dict(_leaves(specs, spec=True)), AXES, coord))
        out = S.gather_tree(params, specs, AXES, shards)
        np.testing.assert_array_equal(_flat(out), _flat(params))
        tmpl = {k: torch.as_tensor(v) for k, v in _leaves(params)}
        tout = S.gather_tree(tmpl, dict(_leaves(specs, spec=True)), AXES,
                             tshards)
        np.testing.assert_array_equal(_flat(tout), _flat(tmpl))

    def test_missing_coordinate_raises(self):
        params = _params()
        specs = _table().resolve_tree(params)
        view = S.ShardView(specs, AXES, {"fsdp": 0, "tp": 0})
        with pytest.raises(KeyError, match="missing shard"):
            S.gather_tree(params, specs, AXES,
                          {(0, 0): S.shard_tree(params, view)})

    def test_mis_shaped_shard_refused(self):
        shards = {(c["tp"],): {"w": np.zeros((3,))}
                  for c in S.inner_coords({"tp": 2})}
        with pytest.raises(ValueError, match="shape"):
            S.gather_tree({"w": np.zeros((8,))}, {"w": P("tp")},
                          {"tp": 2}, shards)

    def test_reassemble_vectors_from_reference_packer(self):
        from bluefog_tpu.runtime.async_windows import TreePacker
        from bluefog_tpu.sharding import ShardView as JView

        params = _params()
        jspecs = _jtable().resolve_tree(params)
        vectors = {}
        for coord in S.inner_coords(AXES):
            vectors[tuple(coord[n] for n in AXES)] = TreePacker(
                params, np.float64, sharding=JView(jspecs, AXES, coord)
            ).pack(params)
        out = S.reassemble_vectors(params, _table().resolve_tree(params),
                                   AXES, vectors)
        np.testing.assert_array_equal(_flat(out), _flat(params))

    def test_tree_wire_bytes_matches_reference(self):
        from bluefog_tpu.sharding import tree_wire_bytes as jwire

        params = _params()
        assert S.tree_wire_bytes(params, _table().resolve_tree(params),
                                 AXES) == jwire(
            params, _jtable().resolve_tree(params), AXES)

    def test_shard_and_gather_fns_match_named_sharding(self, devices8):
        """Each device's shard of ``jax.device_put(x, NamedSharding(mesh,
        spec))`` is the port's stacked row at that mesh position."""
        import jax
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as JP

        from bluefog_tpu.sharding import GossipMesh as JGM

        jmesh = JGM(4, {"tp": 2}).jax_mesh(devices8)
        mesh = S.GossipMesh(4, {"tp": 2}).mesh(ranks=range(8))
        x = np.random.default_rng(3).standard_normal((8, 6)).astype(
            np.float32)
        for spec in ((None, "tp"), ("tp", None), ("bf", "tp"), ()):
            fns, gathers = S.make_shard_and_gather_fns({"w": P(*spec)}, mesh)
            got = fns["w"](x)
            arr = jax.device_put(x, NamedSharding(jmesh, JP(*spec)))
            where = {d.id: tuple(int(i) for i in np.argwhere(
                jmesh.devices == d)[0]) for d in jmesh.devices.flat}
            for sh in arr.addressable_shards:
                np.testing.assert_array_equal(
                    got[where[sh.device.id]].numpy(), np.asarray(sh.data))
            np.testing.assert_array_equal(gathers["w"](got).numpy(), x)


def _leaves(tree, spec=False):
    """``[(path, leaf)]`` of a nested dict, '/'-joined."""
    return S.named_leaves(tree, is_leaf=(lambda v: isinstance(v, P))
                          if spec else None)


def _torch_params(params):
    """The reference tree as a name -> tensor dict (f32)."""
    return {k.replace("/", "."): torch.tensor(np.asarray(v), dtype=torch.float32)
            for k, v in _leaves(params)}


class TestOptStateInheritance:
    def test_adamw_moments_inherit_like_reference_mu_nu(self):
        import optax

        from bluefog_tpu.optim import optimizer_state_specs as joss
        from bluefog_tpu_torch.optim import optimizer_state_specs

        params = _params()
        tp = _torch_params(params)
        opt = torch.optim.AdamW(list(tp.values()), lr=1e-3)
        got = optimizer_state_specs(_table(), tp, opt)
        want = dict(S.named_leaves(
            joss(_jtable(), params, optax.adamw(1e-3)),
            is_leaf=lambda v: type(v).__name__ == "PartitionSpec"))
        for ours, theirs in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            for name, spec in got[ours].items():
                key = next(k for k in want if theirs in k.split("/")
                           and k.endswith(name))
                _same(spec, want[key])
        assert all(tuple(s) == () for s in got["step"].values())
        # after a step the state is real, and resolves the same
        for p in tp.values():
            p.grad = torch.ones_like(p)
        opt.step()
        assert optimizer_state_specs(_table(), tp, opt) == got

    def test_unshadowed_and_shape_mismatch_like_reference(self):
        from bluefog_tpu.sharding import opt_state_specs as jspecs
        from jax.sharding import PartitionSpec as JP

        from bluefog_tpu.sharding import RuleTable as JTable

        params = {"w": np.zeros((4, 4))}
        for rules, state in (
                ([("w$", "tp"), ("slot$", ("fsdp", None))],
                 {"0": {"w": np.zeros((4, 4)), "slot": np.zeros((2, 2))}}),
                ([("w$", "tp")], {"mu": {"w": np.zeros((8, 8))}})):
            conv = lambda Pc: [  # noqa: E731
                (r, Pc(*s) if isinstance(s, tuple) else Pc(s))
                for r, s in rules]
            got = S.opt_state_specs(S.RuleTable(conv(P)), params, state)
            want = jspecs(JTable(conv(JP)), params, state)
            want = dict(S.named_leaves(want, is_leaf=lambda v: isinstance(
                v, JP)))
            got = dict(S.named_leaves(got, is_leaf=lambda v: isinstance(
                v, P)))
            assert set(got) == set(want)
            for k, a in got.items():
                _same(a, want[k])
        with pytest.raises(S.UnmatchedLeafError):
            S.opt_state_specs(S.RuleTable([(r"^w$", P("tp"))]), params,
                              {"mu": {"w": np.zeros((8, 8))}})

    def test_shard_optimizer_state_places_moments_like_params(self):
        from bluefog_tpu_torch.optim import shard_optimizer_state

        tp = _torch_params(_params())
        full_opt = torch.optim.AdamW(list(tp.values()), lr=1e-3)
        for p in tp.values():
            p.grad = torch.linspace(-1, 1, p.numel()).view(p.shape)
        full_opt.step()
        mesh = S.GossipMesh(1, AXES).mesh(ranks=range(4))
        specs = {k: _table().resolve(k.replace(".", "/"), v.shape)
                 for k, v in tp.items()}
        fns, _ = S.make_shard_and_gather_fns(specs, mesh)
        placed = {k: fns[k](v).requires_grad_() for k, v in tp.items()}
        opt = torch.optim.AdamW(list(placed.values()), lr=1e-3)
        state = shard_optimizer_state(_table(), tp, full_opt, mesh, into=opt)
        for name, p in tp.items():
            st = full_opt.state[p]
            for key in ("exp_avg", "exp_avg_sq"):
                want = fns[name](st[key])
                assert torch.equal(state[key][name], want)
                assert want.shape == placed[name].shape
                assert torch.equal(opt.state[placed[name]][key], want)
            assert float(opt.state[placed[name]]["step"]) == 1.0


class TestOneRuleGovernsAllThree:
    def test_single_rule_change_reshards_all_families(self):
        import optax

        from bluefog_tpu.ops.windows import win_create as jwin
        from bluefog_tpu.ops.windows import win_partition as jpart
        from bluefog_tpu.optim import optimizer_state_specs as joss
        from bluefog_tpu.topology import RingGraph as JRing
        from bluefog_tpu.topology.schedule import build_schedule as jbuild
        from bluefog_tpu_torch.ops.windows import win_create, win_partition
        from bluefog_tpu_torch.optim import optimizer_state_specs
        from bluefog_tpu_torch.topology import RingGraph, build_schedule

        from jax.sharding import PartitionSpec as JP

        params = _params()
        tp = _torch_params(params)
        stacked = {k: v.expand(4, *v.shape).clone() for k, v in tp.items()}

        def ours(table):
            pspec = {k: table.resolve(k.replace(".", "/"), v.shape)
                     for k, v in tp.items()}
            ospec = optimizer_state_specs(
                table, tp, torch.optim.AdamW(list(tp.values())))
            win = win_create(stacked, build_schedule(RingGraph(4)),
                             rule_table=table)
            return pspec, ospec, win_partition(win)

        def theirs(table):
            ospec = dict(S.named_leaves(
                joss(table, params, optax.adamw(1e-3)),
                is_leaf=lambda v: isinstance(v, JP)))
            win = jwin(params, jbuild(JRing(4)), "bf", rule_table=table)
            return table.resolve_tree(params), ospec, jpart(win)

        t1, j1 = _table(), _jtable()
        t2 = t1.replaced(r"up/kernel$", P("fsdp", None))
        j2 = j1.replaced(r"up/kernel$", JP("fsdp", None))
        for t, j, want in ((t1, j1, ("tp",)), (t2, j2, ("fsdp",))):
            (p, o, w), (jp, jo, jw) = ours(t), theirs(j)
            _same(p["blk.up.kernel"], jp["blk"]["up"]["kernel"])
            _same(w["blk/up/kernel"], jw["blk/up/kernel"])
            mu = next(k for k in jo if "mu" in k.split("/")
                      and k.endswith("up/kernel"))
            _same(o["exp_avg"]["blk/up/kernel"], jo[mu])
            assert S.norm_spec(p["blk.up.kernel"])[-1] == want or \
                S.norm_spec(p["blk.up.kernel"])[0] == want
            for key in ("blk/down/kernel", "emb/kernel", "blk/up/bias"):
                _same(w[key], jw[key])
        # the placed shards change with the rule, parameter and moments
        mesh = S.GossipMesh(1, AXES).mesh(ranks=range(4))
        for t in (t1, t2):
            spec = t.resolve("blk/up/kernel", (4, 8))
            fns, _ = S.make_shard_and_gather_fns({"w": spec}, mesh)
            assert tuple(fns["w"](tp["blk.up.kernel"]).shape[3:]) == (
                S.shard_shape((4, 8), spec, AXES))


def _hybrid_inputs():
    rng = np.random.default_rng(5)
    return {"b": rng.standard_normal((4, 8)).astype(np.float32),
            "w": rng.standard_normal((4, 8, 6)).astype(np.float32)}


def _jax_sharded(x, topo_name):
    import jax
    import jax.numpy as jnp

    from bluefog_tpu import topology as JT
    from bluefog_tpu.ops import collectives as JC
    from bluefog_tpu.parallel.api import shard_map
    from bluefog_tpu.parallel.tensor import make_hybrid_mesh
    from bluefog_tpu.sharding import RuleTable as JTable
    from jax.sharding import PartitionSpec as JP

    topo = getattr(JT, topo_name)(4)
    sched = JT.build_schedule(topo)
    mesh = make_hybrid_mesh({"bf": 4, "tp": 2}, devices=jax.devices()[:8])
    table = JTable([("w$", JP(None, None, "tp")), (".*", JP())])

    def body(xl):
        return JC.sharded_neighbor_allreduce(xl, sched, "bf",
                                             rule_table=table,
                                             inner_axes={"tp": 2})

    specs = {"b": JP("bf", None), "w": JP("bf", None, "tp")}
    out = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs,),
                            out_specs=specs, check_vma=False))(
        {k: jnp.asarray(v) for k, v in x.items()})
    return {k: np.asarray(v) for k, v in out.items()}


class TestShardedNeighborAllreduce:
    @pytest.mark.parametrize("topo", ["FullyConnectedGraph",
                                      "ExponentialTwoGraph", "RingGraph"])
    def test_numerics_on_hybrid_mesh_match_reference(self, topo):
        from bluefog_tpu_torch import topology as PT
        from bluefog_tpu_torch.ops import collectives as C

        x = _hybrid_inputs()
        want = _jax_sharded(x, topo)
        # the port's layout: (bf, tp, *shard)
        port = {"b": torch.from_numpy(x["b"])[:, None].expand(4, 2, 8)
                .contiguous(),
                "w": torch.from_numpy(x["w"]).view(4, 8, 2, 3)
                .permute(0, 2, 1, 3).contiguous()}
        table = S.RuleTable([("w$", P(None, "tp")), (".*", P())])
        sched = PT.build_schedule(getattr(PT, topo)(4))
        out = C.sharded_neighbor_allreduce(port, sched, "bf",
                                           rule_table=table,
                                           inner_axes={"tp": 2})
        got_w = out["w"].permute(0, 2, 1, 3).reshape(4, 8, 6).numpy()
        got_b = out["b"].numpy()
        if topo == "FullyConnectedGraph":
            np.testing.assert_array_equal(got_w, want["w"])
            for t in range(2):
                np.testing.assert_array_equal(got_b[:, t], want["b"])
        else:
            np.testing.assert_allclose(got_w, want["w"], rtol=1e-6,
                                       atol=1e-7)
            for t in range(2):
                np.testing.assert_allclose(got_b[:, t], want["b"],
                                           rtol=1e-6, atol=1e-7)
        # the closed form and the wire counters
        w = getattr(PT, topo)(4).weights
        np.testing.assert_allclose(got_w.reshape(4, -1),
                                   w @ x["w"].reshape(4, -1), atol=1e-5)
        shard_b, saved_b = C.sharded_neighbor_allreduce.last_wire
        k = sched.num_slots
        assert shard_b == (8 * 3 + 8) * 4 * k and saved_b == 8 * 3 * 4 * k
        full = {"b": x["b"][0], "w": x["w"][0]}
        sb, fb = S.tree_wire_bytes(full, {"b": P(), "w": P(None, "tp")},
                                   {"tp": 2})
        assert (sb * k, (fb - sb) * k) == (shard_b, saved_b)

    def test_spec_on_gossip_axis_rejected(self):
        from bluefog_tpu_torch.ops import collectives as C
        from bluefog_tpu_torch.topology import RingGraph, build_schedule

        sched = build_schedule(RingGraph(4))
        with pytest.raises(ValueError, match="GOSSIP axis"):
            C.sharded_neighbor_allreduce(
                {"w": torch.zeros(4, 2, 8)}, sched, "bf",
                specs={"w": P("bf")}, inner_axes={"tp": 2})

    def test_table_required_and_exclusive(self):
        from bluefog_tpu_torch.ops import collectives as C
        from bluefog_tpu_torch.topology import RingGraph, build_schedule

        sched = build_schedule(RingGraph(4))
        with pytest.raises(ValueError, match="rule table"):
            C.sharded_neighbor_allreduce({"w": torch.zeros(4, 8)}, sched)
        with pytest.raises(ValueError, match="not both"):
            C.sharded_neighbor_allreduce(
                {"w": torch.zeros(4, 8)}, sched,
                rule_table=S.RuleTable([(".*", P())]), specs={"w": P()})

    def test_optimizer_through_the_table_is_the_plain_step(self):
        """A TP GPT (bf 2 x tp 2): parameters placed by the shard functions
        from the gathered full leaves, AdamW's state by
        shard_optimizer_state, the gossip through the rule table: two steps
        bit-equal to the plain optimizer's from the same state and
        gradients."""
        from bluefog_tpu_torch.models.transformer import GPTConfig
        from bluefog_tpu_torch.optim import (
            DistributedNeighborAllreduceOptimizer, shard_optimizer_state)
        from bluefog_tpu_torch.parallel import tensor as pt
        from bluefog_tpu_torch.topology import ExponentialTwoGraph

        cfg = GPTConfig(vocab_size=64, hidden_size=64, num_layers=2,
                        num_heads=4, max_position=32, dtype=torch.float32)
        gm = S.GossipMesh(2, {"tp": 2})
        mesh = gm.mesh(ranks=range(4))
        model = pt.TPTransformerLM(cfg, mesh)
        ref = {k: v.detach().clone().requires_grad_()
               for k, v in model.named_parameters()}
        axis = mesh.axis("tp", dim=0)
        full = {k: v[0] for k, v in pt.gather_tp_params(
            {k: v.detach()[0] for k, v in ref.items()}, model,
            axis).items()}
        table = pt.tp_param_rules()
        specs = {k: table.resolve(k.replace(".", "/"), v.shape)
                 for k, v in full.items()}
        fns, gathers = S.make_shard_and_gather_fns(specs, mesh)
        placed = {k: fns[k](v).requires_grad_() for k, v in full.items()}
        for k in ref:
            assert torch.equal(placed[k], ref[k]), k
            assert torch.equal(gathers[k](placed[k]), full[k]), k
        topo = ExponentialTwoGraph(2)
        plain = DistributedNeighborAllreduceOptimizer(
            torch.optim.AdamW(list(ref.values()), lr=3e-4,
                              weight_decay=0.01), topology=topo)
        base = torch.optim.AdamW(list(placed.values()), lr=3e-4,
                                 weight_decay=0.01)
        shard_optimizer_state(table, full, torch.optim.AdamW(
            list(full.values())), mesh, into=base)
        sharded = DistributedNeighborAllreduceOptimizer(
            base, topology=topo, rule_table=table,
            param_names=list(placed), inner_axes={"tp": 2})
        gen = torch.Generator().manual_seed(0)
        for _ in range(2):
            for k in ref:
                g = torch.randn(ref[k].shape, generator=gen)
                ref[k].grad, placed[k].grad = g.clone(), g.clone()
            plain.step()
            sharded.step()
            for k in ref:
                assert torch.equal(placed[k], ref[k]), k


class TestWindowPartition:
    def test_declaration_readback_matches_reference(self):
        from bluefog_tpu.ops.windows import win_create as jwin
        from bluefog_tpu.ops.windows import win_partition as jpart
        from bluefog_tpu.topology import RingGraph as JRing
        from bluefog_tpu.topology.schedule import build_schedule as jbuild
        from bluefog_tpu_torch.ops.windows import win_create, win_partition
        from bluefog_tpu_torch.topology import RingGraph, build_schedule

        params = _params()
        stacked = {k: v.expand(4, *v.shape).clone()
                   for k, v in _torch_params(params).items()}
        sched = build_schedule(RingGraph(4))
        got = win_partition(win_create(stacked, sched, rule_table=_table()))
        want = jpart(jwin(params, jbuild(JRing(4)), "bf",
                          rule_table=_jtable()))
        assert set(got) == {k.replace("/", ".") for k in want} or set(
            got) == set(want)
        for k, v in want.items():
            _same(got.get(k, got.get(k.replace("/", "."))), v)
        assert win_partition(win_create(stacked, sched)) is None
        explicit = win_create(stacked, sched, partition={
            k: _table().resolve(k.replace(".", "/"), v.shape[1:])
            for k, v in stacked.items()})
        assert win_partition(explicit) == got

    def test_rule_table_and_partition_exclusive(self):
        from bluefog_tpu_torch.ops.windows import win_create
        from bluefog_tpu_torch.topology import RingGraph, build_schedule

        with pytest.raises(ValueError, match="not both"):
            win_create({"w": torch.zeros(4, 8)},
                       build_schedule(RingGraph(4)), rule_table=_table(),
                       partition={"w": P()})

    def test_winput_over_a_partitioned_window_moves_shards(self):
        """WinPut over a window of (bf 4, tp 2, *shard) leaves (K2's
        route; its plain twin on the CPU): each shard lands in the same
        coordinate of the out-neighbours' slots."""
        from bluefog_tpu_torch.ops import windows as W
        from bluefog_tpu_torch.topology import RingGraph, build_schedule

        sched = build_schedule(RingGraph(4))
        x = {"w": torch.randn(4, 2, 8, 3, generator=torch.Generator()
                              .manual_seed(1))}
        win = W.win_create(x, sched, rule_table=S.RuleTable(
            [("w$", P(None, "tp"))]), inner_axes={"tp": 2})
        assert W.win_partition(win) == {"w": P(None, "tp")}
        W.win_put(win, {"w": x["w"] * 2})
        peers = win.peer_bufs["w"]
        for i in range(4):
            for k in range(sched.num_slots):
                src = int(sched.recv_src[i, k])
                assert torch.equal(peers[i, k], x["w"][src] * 2)


def test_rank_shard_places_on_the_context():
    import bluefog_tpu_torch as bf

    bf.init(size=4, device="cpu")
    try:
        x = {"w": torch.arange(8.0).view(4, 2)}
        out = bf.rank_shard(x)
        assert torch.equal(out["w"], x["w"])
        with pytest.raises(ValueError):
            bf.rank_shard({"w": torch.zeros(3, 2)})
    finally:
        bf.shutdown()

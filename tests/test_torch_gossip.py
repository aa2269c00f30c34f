"""K1 and the gossip collectives of the port against the JAX package.

The TPU kernel ``neighbor_allreduce_pallas`` runs as the JAX package's own
tests run it on the CPU: in TPU-interpret mode under ``shard_map`` on the
8-device mesh.  The port's K1 wrapper, given CPU tensors, runs its plain
version, which is what is compared here; the CUDA kernel itself is held
against the same plain version on the card by ``chip_smoke.py``.

Tolerances: f32 at rtol 1e-6 (the same weighted f32 sum, at most a
different rounding order); bf16 at one bf16 ulp (rtol 2**-7), since both
sides round an f32 sum to bf16 once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bluefog_tpu as bf
import bluefog_tpu.topology as jt
from bluefog_tpu.ops import collectives as jcoll
from bluefog_tpu.ops import pallas_gossip
from bluefog_tpu.parallel.api import shard_map
import bluefog_tpu_torch.topology as pt
from bluefog_tpu_torch.ops import collectives as pcoll
from bluefog_tpu_torch.ops import gossip_kernel as k1

N = 8
BF16_RTOL = 2.0 ** -7


def _run(body, *inputs):
    bf.init()
    ctx = bf.get_context()
    f = jax.jit(shard_map(body, mesh=ctx.mesh,
                          in_specs=(P("bf"),) * len(inputs),
                          out_specs=P("bf"), check_vma=False))
    return f(*inputs)


def _jax_pallas(jsched, x):
    return np.asarray(_run(lambda xs: pallas_gossip.neighbor_allreduce_pallas(
        xs[0], jsched, "bf", interpret=True)[None], x).astype(jnp.float32))


def _port_topology(jtopo):
    # the port's Topology from the JAX weight matrix: the one-peer phases of
    # topology/dynamic.py are not ported, their matrices are
    return pt.Topology(weights=np.asarray(jtopo.weights), name=jtopo.name)


TOPOLOGIES = {
    "ring": lambda: jt.RingGraph(N),
    "exp2": lambda: jt.ExponentialTwoGraph(N),
    "one_peer_phase1": lambda: jt.one_peer_exponential_two_schedules(N)[1],
}


@pytest.mark.parametrize("kind", sorted(TOPOLOGIES))
def test_k1_plain_matches_pallas_interpret_f32(kind):
    jtopo = TOPOLOGIES[kind]()
    psched = pt.build_schedule(_port_topology(jtopo))
    x = np.random.default_rng(0).standard_normal((N, 5)).astype(np.float32)
    want = _jax_pallas(jt.build_schedule(jtopo), jnp.asarray(x))
    sw, rw, src = k1.schedule_tables(psched, "cpu")
    got = k1.gossip_mix(torch.from_numpy(x), sw, rw, src)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # the op layer routes this circulant schedule to K1 and agrees too
    assert k1.resolve_backend("auto", psched) == "kernel"
    via_op = pcoll.neighbor_allreduce(torch.from_numpy(x), psched)
    np.testing.assert_allclose(via_op.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(via_op.numpy(), jtopo.weights @ x, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["ring", "exp2"])
def test_k1_unaligned_bf16_matches_pallas_interpret(kind):
    """A (3, 7) bf16 leaf per rank: not tile-aligned on the TPU, and an
    unaligned row for K1; bf16 on the wire, f32 sum."""
    jtopo = TOPOLOGIES[kind]()
    x32 = np.random.default_rng(1).standard_normal((N, 3, 7)).astype(
        np.float32)
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    want = _jax_pallas(jt.build_schedule(jtopo), xj)
    xt = torch.from_numpy(x32).to(torch.bfloat16)
    # both sides round the same f32 values to bf16, to nearest even
    np.testing.assert_array_equal(xt.float().numpy(),
                                  np.asarray(xj.astype(jnp.float32)))
    got = pcoll.neighbor_allreduce(xt, pt.build_schedule(
        _port_topology(jtopo)), backend="kernel")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                               atol=1e-6)


def test_zero_slot_schedule_is_the_self_term():
    jtopo = jt.Topology(weights=np.eye(N) * 1.0, name="identity")
    psched = pt.build_schedule(_port_topology(jtopo))
    assert psched.num_slots == 0 and psched.is_circulant
    x = np.random.default_rng(2).standard_normal((N, 6)).astype(np.float32)
    want = np.asarray(_run(lambda xs: pallas_gossip.neighbor_allreduce_pallas(
        xs[0], jt.build_schedule(jtopo), "bf", self_weight=0.5,
        interpret=True)[None], jnp.asarray(x)))
    np.testing.assert_allclose(want, 0.5 * x, rtol=1e-6)
    got = pcoll.neighbor_allreduce(torch.from_numpy(x), psched,
                                   self_weight=0.5, backend="kernel")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # 'auto' takes the plain path for a schedule without slots, as the
    # reference takes XLA
    assert k1.resolve_backend("auto", psched) == "plain"
    np.testing.assert_allclose(pcoll.neighbor_allreduce(
        torch.from_numpy(x), psched, self_weight=0.5).numpy(), want,
        rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_non_circulant_schedule_is_rejected_by_the_kernel_backend(dtype):
    """The TPU kernel refuses the star (its remote DMA needs a uniform
    shift); the port's K1 reads any source row, so ``'auto'`` routes the
    star and the grid to K1, and K1's plain twin on their tables is
    bit-equal to the plain path (``backend='plain'``)."""
    jsched = jt.build_schedule(jt.StarGraph(N))
    with pytest.raises(ValueError, match="circulant"):
        pallas_gossip.neighbor_allreduce_pallas(jnp.zeros(4), jsched, "bf",
                                                interpret=True)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (N, 3, 7)).astype(np.float32)).to(dtype)
    for topo in (pt.StarGraph(N), pt.MeshGrid2DGraph(N)):
        psched = pt.build_schedule(topo)
        assert not psched.is_circulant
        assert k1.resolve_backend("auto", psched) == "kernel"
        sw, rw, src = k1.schedule_tables(psched, "cpu")
        twin = k1.gossip_mix_plain(x.reshape(N, -1), sw, rw, src)
        plain = pcoll.neighbor_allreduce(x, psched, backend="plain")
        assert torch.equal(twin.reshape(x.shape), plain), topo.name
        via_op = pcoll.neighbor_allreduce(x, psched)
        assert torch.equal(via_op, plain), topo.name
        np.testing.assert_allclose(
            via_op.float().numpy(),
            np.einsum("ij,j...->i...", topo.weights, x.double().numpy()),
            rtol=1e-5 if dtype == torch.float32 else BF16_RTOL, atol=1e-6)
    with pytest.raises(ValueError, match="unknown backend"):
        pcoll.neighbor_allreduce(torch.zeros(N, 4), psched, backend="pallas")


def test_send_weights_refuse_the_kernel_and_auto_keeps_plain():
    psched = pt.build_schedule(pt.RingGraph(N))
    x = torch.ones(N, 3)
    with pytest.raises(NotImplementedError):
        pcoll.neighbor_allreduce(x, psched, send_weights=[1.0, 1.0],
                                 backend="kernel")
    k1.gossip_mix.launches = 0
    pcoll.neighbor_allreduce(x, psched, send_weights=[1.0, 1.0])
    assert k1.gossip_mix.launches == 0


def _tree(rng):
    return {
        "a": rng.standard_normal((N, 3, 4)).astype(np.float32),
        "b": rng.standard_normal((N, 5)).astype(np.float32),
        "c": [rng.standard_normal((N, 2, 2)).astype(np.float32)],
        "h": rng.standard_normal((N, 6)).astype(np.float32),  # sent as bf16
    }


def _to_jax(tree):
    out = jax.tree_util.tree_map(jnp.asarray, tree)
    out["h"] = out["h"].astype(jnp.bfloat16)
    return out


def _to_torch(tree):
    out = {k: (torch.from_numpy(v) if not isinstance(v, list)
               else [torch.from_numpy(u) for u in v]) for k, v in tree.items()}
    out["h"] = out["h"].to(torch.bfloat16)
    return out


def _assert_tree_close(got, want):
    g_leaves = jax.tree_util.tree_leaves(
        {k: v for k, v in got.items() if k != "h"})
    w_leaves = jax.tree_util.tree_leaves(
        {k: v for k, v in want.items() if k != "h"})
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    assert got["h"].dtype == torch.bfloat16
    np.testing.assert_allclose(got["h"].float().numpy(),
                               np.asarray(want["h"].astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=1e-6)


OVERRIDES = {
    "schedule_weights": {},
    "self_and_recv": {"self_weight": 0.4, "recv_weights": [0.5, 0.1, 0.0]},
    "send_per_slot": {"send_weights": [2.0, 0.5, 1.0]},
    "send_table": {"send_weights": "table", "recv_weights": [0.3, 0.3, 0.4],
                   "self_weight": 0.0},
}


@pytest.mark.parametrize("fused", [False, True], ids=["leafwise", "fused"])
@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_neighbor_allreduce_pytree_matches_xla(case, fused):
    """The port's ``neighbor_allreduce`` (and under ``fuse_apply``) on a
    pytree of f32 and bf16 leaves against the JAX package's
    ``neighbor_allreduce(backend='xla')`` under ``shard_map``, with
    per-call weight overrides, on Exponential-2 (3 slots)."""
    kw = dict(OVERRIDES[case])
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    if kw.get("send_weights") == "table":
        kw["send_weights"] = rng.uniform(0.5, 1.5, (N, 3)).astype(np.float32)
    jsched = jt.build_schedule(jt.ExponentialTwoGraph(N))
    psched = pt.build_schedule(pt.ExponentialTwoGraph(N))
    jkw = {k: jnp.asarray(v, jnp.float32) for k, v in kw.items()}

    def jfn(t):
        return jcoll.neighbor_allreduce(t, jsched, "bf", backend="xla", **jkw)

    def body(t):
        t = jax.tree_util.tree_map(lambda v: v[0], t)
        out = jcoll.fuse_apply(jfn, t, threshold_bytes=64) if fused \
            else jfn(t)
        return jax.tree_util.tree_map(lambda v: v[None], out)

    want = _run(body, _to_jax(tree))

    def pfn(t):
        return pcoll.neighbor_allreduce(t, psched, **kw)

    x = _to_torch(tree)
    got = pcoll.fuse_apply(pfn, x, threshold_bytes=64) if fused else pfn(x)
    _assert_tree_close(got, want)


def test_fuse_plan_groups_by_dtype_and_ships_large_leaves_alone():
    leaves = [torch.zeros(N, 4), torch.zeros(N, 100), torch.zeros(N, 3),
              torch.zeros(N, 8, dtype=torch.bfloat16)]
    groups, big = pcoll.fuse_plan(leaves, threshold_bytes=400)
    assert big == [1]  # 100 f32 per rank = 400 bytes, at the threshold
    assert groups == {torch.float32: [0, 2], torch.bfloat16: [3]}
    groups, big = pcoll.fuse_plan(leaves, threshold_bytes=None)
    assert big == [] and groups[torch.float32] == [0, 1, 2]
    calls = []
    out = pcoll.fuse_apply(lambda t: calls.append(t) or t, leaves,
                           threshold_bytes=400)
    assert sorted(calls[0]["fused"]) == ["torch.bfloat16", "torch.float32"]
    assert calls[0]["fused"]["torch.float32"].shape == (N, 7)
    for a, b in zip(out, leaves):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_stacked_api_neighbor_allreduce_matches_reference_api():
    """``bf.neighbor_allreduce`` of the stacked-array API on both sides."""
    import bluefog_tpu_torch as pbf

    x = np.random.default_rng(4).standard_normal((N, 3)).astype(np.float32)
    bf.init(topology=jt.RingGraph(N))
    want = np.asarray(bf.neighbor_allreduce(jnp.asarray(x), self_weight=0.5,
                                            recv_weights=[0.25, 0.25]))
    pbf.init(topology=pt.RingGraph(N), device="cpu")
    try:
        got = pbf.neighbor_allreduce(torch.from_numpy(x), self_weight=0.5,
                                     recv_weights=[0.25, 0.25])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        stacked = pbf.rank_stack({"w": torch.ones(2, 3)})
        assert stacked["w"].shape == (N, 2, 3)
        np.testing.assert_allclose(
            pbf.neighbor_allreduce(stacked)["w"].numpy(), 1.0, rtol=1e-6)
    finally:
        pbf.shutdown()


def test_wrapper_checks_and_counts_only_card_launches():
    sched = pt.build_schedule(pt.ExponentialTwoGraph(N))
    sw, rw, src = k1.schedule_tables(sched, "cpu")
    k1.gossip_mix.launches = 0
    k1.gossip_mix(torch.zeros(N, 9), sw, rw, src)
    assert k1.gossip_mix.launches == 0  # CPU tensors run the plain version
    with pytest.raises(TypeError):
        k1.gossip_mix(torch.zeros(N, 9, dtype=torch.float64), sw, rw, src)
    with pytest.raises(ValueError):
        k1.gossip_mix(torch.zeros(N - 1, 9), sw, rw, src)
    with pytest.raises(ValueError):
        k1.gossip_mix(torch.zeros(N, 9), sw, rw[:, :2], src)
    with pytest.raises(ValueError):
        k1.gossip_mix(torch.zeros(N, 9), sw.double(), rw, src)
    with pytest.raises(ValueError):
        k1.gossip_mix(torch.zeros(N, 9, device="meta"), sw.to("meta"),
                      rw.to("meta"), src.to("meta"))
    assert k1._wire_dtype(torch.bfloat16) == torch.bfloat16
    assert k1._wire_dtype(torch.float16) == torch.float32
    assert pcoll._acc_dtype(torch.bfloat16) == torch.float32
    assert pcoll._acc_dtype(torch.float64) == torch.float64

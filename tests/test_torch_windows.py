"""K2 and the one-sided window ops of the port against the JAX package.

The TPU kernel ``deliver_pallas`` runs as the JAX package's own tests run it
on the CPU: in TPU-interpret mode under ``shard_map`` on the 8-device mesh.
The port's K2 wrapper, given CPU tensors, runs its plain version, which is
what is compared here; the CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``.  The window ops run against
``bluefog_tpu/ops/windows.py`` with ``backend='xla'`` and with ``'pallas'``
in interpret mode, on inputs from seeded numpy, and the final self and
landing buffers are compared, so a flipped slot direction shows on the
directed graphs (Exponential-2, the one-way ring).

Tolerances: f32 at rtol 1e-6 (the same element-wise arithmetic, at most a
different rounding of the schedule's weights); bf16 and f16 at one ulp of
their dtype (rtol 2**-7, 2**-10), since each side rounds the same f32 value
to it once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bluefog_tpu as bf
import bluefog_tpu.topology as jt
from bluefog_tpu.ops import pallas_gossip
from bluefog_tpu.ops import windows as JW
from bluefog_tpu.parallel.api import shard_map
import bluefog_tpu_torch as pbf
import bluefog_tpu_torch.topology as pt
from bluefog_tpu_torch.ops import deliver_kernel as k2
from bluefog_tpu_torch.ops import windows as PW

N = 8
BF16_RTOL = 2.0 ** -7
F16_RTOL = 2.0 ** -10


def _run(body, *inputs):
    bf.init()
    ctx = bf.get_context()
    f = jax.jit(shard_map(body, mesh=ctx.mesh,
                          in_specs=(P("bf"),) * len(inputs),
                          out_specs=P("bf"), check_vma=False))
    return f(*inputs)


def _port_topology(jtopo):
    return pt.Topology(weights=np.asarray(jtopo.weights), name=jtopo.name)


def _close(got, want, err_msg=""):
    """``got`` (torch) against ``want`` (jax or numpy), in each one's dtype:
    f32 at rtol 1e-6, bf16 and f16 at one ulp of their dtype."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    rtol = {torch.bfloat16: BF16_RTOL, torch.float16: F16_RTOL}.get(
        got.dtype, 1e-6)
    np.testing.assert_allclose(
        got.float().numpy().astype(np.float64), want, rtol=rtol, atol=1e-6,
        err_msg=err_msg)


TOPOLOGIES = {
    "ring": lambda: jt.RingGraph(N),
    "exp2": lambda: jt.ExponentialTwoGraph(N),
    "ring_directed": lambda: jt.RingGraph(N, connect_style=1),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("kind", ["ring", "exp2"])
def test_k2_plain_matches_deliver_pallas_interpret(kind, dtype):
    """Put, then acc, into landing buffers that start non-zero: the port's
    K2 wrapper (its plain version on the CPU) against the TPU kernel, which
    carries f16 on an f32 wire."""
    jtopo = TOPOLOGIES[kind]()
    jsched = jt.build_schedule(jtopo)
    psched = pt.build_schedule(_port_topology(jtopo))
    k = jsched.num_slots
    shape = (4,) if dtype == "f32" else (3, 7)
    rng = np.random.default_rng(5)
    x32 = rng.standard_normal((N,) + shape).astype(np.float32)
    b32 = rng.standard_normal((N, k) + shape).astype(np.float32)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16,
           "f16": torch.float16}[dtype]

    def body(xs, bs):
        bufs = pallas_gossip.deliver_pallas(xs[0], bs[0], jsched, "bf",
                                            accumulate=False, interpret=True)
        bufs = pallas_gossip.deliver_pallas(xs[0], bufs, jsched, "bf",
                                            accumulate=True, interpret=True)
        return bufs[None]

    want = _run(body, jnp.asarray(x32).astype(jdt),
                jnp.asarray(b32).astype(jdt))
    assert want.dtype == jdt
    src, mask = k2.deliver_tables(psched, "cpu")
    x = torch.from_numpy(x32).to(tdt).reshape(N, -1)
    bufs = torch.from_numpy(b32).to(tdt).reshape(N, k, -1)
    k2.window_deliver.launches = 0
    out = k2.window_deliver(x, bufs, src, mask, accumulate=False)
    assert out is bufs  # in place
    k2.window_deliver(x, bufs, src, mask, accumulate=True)
    assert k2.window_deliver.launches == 0  # CPU tensors: the plain version
    _close(bufs.reshape((N, k) + shape), want)
    # slot k of rank i holds twice the value of the rank feeding it
    for r in range(N):
        for s in range(k):
            np.testing.assert_allclose(
                bufs[r, s].float().numpy(),
                2 * x[psched.recv_src[r, s]].float().numpy(), rtol=BF16_RTOL)


def test_k2_plain_weighted_payload_and_closed_form():
    """``dst_weight`` folds into the deliver: the payload is rounded to the
    wire dtype before the add, as the JAX path's ``_weighted`` rounds it.
    Closed form on rank-valued rows: put then acc leaves
    ``2 * dst_weight * recv_src``."""
    psched = pt.build_schedule(pt.ExponentialTwoGraph(N))
    src, mask = k2.deliver_tables(psched, "cpu")
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.arange(N, dtype=torch.float32)[:, None].expand(
            N, 11).to(dtype).contiguous()
        bufs = torch.full((N, 3, 11), -7.0, dtype=dtype)
        k2.window_deliver(x, bufs, src, mask, 0.5, accumulate=False)
        k2.window_deliver(x, bufs, src, mask, 0.5, accumulate=True)
        want = 2 * 0.5 * src.double()[:, :, None].expand(N, 3, 11)
        np.testing.assert_array_equal(bufs.double().numpy(), want.numpy())
    # bf16: 1/3 * x rounds to bf16 first, then the add rounds again
    x = torch.tensor([[1.0, 3.0, 5.0]] * N, dtype=torch.bfloat16)
    bufs = torch.zeros(N, 3, 3, dtype=torch.bfloat16)
    k2.window_deliver(x, bufs, src, mask, 1 / 3, accumulate=True)
    k2.window_deliver(x, bufs, src, mask, 1 / 3, accumulate=True)
    pay = (torch.tensor(1 / 3) * x.float()).to(torch.bfloat16)
    once = (pay.float() + pay.float()).to(torch.bfloat16)
    np.testing.assert_array_equal(bufs[:, 0].float().numpy(),
                                  once.float().numpy())


def test_zero_slot_schedule_leaves_the_slots_unchanged():
    jtopo = jt.Topology(weights=np.eye(N), name="identity8")
    jsched = jt.build_schedule(jtopo)
    psched = pt.build_schedule(_port_topology(jtopo))
    assert psched.num_slots == 0 and psched.is_circulant
    out = _run(lambda p, b: pallas_gossip.deliver_pallas(
        p[0], b[0], jsched, "bf", accumulate=False)[None],
        jnp.ones((N, 4)), jnp.zeros((N, 0, 4)))
    assert out.shape == (N, 0, 4)
    assert k2.resolve_window_backend("auto", psched) == "plain"
    src, mask = k2.deliver_tables(psched, "cpu")
    assert src.shape == (N, 0) and mask.shape == (N, 0)
    bufs = torch.zeros(N, 0, 4)
    assert k2.window_deliver(torch.ones(N, 4), bufs, src, mask,
                             accumulate=True) is bufs
    st = PW.win_create(torch.ones(N, 4), psched)
    PW.win_put(st, None, backend="kernel")
    out, _ = PW.win_update(st, self_weight=0.5)
    np.testing.assert_array_equal(out.numpy(), 0.5)


def test_non_circulant_schedule_is_refused_by_the_kernel_backend():
    """``deliver_pallas`` refuses the star (its remote DMA needs a uniform
    shift); K2 reads each slot's sender row, so ``'auto'`` routes the star
    and the grid to K2, and the kernel route lands the same slots as the
    plain route, put then acc, bit for bit."""
    jsched = jt.build_schedule(jt.StarGraph(N))
    with pytest.raises(ValueError, match="circulant"):
        pallas_gossip.deliver_pallas(jnp.zeros(4), jnp.zeros((1, 4)), jsched,
                                     "bf", accumulate=False, interpret=True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (N, 5)).astype(np.float32))
    for topo in (pt.StarGraph(N), pt.MeshGrid2DGraph(N)):
        psched = pt.build_schedule(topo)
        assert not psched.is_circulant
        assert k2.resolve_window_backend("auto", psched) == "kernel"
        landed = []
        for backend in ("kernel", "plain"):
            st = PW.win_create(x.clone(), psched)
            PW.win_put(st, None, backend=backend, dst_weight=0.5)
            PW.win_accumulate(st, None, backend=backend)
            landed.append(torch.cat([b.reshape(N, -1)
                                     for b in st.peers.values()], 1))
        assert torch.equal(landed[0], landed[1]), topo.name
    with pytest.raises(ValueError, match="unknown backend"):
        PW.win_put(st, None, backend="pallas")
    assert k2.resolve_window_backend(
        "auto", pt.build_schedule(pt.ExponentialTwoGraph(N))) == "kernel"


# ---------------------------------------------------------------------------
# The window op layer against bluefog_tpu/ops/windows.py
# ---------------------------------------------------------------------------


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ops(side, backend):
    """The op calls of one side: JAX inside shard_map, the port on stacked
    tensors.  Returns ``(create, put, acc, get, update, collect)``."""
    if side == "jax":
        return (
            lambda x, s, **kw: JW.win_create(x, s, "bf", **kw),
            lambda st, x, **kw: JW.win_put(st, x, "bf", backend=backend,
                                           **kw),
            lambda st, x, **kw: JW.win_accumulate(st, x, "bf",
                                                  backend=backend, **kw),
            lambda st: JW.win_get(st, "bf"),
            lambda st, **kw: JW.win_update(st, "bf", **kw),
            lambda st: JW.win_update_then_collect(st, "bf"),
        )
    return (
        lambda x, s, **kw: PW.win_create(x, s, **{k: v for k, v in kw.items()
                                                  if k != "name"}),
        lambda st, x, **kw: PW.win_put(st, x, backend=backend, **kw),
        lambda st, x, **kw: PW.win_accumulate(st, x, backend=backend, **kw),
        PW.win_get,
        lambda st, **kw: PW.win_update(st, **kw),
        PW.win_update_then_collect,
    )


def _scn_identity(o, x, s, zeros, nm):
    create, put, acc, get, update, collect = o
    st = create(x, s, name=nm)
    out, st = update(st)
    return out, st


def _scn_put_update(o, x, s, zeros, nm):
    create, put, acc, get, update, collect = o
    st = create(x, s, name=nm)
    st = put(st, x)
    out, st = update(st)
    return out, st


def _scn_weighted_put(o, x, s, zeros, nm):
    create, put, acc, get, update, collect = o
    st = create(x, s, name=nm)
    st = put(st, x, dst_weight=0.5)
    out, st = update(st, self_weight=1.0, recv_weights=[1.0, 1.0])
    return out, st


def _scn_accumulate(o, x, s, zeros, nm):
    create, put, acc, get, update, collect = o
    st = create(zeros(x), s, name=nm)
    st = acc(st, x)
    st = acc(st, x, dst_weight=0.25)
    out, st = update(st, self_weight=1.0, recv_weights=[1.0, 1.0])
    return out, st


def _scn_get(o, x, s, zeros, nm):
    create, put, acc, get, update, collect = o
    st = create(x, s, name=nm)
    st = get(st)
    out, st = update(st)
    return out, st


def _scn_collect(o, x, s, zeros, nm):
    create, put, acc, get, update, collect = o
    st = create(zeros(x), s, name=nm)
    st = acc(st, x)
    first, st = collect(st)
    first = jax.tree_util.tree_map(lambda t: t * 1, first)  # keep a copy
    second, st = collect(st)
    return (first, second), st


def _scn_pytree(o, x, s, zeros, nm):
    create, put, acc, get, update, collect = o
    st = create(x, s, name=nm)
    st = put(st, x, dst_weight=0.5)
    out, st = update(st)
    return out, st


# scenario -> (body, topology, the mirrored test of tests/test_windows.py)
SCENARIOS = {
    "create_then_update_is_identity": (_scn_identity, "ring"),
    "put_update_is_neighbor_allreduce": (_scn_put_update, "exp2"),
    "weighted_put": (_scn_weighted_put, "ring"),
    "accumulate_adds": (_scn_accumulate, "ring"),
    "get_pulls_published_values": (_scn_get, "exp2"),
    "update_then_collect_resets_slots": (_scn_collect, "ring_directed"),
    "pytree_window": (_scn_pytree, "exp2"),
}


def _inputs(name):
    if name == "pytree_window":
        return {"a": _rand((N, 2), 11), "b": _rand((N, 3, 2), 12),
                "h": _rand((N, 5), 13)}  # h is a bf16 leaf
    return {"x": _rand((N, 4), 10)}


def _jax_tree(tree):
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "h" else jnp.float32)
            for k, v in tree.items()}


def _torch_tree(tree):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k == "h"
                                      else torch.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_window_ops_match_jax_windows(name, jax_backend, monkeypatch):
    if jax_backend == "pallas":
        monkeypatch.setenv("BLUEFOG_TPU_PALLAS_INTERPRET", "1")
    body_fn, kind = SCENARIOS[name]
    jtopo = TOPOLOGIES[kind]()
    jsched = jt.build_schedule(jtopo)
    psched = pt.build_schedule(_port_topology(jtopo))
    tree = _inputs(name)
    if name == "weighted_put" or name == "accumulate_adds":
        assert jsched.num_slots == 2  # recv_weights=[1, 1] below

    def body(t):
        t = jax.tree_util.tree_map(lambda v: v[0], t)
        out, st = body_fn(_ops("jax", jax_backend), t, jsched,
                          lambda v: jax.tree_util.tree_map(jnp.zeros_like, v),
                          f"tw_{name}_{jax_backend}")
        return jax.tree_util.tree_map(lambda v: v[None],
                                      (out, st.self_buf, st.peer_bufs))

    want_out, want_self, want_peers = _run(body, _jax_tree(tree))
    # the port: the kernel backend (its plain version on the CPU) against
    # the TPU kernel, the plain backend against XLA
    backend = "kernel" if jax_backend == "pallas" else "plain"
    got_out, st = body_fn(_ops("torch", backend), _torch_tree(tree), psched,
                          lambda v: {k: torch.zeros_like(t)
                                     for k, t in v.items()}, name)
    for g, w in zip(jax.tree_util.tree_leaves((got_out, st.self_buf,
                                               st.peer_bufs)),
                    jax.tree_util.tree_leaves((want_out, want_self,
                                               want_peers))):
        assert tuple(g.shape) == w.shape
        _close(g, w, err_msg=name)
    if name == "create_then_update_is_identity":
        np.testing.assert_allclose(got_out["x"].numpy(), tree["x"], rtol=1e-6)
    if name in ("put_update_is_neighbor_allreduce",
                "get_pulls_published_values"):
        np.testing.assert_allclose(got_out["x"].numpy(),
                                   jtopo.weights @ tree["x"], rtol=1e-5,
                                   atol=1e-6)
    if name == "update_then_collect_resets_slots":
        first, second = got_out
        np.testing.assert_array_equal(first["x"].numpy(), second["x"].numpy())
        assert not st.peers[torch.float32].any()


def test_one_buffer_and_one_deliver_per_dtype(monkeypatch):
    """The window's memory is one (n, L) self buffer and one (n, K, L) slot
    block per dtype, and a put calls K2 once per dtype, whatever the number
    of leaves; the leaves are views into those buffers."""
    tree = _torch_tree(_inputs("pytree_window"))
    tree["c"] = torch.ones(N, 2, 2)
    st = PW.win_create(tree, pt.build_schedule(pt.ExponentialTwoGraph(N)))
    assert {dt: tuple(b.shape) for dt, b in st.bufs.items()} == {
        torch.float32: (N, 12), torch.bfloat16: (N, 5)}
    assert {dt: tuple(b.shape) for dt, b in st.peers.items()} == {
        torch.float32: (N, 3, 12), torch.bfloat16: (N, 3, 5)}
    assert (st.self_buf["c"].data_ptr()
            == st.bufs[torch.float32][:, 8:].data_ptr())
    assert st.peer_bufs["b"].shape == (N, 3, 3, 2)
    calls = []
    real = k2.window_deliver
    monkeypatch.setattr(
        k2, "window_deliver",
        lambda *a, **kw: calls.append(a[0].dtype) or real(*a, **kw))
    PW.win_put(st, None)
    assert calls == [torch.float32, torch.bfloat16]
    PW.win_put(st, tree, backend="plain")
    assert len(calls) == 2
    # the route depends on the schedule alone: f64 and f16 buffers take the
    # kernel under auto too (its wrapper runs the plain version on these CPU
    # tensors), f64 exact and f16 rounded from f32 arithmetic
    ring = pt.build_schedule(pt.RingGraph(N))
    for dt, want in ((torch.float64, 1 / 3),
                     (torch.float16, float(torch.tensor(1 / 3).half()))):
        st_dt = PW.win_create(torch.ones(N, 3, dtype=dt), ring)
        PW.win_put(st_dt, None, dst_weight=1 / 3)
        assert calls[-1] == dt
        np.testing.assert_array_equal(
            st_dt.peers[dt].double().numpy(), want)
    assert len(calls) == 4
    # a dtype K2 does not take raises on the kernel route
    with pytest.raises(TypeError):
        PW.win_put(PW.win_create(torch.ones(N, 3, dtype=torch.int32), ring),
                   None)
    assert len(calls) == 5


def test_sync_and_misuse():
    psched = pt.build_schedule(pt.RingGraph(N))
    x = torch.from_numpy(_rand((N, 3), 20))
    st = PW.win_create(x, psched)
    assert PW.win_sync(st) is st
    out, _ = PW.win_update(st)
    PW.win_sync(st, out * 2)  # a value computed from the window's own view
    np.testing.assert_allclose(st.self_buf.numpy(), 2 * x.numpy(), rtol=1e-6)
    PW.win_sync(st, st.self_buf)  # the self buffer itself
    np.testing.assert_allclose(st.self_buf.numpy(), 2 * x.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="structure"):
        PW.win_sync(st, {"x": x})
    with pytest.raises(ValueError, match="shape"):
        PW.win_sync(st, x[:, :2])
    with pytest.raises(NotImplementedError):
        PW.win_create(x, psched, rule_table=object())
    with pytest.raises(NotImplementedError):
        PW.win_create(x, psched, partition=())
    with pytest.raises(ValueError):
        PW.win_create(torch.ones(N - 1, 3), psched)
    assert PW.win_free(st) is None


def test_k2_wrapper_checks_and_counts_only_card_launches():
    sched = pt.build_schedule(pt.ExponentialTwoGraph(N))
    src, mask = k2.deliver_tables(sched, "cpu")
    k2.window_deliver.launches = 0
    k2.window_deliver(torch.zeros(N, 9), torch.zeros(N, 3, 9), src, mask,
                      accumulate=False)
    assert k2.window_deliver.launches == 0
    with pytest.raises(TypeError):
        k2.window_deliver(torch.zeros(N, 9, dtype=torch.int32),
                          torch.zeros(N, 3, 9, dtype=torch.int32), src,
                          mask, accumulate=False)
    # every float dtype runs the plain version on the CPU, in its own
    # arithmetic: f64 in f64, f16 in f32 rounded to f16
    for dt in (torch.float64, torch.float16):
        bufs = torch.ones(N, 3, 5, dtype=dt)
        k2.window_deliver(torch.full((N, 5), 0.1, dtype=dt), bufs, src, mask,
                          1 / 3, accumulate=True)
        acc = torch.float64 if dt == torch.float64 else torch.float32
        pay = (torch.tensor(1 / 3, dtype=acc)
               * torch.tensor(0.1, dtype=dt).to(acc)).to(dt)
        want = (1 + pay.to(acc)).to(dt)
        np.testing.assert_array_equal(bufs.numpy(),
                                      np.full((N, 3, 5), want.numpy()))
    with pytest.raises(ValueError):
        k2.window_deliver(torch.zeros(N, 9), torch.zeros(N, 2, 9), src, mask,
                          accumulate=False)
    with pytest.raises(ValueError):
        k2.window_deliver(torch.zeros(N, 9), torch.zeros(N, 3, 9),
                          src.long(), mask, accumulate=False)
    with pytest.raises(ValueError):
        k2.window_deliver(torch.zeros(N, 9), torch.zeros(N, 3, 9), src,
                          mask[:, :2], accumulate=False)
    with pytest.raises(ValueError):
        k2.window_deliver(torch.zeros(N, 9, device="meta"),
                          torch.zeros(N, 3, 9, device="meta"),
                          src.to("meta"), mask.to("meta"), accumulate=False)
    # a dead slot keeps its value, even with a source named
    dead = mask.clone()
    dead[2, 1] = 0
    bufs = torch.full((N, 3, 4), 9.0)
    k2.window_deliver(torch.ones(N, 4), bufs, src, dead, accumulate=True)
    assert bufs[2, 1].eq(9.0).all() and bufs[2, 0].eq(10.0).all()
    assert k2.window_deliver.launches == 0


# ---------------------------------------------------------------------------
# The stacked registry against bluefog_tpu.parallel.api
# ---------------------------------------------------------------------------


def test_registry_matches_the_reference_api():
    """``bf.win_*`` of the stacked-array API on both sides: put, accumulate
    and update over a named window, then the registry's misuse errors."""
    x = _rand((N, 3), 30)
    bf.init(topology=jt.RingGraph(N))
    bf.win_create(jnp.asarray(x), "w")
    bf.win_put(jnp.asarray(x), "w", dst_weight=0.5)
    bf.win_accumulate(jnp.asarray(x), "w")
    want = np.asarray(bf.win_update("w", self_weight=0.5,
                                    recv_weights=[0.25, 0.25]))
    want2 = np.asarray(bf.win_update_then_collect("w"))
    pbf.init(topology=pt.RingGraph(N), device="cpu")
    try:
        assert pbf.win_create(x, "w")
        assert pbf.win_put(x, "w", dst_weight=0.5)
        assert pbf.win_accumulate(x, "w")
        got = pbf.win_update("w", self_weight=0.5, recv_weights=[0.25, 0.25])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        got2 = pbf.win_update_then_collect("w")
        np.testing.assert_allclose(got2.numpy(), want2, rtol=1e-6)
        assert pbf.win_get("w")
        ctx = pbf.get_context()
        assert ctx.windows["w"].device.type == "cpu"
        pbf.win_free("w")
        with pytest.raises(KeyError):
            pbf.win_put(x, "w")
        with pytest.raises(KeyError):
            pbf.win_update("w")
        pbf.win_create(x, "a", zero_init=True)
        assert not ctx.windows["a"].bufs[torch.float32].any()
        pbf.win_create(x, "b", topology=pt.ExponentialTwoGraph(N))
        assert ctx.windows["b"].spec.schedule.num_slots == 3
        pbf.win_free()
        assert not ctx.windows
        pbf.win_create(x, "c")
    finally:
        pbf.shutdown()
    with pytest.raises(RuntimeError, match="init"):
        pbf.win_create(x, "w")


# ---------------------------------------------------------------------------
# Associated push-sum scalar (TestAssociatedP of tests/test_windows.py)
# ---------------------------------------------------------------------------


class TestAssociatedP:

    def test_requires_flag(self):
        st = JW.win_create(jnp.zeros((3,)), jt.build_schedule(jt.RingGraph(N)),
                           "bf")
        with pytest.raises(ValueError):
            JW.win_associated_p(st)
        pst = PW.win_create(torch.zeros(N, 3),
                            pt.build_schedule(pt.RingGraph(N)))
        with pytest.raises(ValueError, match="associated_p"):
            PW.win_associated_p(pst)

    def test_explicit_x_on_associated_p_window_raises(self):
        st = PW.win_create(torch.ones(N, 2),
                           pt.build_schedule(pt.RingGraph(N)),
                           associated_p=True)
        with pytest.raises(ValueError, match="associated push-sum"):
            PW.win_put(st, torch.zeros(N, 2))
        with pytest.raises(ValueError, match="associated push-sum"):
            PW.win_accumulate(st, torch.zeros(N, 2))
        # initial contents: p = 1, every slot empty
        np.testing.assert_array_equal(st.assoc_self.numpy(), 1.0)
        assert not st.assoc_peers.any() and not st.peers[torch.float32].any()

    @pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
    def test_win_update_merges_p_with_same_weights(self, jax_backend,
                                                   monkeypatch):
        if jax_backend == "pallas":
            monkeypatch.setenv("BLUEFOG_TPU_PALLAS_INTERPRET", "1")
        jsched = jt.build_schedule(jt.ExponentialTwoGraph(N))
        x = _rand((N, 2), 40)

        def body(xb):
            st = JW.win_create(xb[0], jsched, "bf", associated_p=True,
                               name=f"assoc_{jax_backend}")
            st = JW.win_put(st, None, "bf", dst_weight=0.5,
                            backend=jax_backend)
            out, st = JW.win_update(st, "bf")
            return (out[None], JW.win_associated_p(st)[None],
                    st.assoc_peers[None])

        bf.init()
        ctx = bf.get_context()
        want_out, want_p, want_pp = jax.jit(shard_map(
            body, mesh=ctx.mesh, in_specs=(P("bf"),),
            out_specs=(P("bf"),) * 3, check_vma=False))(jnp.asarray(x))
        st = PW.win_create(torch.from_numpy(x),
                           pt.build_schedule(pt.ExponentialTwoGraph(N)),
                           associated_p=True)
        PW.win_put(st, None, dst_weight=0.5,
                   backend="kernel" if jax_backend == "pallas" else "plain")
        out, _ = PW.win_update(st)
        _close(out, want_out)
        _close(st.assoc_self, want_p)
        _close(st.assoc_peers, want_pp)
        # 1/4 self + 3 x 1/4 of the half-weighted p = 1/4 + 3/8
        np.testing.assert_allclose(st.assoc_self.numpy(), 0.625, rtol=1e-7)

    def test_push_sum_converges_directed(self):
        """Directed one-way ring: x / p recovers the exact mean, and p's
        mass stays n; both sides step for step."""
        jsched = jt.build_schedule(jt.RingGraph(N, connect_style=1))
        psched = pt.build_schedule(pt.RingGraph(N, connect_style=1))
        x0 = _rand((N, 4), 41)
        steps = 200

        def body(x0_blk):
            st = JW.win_create(jnp.zeros_like(x0_blk[0]), jsched, "bf",
                               associated_p=True)
            st = JW.win_sync(st, x0_blk[0])

            def step(st, _):
                st = JW.win_accumulate(st, None, "bf", dst_weight=0.5)
                st = st.replace(self_buf=0.5 * st.self_buf,
                                assoc_self=0.5 * st.assoc_self)
                _, st = JW.win_update_then_collect(st, "bf")
                return st, None

            st, _ = jax.lax.scan(step, st, jnp.arange(steps))
            return st.self_buf[None], JW.win_associated_p(st)[None]

        bf.init()
        ctx = bf.get_context()
        want_x, want_p = jax.jit(shard_map(
            body, mesh=ctx.mesh, in_specs=(P("bf"),),
            out_specs=(P("bf"),) * 2, check_vma=False))(jnp.asarray(x0))

        st = PW.win_create(torch.zeros(N, 4), psched, associated_p=True)
        PW.win_sync(st, torch.from_numpy(x0))
        for _ in range(steps):
            PW.win_accumulate(st, None, dst_weight=0.5)
            st.self_buf.mul_(0.5)
            st.assoc_self.mul_(0.5)
            PW.win_update_then_collect(st)
        p = PW.win_associated_p(st)
        _close(st.self_buf, want_x)
        _close(p, want_p)
        assert float(p.sum()) == N  # dyadic fractions: exact
        np.testing.assert_allclose((st.self_buf / p[:, None]).numpy(),
                                   np.broadcast_to(x0.mean(0), (N, 4)),
                                   atol=1e-5)

"""Compressed gossip (CHOCO) of the port against the JAX package's.

The reference's ``tests/test_compression.py`` on the port, and the same
runs through ``bluefog_tpu.ops.compression`` under ``shard_map`` on the
8-device CPU mesh (the flat mesh, or the two-level mesh for the
hierarchical form).  The port runs on rank-stacked CPU tensors.

``random_block_k`` draws its block offset from a shared seed; the JAX
package folds ``(key, round, leaf)`` into a threefry key and the port draws
from a ``torch.Generator`` (``compression.shared_offset``).  The parity runs
inject the JAX offsets into the port through ``monkeypatch`` on that one
function, so both sides mask the same block; ``identity`` and ``top_k`` need
no injection.

Tolerances: a compressor's payload and its dense form are bit-equal.  A
CHOCO round is the same arithmetic in the same order, but XLA's CPU code
contracts some products and sums into fused multiply-adds, so the rounds
agree to 1e-6 relative per round and the runs to 1e-5 absolute after their
last round (unit-scale values; the consensus contracts the differences).
bf16 runs agree to 2**-6 (two bf16 ulps of unit values).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import bluefog_tpu as bf
import bluefog_tpu.topology as jt
from bluefog_tpu.ops import compression as JCP
from bluefog_tpu.optim import DistributedChocoSGDOptimizer as JChoco
from bluefog_tpu.parallel.api import shard_map
import bluefog_tpu_torch.topology as pt
from bluefog_tpu_torch.ops import compression as CP
from bluefog_tpu_torch.optim import DistributedChocoSGDOptimizer as PChoco

N = 8


@pytest.fixture(autouse=True, scope="module")
def _warm_and_pinned():
    """One torch thread (parallel workers would oversubscribe the host),
    and the JAX mesh's start-up paid once here."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    _jax_choco(JCP.identity(), 1.0, 1, np.zeros((N, 2), np.float32))
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _jax_offset(seed, rnd, leaf_index, n):
    """The offset ``random_block_k`` draws in the JAX package for this
    round and leaf under ``PRNGKey(seed)``."""
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed), rnd), leaf_index)
    return int(jax.random.randint(key, (), 0, n))


@pytest.fixture
def jax_offsets(monkeypatch):
    monkeypatch.setattr(CP, "shared_offset", _jax_offset)


def _mesh():
    return Mesh(np.array(jax.devices()[:N]), ("g",))


def _jax_choco(comp, gamma, rounds, x0, key=42, sched=None):
    sched = sched or jt.build_schedule(jt.RingGraph(N))

    def run(x_blk):
        x = jax.tree_util.tree_map(lambda t: t[0], x_blk)
        st = JCP.choco_init(x, sched)

        def body(carry, _):
            x, st = carry
            return JCP.choco_gossip(x, st, sched, "g", compressor=comp,
                                    gamma=gamma,
                                    key=jax.random.PRNGKey(key)), None

        (x, _), _ = lax.scan(body, (x, st), None, length=rounds)
        return jax.tree_util.tree_map(lambda t: t[None], x)

    out = jax.jit(shard_map(run, mesh=_mesh(), in_specs=(P("g"),),
                            out_specs=P("g"), check_vma=False))(
        jax.tree_util.tree_map(jnp.asarray, x0))
    return jax.tree_util.tree_map(
        lambda t: np.asarray(t.astype(jnp.float32)), out)


def _port_choco(comp, gamma, rounds, x0, key=42, topo=None):
    sched = pt.build_schedule(topo or pt.RingGraph(N))
    x = jax.tree_util.tree_map(torch.from_numpy, x0)
    st = CP.choco_init(x, sched)
    for _ in range(rounds):
        x, st = CP.choco_gossip(x, st, sched, compressor=comp, gamma=gamma,
                                key=key)
    return x, st


def _x0(seed=0, shape=(N, 6)):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))


def _errs(out, x0):
    target = np.asarray(x0, np.float64).mean(axis=0)
    out = np.asarray(out, np.float64)
    return (np.abs(out - target).max(),
            np.abs(out.mean(axis=0) - target).max())


# ---------------------------------------------------------------------------
# Compressors
# ---------------------------------------------------------------------------


def test_identity_roundtrip():
    c = CP.identity()
    x = torch.arange(12.0).reshape(1, 3, 4)
    assert torch.equal(c.decompress(c.compress(x, (0, 0, 0)), (0, 0, 0), x),
                       x)
    assert c.wire_ratio(x) == 1.0 and c.delta == 1.0


@pytest.mark.parametrize("ratio", [0.1, 0.25, 1.0])
def test_random_block_k_is_the_reference_projection(ratio, jax_offsets):
    """``decompress(compress(x))`` keeps ``k`` coordinates of every rank's
    value and zeroes the rest, ``k`` values and no index on the wire; with
    the JAX offset injected, payload and dense form are bit-equal to the
    JAX package's, for every rank at once."""
    c, jc = CP.random_block_k(ratio), JCP.random_block_k(ratio)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (3, 37)))
    key = (7, 2, 1)
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), 2),
                              1)
    payload = c.compress(torch.from_numpy(x), key)
    k = max(1, int(round(ratio * 37)))
    assert payload.shape == (3, k)
    y = c.decompress(payload, key, torch.from_numpy(x)).numpy()
    for r in range(3):
        jp = jc.compress(jnp.asarray(x[r]), jkey)
        np.testing.assert_array_equal(payload[r].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(
            y[r], np.asarray(jc.decompress(jp, jkey, jnp.asarray(x[r]))))
        kept = y[r] != 0
        assert kept.sum() == k
        np.testing.assert_array_equal(y[r][kept], x[r][kept])
    assert abs(c.wire_ratio(torch.zeros(1, 37)) - k / 37) < 1e-9
    assert c.wire_ratio(torch.zeros(1, 37)) == jc.wire_ratio(jnp.zeros(37))


def test_shared_offset_is_a_shared_seeded_draw():
    """The same numbers give the same offset (every rank computes it), in
    range; rounds and leaves move it."""
    draws = [CP.shared_offset(0, r, leaf, 50) for r in range(20)
             for leaf in range(3)]
    assert draws == [CP.shared_offset(0, r, leaf, 50) for r in range(20)
                     for leaf in range(3)]
    assert all(0 <= d < 50 for d in draws) and len(set(draws)) > 10
    c = CP.random_block_k(0.2)
    x = torch.arange(1.0, 51.0)[None]
    m1 = c.decompress(c.compress(x, (0, 0, 0)), (0, 0, 0), x) != 0
    m2 = c.decompress(c.compress(x, (0, 3, 0)), (0, 3, 0), x) != 0
    assert (m1 != m2).any()


def test_top_k_keeps_largest_as_the_reference():
    c, jc = CP.top_k(0.25), JCP.top_k(0.25)
    x = [0.1, -5.0, 0.2, 3.0, -0.3, 0.0, 1.0, 0.05]
    y = c.decompress(c.compress(torch.tensor([x]), None), None,
                     torch.tensor([x]))
    np.testing.assert_array_equal(y[0].numpy(), [0, -5.0, 0, 3.0, 0, 0, 0, 0])
    xs = np.array(jax.random.normal(jax.random.PRNGKey(3), (N, 40)))
    got = c.decompress(c.compress(torch.from_numpy(xs), None), None,
                       torch.from_numpy(xs)).numpy()
    for r in range(N):
        want = jc.decompress(jc.compress(jnp.asarray(xs[r]), None), None,
                             jnp.asarray(xs[r]))
        np.testing.assert_array_equal(got[r], np.asarray(want))
    assert c.wire_ratio(torch.zeros(1, 8)) == pytest.approx(
        2 * (4 + 4) / (8 * 4))


@pytest.mark.parametrize("make", [lambda: CP.random_block_k(0.2),
                                  lambda: CP.top_k(0.2)],
                         ids=["random_block_k", "top_k"])
def test_contraction_property(make):
    """``E||C(x) - x||^2 <= (1 - k/n) ||x||^2`` over the port's own shared
    draws (30 rounds), the CHOCO requirement."""
    c = make()
    x = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(2), (1, 200))))
    errs = [float(((c.decompress(c.compress(x, (0, s, 0)), (0, s, 0), x)
                    - x) ** 2).sum()) for s in range(30)]
    bound = (1 - 40 / 200) * float((x ** 2).sum())
    assert np.mean(errs) <= bound * 1.05


@pytest.mark.parametrize("bad", [0.0, -0.5, 1.5])
def test_bad_ratio_raises(bad):
    for make in (CP.random_block_k, CP.top_k):
        with pytest.raises(ValueError):
            make(bad)


# ---------------------------------------------------------------------------
# CHOCO-Gossip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,gamma,rounds,err_max", [
    ("identity", 1.0, 60, 1e-3),
    ("random_block_k", 0.2, 800, 1e-4),
    ("top_k", 0.6, 200, 5e-3),
])
def test_choco_reaches_consensus_as_the_reference(name, gamma, rounds,
                                                  err_max, jax_offsets):
    """The reference's three consensus runs on the ring (random_block_k at
    ratio 0.1, top_k at 0.25): the port follows the JAX run and meets the
    reference's bounds, and the symmetric mix keeps the mean."""
    make = {"identity": lambda m: m.identity(),
            "random_block_k": lambda m: m.random_block_k(0.1),
            "top_k": lambda m: m.top_k(0.25)}[name]
    x0 = _x0()
    want = _jax_choco(make(JCP), gamma, rounds, x0)
    got, st = _port_choco(make(CP), gamma, rounds, x0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    err, drift = _errs(got.numpy(), x0)
    assert err < err_max, err
    assert drift < (1e-5 if name == "identity" else 1e-4), drift
    assert st.round == rounds


def test_mirror_state_shapes():
    sched = pt.build_schedule(pt.RingGraph(N))
    x = {"a": torch.zeros(N, 3, 2), "b": torch.zeros(N, 5)}
    st = CP.choco_init(x, sched)
    assert st.xhat_nbrs["a"].shape == (N, sched.num_slots, 3, 2)
    assert st.xhat_nbrs["b"].shape == (N, sched.num_slots, 5)
    assert st.xhat_self["a"].shape == (N, 3, 2) and st.round == 0
    jst = JCP.choco_init({"a": jnp.zeros((3, 2))}, jt.build_schedule(
        jt.RingGraph(N)))
    assert jst.xhat_nbrs["a"].shape == st.xhat_nbrs["a"].shape[1:]


def test_choco_on_a_grid_with_empty_slots():
    """The grid's greedy slots leave some ranks without an in-edge in a
    slot: those receive zeros, as from ``ppermute``, and their mirror of
    that slot stays put; the run still follows the JAX one."""
    jsched = jt.build_schedule(jt.MeshGrid2DGraph(N))
    assert (np.asarray(jsched.recv_src) < 0).any()
    x0 = _x0(4)
    want = _jax_choco(JCP.top_k(0.5), 0.5, 100, x0, sched=jsched)
    got, st = _port_choco(CP.top_k(0.5), 0.5, 100, x0,
                          topo=pt.MeshGrid2DGraph(N))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    empty = torch.as_tensor(pt.build_schedule(pt.MeshGrid2DGraph(N))
                            .recv_src) < 0
    assert (st.xhat_nbrs[empty] == 0).all()


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------


def test_asymmetric_topology_raises():
    base = torch.optim.SGD([torch.zeros(N, 2, requires_grad=True)], lr=0.1)
    with pytest.raises(ValueError, match="symmetric"):
        JChoco(optax.sgd(0.1), jt.ExponentialTwoGraph(N), "g")
    with pytest.raises(ValueError, match="symmetric"):
        PChoco(base, pt.ExponentialTwoGraph(N))
    with pytest.raises(ValueError, match="local_size"):
        PChoco(base, pt.RingGraph(N), local_size=0)


def _least_squares(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(N, 16, 4)).astype(np.float32)
    w_star = rng.normal(size=(4,)).astype(np.float32)
    return a, w_star, np.einsum("nij,j->ni", a, w_star).astype(np.float32)


def _port_train(opt_fn, a, b, steps):
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    w = torch.zeros(N, a.shape[2], requires_grad=True)
    opt = opt_fn(torch.optim.SGD([w], lr=0.05))
    for _ in range(steps):
        loss = ((torch.bmm(at, w[:, :, None])[..., 0] - bt) ** 2).mean(1)
        (w.grad,) = torch.autograd.grad(loss.sum(), [w])
        opt.step()
    return w.detach().numpy(), opt


def test_training_converges_to_the_consensus_optimum(jax_offsets):
    """Least squares with per-rank data, ``random_block_k(0.25)`` at gamma
    0.3 for 1000 steps: every rank near the shared optimum and near each
    other (the reference's bounds), following the JAX run."""
    a, w_star, b = _least_squares()
    sched = jt.build_schedule(jt.RingGraph(N))
    jopt = JChoco(optax.sgd(0.05), sched, "g",
                  compressor=JCP.random_block_k(0.25), gamma=0.3)

    def train(a_blk, b_blk):
        ai, bi = a_blk[0], b_blk[0]
        params = jnp.zeros((4,))

        def body(carry, _):
            params, state = carry
            g = jax.grad(lambda w: jnp.mean((ai @ w - bi) ** 2))(params)
            upd, state = jopt.update(g, state, params)
            return (optax.apply_updates(params, upd), state), None

        (params, _), _ = lax.scan(body, (params, jopt.init(params)), None,
                                  length=1000)
        return params[None]

    want = np.asarray(jax.jit(shard_map(
        train, mesh=_mesh(), in_specs=(P("g"), P("g")), out_specs=P("g"),
        check_vma=False))(jnp.asarray(a), jnp.asarray(b)))
    got, opt = _port_train(lambda base: PChoco(
        base, pt.RingGraph(N), compressor=CP.random_block_k(0.25),
        gamma=0.3), a, b, 1000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got - w_star).max() < 0.05, got
    assert np.abs(got - got.mean(axis=0)).max() < 0.01
    assert opt.choco.round == 1000 and opt.count == 1000


def test_default_gamma_is_the_compressors_delta():
    """``gamma=None`` takes the compressor's delta (0.25 here), which
    reaches consensus from random starts in 500 zero-gradient steps."""
    x0 = _x0(5)
    w = torch.from_numpy(x0.copy()).requires_grad_(True)
    opt = PChoco(torch.optim.SGD([w], lr=0.05), pt.RingGraph(N),
                 compressor=CP.random_block_k(0.25))
    assert opt.gamma == 0.25
    for _ in range(500):
        w.grad = torch.zeros_like(w)
        opt.step()
    assert _errs(w.detach().numpy(), x0)[0] < 1e-3


def test_state_dict_round_trip():
    a, _, b = _least_squares(1)
    straight, _ = _port_train(lambda base: PChoco(base, pt.RingGraph(N)),
                              a, b, 6)
    w, opt = _port_train(lambda base: PChoco(base, pt.RingGraph(N)), a, b, 4)
    state = opt.state_dict()
    assert state["round"] == 4 and len(state["xhat_nbrs"]) == 1
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    q = torch.tensor(w, requires_grad=True)
    opt2 = PChoco(torch.optim.SGD([q], lr=0.05), pt.RingGraph(N))
    opt2.load_state_dict(state)
    for _ in range(2):
        loss = ((torch.bmm(at, q[:, :, None])[..., 0] - bt) ** 2).mean(1)
        (q.grad,) = torch.autograd.grad(loss.sum(), [q])
        opt2.step()
    np.testing.assert_array_equal(q.detach().numpy(), straight)


# ---------------------------------------------------------------------------
# The hierarchical form
# ---------------------------------------------------------------------------


def test_hierarchical_consensus_to_the_global_mean(jax_offsets):
    """Exact mean inside machines of 2, CHOCO across Ring(4): every rank at
    the global mean after 300 rounds, the local ranks of a machine exactly
    equal, following the JAX run on the two-level mesh."""
    bf.init(local_size=2, machine_topology=jt.RingGraph(4))
    ctx = bf.get_context()
    m_ax, l_ax = ctx.machine_axis_name, ctx.local_axis_name
    jsched = jt.build_schedule(jt.RingGraph(4))
    jcomp = JCP.random_block_k(0.25)
    x0 = _x0()

    def run(x_blk):
        x = x_blk[0]
        st = JCP.choco_init(x, jsched)

        def body(carry, _):
            x, st = carry
            return JCP.hierarchical_choco_gossip(
                x, st, jsched, m_ax, l_ax, compressor=jcomp,
                gamma=0.3), None

        (x, _), _ = lax.scan(body, (x, st), None, length=300)
        return x[None]

    want = np.asarray(jax.jit(shard_map(
        run, mesh=ctx.hier_mesh, in_specs=(P((m_ax, l_ax)),),
        out_specs=P((m_ax, l_ax)), check_vma=False))(jnp.asarray(x0)))
    msched = pt.build_schedule(pt.RingGraph(4))
    x = torch.from_numpy(x0)
    st = CP.choco_init(x, msched)
    for _ in range(300):
        x, st = CP.hierarchical_choco_gossip(
            x, st, msched, local_size=2, compressor=CP.random_block_k(0.25),
            gamma=0.3)
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-5)
    assert _errs(x.numpy(), x0)[0] < 1e-3
    for m in range(4):
        assert torch.equal(x[2 * m], x[2 * m + 1])
    with pytest.raises(ValueError, match="leading axis"):
        CP.hierarchical_choco_gossip(x[:6], st, msched, local_size=2,
                                     compressor=CP.identity())


def test_optimizer_hierarchical_form():
    """The reference's quadratic under the hierarchical form (machines of
    2 on Ring(4), ``random_block_k(0.25)``, gamma 0.3, 800 steps): the mean
    at the optimum, a bounded bias, the local ranks of a machine equal."""
    c = torch.arange(N, dtype=torch.float32)[:, None].expand(N, 4).clone()
    w = torch.zeros(N, 4, requires_grad=True)
    opt = PChoco(torch.optim.SGD([w], lr=0.05), pt.RingGraph(4),
                 compressor=CP.random_block_k(0.25), gamma=0.3, local_size=2)
    for _ in range(800):
        w.grad = (w - c).detach()
        opt.step()
    w = w.detach().numpy()
    assert abs(w.mean() - 3.5) < 1e-2, w.mean()
    assert np.abs(w - 3.5).max() < 0.5
    for m in range(4):
        np.testing.assert_array_equal(w[2 * m], w[2 * m + 1])


# ---------------------------------------------------------------------------
# Edge cases
# ---------------------------------------------------------------------------


def test_bf16_leaves_converge_as_the_reference(jax_offsets):
    """bf16 mirrors and payloads, the mix in f32: the run bottoms out at
    the bf16 quantization floor (the reference's bound 0.06), following the
    JAX run."""
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (N, 6)))
    x0 = np.array(jnp.asarray(x0).astype(jnp.bfloat16).astype(jnp.float32))
    want = _jax_choco(JCP.random_block_k(0.25), 0.3, 300,
                      jnp.asarray(x0, jnp.bfloat16), key=0)
    sched = pt.build_schedule(pt.RingGraph(N))
    x = torch.from_numpy(x0).to(torch.bfloat16)
    st = CP.choco_init(x, sched)
    for _ in range(300):
        x, st = CP.choco_gossip(x, st, sched,
                                compressor=CP.random_block_k(0.25),
                                gamma=0.3)
    assert x.dtype == torch.bfloat16 and st.xhat_self.dtype == torch.bfloat16
    np.testing.assert_allclose(x.float().numpy(), want, rtol=0,
                               atol=2.0 ** -6)
    err, drift = _errs(x.float().numpy(), x0)
    assert err < 0.06 and drift < 0.06, (err, drift)


def test_size_one_leaf():
    c = CP.random_block_k(0.1)
    x = torch.tensor([[3.0]])
    payload = c.compress(x, (0, 0, 0))
    assert payload.shape == (1, 1)
    assert torch.equal(c.decompress(payload, (0, 0, 0), x), x)


def test_mixed_tree_shapes(jax_offsets):
    """Matrices, vectors and a one-element leaf in one tree, each with its
    own mask key: 200 rounds to each leaf's mean, following the JAX run."""
    # torch's pytree counts a dict's leaves in insertion order, JAX's in
    # sorted key order: sorted keys give both the same leaf indices
    tree0 = {"b": _x0(1, (N, 5)), "s": _x0(2, (N, 1)), "w": _x0(0, (N, 4, 3))}
    want = _jax_choco(JCP.random_block_k(0.5), 0.5, 200, tree0, key=0)
    got, _ = _port_choco(CP.random_block_k(0.5), 0.5, 200, tree0, key=0)
    for k in tree0:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-5, err_msg=k)
        assert _errs(got[k].numpy(), tree0[k])[0] < 1e-3, k

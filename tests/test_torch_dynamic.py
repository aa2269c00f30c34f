"""Time-varying gossip of the port against the JAX package's.

Covers ``topology/dynamic.py`` (the per-rank generators, the one-peer
periods, the aperiodic matrix builder), ``neighbor_allreduce_dynamic``,
``neighbor_allreduce_aperiodic`` (full and capped, the stacked wrapper) and
the optimizer's sequence and callable topologies, with the reference's own
tests (``tests/test_aperiodic.py``, ``tests/test_optimizers.py``) as the
model.  The JAX side runs under ``shard_map`` on the 8-device CPU mesh; the
port runs on rank-stacked CPU tensors, where K1's wrapper takes its plain
version.

Tolerances: the periodic gossip is bit-equal (the same f32 products and sums
in the same order).  The aperiodic gossip is the same fold, but XLA's CPU
code for the JAX decomposition rounds some of its products and sums together
(one f32 ulp apart in a quarter of the entries), so f32 to rtol 1e-6 with an
absolute floor of 1e-6 times the largest magnitude, and bf16 to one bf16 ulp
(rtol 2**-7) after its one rounding; the capped form equals the full form
bit for bit on both sides.  The optimizers over ``optax.sgd``
and ``torch.optim.SGD`` to rtol 1e-6 with an absolute floor of 1e-6 times
the largest magnitude (test_torch_optim.py's, measured bit-equal), and the
300-600-step quadratic runs, whose last digits drift, to 1e-5 absolute.
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
from bluefog_tpu import optim as jopt
from bluefog_tpu.ops import collectives as jcoll
from bluefog_tpu.parallel.api import shard_map
import bluefog_tpu_torch as pbf
import bluefog_tpu_torch.topology as pt
from bluefog_tpu_torch import optim as popt
from bluefog_tpu_torch.ops import collectives as pcoll

N, DIM = 8, 4


@pytest.fixture(autouse=True, scope="module")
def _warm_and_pinned():
    """One torch thread (parallel workers would oversubscribe the host),
    and the JAX mesh's start-up paid once here, not in a timed test."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    _aperiodic_jit(None)(jnp.zeros((N, 1)), jnp.eye(N, dtype=jnp.float32))
    yield
    torch.set_num_threads(prev)


def _mesh():
    return Mesh(np.array(jax.devices()[:N]), ("bf",))


@functools.lru_cache(maxsize=None)
def _aperiodic_jit(cap):
    return jax.jit(shard_map(
        lambda xs, w: jcoll.neighbor_allreduce_aperiodic(
            xs, w, "bf", max_rotations=cap),
        mesh=_mesh(), in_specs=(P("bf"), P()), out_specs=P("bf"),
        check_vma=False))


def _jax_aperiodic(x, w, cap=None):
    xj = jax.tree_util.tree_map(jnp.asarray, x)
    out = _aperiodic_jit(cap)(xj, jnp.asarray(w, jnp.float32))
    return jax.tree_util.tree_map(
        lambda t: np.asarray(t.astype(jnp.float32)), out)


def _close(got, want, rtol=1e-6):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _port_topology(jtopo):
    return pt.Topology(weights=np.asarray(jtopo.weights), name=jtopo.name)


def _random_mixing_matrix(rng, n=N, max_degree=3):
    """Row-stochastic W with a random edge set of random in-degrees (the
    reference test's generator)."""
    w = np.zeros((n, n))
    for i in range(n):
        deg = rng.integers(0, max_degree + 1)
        nbrs = rng.choice([j for j in range(n) if j != i], size=deg,
                          replace=False)
        weights = rng.random(deg + 1) + 0.1
        weights /= weights.sum()
        w[i, i] = weights[0]
        for j, wt in zip(nbrs, weights[1:]):
            w[i, j] = wt
    return w


# ---------------------------------------------------------------------------
# topology/dynamic.py
# ---------------------------------------------------------------------------


def _take(gen, k=12):
    return [next(gen) for _ in range(k)]


GENERATORS = {
    "one_peer_exp2": (
        lambda m, r: m.GetDynamicOnePeerSendRecvRanks(
            m.ExponentialTwoGraph(N), r)),
    "exp2_machines": (
        lambda m, r: m.GetExp2DynamicSendRecvMachineRanks(N, 2, r, r % 2)),
    "inner_outer_ring": (
        lambda m, r: m.GetInnerOuterRingDynamicSendRecvRanks(N, 2, r)),
    "inner_outer_expo2": (
        lambda m, r: m.GetInnerOuterExpo2DynamicSendRecvRanks(N, 4, r)),
}


@pytest.mark.parametrize("kind", sorted(GENERATORS))
def test_generators_match_reference(kind):
    make = GENERATORS[kind]
    for r in range(N):
        assert _take(make(pt, r)) == _take(make(jt, r)), (kind, r)
    want = jt.dynamic_topologies_from_generator(
        N, lambda r: make(jt, r), 6, name=kind)
    got = pt.dynamic_topologies_from_generator(
        N, lambda r: make(pt, r), 6, name=kind)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.weights, w.weights)
        assert g.name == w.name


def test_generators_reject_bad_sizes_and_inconsistent_lists():
    with pytest.raises(ValueError, match="divisible"):
        next(pt.GetExp2DynamicSendRecvMachineRanks(6, 4, 0, 0))
    with pytest.raises(ValueError, match="divisible"):
        pt.GetInnerOuterRingDynamicSendRecvRanks(6, 4, 0)

    def lying(r):
        while True:  # every rank sends right but claims to hear from itself
            yield ([(r + 1) % N], [r])

    # the star's one-peer lists are not symmetric: the centre names one
    # leaf a step while every leaf names the centre
    for m in (pt, jt):
        with pytest.raises(ValueError, match="inconsistent"):
            m.dynamic_topologies_from_generator(N, lying, 1)
        with pytest.raises(ValueError, match="inconsistent"):
            m.dynamic_topologies_from_generator(
                N, lambda r: m.GetDynamicOnePeerSendRecvRanks(
                    m.StarGraph(N), r), 1)
    for r in range(N):
        assert _take(pt.GetDynamicOnePeerSendRecvRanks(pt.StarGraph(N), r)) \
            == _take(jt.GetDynamicOnePeerSendRecvRanks(jt.StarGraph(N), r))


@pytest.mark.parametrize("size", [1, 2, 3, 8, 12])
def test_one_peer_periods_match_reference(size):
    for name in ("one_peer_exponential_two_schedules",
                 "one_peer_ring_schedules"):
        got, want = getattr(pt, name)(size), getattr(jt, name)(size)
        assert [g.name for g in got] == [w.name for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.weights, w.weights)


@pytest.mark.parametrize("size", [1, 3, 8])
def test_one_peer_exp2_matrix_matches_reference_and_schedules(size):
    """The reference's ``test_one_peer_exp2_matrix_matches_schedules``, and
    the port's CPU f32 tensor bit-equal to the JAX array."""
    topos = pt.one_peer_exponential_two_schedules(size)
    for step in range(2 * len(topos) + 1):
        got = pt.one_peer_exp2_mixing_matrix(size, step)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jt.one_peer_exp2_mixing_matrix(size,
                                                                    step)))
        np.testing.assert_array_equal(got.numpy(),
                                      topos[step % len(topos)].weights)


# ---------------------------------------------------------------------------
# neighbor_allreduce_dynamic / neighbor_allreduce_aperiodic
# ---------------------------------------------------------------------------


def test_dynamic_gossip_matches_reference():
    """``schedules[step % period]``, bit-equal to the JAX ``lax.switch`` at
    every phase of one-peer exp2 and of a generated period; a period of one
    is ``neighbor_allreduce``."""
    x = np.random.default_rng(0).standard_normal((N, 5, 3)).astype(
        np.float32)
    # inner ring / outer ring of machines of 2: phases that are not
    # circulant (lane 0 sends +1, lane 1 sends -1)
    inner_outer = jt.dynamic_topologies_from_generator(
        N, lambda r: jt.GetInnerOuterRingDynamicSendRecvRanks(N, 2, r), 2)
    assert not jt.build_schedule(inner_outer[0]).is_circulant
    for jphases in (jt.one_peer_exponential_two_schedules(N), inner_outer):
        jscheds = [jt.build_schedule(t) for t in jphases]
        pphases = [_port_topology(t) for t in jphases]
        f = jax.jit(shard_map(
            lambda xs, s: jcoll.neighbor_allreduce_dynamic(
                xs, jscheds, s, "bf"),
            mesh=_mesh(), in_specs=(P("bf"), P()), out_specs=P("bf"),
            check_vma=False))
        for step in range(2 * len(jphases)):
            want = np.asarray(f(jnp.asarray(x), jnp.int32(step)))
            got = pcoll.neighbor_allreduce_dynamic(torch.from_numpy(x),
                                                   pphases, step)
            np.testing.assert_array_equal(got.numpy(), want)
    one = pcoll.neighbor_allreduce_dynamic(torch.from_numpy(x),
                                           [pt.RingGraph(N)], 5)
    assert torch.equal(one, pcoll.neighbor_allreduce(torch.from_numpy(x),
                                                     pt.RingGraph(N)))
    with pytest.raises(ValueError, match="at least one"):
        pcoll.neighbor_allreduce_dynamic(torch.from_numpy(x), [], 0)


def test_aperiodic_matches_reference_over_many_edge_sets():
    """The reference's dense-oracle test: six random irregular matrices,
    each against the JAX decomposition and within 1e-5 of ``W @ x``;
    each distinct matrix builds its tables once."""
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((N, 5, 3)).astype(np.float32)
    pcoll._aperiodic_tables.cache_clear()
    for _ in range(6):
        w = _random_mixing_matrix(rng)
        want = _jax_aperiodic(xs, w)
        got = pcoll.neighbor_allreduce_aperiodic(torch.from_numpy(xs), w)
        _close(got, want)
        np.testing.assert_allclose(got.numpy(),
                                   np.einsum("ij,jkl->ikl", w, xs),
                                   rtol=1e-5, atol=1e-5)
        pcoll.neighbor_allreduce_aperiodic(torch.from_numpy(xs),
                                           torch.as_tensor(w))
    info = pcoll._aperiodic_tables.cache_info()
    assert (info.misses, info.hits) == (6, 6)


def test_aperiodic_pytree_and_bf16_accumulate_in_f32():
    rng = np.random.default_rng(1)
    w = _random_mixing_matrix(rng)
    tree = {"a": rng.standard_normal((N, 4)).astype(np.float32),
            "b": rng.standard_normal((N, 2, 2)).astype(np.float32)}
    want = _jax_aperiodic(tree, w)
    got = pcoll.neighbor_allreduce_aperiodic(
        {k: torch.from_numpy(v) for k, v in tree.items()}, w)
    for k in tree:
        _close(got[k], want[k])
    xs = rng.standard_normal((N, 16)).astype(np.float32)
    want = _jax_aperiodic(jnp.asarray(xs, jnp.bfloat16), w)
    got = pbf.neighbor_allreduce_aperiodic(
        torch.from_numpy(xs).to(torch.bfloat16), w)
    assert got.dtype == torch.bfloat16
    _close(got, want, rtol=2.0 ** -7)
    np.testing.assert_allclose(got.float().numpy(), w @ xs, rtol=0.05,
                               atol=0.05)


def test_aperiodic_refuses_a_device_matrix_and_bad_shapes():
    x = torch.zeros(N, 3)
    with pytest.raises(ValueError, match="host"):
        pcoll.neighbor_allreduce_aperiodic(x, torch.eye(N, device="meta"))
    with pytest.raises(ValueError, match=r"\(n, n\)"):
        pcoll.neighbor_allreduce_aperiodic(x, np.ones((N, N - 1)))
    with pytest.raises(ValueError, match="leading axis"):
        pcoll.neighbor_allreduce_aperiodic(torch.zeros(N - 1, 3), np.eye(N))
    with pytest.raises(ValueError, match="max_rotations"):
        pcoll.neighbor_allreduce_aperiodic(x, np.eye(N), max_rotations=0)


def test_capped_matches_reference_within_the_cap():
    """``max_rotations=3`` with three active shifts: the JAX capped
    program's result, and the full form's bit for bit."""
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((N, 5)).astype(np.float32)
    for _ in range(4):
        w = np.zeros((N, N))
        for s in rng.choice(range(1, N), size=3, replace=False):
            for i in range(N):
                w[i, i] = 0.4
                w[i, (i - s) % N] = 0.2
        got = pcoll.neighbor_allreduce_aperiodic(torch.from_numpy(xs), w,
                                                 max_rotations=3)
        _close(got, _jax_aperiodic(xs, w, 3))
        np.testing.assert_array_equal(
            got.numpy(),
            pcoll.neighbor_allreduce_aperiodic(torch.from_numpy(xs),
                                               w).numpy())


def test_capped_one_peer_needs_one_slot():
    xs = np.random.default_rng(8).standard_normal((N, 4)).astype(np.float32)
    for step in range(4):
        w = pt.one_peer_exp2_mixing_matrix(N, step)
        got = pcoll.neighbor_allreduce_aperiodic(torch.from_numpy(xs), w,
                                                 max_rotations=1)
        _close(got, _jax_aperiodic(xs, w.numpy(), 1))
        np.testing.assert_allclose(got.numpy(), w.numpy() @ xs, rtol=1e-5,
                                   atol=1e-5)


def test_capped_overflow_poisons_with_nan():
    xs = np.ones((N, 3), np.float32)
    w = np.full((N, N), 1.0 / N)  # full graph: n - 1 active rotations
    assert np.isnan(_jax_aperiodic(xs, w, 2)).all()
    got = pcoll.neighbor_allreduce_aperiodic(
        {"a": torch.from_numpy(xs), "b": torch.ones(N, 2).bfloat16()}, w,
        max_rotations=2)
    assert got["a"].isnan().all() and got["b"].isnan().all()
    assert got["b"].dtype == torch.bfloat16


def test_capped_fuzz_against_full_and_overflow():
    """The reference's fuzz: random circulant-sparse ``W``; the cap that
    covers the active rotations equals the full form (and the JAX capped
    form), one below poisons."""
    rng = np.random.default_rng(11)
    xs = rng.standard_normal((N, 4)).astype(np.float32)
    x = torch.from_numpy(xs)
    for trial in range(8):
        n_active = int(rng.integers(1, 5))
        shifts = rng.choice(range(1, N), size=n_active, replace=False)
        w = np.zeros((N, N))
        for i in range(N):
            w[i, i] = 0.5
            for s in shifts:
                w[i, (i - s) % N] = 0.5 / n_active
        got = pcoll.neighbor_allreduce_aperiodic(x, w, max_rotations=4)
        _close(got, _jax_aperiodic(xs, w, 4))
        np.testing.assert_allclose(got.numpy(), w @ xs, rtol=1e-5,
                                   atol=1e-5)
        if n_active > 1:
            under = pcoll.neighbor_allreduce_aperiodic(
                x, w, max_rotations=n_active - 1)
            assert under.isnan().all(), f"trial {trial}"


# ---------------------------------------------------------------------------
# The optimizer's sequence and callable topologies
# ---------------------------------------------------------------------------


def _targets():
    return np.broadcast_to(np.arange(N, dtype=np.float32)[:, None],
                           (N, DIM)).copy()


def _jax_quadratic(opt, steps):
    """The reference's ``run_quadratic``: rank r minimizes ``||w -
    r||^2 / 2`` from zero."""
    bf.init()
    ctx = bf.get_context()

    def body(c):
        w0 = jnp.zeros_like(c)

        def step(carry, _):
            w, st = carry
            upd, st = opt.update(w - c, st, w)
            return (optax.apply_updates(w, upd), st), None

        (w, _), _ = lax.scan(step, (w0, opt.init(w0)), None, length=steps)
        return w

    f = jax.jit(shard_map(body, mesh=ctx.mesh, in_specs=(P("bf"),),
                          out_specs=P("bf"), check_vma=False))
    return np.asarray(f(jnp.asarray(_targets())))


def _port_quadratic(make_opt, steps, lr=0.05):
    c = torch.from_numpy(_targets())
    w = torch.zeros(N, DIM, requires_grad=True)
    opt = make_opt(torch.optim.SGD([w], lr=lr))
    for _ in range(steps):
        w.grad = (w - c).detach()
        opt.step()
    return w.detach().numpy(), opt


@pytest.mark.parametrize("atc", [True, False], ids=["atc", "awc"])
def test_dynamic_one_peer_optimizer_matches_reference(atc):
    """The reference's ``test_dynamic_one_peer_optimizer`` (300 steps of
    one-peer exp2 on the quadratics) in both modes, against the JAX run."""
    want = _jax_quadratic(jopt.DistributedNeighborAllreduceOptimizer(
        optax.sgd(0.05), topology=jt.one_peer_exponential_two_schedules(N),
        axis_name="bf", atc=atc), 300)
    got, opt = _port_quadratic(
        lambda b: popt.DistributedNeighborAllreduceOptimizer(
            b, topology=pt.one_peer_exponential_two_schedules(N), atc=atc),
        300)
    assert opt.comm_count == 300 and len(opt.schedules) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got - 3.5).max() < 0.5


def test_dynamic_schedules_with_local_steps_cycle_all_phases():
    """The reference's regression test: with k = 3 the phase advances per
    communication round, not per step (stuck on one matching, the spread
    stays 3.0)."""
    want = _jax_quadratic(jopt.DistributedNeighborAllreduceOptimizer(
        optax.sgd(0.05), topology=jt.one_peer_exponential_two_schedules(N),
        axis_name="bf", atc=True, num_steps_per_communication=3), 600)
    got, opt = _port_quadratic(
        lambda b: popt.DistributedNeighborAllreduceOptimizer(
            b, topology=pt.one_peer_exponential_two_schedules(N), atc=True,
            num_steps_per_communication=3), 600)
    assert (opt.count, opt.comm_count) == (600, 200)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got - 3.5).max() < 1.2
    assert (got.max(axis=0) - got.min(axis=0)).max() < 2.0


def test_runtime_cadence_matches_static_and_retunes():
    """The reference's ``runtime_cadence`` test: at a fixed cadence the
    trajectory equals the static form; ``set_comm_every`` retunes it
    between steps; the guards raise."""
    def make(dynamic):
        return lambda b: popt.DistributedNeighborAllreduceOptimizer(
            b, topology=pt.ExponentialTwoGraph(N), atc=True,
            num_steps_per_communication=4, runtime_cadence=dynamic)

    w_static, _ = _port_quadratic(make(False), 12, lr=0.1)
    w_dyn, opt = _port_quadratic(make(True), 12, lr=0.1)
    np.testing.assert_array_equal(w_dyn, w_static)
    want = _jax_quadratic(jopt.DistributedNeighborAllreduceOptimizer(
        optax.sgd(0.1), topology=jt.ExponentialTwoGraph(N), axis_name="bf",
        atc=True, num_steps_per_communication=4, runtime_cadence=True), 12)
    np.testing.assert_allclose(w_dyn, want, rtol=1e-6, atol=1e-6)
    assert popt.get_comm_every(opt) == 4 and opt.comm_count == 3
    popt.set_comm_every(opt, 1)
    w = opt.param_groups[0]["params"][0]
    for _ in range(4):
        w.grad = torch.zeros_like(w)
        opt.step()
    assert opt.comm_count == 3 + 4
    state = opt.state_dict()
    assert (state["comm_every"], state["comm_count"]) == (1, 7)
    with pytest.raises(TypeError, match="runtime_cadence"):
        popt.set_comm_every(_port_quadratic(make(False), 0)[1], 2)
    with pytest.raises(ValueError, match="gossip communication types"):
        popt.decentralized_optimizer(
            torch.optim.SGD([w], lr=0.1), None,
            communication_type=popt.CommunicationType.allreduce,
            runtime_cadence=True)


def _matrix_fn(port):
    return functools.partial(
        pt.one_peer_exp2_mixing_matrix if port
        else jt.one_peer_exp2_mixing_matrix, N)


def _jax_steps(opt, p0, grads):
    mesh = _mesh()
    init = jax.jit(shard_map(
        lambda q: jax.tree_util.tree_map(lambda t: jnp.asarray(t)[None],
                                         opt.init(q[0])),
        mesh=mesh, in_specs=(P("bf"),), out_specs=P("bf"), check_vma=False))

    def step_fn(p, st, g):
        upd, st = opt.update(g, st, p)
        return optax.apply_updates(p, upd), st

    step = jax.jit(shard_map(
        lambda q, s, g: jax.tree_util.tree_map(
            lambda t: t[None],
            step_fn(q[0], jax.tree_util.tree_map(lambda t: t[0], s), g[0])),
        mesh=mesh, in_specs=(P("bf"),) * 3, out_specs=P("bf"),
        check_vma=False))
    p = jnp.asarray(p0)
    st = init(p)
    for g in grads:
        p, st = step(p, st, jnp.asarray(g))
    return np.asarray(p)


def _port_steps(make_opt, p0, grads, lr=0.1):
    p = torch.tensor(p0, requires_grad=True)
    opt = make_opt(torch.optim.SGD([p], lr=lr))
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
    return p.detach().numpy(), opt


@pytest.mark.parametrize("atc", [True, False], ids=["atc", "awc"])
def test_callable_topology_matches_reference_and_respects_the_cap(atc):
    """The reference's ``test_optimizer_callable_topology_respects_cap``:
    the capped one-peer run equals the uncapped one (bit for bit here), both
    match the JAX runs, and the ATC run is ``W_t (p - lr g)`` step by step
    (``test_optimizer_callable_topology_one_compile``)."""
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((N, 6)).astype(np.float32)
    grads = [rng.standard_normal((N, 6)).astype(np.float32)
             for _ in range(4)]
    runs = {}
    for cap in (None, 1):
        want = _jax_steps(jopt.DistributedNeighborAllreduceOptimizer(
            optax.sgd(0.1), topology=_matrix_fn(False), axis_name="bf",
            atc=atc, max_rotations=cap), p0, grads)
        runs[cap], opt = _port_steps(
            lambda b: popt.DistributedNeighborAllreduceOptimizer(
                b, topology=_matrix_fn(True), atc=atc, max_rotations=cap),
            p0, grads)
        np.testing.assert_allclose(runs[cap], want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        assert opt.comm_count == 4 and opt.schedule is None
    np.testing.assert_array_equal(runs[1], runs[None])
    if atc:
        want = p0.astype(np.float64)
        for step, g in enumerate(grads):
            want = (pt.one_peer_exp2_mixing_matrix(N, step).double().numpy()
                    @ (want - 0.1 * g))
        np.testing.assert_allclose(runs[None], want, rtol=1e-5, atol=1e-5)
    base = torch.optim.SGD([torch.zeros(N, 2, requires_grad=True)], lr=0.1)
    with pytest.raises(ValueError, match="callable-topology"):
        popt.DistributedNeighborAllreduceOptimizer(
            base, topology=pt.RingGraph(N), max_rotations=2)


def test_callable_topology_over_the_cap_poisons_the_parameters():
    p, _ = _port_steps(lambda b: popt.DistributedNeighborAllreduceOptimizer(
        b, topology=lambda step: np.full((N, N), 1.0 / N), atc=True,
        max_rotations=2), np.ones((N, 3), np.float32),
        [np.zeros((N, 3), np.float32)])
    assert np.isnan(p).all()


def test_dynamic_state_dict_round_trip():
    """``comm_count`` rides the state dict, so a reloaded optimizer resumes
    at the phase it left."""
    p0 = np.random.default_rng(5).standard_normal((N, 3)).astype(np.float32)
    grads = [np.zeros((N, 3), np.float32)] * 2
    make = lambda b: popt.DistributedNeighborAllreduceOptimizer(  # noqa: E731
        b, topology=pt.one_peer_exponential_two_schedules(N),
        num_steps_per_communication=2)
    _, opt = _port_steps(make, p0, grads)
    state = opt.state_dict()
    assert (state["count"], state["comm_count"]) == (2, 1)
    _, opt2 = _port_steps(make, p0, [])
    opt2.load_state_dict(state)
    assert opt2.comm_count == 1
    assert opt2.schedule.name == opt.schedule.name == "OnePeerShift(2)"

"""Machines, local ranks and hierarchical gossip of the port against the JAX
package's.

The JAX side is the package's stacked API (``bf.init(local_size=...,
machine_topology=...)`` then ``bf.hierarchical_neighbor_allreduce``, flat or
on the two-level mesh) on the 8-device CPU mesh, and its
``DistributedHierarchicalNeighborAllreduceOptimizer`` under ``shard_map``.
The port runs on rank-stacked CPU tensors, where K1's wrapper takes its
plain version; both machine rings used here (Ring(4) at local size 2,
Ring(2) at local size 4) are circulant, so ``'auto'`` routes the machine
gossip to K1.

Tolerances: f32 to rtol 1e-6 with an absolute floor of 1e-6 times the
largest magnitude (the same f32 sums; measured bit-equal).  bf16 to one
bf16 ulp (rtol 2**-7): both sides round an f32 result to bf16 once, and the
port keeps the reference's order (the local sum in f32, rounded to bf16 on
the flat path and not on the two-level one; the self term unrounded, the
shipped rows rounded).  The optimizer over 3 steps: f32 to rtol 1e-6 with
the same floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bluefog_tpu as bf
import bluefog_tpu.topology as jt
from bluefog_tpu import optim as jopt
from bluefog_tpu.parallel.api import shard_map
import bluefog_tpu_torch as pbf
import bluefog_tpu_torch.topology as pt
from bluefog_tpu_torch import optim as popt
from bluefog_tpu_torch.examples import synthetic_benchmark as sb
from bluefog_tpu_torch.ops import collectives as pcoll
from bluefog_tpu_torch.ops import gossip_kernel as k1

N = 8
RTOL = {"f32": 1e-6, "bf16": 2.0 ** -7}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    """One torch thread: under the tier-1 run's parallel workers, torch's
    default of a thread per core oversubscribes the host (a 0.3 s CPU step
    took 24 s there)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.fixture(autouse=True)
def _shutdown_port():
    yield
    pbf.shutdown()


def test_context_machines_match_reference():
    ctx_j = bf.init(local_size=2, machine_topology=jt.RingGraph(4))
    ctx_p = pbf.init(size=N, local_size=2,
                     machine_topology=pt.RingGraph(4), device="cpu")
    assert ctx_p.n_machines == ctx_j.n_machines == 4
    assert pbf.local_size() == bf.local_size() == 2
    assert pbf.machine_size() == bf.machine_size()
    for r in range(N):
        assert pbf.local_rank(r) == bf.local_rank(r)
        assert pbf.machine_rank(r) == bf.machine_rank(r)
    for m in range(4):
        assert pbf.in_neighbor_machine_ranks(m) == \
            bf.in_neighbor_machine_ranks(m)
        assert pbf.out_neighbor_machine_ranks(m) == \
            bf.out_neighbor_machine_ranks(m)
    assert pbf.load_machine_topology().name == bf.load_machine_topology().name
    pbf.set_machine_topology(pt.ExponentialTwoGraph(4), is_weighted=False)
    bf.set_machine_topology(jt.ExponentialTwoGraph(4), is_weighted=False)
    np.testing.assert_allclose(pbf.load_machine_topology().weights,
                               bf.load_machine_topology().weights)
    with pytest.raises(ValueError):
        pbf.set_machine_topology(pt.RingGraph(8))
    # one machine: no machine topology, as in the reference
    pbf.init(size=N, local_size=N, device="cpu")
    assert pbf.load_machine_topology() is None
    assert pbf.in_neighbor_machine_ranks(0) == []
    with pytest.raises(ValueError):
        pbf.init(size=N, local_size=3, device="cpu")


CASES = [(local, over, dt) for local in (2, 4) for over in (False, True)
         for dt in ("f32", "bf16")]


@pytest.mark.parametrize("two_level", [False, True], ids=["flat", "2d"])
@pytest.mark.parametrize("local,overrides,dt", CASES,
                         ids=[f"L{c[0]}-{'weights' if c[1] else 'schedule'}-"
                              f"{c[2]}" for c in CASES])
def test_hierarchical_neighbor_allreduce_matches(two_level, local, overrides,
                                                 dt):
    m = N // local
    x = np.random.default_rng(local + 10 * overrides).standard_normal(
        (N, 3, 7)).astype(np.float32)
    kw = {}
    if overrides:
        k = pt.build_schedule(pt.RingGraph(m)).num_slots
        kw = {"self_weight": 0.3,
              "recv_weights": np.full((k,), 0.7 / k, np.float32)}
    bf.init(local_size=local, machine_topology=jt.RingGraph(m))
    want = bf.hierarchical_neighbor_allreduce(
        jnp.asarray(x, JDT[dt]), two_level_mesh=two_level, **kw)
    pbf.init(size=N, local_size=local, machine_topology=pt.RingGraph(m),
             device="cpu")
    xt = torch.from_numpy(x).to(TDT[dt])
    assert k1.resolve_backend("auto", pbf.get_context().machine_schedule) \
        == "kernel"
    for backend in ("auto", "plain"):
        got = pbf.hierarchical_neighbor_allreduce(
            xt, two_level_mesh=two_level, backend=backend, **kw)
        assert got.dtype == xt.dtype and got.shape == xt.shape
        _close(got, want, RTOL[dt])
        # every local rank of a machine holds the same value
        lanes = got.reshape(m, local, -1)
        assert torch.equal(lanes, lanes[:, :1].expand_as(lanes))


def test_bf16_self_term_stays_unrounded():
    """A bf16 case whose result differs by a bf16 ulp if the self term is
    rounded to bf16 before the fold: the two-level form's local mean is an
    f32 value (on the flat path the bf16 sum halved is already a bf16
    value).  The port keeps the self term in f32, as the reference does, and
    matches it bit for bit here."""
    x = np.random.default_rng(5).standard_normal((N, 4096)).astype(
        np.float32)
    bf.init(local_size=2, machine_topology=jt.RingGraph(4))
    want = _np(bf.hierarchical_neighbor_allreduce(
        jnp.asarray(x, jnp.bfloat16), self_weight=0.55,
        recv_weights=np.array([0.2, 0.25], np.float32), two_level_mesh=True))
    sched = pt.build_schedule(pt.RingGraph(4))
    xt = torch.from_numpy(x).bfloat16()
    got = _np(pcoll.hierarchical_neighbor_allreduce_2d(
        xt, sched, local_size=2, self_weight=0.55,
        recv_weights=[0.2, 0.25]))
    np.testing.assert_array_equal(got, want)
    # the same fold from a rounded self term lands elsewhere
    rounded = (xt.float().reshape(4, 2, -1).sum(1) / 2).bfloat16().float()
    src = torch.as_tensor(sched.recv_src).long()
    alt = (0.55 * rounded + 0.2 * rounded[src[:, 0]]
           + 0.25 * rounded[src[:, 1]]).bfloat16().float()
    assert (alt.repeat_interleave(2, 0).numpy() != got).any()


def test_non_circulant_machine_schedule_takes_the_plain_path():
    """A grid of machines is not circulant: ``'auto'`` folds it on K1's
    plain version, and ``'kernel'`` raises."""
    x = np.random.default_rng(9).standard_normal((N, 5)).astype(np.float32)
    jtopo = jt.MeshGrid2DGraph(4)
    bf.init(local_size=2, machine_topology=jtopo)
    want = bf.hierarchical_neighbor_allreduce(jnp.asarray(x))
    msched = pt.build_schedule(pt.Topology(weights=np.asarray(jtopo.weights),
                                           name=jtopo.name))
    assert k1.resolve_backend("auto", msched) == "plain"
    got = pcoll.hierarchical_neighbor_allreduce(torch.from_numpy(x), msched,
                                                local_size=2)
    _close(got, want, RTOL["f32"])
    with pytest.raises(ValueError, match="circulant"):
        pcoll.hierarchical_neighbor_allreduce(torch.from_numpy(x), msched,
                                              local_size=2, backend="kernel")


def test_machine_fold_runs_on_k1():
    """The machine gossip goes through K1's wrapper (which runs its plain
    version on a CPU tensor): one call per leaf, on the machines' rows,
    f32 and bf16 alike."""
    calls = []
    real = k1.gossip_mix

    def spy(x, *a):
        calls.append((tuple(x.shape), x.dtype))
        return real(x, *a)

    k1.gossip_mix = spy
    try:
        sched = pt.build_schedule(pt.RingGraph(4))
        tree = {"a": torch.randn(N, 6), "b": torch.randn(N, 2, 3).bfloat16()}
        pcoll.hierarchical_neighbor_allreduce(tree, sched, local_size=2)
    finally:
        k1.gossip_mix = real
    # the f32 leaf's 4 machine rows; the bf16 leaf's 4 self rows and 4
    # rounded rows in f32
    assert sorted(calls, key=str) == sorted(
        [((4, 6), torch.float32), ((8, 6), torch.float32)], key=str)


STEPS, LR = 3, 0.1


def _data(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((N, 4, 3)).astype(np.float32),
              "b": rng.standard_normal((N, 5)).astype(np.float32)}
    grads = {k: rng.standard_normal((N, STEPS) + v.shape[1:]).astype(
        np.float32) for k, v in params.items()}
    return params, grads


def _jax_run(opt, params, grads, local):
    ctx = bf.init(local_size=local,
                  machine_topology=jt.RingGraph(N // local))

    def body(p_blk, g_blk):
        p = jax.tree_util.tree_map(lambda t: t[0], p_blk)
        st = opt.init(p)
        for s in range(STEPS):
            g = jax.tree_util.tree_map(lambda t: t[0, s], g_blk)
            upd, st = opt.update(g, st, p)
            p = optax.apply_updates(p, upd)
        return jax.tree_util.tree_map(lambda t: t[None], p)

    f = jax.jit(shard_map(body, mesh=ctx.mesh, in_specs=(P("bf"), P("bf")),
                          out_specs=P("bf"), check_vma=False))
    out = f(jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, grads))
    return {k: np.asarray(v) for k, v in out.items()}


OPT_CASES = [(atc, local, wd) for atc in (False, True) for local in (2, 4)
             for wd in (0.0, 1e-2)]


@pytest.mark.parametrize(
    "atc,local,wd", OPT_CASES,
    ids=[f"{'atc' if c[0] else 'awc'}-L{c[1]}-{'decay' if c[2] else 'sgd'}"
         for c in OPT_CASES])
def test_hierarchical_optimizer_matches_reference(atc, local, wd):
    """3 steps of the hierarchical optimizer.  With weight decay (optax's
    ``add_decayed_weights`` before Nesterov SGD against torch's
    ``SGD(weight_decay=, nesterov=True)``), an AWC base step that read the
    mixed parameters fails this test (without decay it computes the same
    step); the port's reads the un-mixed ones, as the reference's does."""
    params, grads = _data(20 + local)
    base = (optax.chain(optax.add_decayed_weights(wd),
                        optax.sgd(LR, momentum=0.9, nesterov=True))
            if wd else optax.sgd(LR, momentum=0.9))
    want = _jax_run(jopt.DistributedHierarchicalNeighborAllreduceOptimizer(
        base, machine_topology=jt.RingGraph(N // local), local_size=local,
        axis_name="bf", atc=atc), params, grads, local)
    kw = {"weight_decay": wd, "nesterov": True} if wd else {}
    ps = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = popt.DistributedHierarchicalNeighborAllreduceOptimizer(
        torch.optim.SGD(list(ps.values()), lr=LR, momentum=0.9, **kw),
        machine_topology=pt.RingGraph(N // local), local_size=local, atc=atc)
    for s in range(STEPS):
        for k, p in ps.items():
            p.grad = torch.from_numpy(np.ascontiguousarray(grads[k][:, s]))
        opt.step()
    for k, p in ps.items():
        np.testing.assert_allclose(
            p.detach().numpy(), want[k], rtol=1e-6,
            atol=1e-6 * float(np.abs(want[k]).max()), err_msg=k)


def test_hierarchical_optimizer_checks_shapes():
    p = torch.zeros(6, 2, requires_grad=True)
    with pytest.raises(ValueError, match="leading axis 8"):
        popt.DistributedHierarchicalNeighborAllreduceOptimizer(
            torch.optim.SGD([p], lr=0.1), machine_topology=pt.RingGraph(4),
            local_size=2)
    with pytest.raises(ValueError, match="machine_topology"):
        popt.decentralized_optimizer(
            torch.optim.SGD([p], lr=0.1), None,
            communication_type=popt.CommunicationType.
            hierarchical_neighbor_allreduce, local_size=2)


@pytest.mark.parametrize("local", [2, 4])
def test_synthetic_benchmark_hierarchical(local):
    """``--comm hierarchical --local-size L``: machines on a ring of
    ``n / L``, K1's wrapper called once per fused buffer each step, and
    the mix leaves the local ranks of a machine equal."""
    trainer = sb.build("lenet", "hierarchical", size=N, batch_size=2,
                       dtype=torch.float32, device="cpu", local_size=local)
    opt = trainer.opt
    assert opt.machine_schedule.size == N // local
    assert opt.machine_schedule.name.startswith("RingGraph")
    res = sb.run(trainer, warmup=0, iters=2)
    assert all(np.isfinite(loss).all() for loss in res["losses"])
    for m in opt._mix():
        lanes = m.reshape(N // local, local, -1)
        assert torch.equal(lanes, lanes[:, :1].expand_as(lanes))
    with pytest.raises(ValueError, match="local-size"):
        sb.build("lenet", "hierarchical", size=N, device="cpu",
                 local_size=1)

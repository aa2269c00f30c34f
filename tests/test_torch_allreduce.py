"""The flat collectives and the centralized baseline of the port against the
JAX package's.

The JAX side runs the package's own functions under ``shard_map`` on the
8-device CPU mesh; the port runs on rank-stacked CPU tensors.  The same
seeded numpy values go in (bf16 inputs are the same f32 values rounded to
bf16 on both sides).

Tolerances, as measured: the JAX CPU mesh's ``psum`` adds the ranks in order
(bf16 in f32, rounded once), and ``torch.sum`` over the rank axis agreed
with it bit for bit on most elements and by one f32 ulp on a few others in
probes, so f32 sums are held to rtol 2.5e-7 (two ulps) with an
absolute floor of 1e-7 times the largest magnitude; bf16 results, rounded
once from the same f32 sum, to one bf16 ulp (rtol 2**-7).  Gathers,
broadcasts and integer results are exact.  The optimizer runs 3 steps of
the JAX ``DistributedGradientAllreduceOptimizer`` and of the port's from the
same parameters and gradients: f32 to rtol 1e-6 with an absolute floor of
1e-6 times the largest parameter, and every rank of the port bit-equal to
every other.
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
from bluefog_tpu.ops import collectives as jcoll
from bluefog_tpu.parallel.api import shard_map
import bluefog_tpu_torch as pbf
import bluefog_tpu_torch.topology as pt
from bluefog_tpu_torch import optim as popt
from bluefog_tpu_torch.examples import synthetic_benchmark as sb
from bluefog_tpu_torch.ops import collectives as pcoll

N = 8
F32_RTOL = 2.5e-7
BF16_RTOL = 2.0 ** -7
DTYPES = {"f32": (jnp.float32, torch.float32, F32_RTOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_RTOL)}


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    """One torch thread: under the tier-1 run's parallel workers, torch's
    default of a thread per core oversubscribes the host (a 0.3 s CPU step
    took 24 s there)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(body, *inputs):
    ctx = bf.init()
    f = jax.jit(shard_map(body, mesh=ctx.mesh,
                          in_specs=(P("bf"),) * len(inputs),
                          out_specs=P("bf"), check_vma=False))
    return f(*inputs)


def _inputs(dtype_key, shape=(N, 3, 5), seed=0):
    jdt, tdt, rtol = DTYPES[dtype_key]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt), rtol


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" or str(
        a.dtype) == "bfloat16" else a


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("average", [True, False], ids=["mean", "sum"])
def test_allreduce_matches_psum(dt, average):
    xj, xt, rtol = _inputs(dt)
    want = _run(lambda xs: jcoll.allreduce(xs, "bf", average=average), xj)
    got = pcoll.allreduce(xt, average=average)
    assert got.dtype == xt.dtype
    _close(got, want, rtol)
    # every rank holds the same row, in a tensor of its own
    assert torch.equal(got, got[:1].expand_as(got))
    assert got.data_ptr() != xt.data_ptr() and got.stride(0) != 0


@pytest.mark.parametrize("dtype", [torch.int32, torch.bool],
                         ids=["int32", "bool"])
def test_allreduce_keeps_integer_and_bool_dtypes(dtype):
    rng = np.random.default_rng(3)
    x = (rng.integers(-50, 50, (N, 6)) if dtype == torch.int32
         else rng.random((N, 6)) < 0.3)
    want = _run(lambda xs: jcoll.allreduce(xs, "bf"), jnp.asarray(x))
    got = pcoll.allreduce(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("tiled", [False, True], ids=["stacked", "tiled"])
def test_allgather_matches(dt, tiled):
    xj, xt, _ = _inputs(dt)
    want = _run(lambda xs: jcoll.allgather(xs[0], "bf", tiled=tiled)[None],
                xj)
    got = pcoll.allgather(xt, tiled=tiled)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("root", [0, 5])
def test_broadcast_matches(dt, root):
    xj, xt, _ = _inputs(dt, seed=root)
    want = _run(lambda xs: jcoll.broadcast(xs, root, "bf"), xj)
    got = pcoll.broadcast(xt, root)
    np.testing.assert_array_equal(_np(got), _np(want))
    got[0].zero_()  # a tensor of its own: writing one rank leaves the rest
    assert torch.equal(got[1], xt[root])


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_pair_gossip_matches(dt):
    perm = [(0, 1), (1, 0), (2, 5), (5, 2), (6, 7)]
    xj, xt, rtol = _inputs(dt, seed=4)
    want = _run(lambda xs: jcoll.pair_gossip(xs, "bf", perm=perm,
                                             self_weight=0.3), xj)
    got = pcoll.pair_gossip(xt, perm=perm, self_weight=0.3)
    _close(got, want, rtol)
    for r in (3, 4, 7):
        assert torch.equal(got[r], xt[r]) == (r != 7)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("graph", ["exp2", "grid"])
def test_neighbor_allgather_matches(dt, graph):
    jtopo = (jt.ExponentialTwoGraph(N) if graph == "exp2"
             else jt.MeshGrid2DGraph(N))
    ptopo = pt.Topology(weights=np.asarray(jtopo.weights), name=jtopo.name)
    xj, xt, _ = _inputs(dt, seed=6)
    jsched = jt.build_schedule(jtopo)

    def body(xs):
        slots, mask = jcoll.neighbor_allgather(xs[0], jsched, "bf")
        return slots[None], mask[None]

    ctx = bf.init()
    want_slots, want_mask = jax.jit(shard_map(
        body, mesh=ctx.mesh, in_specs=(P("bf"),),
        out_specs=(P("bf"), P("bf")), check_vma=False))(xj)
    slots, mask = pcoll.neighbor_allgather(xt, pt.build_schedule(ptopo))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(_np(slots), _np(want_slots))


def test_stacked_api_matches_the_reference_api():
    x = np.random.default_rng(7).standard_normal((N, 4)).astype(np.float32)
    bf.init()
    pbf.init(size=N, device="cpu")
    try:
        xt = torch.from_numpy(x)
        _close(pbf.allreduce(xt), bf.allreduce(jnp.asarray(x)), F32_RTOL)
        _close(pbf.allreduce(xt, average=False),
               bf.allreduce(jnp.asarray(x), average=False), F32_RTOL)
        np.testing.assert_array_equal(pbf.allgather(xt).numpy(),
                                      np.asarray(bf.allgather(
                                          jnp.asarray(x))))
        np.testing.assert_array_equal(pbf.broadcast(xt, 3).numpy(),
                                      np.asarray(bf.broadcast(
                                          jnp.asarray(x), 3)))
        slots, mask = pbf.neighbor_allgather(xt)
        jslots, jmask = bf.neighbor_allgather(jnp.asarray(x))
        np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert pbf.barrier() is True
    finally:
        pbf.shutdown()


def test_parameter_sync_helpers():
    """``broadcast_parameters``, ``allreduce_parameters`` and
    ``broadcast_optimizer_state`` on a ``torch.optim`` state dict, against
    the reference's helpers on the same values."""
    rng = np.random.default_rng(8)
    params = {"w": rng.standard_normal((N, 3, 2)).astype(np.float32),
              "n": rng.integers(0, 9, (N, 2)).astype(np.int32)}
    bf.init()
    pbf.init(size=N, device="cpu")
    try:
        tp = {k: torch.from_numpy(v) for k, v in params.items()}
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        for port_fn, ref_fn in ((pbf.broadcast_parameters,
                                 lambda t: bf.broadcast_parameters(t, 2)),
                                (pbf.allreduce_parameters,
                                 bf.allreduce_parameters)):
            got = (port_fn(tp, 2) if port_fn is pbf.broadcast_parameters
                   else port_fn(tp))
            want = ref_fn(jp)
            assert got["n"].dtype == torch.int32
            np.testing.assert_array_equal(got["n"].numpy(),
                                          np.asarray(want["n"]))
            _close(got["w"], want["w"], F32_RTOL)
        # a torch.optim state dict: momentum buffers are rank-stacked, the
        # hyper-parameters pass through
        w = torch.from_numpy(params["w"]).requires_grad_(True)
        opt = torch.optim.SGD([w], lr=0.1, momentum=0.9)
        w.grad = torch.from_numpy(rng.standard_normal((N, 3, 2)).astype(
            np.float32))
        opt.step()
        state = opt.state_dict()
        out = pbf.broadcast_optimizer_state(state, root_rank=4)
        buf = state["state"][0]["momentum_buffer"]
        want = np.asarray(bf.broadcast_optimizer_state(
            {"m": jnp.asarray(buf.numpy())}, 4)["m"])
        np.testing.assert_array_equal(
            out["state"][0]["momentum_buffer"].numpy(), want)
        assert out["param_groups"] == state["param_groups"]
        opt.load_state_dict(out)
    finally:
        pbf.shutdown()


STEPS, LR = 3, 0.1


def _opt_data(seed):
    rng = np.random.default_rng(seed)
    params = {"w": np.broadcast_to(rng.standard_normal((1, 4, 3)),
                                   (N, 4, 3)).astype(np.float32),
              "b": np.broadcast_to(rng.standard_normal((1, 5)),
                                   (N, 5)).astype(np.float32)}
    grads = {k: rng.standard_normal((N, STEPS) + v.shape[1:]).astype(
        np.float32) for k, v in params.items()}
    return params, grads


def _jax_opt_run(opt, params, grads):
    ctx = bf.init()

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


@pytest.mark.parametrize("recipe", ["sgd_momentum", "decay_nesterov"])
def test_gradient_allreduce_optimizer_matches_reference(recipe):
    """The centralized baseline over 3 steps, with the synthetic
    benchmark's SGD and with ``imagenet_resnet``'s
    ``add_decayed_weights(wd)`` chained before Nesterov SGD (torch's
    ``SGD(weight_decay=wd, nesterov=True)``): weight decay reads each rank's
    own parameters, after the gradients' mean."""
    wd = 1e-2
    params, grads = _opt_data(11)
    if recipe == "sgd_momentum":
        base, kw = optax.sgd(LR, momentum=0.9), {}
    else:
        base = optax.chain(optax.add_decayed_weights(wd),
                           optax.sgd(LR, momentum=0.9, nesterov=True))
        kw = {"weight_decay": wd, "nesterov": True}
    want = _jax_opt_run(jopt.DistributedGradientAllreduceOptimizer(
        base, axis_name="bf"), params, grads)
    ps = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = popt.DistributedGradientAllreduceOptimizer(
        torch.optim.SGD(list(ps.values()), lr=LR, momentum=0.9, **kw))
    for s in range(STEPS):
        for k, p in ps.items():
            p.grad = torch.from_numpy(np.ascontiguousarray(grads[k][:, s]))
        opt.step()
    for k, p in ps.items():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, want[k], rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want[k]).max()))
        # the allreduce's defining property: ranks that start equal stay
        # equal, bit for bit, parameters and momentum alike
        assert (got == got[:1]).all()
        mom = opt.state[p]["momentum_buffer"].numpy()
        assert (mom == mom[:1]).all()
    # the gradients were averaged in place
    g = ps["w"].grad.numpy()
    assert (g == g[:1]).all()


def test_gradient_allreduce_ignores_the_communication_cadence():
    """As in the reference, the allreduce type averages on every step."""
    opt = popt.decentralized_optimizer(
        torch.optim.SGD([torch.zeros(N, 2, requires_grad=True)], lr=1.0),
        None, communication_type=popt.CommunicationType.allreduce,
        num_steps_per_communication=3)
    p = opt.param_groups[0]["params"][0]
    p.grad = torch.arange(2 * N, dtype=torch.float32).reshape(N, 2)
    opt.step()
    assert torch.equal(p, -p.grad) and torch.equal(p[0], p[7])


def test_synthetic_benchmark_allreduce_keeps_ranks_equal():
    """``--comm allreduce`` of the synthetic benchmark: different batches a
    rank, the same parameters and momentum on every rank after the steps."""
    trainer = sb.build("resnet18", "allreduce", size=4, batch_size=2,
                       image_size=16, num_classes=5, num_filters=4,
                       dtype=torch.float32, device="cpu")
    assert trainer.opt.communication_type == popt.CommunicationType.allreduce
    res = sb.run(trainer, warmup=0, iters=2)
    assert all(np.isfinite(loss).all() for loss in res["losses"])
    assert not np.allclose(res["losses"][0][0], res["losses"][0][1])
    for name, t in trainer.state().items():
        if name.startswith(("param.", "momentum.")):
            assert torch.equal(t, t[:1].expand_as(t)), name

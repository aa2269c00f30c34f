"""The slices end to end: decentralized SGD of a narrow ResNet over 8 virtual
ranks on Exponential-2, the port against the JAX package, with the gossip
optimizer (slice 1's main path) and with the one-sided WinPut optimizer; and
the transformer slice, the same gossip SGD of a narrow GPT.

The JAX side is the ``shard_map`` step of ``__graft_entry__.py::
dryrun_multichip`` (its first optimizer loop) on the 8-device CPU mesh, with
the main path's optimizer (``DistributedNeighborAllreduceOptimizer`` over SGD
with lr 0.01 and momentum 0.9, state carried across steps) and train-mode
BatchNorm whose per-rank statistics are not gossiped.  The port runs
``examples.synthetic_benchmark.Trainer.step`` on the CPU, where K1's wrapper
takes its plain version.

Every rank starts from the same weights and sees its own batch.  As in
``test_torch_resnet.py`` the JAX oracle computes in f64 (its optimizer still
rounds each update through f32), the port in f32; losses, parameters and
BatchNorm statistics of every rank after one and after two steps agree to
rtol 1e-4 with an absolute floor of 1e-4 times each tensor's largest entry.
The per-rank batch is 16: at 8, the stage-4 BatchNorm normalizes 8 values
per channel, and the port's own f32 and f64 parameters after two steps were
measured 9e-4 of their scale apart, while its f64 ones met the JAX oracle to
1.2e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bluefog_tpu as bf
from bluefog_tpu.models import resnet as jres
from bluefog_tpu.models import transformer as jtr
from bluefog_tpu.optim import DistributedNeighborAllreduceOptimizer as JOpt
from bluefog_tpu.optim import DistributedWinPutOptimizer as JWinPut
from bluefog_tpu.parallel.api import shard_map
from bluefog_tpu.topology import ExponentialTwoGraph as JExp2
import bluefog_tpu_torch as pbf
from bluefog_tpu_torch import convert
from bluefog_tpu_torch.examples import synthetic_benchmark as sb
from bluefog_tpu_torch.models import resnet as pres
from bluefog_tpu_torch.models import transformer as ptr
from bluefog_tpu_torch.ops import gossip_kernel

N, BATCH, IMG, CLASSES, FILTERS = 8, 16, 32, 10, 8
LR, MOMENTUM, STEPS, RTOL = 0.01, 0.9, 2, 1e-4
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    """The port's f32 gradients on the CPU depend on torch's thread count
    (see ``test_torch_resnet.py``); a fixed count makes them the same on
    every machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(prev)


def _port_model():
    pm = pres.ResNet(stage_sizes=[1, 1, 1, 1],
                     block_cls=pres.BottleneckBlock, num_classes=CLASSES,
                     num_filters=FILTERS, dtype=torch.float32,
                     generator=torch.Generator().manual_seed(0))
    # random BN scales and biases: the zero-scaled last BN of each block
    # would otherwise leave the residual branches without gradient
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, t in pm.named_parameters():
            if t.dim() == 1 and not name.startswith("head"):
                lo, hi = (-0.2, 0.2) if name.endswith("bias") else (0.5, 1.5)
                t.copy_(torch.from_numpy(rng.uniform(lo, hi, t.shape)))
    return pm


def _data():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N, BATCH, IMG, IMG, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, (N, BATCH)).astype(np.int32)
    return x, y


def _jax_steps(params, stats, x, y, winput=False):
    """Per step: (losses (n,), params tree, batch_stats tree), stacked."""
    model = jres.ResNet(stage_sizes=[1, 1, 1, 1],
                        block_cls=jres.BottleneckBlock, num_classes=CLASSES,
                        num_filters=FILTERS, dtype=jnp.float64)
    ctx = bf.init(topology=JExp2(N))
    make = JWinPut if winput else JOpt
    opt = make(optax.sgd(LR, momentum=MOMENTUM), topology=ctx.schedule,
               axis_name=ctx.axis_name)

    def train_step(p_blk, bs_blk, st_blk, x_blk, y_blk):
        p, bs, st = jax.tree_util.tree_map(lambda t: t[0],
                                           (p_blk, bs_blk, st_blk))
        xb, yb = x_blk[0], y_blk[0]

        def loss_fn(p):
            logits, mut = model.apply({"params": p, "batch_stats": bs}, xb,
                                      train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, yb).mean(), mut["batch_stats"]

        (loss, new_bs), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        upd, st = opt.update(g, st, p)
        p = optax.apply_updates(p, upd)
        return (jax.tree_util.tree_map(lambda t: t[None], (p, new_bs, st))
                + (loss[None],))

    step = jax.jit(shard_map(
        train_step, mesh=ctx.mesh, in_specs=(P(ctx.axis_name),) * 5,
        out_specs=(P(ctx.axis_name),) * 4, check_vma=False))
    f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, jnp.float64), t)
    stack = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.broadcast_to(a[None], (N,) + jnp.shape(a)), t)
    p, bs = stack(f64(params)), stack(f64(stats))
    st = stack(opt.init(f64(params)))
    xs, ys = jnp.asarray(x, jnp.float64), jnp.asarray(y)
    out = []
    for _ in range(STEPS):
        p, bs, st, loss = step(p, bs, st, xs, ys)
        out.append(jax.tree_util.tree_map(np.asarray, (loss, p, bs)))
    return out


def _both_runs(winput):
    x, y = _data()
    pm = _port_model()
    params, stats = convert.flax_from_state_dict(pm.state_dict())
    with jax.enable_x64(True):
        want = _jax_steps(params, stats, x, y, winput)
    bf.shutdown()

    dev = torch.device("cpu")
    ps = pbf.rank_stack(dict(pm.named_parameters()), N, dev)
    for p in ps.values():
        p.requires_grad_(True)
        p.grad = torch.zeros_like(p)
    make = (pbf.DistributedWinPutOptimizer if winput
            else pbf.DistributedNeighborAllreduceOptimizer)
    opt = make(torch.optim.SGD(list(ps.values()), lr=LR, momentum=MOMENTUM),
               topology=pbf.topology.ExponentialTwoGraph(N))
    trainer = sb.Trainer(pm, ps, pbf.rank_stack(dict(pm.named_buffers()), N,
                                                 dev),
                         opt,
                         (torch.from_numpy(x), torch.from_numpy(y).long()),
                         sb.image_loss)
    got = []
    for _ in range(STEPS):
        loss = trainer.step()
        got.append((loss.numpy().copy(),
                    {k: v.detach().numpy().copy()
                     for k, v in trainer.params.items()},
                    {k: v.numpy().copy() for k, v in trainer.buffers.items()}))
    return want, got


@pytest.fixture(scope="module")
def runs():
    return _both_runs(winput=False)


@pytest.fixture(scope="module")
def winput_runs():
    return _both_runs(winput=True)


def _close(got, want, name):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=RTOL,
        atol=RTOL * max(float(np.abs(want).max()), 1e-30), err_msg=name)


def _check_step(runs, step):
    want, got = runs
    jloss, jparams, jstats = want[step]
    ploss, pparams, pstats = got[step]
    assert np.isfinite(ploss).all()
    _close(ploss, jloss, "losses")
    for r in range(N):
        ref = convert.state_dict_from_flax(
            jax.tree_util.tree_map(lambda t: t[r], jparams),
            jax.tree_util.tree_map(lambda t: t[r], jstats))
        for k, v in pparams.items():
            _close(v[r], ref[k], f"rank {r} param {k}")
        for k, v in pstats.items():
            _close(v[r], ref[k], f"rank {r} stat {k}")
    # ranks saw different data, so one gossip round leaves them apart
    assert not np.allclose(pparams["head.weight"][0],
                           pparams["head.weight"][1])


@pytest.mark.parametrize("step", range(STEPS), ids=["one_step", "two_steps"])
def test_decentralized_steps_match_jax_shard_map(runs, step):
    _check_step(runs, step)


@pytest.mark.parametrize("step", range(STEPS), ids=["one_step", "two_steps"])
def test_winput_steps_match_jax_shard_map(winput_runs, step):
    """The same steps with ``DistributedWinPutOptimizer`` on both sides: the
    port's window put rides K2's wrapper (its plain version here)."""
    _check_step(winput_runs, step)


def test_build_and_run_at_a_toy_size_on_the_cpu():
    trainer = sb.build("resnet18", "neighbor", "ring", size=2, batch_size=1,
                       image_size=32, num_classes=10, num_filters=4,
                       dtype=torch.float32, device="cpu")
    assert trainer.batch[0].shape == (2, 1, 32, 32, 3)
    gossip_kernel.gossip_mix.launches = 0
    res = sb.run(trainer, warmup=1, iters=1)
    assert len(res["losses"]) == 2 and len(res["step_ms"]) == 1
    assert all(np.isfinite(v).all() for v in res["losses"])
    assert gossip_kernel.gossip_mix.launches == 0  # no card here
    assert trainer.opt.count == 2
    local = sb.build("resnet18", "none", size=2, batch_size=1,
                     image_size=32, num_classes=10, num_filters=4,
                     dtype=torch.float32, device="cpu")
    assert local.opt.schedule is None
    winput = sb.build("resnet18", "winput", "ring", size=2, batch_size=1,
                      image_size=32, num_classes=10, num_filters=4,
                      dtype=torch.float32, device="cpu")
    res = sb.run(winput, warmup=0, iters=1)
    assert all(np.isfinite(v).all() for v in res["losses"])
    state = winput.state()
    assert {"window.self.torch.float32",
            "window.peers.torch.float32"} <= set(state)
    assert state["window.peers.torch.float32"].shape[:2] == (2, 1)


# --- the transformer slice ---------------------------------------------------
#
# ``examples/synthetic_benchmark.py --model gpt-small --comm neighbor`` of the
# JAX package, at the narrow width of ``test_torch_transformer.py`` (vocab
# 512, hidden 128, 4 heads, 2 layers, T = 128, f32, batch 2 per rank): its
# ``train_step`` (``:232-245``, rebuilt here on the CPU mesh, since ``main()``
# cannot be imported) under ``DistributedNeighborAllreduceOptimizer`` over SGD
# with lr 0.01 and momentum 0.9, against the port's ``Trainer.step`` with
# ``lm_loss``, where K3's wrappers take their twins and K1's its plain
# version.  f32 on both sides: the narrow GPT's f32 logits and gradients
# already meet flax's to 1.4e-6, so no f64 oracle is needed; the same RTOL.

GPT = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
           max_position=256)
GPT_T, GPT_BATCH = 128, 2


def _gpt_params():
    """flax's initial params, LayerNorm scales and biases moved by seeded
    noise (numpy arrays)."""
    model = jtr.TransformerLM(jtr.GPTConfig(dtype=jnp.float32, **GPT))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, GPT_T), jnp.int32))["params"]
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + (
            0.1 * rng.standard_normal(a.shape).astype(np.float32)
            if path[-1].key in ("bias", "scale") else 0), params)


def _jax_gpt_steps(params, ids):
    """Per step: (losses (n,), params tree), stacked."""
    model = jtr.TransformerLM(jtr.GPTConfig(dtype=jnp.float32, **GPT))
    ctx = bf.init(topology=JExp2(N))
    opt = JOpt(optax.sgd(LR, momentum=MOMENTUM), topology=ctx.schedule,
               axis_name=ctx.axis_name)

    def loss_fn(p, ids):
        logits = model.apply({"params": p}, ids)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.roll(ids, -1, axis=-1)).mean()

    def train_step(p_blk, st_blk, ids_blk):
        p, st = jax.tree_util.tree_map(lambda t: t[0], (p_blk, st_blk))
        loss, g = jax.value_and_grad(loss_fn)(p, ids_blk[0])
        upd, st = opt.update(g, st, p)
        p = optax.apply_updates(p, upd)
        return jax.tree_util.tree_map(lambda t: t[None], (p, st)) + (
            loss[None],)

    step = jax.jit(shard_map(
        train_step, mesh=ctx.mesh, in_specs=(P(ctx.axis_name),) * 3,
        out_specs=(P(ctx.axis_name),) * 3, check_vma=False))
    stack = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.broadcast_to(a[None], (N,) + jnp.shape(a)), t)
    p, st = stack(params), stack(opt.init(params))
    out = []
    for _ in range(STEPS):
        p, st, loss = step(p, st, jnp.asarray(ids))
        out.append(jax.tree_util.tree_map(np.asarray, (loss, p)))
    return out


@pytest.fixture(scope="module")
def gpt_runs():
    params = _gpt_params()
    ids = np.random.default_rng(2).integers(
        0, GPT["vocab_size"], (N, GPT_BATCH, GPT_T)).astype(np.int32)
    want = _jax_gpt_steps(params, ids)
    bf.shutdown()

    model = ptr.TransformerLM(ptr.GPTConfig(dtype=torch.float32, **GPT))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           convert.gpt_from_flax(params).items()})
    ps = pbf.rank_stack(dict(model.named_parameters()), N, "cpu")
    for p in ps.values():
        p.requires_grad_(True)
        p.grad = torch.zeros_like(p)
    opt = pbf.DistributedNeighborAllreduceOptimizer(
        torch.optim.SGD(list(ps.values()), lr=LR, momentum=MOMENTUM),
        topology=pbf.topology.ExponentialTwoGraph(N))
    trainer = sb.Trainer(model, ps, {}, opt, (torch.from_numpy(ids).long(),),
                         sb.lm_loss)
    got = []
    for _ in range(STEPS):
        loss = trainer.step()
        got.append((loss.numpy().copy(),
                    {k: v.detach().numpy().copy() for k, v in ps.items()}))
    return want, got


@pytest.mark.parametrize("step", range(STEPS), ids=["one_step", "two_steps"])
def test_gpt_steps_match_jax_shard_map(gpt_runs, step):
    want, got = gpt_runs
    jloss, jparams = want[step]
    ploss, pparams = got[step]
    assert np.isfinite(ploss).all()
    _close(ploss, jloss, "losses")
    for r in range(N):
        ref = convert.gpt_from_flax(
            jax.tree_util.tree_map(lambda t: t[r], jparams))
        assert set(ref) == set(pparams)
        for k, v in pparams.items():
            _close(v[r], ref[k], f"rank {r} param {k}")
    # ranks saw different tokens, so one gossip round leaves them apart
    assert not np.allclose(pparams["lm_head.weight"][0],
                           pparams["lm_head.weight"][1])


def test_gpt_build_and_run_at_a_narrow_width_on_the_cpu(monkeypatch):
    """``build`` makes the token batch and the trainer of ``gpt-small``;
    here with the narrow GPT in its place (gpt-small itself is full width,
    168.6M parameters per rank)."""
    from bluefog_tpu_torch.ops import flash_kernel

    spec = sb.MODELS["gpt-small"]
    monkeypatch.setitem(sb.MODELS, "gpt-small", sb.ModelSpec(
        lambda dtype, gen, classes, filters: ptr.TransformerLM(
            ptr.GPTConfig(dtype=dtype, **GPT), generator=gen),
        spec.loss, tokens=True))
    trainer = sb.build("gpt-small", "neighbor", "exp2", size=2, batch_size=1,
                       seq_len=1000, dtype=torch.float32, device="cpu")
    # the sequence is cut to the model's positions, as in the JAX benchmark
    assert trainer.batch[0].shape == (2, 1, GPT["max_position"])
    assert trainer.batch[0].dtype == torch.int64 and not trainer.buffers
    flash_kernel.flash_forward.launches = 0
    res = sb.run(trainer, warmup=1, iters=1)
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert flash_kernel.flash_forward.launches == 0  # no card here
    assert trainer.opt.count == 2

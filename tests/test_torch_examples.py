"""LeNet and the two examples that train from a data source,
``mnist_decentralized`` (BASELINE.json ``configs[0]``) and
``imagenet_resnet`` (``configs[1]``), against the JAX package.

- LeNet's f32 logits and gradients from converted flax weights: rtol 1e-5
  with an absolute floor of 1e-5 times the largest magnitude (the same f32
  convolutions and products in another order).
- The learning-rate schedule against ``optax.join_schedules`` at every step
  of a small run (rtol 1e-6: optax computes in f32, the port in f64), and
  the label-smoothed loss against optax's ``smooth_labels`` and
  ``softmax_cross_entropy`` (rtol 1e-6).
- Two steps of the MNIST example's ring gossip (ATC and AWC) against the
  JAX package's ``DistributedNeighborAllreduceOptimizer`` over ``optax.sgd``
  with flax's LeNet under ``shard_map``, on data both are given: losses and
  parameters to rtol 1e-5 with the same floor.
- One ``imagenet_resnet`` step at image size 32 with ``--optimizer
  allreduce`` against the JAX example's ``train_step``, composed here from
  converted weights: the JAX side computes in f64 (as ``test_torch_slice``
  explains, flax's own f32 ResNet gradients stray), the port in f32; losses,
  parameters and BatchNorm statistics to rtol 1e-4 with a floor of 1e-4
  times each tensor's largest entry.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

import bluefog_tpu as bf
from bluefog_tpu.models import LeNet5 as JLeNet
from bluefog_tpu.models import ResNet50 as JResNet50
from bluefog_tpu.optim import (
    DistributedGradientAllreduceOptimizer as JAllreduce,
    DistributedNeighborAllreduceOptimizer as JNeighbor,
)
from bluefog_tpu.parallel.api import shard_map
from bluefog_tpu.topology import RingGraph as JRing
from bluefog_tpu_torch import convert
from bluefog_tpu_torch.data import (
    DistributedLoader, write_image_classification_shards)
from bluefog_tpu_torch.examples import imagenet_resnet as inet
from bluefog_tpu_torch.examples import mnist_decentralized as mnist
from bluefog_tpu_torch.examples import synthetic_benchmark as sb
from bluefog_tpu_torch.models import LeNet5
from bluefog_tpu_torch.ops import gossip_kernel as k1

N = 8
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    """f32 CPU results depend on torch's thread count (see
    ``test_torch_resnet.py``); a fixed count makes them repeat."""
    prev = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol, name=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=rtol,
        atol=rtol * max(float(np.abs(want).max()), 1e-30), err_msg=name)


def _flax_lenet(seed=0):
    return JLeNet().init(jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 1)))


def _port_lenet(variables):
    return convert.load_flax(LeNet5(), variables["params"])


@pytest.fixture(scope="module")
def lenet_oracle():
    """flax LeNet's logits and gradients on a seeded batch (the first JAX
    compilation of the module is paid here, outside the test's budget)."""
    variables = _flax_lenet(3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 6)

    def loss_fn(p):
        logits = JLeNet().apply(p, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(), logits

    (_, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables)
    return variables, x, y, np.asarray(logits), grads


def test_lenet_logits_and_gradients_match_flax(lenet_oracle):
    variables, x, y, logits, grads = lenet_oracle
    pm = _port_lenet(variables)
    out = pm(torch.from_numpy(x))
    assert out.dtype == torch.float32
    _close(out.detach().numpy(), logits, 1e-5, "logits")
    F.cross_entropy(out, torch.from_numpy(y)).backward()
    want = convert.state_dict_from_flax(grads["params"])
    for name, p in pm.named_parameters():
        _close(p.grad.numpy(), want[name], 1e-5, name)


def test_lenet_bf16_computes_in_bf16_with_an_f32_head():
    pm = LeNet5(dtype=torch.bfloat16)
    out = pm(torch.randn(2, 28, 28, 1))
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in pm.parameters())


def test_lr_schedule_matches_optax():
    lr, batch, warmup, epochs, spe = 0.1, 32, 2, 5, 3
    base = lr * batch / 256.0
    want = optax.join_schedules(
        [optax.linear_schedule(0.0, base, warmup * spe),
         optax.cosine_decay_schedule(base, (epochs - warmup) * spe)],
        [warmup * spe])
    got = inet.lr_schedule(lr, batch, warmup, epochs, spe)
    for step in range(epochs * spe + 2):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-9, err_msg=f"step {step}")
    # no warm-up, and more warm-up epochs than epochs: one decay epoch
    for warmup, epochs in ((0, 3), (4, 2)):
        want = optax.join_schedules(
            [optax.linear_schedule(0.0, base, warmup * spe),
             optax.cosine_decay_schedule(
                 base, max(epochs - warmup, 1) * spe)], [warmup * spe])
        got = inet.lr_schedule(lr, batch, warmup, epochs, spe)
        for step in range((warmup + 2) * spe):
            np.testing.assert_allclose(got(step), float(want(step)),
                                       rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.4])
def test_label_smoothed_loss_matches_optax(smoothing):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((7, 12)).astype(np.float32) * 3
    y = rng.integers(0, 12, 7)
    want = optax.softmax_cross_entropy(
        logits, optax.smooth_labels(jax.nn.one_hot(y, 12), smoothing)).mean()
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(y),
                          label_smoothing=smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prepare_maps_uint8_as_the_jax_example(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = np.asarray((jnp.asarray(x).astype(jdt) / 127.5 - 1.0).astype(
        jdt).astype(jnp.float32))
    got = inet.prepare(torch.from_numpy(x), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_mnist_reaches_ok_on_the_cpu(capsys):
    res = mnist.main(["--device", "cpu", "--n-per-rank", "80",
                      "--batch-size", "8", "--epochs", "3", "--atc"])
    out = capsys.readouterr().out
    assert res["total_steps"] == 30
    assert res["final_acc"] > 0.9
    assert out.strip().splitlines()[-1] == "OK"
    # allreduce_parameters left every rank with the same parameters
    for p in res["trainer"].params.values():
        assert torch.equal(p, p[:1].expand_as(p))


def test_mnist_dataset_recipe():
    imgs, labels = mnist.make_dataset(16, 3, seed=1)
    assert imgs.shape == (3, 16, 28, 28, 1) and imgs.dtype == np.float32
    assert labels.shape == (3, 16) and labels.max() < 10
    again, _ = mnist.make_dataset(16, 3, seed=1)
    np.testing.assert_array_equal(imgs, again)


@pytest.mark.parametrize("atc", [True, False], ids=["atc", "awc"])
def test_mnist_steps_match_jax(atc):
    """Two steps of the example's training on data both sides are given."""
    batch, steps, lr = 4, 2, 0.05
    imgs, labels = mnist.make_dataset(batch * steps, N, seed=3)
    variables = _flax_lenet(1)
    model = JLeNet()
    ctx = bf.init(topology=JRing(N))
    opt = JNeighbor(optax.sgd(lr, momentum=0.9), topology=ctx.schedule,
                    axis_name=ctx.axis_name, atc=atc)

    def body(p_blk, x_blk, y_blk):
        p = jax.tree_util.tree_map(lambda t: t[0], p_blk)
        st = opt.init(p)
        losses = []
        for i in range(steps):
            xb = x_blk[0, i * batch:(i + 1) * batch]
            yb = y_blk[0, i * batch:(i + 1) * batch]
            loss, g = jax.value_and_grad(
                lambda q: optax.softmax_cross_entropy_with_integer_labels(
                    model.apply(q, xb), yb).mean())(p)
            upd, st = opt.update(g, st, p)
            p = optax.apply_updates(p, upd)
            losses.append(loss)
        return (jax.tree_util.tree_map(lambda t: t[None], p),
                jnp.stack(losses)[None])

    stacked = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (N,) + a.shape), variables)
    p_want, loss_want = jax.jit(shard_map(
        body, mesh=ctx.mesh, in_specs=(P("bf"),) * 3,
        out_specs=(P("bf"), P("bf")), check_vma=False))(
            stacked, jnp.asarray(imgs), jnp.asarray(labels))

    trainer = mnist.build(N, lr, atc, device="cpu")
    state = convert.state_dict_from_flax(variables["params"])
    with torch.no_grad():
        for k, p in trainer.params.items():
            p.copy_(torch.tensor(state[k]))
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels)
    losses = [trainer.step((x[:, i * batch:(i + 1) * batch],
                            y[:, i * batch:(i + 1) * batch]))
              for i in range(steps)]
    _close(torch.stack(losses, 1).numpy(), loss_want, 1e-5, "losses")
    for r in range(N):
        want = convert.state_dict_from_flax(
            jax.tree_util.tree_map(lambda t: np.asarray(t[r]),
                                   p_want["params"]))
        for k, p in trainer.params.items():
            _close(p[r].detach().numpy(), want[k], 1e-5, f"rank {r} {k}")


IMG, CLASSES, FILTERS, BATCH, WD, LABEL_SMOOTHING = 32, 10, 8, 8, 1e-4, 0.1


@pytest.fixture(scope="module")
def imagenet_step():
    """One step of the example's trainer (``--optimizer allreduce``, f32)
    and the JAX example's ``train_step`` on the same first batch, from the
    same weights."""
    args = inet.parse_args([
        "--device", "cpu", "--image-size", str(IMG), "--num-classes",
        str(CLASSES), "--num-filters", str(FILTERS), "--batch-size",
        str(BATCH), "--steps-per-epoch", "1", "--epochs", "1",
        "--warmup-epochs", "0", "--lr", "6.4", "--optimizer", "allreduce",
        "--fp32"])
    train_src, _ = inet.make_sources(args, N)
    x, y = next(iter(DistributedLoader(train_src, BATCH, num_ranks=N,
                                       device_put=False).epoch(0)))
    sched = inet.lr_schedule(args.lr, BATCH, 0, 1, 1)
    trainer = inet.build_trainer(args, N, torch.device("cpu"))
    params, stats = convert.flax_from_state_dict(trainer.model.state_dict())
    inet.set_lr(trainer, sched(0))
    loss = trainer.step((torch.from_numpy(x), torch.from_numpy(y)))
    got = (loss.numpy(),
           {k: v.detach().numpy() for k, v in trainer.params.items()},
           {k: v.numpy() for k, v in trainer.buffers.items()},
           int(trainer.loss_fn.hits))

    with jax.enable_x64(True):
        want = _jax_imagenet_step(params, stats, x, y)
    return got, want


def _jax_imagenet_step(params, stats, x, y):
    """The JAX example's ``train_step`` under ``--optimizer allreduce``, in
    f64."""
    model = JResNet50(num_classes=CLASSES, num_filters=FILTERS,
                      dtype=jnp.float64)
    base = 6.4 * BATCH / 256.0
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, base, 0),
         optax.cosine_decay_schedule(base, 1)], [0])
    ctx = bf.init()
    opt = JAllreduce(optax.chain(optax.add_decayed_weights(WD),
                                 optax.sgd(sched, momentum=0.9,
                                           nesterov=True)),
                     axis_name=ctx.axis_name)

    def train_step(p_blk, bs_blk, x_blk, y_blk):
        p, bs = jax.tree_util.tree_map(lambda t: t[0], (p_blk, bs_blk))
        st = opt.init(p)
        xb, yb = x_blk[0].astype(jnp.float64), y_blk[0]

        def loss_fn(p):
            logits, mut = model.apply({"params": p, "batch_stats": bs}, xb,
                                      train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy(
                logits, optax.smooth_labels(jax.nn.one_hot(yb, CLASSES),
                                            LABEL_SMOOTHING)).mean()
            return loss, (mut["batch_stats"], logits)

        (loss, (new_bs, logits)), g = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        upd, st = opt.update(g, st, p)
        p = optax.apply_updates(p, upd)
        hits = (jnp.argmax(logits, -1) == yb).sum()
        return (jax.tree_util.tree_map(lambda t: t[None], (p, new_bs))
                + (loss[None], hits[None]))

    step = jax.jit(shard_map(
        train_step, mesh=ctx.mesh, in_specs=(P(ctx.axis_name),) * 4,
        out_specs=(P(ctx.axis_name),) * 4, check_vma=False))
    f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.broadcast_to(jnp.asarray(a, jnp.float64)[None],
                                   (N,) + np.shape(a)), t)
    p, bs, loss, hits = step(f64(params), f64(stats), jnp.asarray(x),
                             jnp.asarray(y))
    return jax.tree_util.tree_map(np.asarray, (loss, p, bs, hits))


def test_imagenet_allreduce_step_matches_jax_train_step(imagenet_step):
    (loss, params, stats, hits), (jloss, jparams, jstats, jhits) = \
        imagenet_step
    assert np.isfinite(loss).all()
    _close(loss, jloss, 1e-4, "losses")
    assert hits == int(jhits.sum())
    for r in range(N):
        ref = convert.state_dict_from_flax(
            jax.tree_util.tree_map(lambda t: t[r], jparams),
            jax.tree_util.tree_map(lambda t: t[r], jstats))
        for k, v in params.items():
            _close(v[r], ref[k], 1e-4, f"rank {r} param {k}")
        for k, v in stats.items():
            _close(v[r], ref[k], 1e-4, f"rank {r} stat {k}")
    # the allreduce keeps the ranks' parameters equal, bit for bit
    for k, v in params.items():
        assert (v == v[:1]).all(), k


def test_imagenet_main_on_tfrecord_shards(tmp_path, capsys):
    """The example end to end on the CPU, reading uint8 TFRecord shards:
    both optimizers train with finite losses, evaluate, and say OK.  In f32:
    on the CPU, PyTorch 2.13's bf16 convolution backward at this size (3x3
    over 1x1 maps in the last stage) returned NaN weight gradients in some
    runs of the same inputs, at one torch thread and at several, and f32
    did not.  The card runs the bf16 path."""
    rng = np.random.default_rng(2)
    for split, n in (("train", 32), ("val", 16)):
        write_image_classification_shards(
            str(tmp_path), rng.integers(0, 256, (n, 16, 16, 3),
                                        dtype=np.uint8),
            rng.integers(0, 5, n), shard_size=12, prefix=split)
    for optimizer in ("neighbor", "allreduce"):
        res = inet.main(["--device", "cpu", "--data-dir", str(tmp_path),
                         "--size", "4", "--batch-size", "2",
                         "--num-classes", "5", "--num-filters", "4",
                         "--epochs", "2", "--warmup-epochs", "1",
                         "--optimizer", optimizer, "--fp32"])
        assert capsys.readouterr().out.strip().splitlines()[-1] == "OK"
        assert len(res["losses"]) == 2 * 4
        assert all(np.isfinite(loss).all() for loss in res["losses"])
        for row in res["epochs"]:
            assert 0.0 <= row["val_top1"] <= 1.0
            assert row["loader_wait_ms"] >= 0.0 and row["img_per_s"] > 0
        momentum = res["trainer"].opt.state
        assert momentum and all(
            math.isfinite(float(s["momentum_buffer"].abs().max()))
            for s in momentum.values())


@pytest.mark.parametrize("flag", [["--checkpoint-dir", "x"], ["--resume"]])
def test_imagenet_checkpoint_flags_raise_until_ported(flag):
    with pytest.raises(NotImplementedError, match="checkpoint"):
        inet.main(["--device", "cpu", *flag])


def test_synthetic_benchmark_lenet_on_the_grid():
    """``--model lenet --topology grid``: 28x28x1 images in 10 classes, and
    a grid that is not circulant, which the port's K1 gossips all the same
    (the TPU kernel would not)."""
    res = sb.main(["--device", "cpu", "--model", "lenet", "--topology",
                   "grid", "--batch-size", "4", "--iters", "2",
                   "--warmup", "0", "--fp32"])
    assert all(np.isfinite(loss).all() for loss in res["losses"])
    trainer = sb.build("lenet", topology="grid", size=N, batch_size=2,
                       device="cpu")
    assert tuple(trainer.batch[0].shape) == (N, 2, 28, 28, 1)
    assert int(trainer.batch[1].max()) < 10
    assert not trainer.opt.schedule.is_circulant
    assert k1.resolve_backend("auto", trainer.opt.schedule) == "kernel"

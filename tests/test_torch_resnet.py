"""The port's hand-written ResNet against the JAX package's flax ResNet.

Narrow widths (``num_filters=8``, one block per stage) on 32x32 inputs: the
port runs in f32, with weights carried across by ``bluefog_tpu_torch.convert``
in both directions, and its logits, the gradients of the integer cross
entropy, and the BatchNorm statistics after one train-mode forward must agree
with flax's to rtol 1e-4, with an absolute floor of 1e-4 times the largest
entry of each tensor.

The flax oracle runs in f64 (``jax.enable_x64``; the head stays f32 as the
model declares it).  Flax's own f32 gradients of this model were measured to
stray from its f64 ones by up to 4e-2 of a tensor's scale (the bottleneck
with the conv stem, batch 8 at 64x64), while the port's f32 ones stay within
1e-5 of them; batch 16 keeps the 1x1 stage-4 BatchNorm well conditioned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from bluefog_tpu.models import resnet as jres
from bluefog_tpu_torch import convert
from bluefog_tpu_torch.models import resnet as pres

RTOL = 1e-4
BATCH, IMG, CLASSES, FILTERS = 16, 32, 10, 8
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    """The port's f32 gradients on the CPU depend on torch's thread count,
    which splits its reductions.  Measured with torch 2.13 on the CPU, the
    cifar-stem bottleneck's strayed from its f64 ones by 3.6e-3 to 5.8e-3
    of a tensor's scale with 1, 4 or 6 threads, and by under 1e-5 with 2,
    3, 5, 7 or 8.  A fixed count makes the result the same on every
    machine; two threads also keep the load beside other test workers
    low."""
    prev = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(prev)


def _close(got, want, name=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=RTOL,
        atol=RTOL * max(float(np.abs(want).max()), 1e-30), err_msg=name)


def _models(block, stem):
    """(flax model computing in f64, port model in f32)."""
    jblock = {"basic": jres.ResNetBlock, "bottleneck": jres.BottleneckBlock}
    pblock = {"basic": pres.ResNetBlock, "bottleneck": pres.BottleneckBlock}
    jm = jres.ResNet(stage_sizes=[1, 1, 1, 1], block_cls=jblock[block],
                     num_classes=CLASSES, num_filters=FILTERS,
                     dtype=jnp.float64, stem=stem)
    pm = pres.ResNet(stage_sizes=[1, 1, 1, 1], block_cls=pblock[block],
                     num_classes=CLASSES, num_filters=FILTERS,
                     dtype=torch.float32, stem=stem)
    return jm, pm


def _randomize(pm, rng):
    """Random BatchNorm scales, biases and running statistics on top of
    the port's own init (whose zero-scaled last BN per block would zero the
    gradients of the residual branch), as flax ``(params, batch_stats)``."""
    with torch.no_grad():
        for name, t in list(pm.named_parameters()) + list(
                pm.named_buffers()):
            if t.dim() == 1:
                lo, hi = (-0.2, 0.2) if name.endswith(("bias", "mean")) \
                    else (0.5, 1.5)
                t.copy_(torch.from_numpy(rng.uniform(lo, hi, t.shape)))
    return convert.flax_from_state_dict(pm.state_dict())


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize("block,stem", [
    ("basic", "conv"), ("bottleneck", "conv"), ("basic", "s2d"),
    ("bottleneck", "s2d"), ("bottleneck", "cifar")])
def test_forward_grads_and_bn_stats_match_flax(block, stem):
    jm, pm = _models(block, stem)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, BATCH)
    params, stats = _randomize(pm, rng)
    # the flax variables carried back: both directions of the conversion
    convert.load_flax(pm, params, stats)

    def loss_fn(p):
        logits, mut = jm.apply({"params": p, "batch_stats": stats},
                               jnp.asarray(x, jnp.float64), train=True,
                               mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return loss, (logits, mut["batch_stats"])

    with jax.enable_x64(True):
        (jloss, (jlogits, jstats)), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(_f64(params))
        jloss, jlogits, jstats, jgrads = jax.tree_util.tree_map(
            np.asarray, (jloss, jlogits, jstats, jgrads))

    plogits = pm(torch.from_numpy(x), train=True)
    ploss = F.cross_entropy(plogits, torch.from_numpy(y))
    ploss.backward()
    assert plogits.dtype == torch.float32 and plogits.shape == (BATCH,
                                                                CLASSES)
    _close(plogits.detach().numpy(), jlogits, "logits")
    _close(ploss.item(), jloss, "loss")
    want = convert.state_dict_from_flax(jgrads, jstats)
    for name, p in pm.named_parameters():
        _close(p.grad.numpy(), want[name], f"grad {name}")
    for name, b in pm.named_buffers():
        _close(b.numpy(), want[name], f"stat {name}")


def test_eval_mode_uses_running_statistics():
    jm, pm = _models("basic", "conv")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    params, stats = _randomize(pm, rng)
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(lambda v: jm.apply(
            {"params": _f64(params), "batch_stats": _f64(stats)}, v,
            train=False))(jnp.asarray(x, jnp.float64)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), train=False)
    _close(got.numpy(), want, "eval logits")


def test_full_width_resnet50_has_the_reference_parameter_shapes():
    """Shapes only (no forward): the full-width model of the main path."""
    jm = jres.ResNet50(num_classes=1000)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    want = convert.state_dict_from_flax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes["params"]),
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes["batch_stats"]))
    with torch.device("meta"):  # shapes without drawing 25M weights
        pm = pres.ResNet50(num_classes=1000)
    got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert got == {k: v.shape for k, v in want.items()}
    assert sum(p.numel() for p in pm.parameters()) == 25_557_032
    assert all(p.dtype == torch.float32 for p in pm.parameters())


def test_init_statistics_follow_flax():
    """Weights are drawn as flax draws them (truncated lecun normal, zero
    bias, unit BN scale, zero scale on each block's last BN); values differ
    across frameworks, the distributions do not."""
    pm = pres.ResNet50(num_classes=1000, num_filters=16,
                       generator=torch.Generator().manual_seed(3))
    w = pm.BottleneckBlock_7.Conv_1.weight.detach()  # 64x64x3x3
    fan_in = w[0].numel()
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.02
    assert float(w.abs().max()) <= 2 / 0.87962566103423978 / np.sqrt(
        fan_in) + 1e-6
    assert torch.all(pm.BottleneckBlock_7.BatchNorm_2.weight == 0)
    assert torch.all(pm.BottleneckBlock_7.BatchNorm_1.weight == 1)
    assert torch.all(pm.head.bias == 0)
    same = pres.ResNet50(num_classes=1000, num_filters=16,
                         generator=torch.Generator().manual_seed(3))
    assert torch.equal(same.head.weight, pm.head.weight)


def test_space_to_depth_and_convert_round_trip():
    x = np.random.default_rng(2).standard_normal((2, 8, 6, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        pres.space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jres.space_to_depth(jnp.asarray(x))))
    jm, _ = _models("bottleneck", "s2d")
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = convert.state_dict_from_flax(variables["params"],
                                      variables["batch_stats"])
    params, stats = convert.flax_from_state_dict(sd)
    for a, b in zip(jax.tree_util.tree_leaves_with_path(variables["params"]),
                    jax.tree_util.tree_leaves_with_path(params)):
        assert jax.tree_util.keystr(a[0]) == jax.tree_util.keystr(b[0])
        np.testing.assert_array_equal(np.asarray(a[1]), b[1])
    assert (jax.tree_util.tree_structure(stats)
            == jax.tree_util.tree_structure(
                jax.tree_util.tree_map(np.asarray, variables["batch_stats"])))
    with pytest.raises(ValueError, match="s2d stem"):
        _models("basic", "s2d")[1](torch.zeros(1, 7, 8, 3))


def test_s2d_stem_kernel_from_7x7_matches_reference_and_the_conv_stem():
    """The embedded 4x4 kernel equals the JAX helper's (in flax's layout),
    and the s2d stem with it computes the 7x7/s2 stem's function on the
    same images, f32, to RTOL of the output's scale."""
    conv = pres.ResNet18(num_classes=10, num_filters=8, dtype=torch.float32)
    s2d = pres.ResNet18(num_classes=10, num_filters=8, dtype=torch.float32,
                        stem="s2d")
    w7 = conv.conv_init.weight.detach()
    w4 = pres.s2d_stem_kernel_from_7x7(w7)
    want = jres.s2d_stem_kernel_from_7x7(w7.permute(2, 3, 1, 0).numpy())
    np.testing.assert_array_equal(w4.permute(2, 3, 1, 0).numpy(), want)
    with torch.no_grad():
        s2d.conv_init.weight.copy_(w4)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        a = conv.conv_init(x.permute(0, 3, 1, 2))
        b = s2d.conv_init(pres.space_to_depth(x, 2).permute(0, 3, 1, 2))
    assert a.shape == b.shape == (2, 8, 16, 16)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                               atol=RTOL * float(a.abs().max()))
    with pytest.raises(ValueError):
        pres.s2d_stem_kernel_from_7x7(torch.zeros(8, 3, 5, 5))

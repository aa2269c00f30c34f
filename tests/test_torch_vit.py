"""The port's ViT against the JAX package's.

``ViTConfig.tiny()`` (32x32 images, 8x8 patches: 17 tokens, hidden 64, 4
heads, 2 layers, f32) with flax's initialisation, ``cls``, every LayerNorm
scale and every bias moved off its constant by seeded noise, carried to the
port by ``convert.vit_from_flax``; images and labels from seeded numpy.  The
loss is the synthetic benchmark's softmax cross-entropy.  Tolerances, as max
|diff| over the reference's largest magnitude: the f32 logits and every
parameter's gradient within 1e-5.

At ViT-base's 224/16 the 197 tokens are not a multiple of 128, so neither
package's gate sends the attention to the flash kernel: the test checks both
gates on that shape.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bluefog_tpu.models import vit as jv
from bluefog_tpu_torch import convert
from bluefog_tpu_torch.examples import synthetic_benchmark as sb
from bluefog_tpu_torch.models import vit as pv
from bluefog_tpu_torch.ops import ring_attention as pra

TOL = 1e-5
B = 3


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def flax_vit():
    """The perturbed flax params, the inputs, flax's logits and the
    gradients of the mean cross-entropy."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, B)
    model = jv.ViT(jv.ViTConfig.tiny())
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key in ("bias", "scale", "cls"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, params)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (_, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return params, x, y, np.asarray(logits), grads


def _port(params):
    model = pv.ViT(pv.ViTConfig.tiny())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.vit_from_flax(params).items()},
                          strict=True)
    return model


def test_vit_forward_matches_flax(flax_vit):
    params, x, _, want, _ = flax_vit
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * float(np.abs(want).max()))


def test_vit_gradients_match_flax(flax_vit):
    params, x, y, _, grads = flax_vit
    model = _port(params)
    loss = sb.image_loss(model, (dict(model.named_parameters()), {}),
                         (torch.from_numpy(x), torch.from_numpy(y)))
    loss.backward()
    want = convert.vit_from_flax(grads)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=0,
                                   atol=TOL * float(np.abs(g).max()),
                                   err_msg=k)


def test_vit_convert_round_trip_is_exact(flax_vit):
    params = flax_vit[0]
    back = convert.flax_from_vit(
        {k: torch.from_numpy(v)
         for k, v in convert.vit_from_flax(params).items()})["params"]
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(flat_b[path], np.asarray(a))


def test_vit_base_is_not_flash_eligible():
    """197 tokens at 224/16: the dense path in both packages."""
    jra = importlib.import_module("bluefog_tpu.ops.ring_attention")
    cfg = pv.ViTConfig.base()
    t = cfg.trunk().max_position
    assert t == 197
    q = torch.zeros(1, t, cfg.num_heads, cfg.hidden_size // cfg.num_heads,
                    dtype=torch.bfloat16)
    assert not pra._flash_eligible(q, q, False, 0, 0)
    qj = jnp.zeros(q.shape, jnp.bfloat16)
    assert not jra._flash_eligible(qj, qj, False, 0, 0)


def test_vit_configs_and_benchmark_image_size():
    for name in ("base", "tiny"):
        want, got = getattr(jv.ViTConfig, name)(), getattr(pv.ViTConfig,
                                                           name)()
        for f in ("image_size", "patch_size", "num_classes", "hidden_size",
                  "num_layers", "num_heads", "mlp_ratio"):
            assert getattr(got, f) == getattr(want, f), f
    # remat is ported (test_vit_remat_*): a remat ViT builds
    pv.ViT(dataclasses.replace(pv.ViTConfig.tiny(), remat=True))
    # --image-size rounded down to a multiple of the patch size, the
    # config's classes, as the JAX benchmark
    assert sb.MODELS["vit-tiny"].sized
    net = sb.MODELS["vit-tiny"].make(torch.float32, torch.Generator(), 1000,
                                     64, image_size=35)
    assert net.cfg.image_size == 32 and net.cfg.num_classes == 10
    trainer = sb.build("vit-tiny", "neighbor", size=2, batch_size=2,
                       image_size=35, dtype=torch.float32, device="cpu")
    images, labels = trainer.batch
    assert tuple(images.shape) == (2, 2, 32, 32, 3)
    assert int(labels.max()) < 10
    res = sb.run(trainer, warmup=0, iters=1)
    assert np.isfinite(res["losses"][0]).all()


def _vit_grads(model, x, y):
    loss = sb.image_loss(model, (dict(model.named_parameters()), {}),
                         (torch.from_numpy(x), torch.from_numpy(y)))
    names, params = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


def test_vit_remat_gradients_bit_equal_and_match_flax_remat(flax_vit):
    """Each block under a non-reentrant checkpoint through functional_call:
    gradients bit-equal to no remat, and within TOL of flax's ``remat=True``
    ViT's (nn.remat of each block)."""
    params, x, y, _, _ = flax_vit
    plain = _vit_grads(_port(params), x, y)
    model = pv.ViT(dataclasses.replace(pv.ViTConfig.tiny(), remat=True))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.vit_from_flax(params).items()})
    got = _vit_grads(model, x, y)
    for k, g in plain.items():
        assert torch.equal(got[k], g), k
    jmodel = jv.ViT(dataclasses.replace(jv.ViTConfig.tiny(), remat=True))

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    want = convert.vit_from_flax(jax.jit(jax.grad(loss_fn))(params))
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g, rtol=0,
                                   atol=TOL * float(np.abs(g).max()),
                                   err_msg=k)

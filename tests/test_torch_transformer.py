"""The port's GPT against the JAX package's ``TransformerLM``.

A narrow GPT (vocab 512, hidden 128, 4 heads so that D = 32 keeps K3
eligible, 2 layers, T = 128, batch 2) with the same weights on both sides:
flax's initialisation, its LayerNorm scales and all biases moved off their
constants by seeded noise, carried to the port by ``convert.gpt_from_flax``.
The loss is the synthetic benchmark's: mean softmax cross-entropy of the
logits against the tokens rolled by one.  The JAX model takes its dense
attention on the CPU (the library kernel needs a TPU); the port takes K3,
whose twins run on CPU tensors.

Tolerances, as max |diff| over the reference's largest magnitude: in f32,
logits and every parameter's gradient within 1e-5 (measured: 7e-7 and
1.4e-6).  In bf16 the two frameworks round at other places (XLA rounds each
elementwise op of GELU, JAX adds the embedding gradients in bf16), so both
are held to the f32 oracle: the port's bf16 logits and gradients within 2^-5
of the JAX f32 model's (JAX's own bf16 model is 1.05% and 1.83% from it),
and the port's bf16 logits within 2^-5 of the JAX bf16 model's, its
gradients within 2^-4 (measured: 0.98% and 2.5%, the latter on the token
embedding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bluefog_tpu.models import transformer as jtr
from bluefog_tpu_torch import convert
from bluefog_tpu_torch.examples import synthetic_benchmark as sb
from bluefog_tpu_torch.models import transformer as ptr

VOCAB, HIDDEN, LAYERS, HEADS, MAXPOS, T, BATCH = 512, 128, 2, 4, 256, 128, 2
F32_TOL, BF16_TOL, BF16_GRAD_TOL = 1e-5, 2.0 ** -5, 2.0 ** -4


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    """One torch thread: the same sums on every machine, and no worker
    thread.  With two, the worker's share of the first ``torch.exp`` in a
    process sometimes came out off in the fifth digit on a loaded host,
    which took the f32 logits to 1.98e-5 from flax's, against 7e-7
    otherwise; flax's own logits repeated bit for bit."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_cfg(dtype):
    return jtr.GPTConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                         num_layers=LAYERS, num_heads=HEADS,
                         max_position=MAXPOS, dtype=dtype)


def _port_cfg(dtype):
    return ptr.GPTConfig(vocab_size=VOCAB, hidden_size=HIDDEN,
                         num_layers=LAYERS, num_heads=HEADS,
                         max_position=MAXPOS, dtype=dtype)


def narrow_params(seed=0):
    """flax's initial params of the narrow GPT, with every LayerNorm scale
    and every bias moved by seeded noise (numpy arrays)."""
    model = jtr.TransformerLM(_jax_cfg(jnp.float32))
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, T), jnp.int32))["params"]
    rng = np.random.default_rng(seed + 1)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key in ("bias", "scale"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


def _ids(seed=2):
    return np.random.default_rng(seed).integers(0, VOCAB, (BATCH, T)).astype(
        np.int32)


def _jax_run(params, ids, dtype, offset):
    model = jtr.TransformerLM(_jax_cfg(dtype))
    ids = jnp.asarray(ids)

    def loss_fn(p):
        logits = model.apply({"params": p}, ids, position_offset=offset)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.roll(ids, -1, axis=-1)).mean(), logits

    (_, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return (np.asarray(logits, np.float64),
            convert.gpt_from_flax(jax.tree_util.tree_map(np.asarray, grads)))


def _port_run(params, ids, dtype, offset):
    model = ptr.TransformerLM(_port_cfg(dtype))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           convert.gpt_from_flax({"params": params}).items()})
    ids = torch.from_numpy(ids).long()
    logits = model(ids, position_offset=offset)
    loss = torch.nn.functional.cross_entropy(
        logits.flatten(0, -2), torch.roll(ids, -1, dims=-1).flatten())
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    assert logits.dtype == torch.float32
    return (logits.detach().double().numpy(),
            {n: g.double().numpy() for n, g in zip(names, grads)})


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_close(got, want, tol, grad_tol, what):
    logits, grads = got
    assert _rel_err(logits, want[0]) <= tol, (what, "logits")
    assert set(grads) == set(want[1])
    for name, g in grads.items():
        assert _rel_err(g, want[1][name]) <= grad_tol, (what, name)


@pytest.fixture(scope="module")
def flax_runs():
    """The JAX model's logits and gradients: f32 at position offsets 0 and
    64, bf16 at 0 (computed once: JAX's first eager calls compile)."""
    params, ids = narrow_params(), _ids()
    return params, ids, {
        (dt, off): _jax_run(params, ids, getattr(jnp, dt), off)
        for dt, off in (("float32", 0), ("float32", 64), ("bfloat16", 0))}


@pytest.mark.parametrize("offset", [0, 64], ids=["pos0", "offset64"])
def test_f32_logits_and_gradients_match_flax(flax_runs, offset):
    params, ids, want = flax_runs
    got = _port_run(params, ids, torch.float32, offset)
    _assert_close(got, want["float32", offset], F32_TOL, F32_TOL, "f32")


def test_bf16_logits_and_gradients_match_flax(flax_runs):
    params, ids, want = flax_runs
    got = _port_run(params, ids, torch.bfloat16, 0)
    _assert_close(got, want["float32", 0], BF16_TOL, BF16_TOL,
                  "bf16 vs f32 oracle")
    _assert_close(got, want["bfloat16", 0], BF16_TOL, BF16_GRAD_TOL,
                  "bf16 vs JAX bf16")


def test_convert_round_trip_is_exact():
    params = narrow_params(seed=3)
    state = convert.gpt_from_flax({"params": params})
    assert state["block_0.qkv.weight"].shape == (3 * HIDDEN, HIDDEN)
    assert state["tok.weight"].shape == (VOCAB, HIDDEN)
    model = ptr.TransformerLM(_port_cfg(torch.float32))
    assert set(state) == {n for n, _ in model.named_parameters()}
    back = convert.flax_from_gpt({k: torch.tensor(v)
                                  for k, v in state.items()})["params"]
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], np.asarray(a))
    # the params alone convert as the variables do
    assert convert.gpt_from_flax(params).keys() == state.keys()


def test_configs_and_gpt_small_shapes_match_jax():
    for name in ("small", "large", "tiny"):
        j, p = getattr(jtr.GPTConfig, name)(), getattr(ptr.GPTConfig, name)()
        for f in dataclasses.fields(j):
            jv, pv = getattr(j, f.name), getattr(p, f.name)
            if f.name == "dtype":
                assert jnp.dtype(jv).name == str(pv).split(".")[-1], name
            else:
                assert jv == pv, (name, f.name)
    shapes = jax.eval_shape(jtr.TransformerLM(jtr.GPTConfig.small()).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 128), jnp.int32))
    want = {}  # flax's shapes, named and laid out as the port's
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes["params"]):
        *mods, kind = (p.key for p in path)
        name = ".".join(mods + ["bias" if kind == "bias" else "weight"])
        want[name] = leaf.shape[::-1] if kind == "kernel" else leaf.shape
    with torch.device("meta"):
        model = ptr.TransformerLM(ptr.GPTConfig.small())
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert sum(np.prod(s) for s in got.values()) == 168_614_400
    assert not list(model.buffers())


def test_remat_and_the_benchmark_model():
    # remat checkpoints each block; through the benchmark's functional_call
    # loss the gradients are the ones without it, bit for bit
    ids = torch.from_numpy(_ids()).long()
    grads = []
    for remat in (False, True):
        model = ptr.TransformerLM(dataclasses.replace(
            _port_cfg(torch.float32), remat=remat))
        p = dict(model.named_parameters())
        loss = sb.lm_loss(model, (p, {}), (ids,))
        grads.append(torch.autograd.grad(loss, list(p.values())))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    spec = sb.MODELS["gpt-small"]
    assert spec.tokens and spec.loss is sb.lm_loss
    # the benchmark's loss is the JAX one: targets rolled, not shifted
    model = ptr.TransformerLM(_port_cfg(torch.float32))
    ids = torch.from_numpy(_ids()).long()
    with torch.no_grad():
        logits = model(ids)
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, VOCAB), torch.roll(ids, -1, -1).reshape(-1))
        got = sb.lm_loss(model, (dict(model.named_parameters()), {}), (ids,))
    assert torch.equal(got, want)

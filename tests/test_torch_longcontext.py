"""The port's long-context slice against the JAX package's.

``GPTConfig.remat`` (checkpointed blocks, against the JAX model's
``nn.remat`` and against no remat), ``TransformerLM``'s ``mlp=`` factory,
the sequence-parallel LM step of ``examples/longcontext_lm.py`` (ring,
zigzag ring and Ulysses: loss and gradients against the JAX step under
``shard_map`` on the conftest's CPU mesh), and the port's example on the
CPU.  Weights are the JAX model's own initialisation, carried over by
``convert.gpt_from_flax``.  Width 128 with 4 heads (D = 32; one layer for
the sequence-parallel step) and 4 ranks of 32 tokens (T = 128) put the
attention on K3's route where it is eligible (the Ulysses step; the remat
and mlp cases at T = 128), through its twins on the CPU.  f32: logits and losses within 1e-5, gradients within 5e-5,
absolute.
"""

import functools
import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from bluefog_tpu.models import transformer as jtr
from bluefog_tpu.parallel.api import shard_map
from bluefog_tpu_torch import convert
from bluefog_tpu_torch.examples import longcontext_lm as lc
from bluefog_tpu_torch.models import transformer as ptr
from bluefog_tpu_torch.ops import ring_attention as pra
from bluefog_tpu_torch.parallel.axes import Axis

jra = importlib.import_module("bluefog_tpu.ops.ring_attention")

OUT_TOL, GRAD_TOL = 1e-5, 5e-5
LM = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
          max_position=256)
N, T_LOCAL, BATCH = 4, 32, 2


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jcfg(**kw):
    return jtr.GPTConfig(**dict(LM, **kw), dtype=jnp.float32)


def _pcfg(**kw):
    return ptr.GPTConfig(**dict(LM, **kw), dtype=torch.float32)


def _tokens(t=N * T_LOCAL, seed=1):
    return np.random.default_rng(seed).integers(
        0, LM["vocab_size"], (BATCH, t)).astype(np.int32)


def _grads_np(tree):
    return convert.gpt_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _port(params, **kw):
    model = ptr.TransformerLM(_pcfg(**kw.pop("cfg", {})), **kw)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           convert.gpt_from_flax(params).items()})
    return model


def _lm_loss(logits, ids):
    return torch.nn.functional.cross_entropy(
        logits.flatten(0, -2), torch.roll(ids, -1, -1).flatten())


def test_remat_matches_jax_and_no_remat():
    """remat=True: logits and gradients equal the JAX remat model's, and
    bit-equal the port's model without remat, under ``functional_call``
    with tensors that are not the module's own (the trap the checkpointed
    function avoids)."""
    ids = _tokens()
    jmodel = jtr.TransformerLM(_jcfg(remat=True))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(ids))["params"]

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(ids))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.roll(jnp.asarray(ids), -1, -1)).mean(), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    want = _grads_np(jgrads)
    tids = torch.from_numpy(ids).long()
    got = {}
    for remat in (False, True):
        model = _port(params, cfg={"remat": remat})
        p = {k: v.detach().clone().requires_grad_()
             for k, v in model.named_parameters()}
        with torch.no_grad():          # the module's own weights differ
            for v in model.parameters():
                v.add_(1.0)
        logits = torch.func.functional_call(model, p, (tids,))
        grads = torch.autograd.grad(_lm_loss(logits, tids), list(p.values()))
        got[remat] = (logits.detach(), dict(zip(p, grads)))
    np.testing.assert_allclose(got[True][0].numpy(), np.asarray(jlogits),
                               rtol=0, atol=OUT_TOL)
    for name, g in got[True][1].items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                   atol=GRAD_TOL, err_msg=name)
        assert torch.equal(g, got[False][1][name]), name


class _JaxMlp(fnn.Module):
    hidden: int

    @fnn.compact
    def __call__(self, y):
        return fnn.Dense(self.hidden, name="inner")(jnp.tanh(y))


class _PortMlp(torch.nn.Module):
    def __init__(self, hidden):
        super().__init__()
        self.inner = ptr.Dense(hidden, hidden, torch.float32)

    def forward(self, y):
        return self.inner(torch.tanh(y))


def test_mlp_factory_matches_jax():
    """``mlp=`` swaps every block's MLP for the factory's module,
    registered as ``mlp`` (flax: the name the factory gives it)."""
    ids = _tokens()
    c = LM["hidden_size"]
    jmodel = jtr.TransformerLM(_jcfg(),
                               mlp=lambda: _JaxMlp(c, name="mlp"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(2),
                                  jnp.asarray(ids))["params"]
    want = np.asarray(jax.jit(jmodel.apply)({"params": params},
                                            jnp.asarray(ids)))
    model = _port(params, mlp=lambda: _PortMlp(c))
    names = {n for n, _ in model.named_parameters()}
    assert "block_0.mlp.inner.weight" in names
    assert not any(".up." in n or ".down." in n for n in names)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_TOL)


def _jax_sp_step(attn_kind, params, ids):
    """The JAX example's step body: each rank's loss on its block (zigzag:
    explicit positions and resharded targets), its gradient, pmean over the
    sequence axis."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("sp",))
    model = jtr.TransformerLM(_jcfg(num_layers=1))
    zig = attn_kind == "ring-zigzag"
    if attn_kind == "ulysses":
        attn = functools.partial(jra.all_to_all_attention, axis_name="sp",
                                 causal=True, backend="auto")
    else:
        attn = functools.partial(jra.ring_attention, axis_name="sp",
                                 causal=True,
                                 layout="zigzag" if zig else "contiguous")
    tokens = jnp.asarray(ids)
    targets = jnp.concatenate([tokens[:, 1:], tokens[:, :1]], 1)
    if zig:
        tokens, targets = (jra.zigzag_shard(t, N) for t in (tokens, targets))
    c = T_LOCAL // 2

    def body(params, tok, tgt):
        r = lax.axis_index("sp")

        def loss_fn(p):
            if zig:
                pos = jnp.concatenate([r * c + jnp.arange(c),
                                       (2 * N - 1 - r) * c + jnp.arange(c)])
                logits = model.apply({"params": p}, tok, attn_fn=attn,
                                     positions=pos[None])
                y = tgt
            else:
                logits = model.apply({"params": p}, tok, attn_fn=attn,
                                     position_offset=r * T_LOCAL)
                nxt = lax.ppermute(tok[:, :1], "sp",
                                   [(i, (i - 1) % N) for i in range(N)])
                y = jnp.concatenate([tok[:, 1:], nxt], axis=1)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()

        loss, g = jax.value_and_grad(loss_fn)(params)
        g = jax.tree_util.tree_map(lambda t: lax.pmean(t, "sp"), g)
        return lax.pmean(loss, "sp"), g

    return jax.jit(shard_map(
        body, mesh=mesh, in_specs=(JP(), JP(None, "sp"), JP(None, "sp")),
        out_specs=(JP(), JP()), check_vma=False))(params, tokens, targets)


@pytest.mark.parametrize("attn_kind", lc.ATTNS)
def test_sequence_parallel_lm_step_matches_jax(attn_kind, monkeypatch):
    ids = _tokens()
    params = jax.jit(jtr.TransformerLM(_jcfg(num_layers=1)).init)(
        jax.random.PRNGKey(0), jnp.asarray(ids[:, :T_LOCAL]))["params"]
    loss, grads = _jax_sp_step(attn_kind, params, ids)
    want = _grads_np(grads)
    model = _port(params, cfg={"num_layers": 1})
    axis = Axis("sp", N)
    zig = attn_kind == "ring-zigzag"
    attn = (functools.partial(pra.all_to_all_attention, axis=axis,
                              causal=True, backend="auto")
            if attn_kind == "ulysses" else
            functools.partial(pra.ring_attention, axis=axis, causal=True,
                              layout="zigzag" if zig else "contiguous"))
    calls = []
    real = pra.flash_attention
    monkeypatch.setattr(pra, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or
                        real(*a, **kw))
    toks, tgts, pos = lc.shard_sequence(torch.from_numpy(ids).long(), N, zig)
    logits = model(toks, attn_fn=attn, positions=pos)
    got_loss = torch.nn.functional.cross_entropy(logits.flatten(0, -2),
                                                 tgts.flatten())
    names, leaves = zip(*model.named_parameters())
    got = torch.autograd.grad(got_loss, leaves)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=0,
                               atol=OUT_TOL)
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                   atol=GRAD_TOL, err_msg=name)
    # Ulysses: K3 at the global T, one call a layer for the whole group
    assert calls == ([(N * BATCH, 1, N * T_LOCAL, 32)]
                     if attn_kind == "ulysses" else [])


@pytest.mark.parametrize("attn_kind", lc.ATTNS)
def test_longcontext_example_on_the_cpu(attn_kind, capsys):
    """The example at a few steps (its defaults take 11-22 s here, over the
    tier-1 budget under load): finite, falling losses and its report."""
    res = lc.main(["--device", "cpu", "--attn", attn_kind, "--steps", "6",
                   "--batch", "2"] + (["--remat"] if attn_kind == "ring"
                                      else []))
    losses = res["losses"]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert f"attn={attn_kind}" in out and "tokens/s" in out
    with pytest.raises(SystemExit):
        lc.main(["--device", "cpu", "--period", "100"])
    with pytest.raises(RuntimeError, match="is_available"):
        if not torch.cuda.is_available():
            lc.main(["--steps", "1"])
        else:
            raise RuntimeError("torch.cuda.is_available(): a card is here")

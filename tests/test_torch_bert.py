"""The port's BERT, its hierarchical AdamW step and the fine-tune example
against the JAX package.

The model: ``BertConfig.tiny()`` (vocab 1024, hidden 128, 2 heads, 2
layers) with flax's initialisation, every LayerNorm scale and bias moved off
its constant by seeded noise, carried to the port by
``convert.bert_from_flax``; ids, attention mask and token types from seeded
numpy.  Tolerances, as max |diff| over the reference's largest magnitude:
in f32, the sequence output and the logits within 1e-5 (measured 2.5e-7 to
7.8e-7).  In bf16 both sides round each bf16 matmul once and XLA rounds at
other places in the LayerNorm and GELU: the sequence output within 2^-7
(measured 0.41%); the classifier's logits, an f32 dot product over 128 of
the pooled bf16-rounded features, within
2^-6 of the JAX bf16 model's and of the JAX f32 model's (JAX's own bf16
logits are 0.73-0.85% from its f32 model's at three seeds, the port's
0.59-1.03%).

The optimizer: one step of
``DistributedHierarchicalNeighborAllreduceOptimizer`` over AdamW (lr 5e-4, weight decay 1e-4, the reference example's
``optax.adamw(5e-4)``) at 8 ranks, local size 2 (machines on Ring(4)), ATC
and AWC, flat and two-level, against the JAX optimizer jitted under
``shard_map`` on the 8-device CPU mesh (the two-level form on the
``(machine, local)`` mesh).  optax's ``adamw`` adds ``wd * p`` to the Adam
direction and scales the sum by ``-lr``; torch's ``AdamW`` first
multiplies ``p`` by ``1 - lr * wd``, then subtracts ``lr`` times the Adam
direction, with the bias corrections folded into the step size and the
denominator.  The two round differently, a few f32 ulps of the parameters'
magnitude: held to rtol 1e-6 with an absolute floor of 2e-6 of the largest
magnitude (measured 1.3e-7 to 3.1e-7 of it).
"""

import dataclasses
import importlib.util
import os

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
from bluefog_tpu.models import bert as jb
from bluefog_tpu.parallel.api import shard_map
import bluefog_tpu_torch as pbf
import bluefog_tpu_torch.topology as pt
from bluefog_tpu_torch import convert
from bluefog_tpu_torch import optim as popt
from bluefog_tpu_torch.examples import bert_finetune_hierarchical as bft
from bluefog_tpu_torch.examples import synthetic_benchmark as sb
from bluefog_tpu_torch.models import bert as pb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, LOCAL, LR, WD = 8, 2, 5e-4, 1e-4
F32_TOL, BF16_TOL, BF16_LOGIT_TOL = 1e-5, 2.0 ** -7, 2.0 ** -6


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    """One torch thread: the same sums on every machine, and no
    oversubscription under the tier-1 run's parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _shutdown_port():
    yield
    pbf.shutdown()


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "ref_bert_finetune",
        os.path.join(ROOT, "examples", "bert_finetune_hierarchical.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, b=2, s=64, vocab=1024):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) > 0.25
    mask[:, 0] = True
    typ = rng.integers(0, 2, (b, s)).astype(np.int32)
    return ids, mask, typ


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key in ("bias", "scale"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def flax_bert():
    """The tiny flax BERT (f32 and bf16 configs share the f32 params, with
    token types and a 3-class head), its perturbed params, the inputs and
    the flax outputs of each case."""
    ids, mask, typ = _inputs(0)
    out = {}
    for dt in ("f32", "bf16"):
        cfg = dataclasses.replace(
            jb.BertConfig.tiny(),
            dtype=jnp.float32 if dt == "f32" else jnp.bfloat16)
        for head in (3, None):
            model = jb.BertEncoder(cfg, num_classes=head)
            params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                jnp.asarray(mask), jnp.asarray(typ))["params"]
            params = _perturbed(params, 1)
            for case in ("plain", "mask_types"):
                args = ((jnp.asarray(ids), jnp.asarray(mask),
                         jnp.asarray(typ)) if case == "mask_types"
                        else (jnp.asarray(ids),))
                got = model.apply({"params": params}, *args)
                out[dt, head, case] = (params, np.asarray(
                    jnp.asarray(got, jnp.float32)))
    return ids, mask, typ, out


@pytest.mark.parametrize("case", ["plain", "mask_types"])
@pytest.mark.parametrize("head", [3, None], ids=["cls", "sequence"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bert_forward_matches_flax(flax_bert, dt, head, case):
    ids, mask, typ, out = flax_bert
    params, want = out[dt, head, case]
    cfg = dataclasses.replace(
        pb.BertConfig.tiny(),
        dtype=torch.float32 if dt == "f32" else torch.bfloat16)
    model = pb.BertEncoder(cfg, num_classes=head, token_types=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.bert_from_flax(params).items()},
                          strict=True)
    args = ((torch.from_numpy(ids).long(), torch.from_numpy(mask),
             torch.from_numpy(typ).long()) if case == "mask_types"
            else (torch.from_numpy(ids).long(),))
    with torch.no_grad():
        got = model(*args)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    tol = F32_TOL if dt == "f32" else BF16_TOL if head is None else \
        BF16_LOGIT_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))
    if dt == "bf16" and head is not None:
        oracle = out["f32", head, case][1]
        np.testing.assert_allclose(got.numpy(), oracle, rtol=0,
                                   atol=tol * float(np.abs(oracle).max()))


def test_bert_convert_round_trip_is_exact(flax_bert):
    params = flax_bert[3]["f32", 3, "plain"][0]
    state = convert.bert_from_flax({"params": params})
    back = convert.flax_from_bert(
        {k: torch.from_numpy(v) for k, v in state.items()})["params"]
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert b.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b, np.asarray(a))
    # and every name lands on a parameter of the port's model
    model = pb.BertEncoder(pb.BertConfig.tiny(), num_classes=3,
                           token_types=True)
    assert set(state) == set(dict(model.named_parameters()))


def test_bert_dropout_rate_and_shape():
    """Dropout runs only when not deterministic; its draws are torch's, so
    the test holds its rate and its scaling, not flax's numbers."""
    x = torch.ones(64, 256)
    gen = torch.Generator().manual_seed(3)
    y = pb._dropout(x, 0.1, False, gen)
    assert y.shape == x.shape
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.01
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert pb._dropout(x, 0.1, True, gen) is x
    model = pb.BertEncoder(pb.BertConfig.tiny(), num_classes=2)
    ids = torch.from_numpy(_inputs(1)[0]).long()
    with torch.no_grad():
        a = model(ids, deterministic=False,
                  generator=torch.Generator().manual_seed(0))
        b = model(ids, deterministic=False,
                  generator=torch.Generator().manual_seed(0))
        c = model(ids)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_bert_remat_and_token_types_raise():
    # remat is ported (test_bert_remat_*); token types still need the table
    pb.BertEncoder(dataclasses.replace(pb.BertConfig.tiny(), remat=True))
    model = pb.BertEncoder(pb.BertConfig.tiny())
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="token_types"):
        model(ids, token_type_ids=ids)


def test_configs_match_reference():
    for name in ("large", "base", "tiny"):
        want = getattr(jb.BertConfig, name)()
        got = getattr(pb.BertConfig, name)()
        for f in dataclasses.fields(want):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert bft.CONFIGS["large"]().hidden_size == 1024


def _opt_data(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((N, 4, 3)).astype(np.float32),
              "b": rng.standard_normal((N, 5)).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    return params, grads


def _jax_step(atc, two_level, params, grads):
    ctx = bf.init(local_size=LOCAL, machine_topology=jt.RingGraph(N // LOCAL))
    axis = ((ctx.machine_axis_name, ctx.local_axis_name) if two_level
            else ctx.axis_name)
    mesh = ctx.hier_mesh if two_level else ctx.mesh
    opt = jopt.DistributedHierarchicalNeighborAllreduceOptimizer(
        optax.adamw(LR), machine_topology=ctx.machine_schedule,
        local_size=LOCAL, axis_name=axis, atc=atc)

    def body(p_blk, g_blk):
        p, g = jax.tree_util.tree_map(lambda t: t[0], (p_blk, g_blk))
        upd, _ = opt.update(g, opt.init(p), p)
        return jax.tree_util.tree_map(lambda t: t[None],
                                      optax.apply_updates(p, upd))

    # P(axis) with the axis pair shards the rank axis over both mesh axes
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(axis), P(axis)),
                          out_specs=P(axis), check_vma=False))
    out = f(jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, grads))
    return {k: np.asarray(v) for k, v in out.items()}


OPT_CASES = [(atc, two) for atc in (False, True) for two in (False, True)]


@pytest.mark.parametrize("atc,two_level", OPT_CASES,
                         ids=[f"{'atc' if a else 'awc'}-"
                              f"{'2d' if t else 'flat'}"
                              for a, t in OPT_CASES])
def test_hierarchical_adamw_step_matches_reference(atc, two_level):
    params, grads = _opt_data(30 + 2 * atc + two_level)
    want = _jax_step(atc, two_level, params, grads)
    ps = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = popt.DistributedHierarchicalNeighborAllreduceOptimizer(
        torch.optim.AdamW(list(ps.values()), lr=LR,
                          weight_decay=bft.WEIGHT_DECAY),
        machine_topology=pt.RingGraph(N // LOCAL), local_size=LOCAL,
        atc=atc, two_level=two_level)
    assert opt.two_level == two_level
    for k, p in ps.items():
        p.grad = torch.from_numpy(grads[k])
    opt.step()
    for k, p in ps.items():
        np.testing.assert_allclose(
            p.detach().numpy(), want[k], rtol=1e-6,
            atol=2e-6 * float(np.abs(want[k]).max()), err_msg=k)


def test_make_task_bytes_equal_reference():
    ref = _reference_example()
    for args in ((64, 32, 1024, 4, 0), (40, 16, 30522, 2, 3)):
        want = ref.make_task(*args)
        got = bft.make_task(*args)
        for a, b in zip(want.arrays, got.arrays):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_finetune_example_two_level_equals_one_level():
    """The example on the CPU at the tiny model: with f32 parameters the
    two-level form's step is the one-level form's, bit for bit; the loss
    falls and the ranks stay close."""
    argv = ["--device", "cpu", "--model", "tiny", "--n-per-rank", "16",
            "--epochs", "2", "--seq-len", "32"]
    one = bft.main(argv)
    two = bft.main(argv + ["--two-level-mesh"])
    assert two["two_level"] and not one["two_level"]
    assert one["steps_per_epoch"] == 2
    for k, v in one["trainer"].params.items():
        assert torch.equal(v, two["trainer"].params[k]), k
    assert [e["loss"] for e in one["epochs"]] == \
        [e["loss"] for e in two["epochs"]]
    assert one["epochs"][-1]["loss"] < one["epochs"][0]["loss"]
    assert one["spread"] < 1e-2


def test_synthetic_benchmark_bert_batch_and_loss():
    """``--model bert-*``: ids and binary labels from the seeded generator,
    softmax cross-entropy on the f32 logits (at the tiny config; the
    benchmark's own configs are BERT-base and -large)."""
    spec = sb.MODELS["bert-large"]
    assert spec.tokens and spec.labels == 2 and spec.loss is sb.cls_loss
    model = pb.BertEncoder(pb.BertConfig.tiny(), num_classes=2)
    ids = torch.from_numpy(_inputs(2)[0]).long()
    labels = torch.tensor([0, 1])
    params = dict(model.named_parameters())
    loss = sb.cls_loss(model, (params, {}), (ids, labels))
    logits = model(ids)
    want = torch.nn.functional.cross_entropy(logits, labels)
    assert torch.equal(loss, want) and logits.dtype == torch.float32


def _bert_grads(model, ids, mask, typ, **kw):
    out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                torch.from_numpy(typ).long(), **kw)
    loss = (out.float() ** 2).mean()
    names, params = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


def test_bert_remat_gradients_bit_equal_to_no_remat():
    """Each layer under a non-reentrant checkpoint (through functional_call,
    as GPTConfig.remat): the same gradients bit for bit, deterministic and
    with dropout from an explicit generator (the recomputation draws the
    same masks, and the generator ends where the plain run leaves it)."""
    ids, mask, typ = _inputs(2)
    for kw in ({}, {"deterministic": False}):
        grads, ends = [], []
        for remat in (False, True):
            cfg = dataclasses.replace(pb.BertConfig.tiny(),
                                      dtype=torch.float32, remat=remat)
            model = pb.BertEncoder(cfg, num_classes=3, token_types=True)
            gen = torch.Generator().manual_seed(5)
            extra = dict(kw, generator=gen) if kw else {}
            grads.append(_bert_grads(model, ids, mask, typ, **extra))
            ends.append(gen.get_state())
        for k, g in grads[0].items():
            assert torch.equal(g, grads[1][k]), k
        assert torch.equal(ends[0], ends[1])


def test_bert_remat_gradients_match_flax_remat(flax_bert):
    """The port's remat BERT against flax's ``remat=True`` BERT (nn.remat of
    each layer): the gradients of the same loss, f32, within F32_TOL of
    each gradient's scale."""
    ids, mask, typ, out = flax_bert
    params = out["f32", 3, "mask_types"][0]
    cfg = dataclasses.replace(jb.BertConfig.tiny(), dtype=jnp.float32,
                              remat=True)
    jmodel = jb.BertEncoder(cfg, num_classes=3)

    def loss_fn(p):
        y = jmodel.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                         jnp.asarray(typ))
        return jnp.mean(jnp.asarray(y, jnp.float32) ** 2)

    want = convert.bert_from_flax(jax.jit(jax.grad(loss_fn))(params))
    model = pb.BertEncoder(dataclasses.replace(
        pb.BertConfig.tiny(), dtype=torch.float32, remat=True),
        num_classes=3, token_types=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.bert_from_flax(params).items()})
    got = _bert_grads(model, ids, mask, typ)
    assert set(got) == set(want)
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g, rtol=0,
                                   atol=F32_TOL * max(float(np.abs(g).max()),
                                                      1e-30), err_msg=k)

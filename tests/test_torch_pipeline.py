"""The port's pipeline parallelism against the JAX package's.

``pipeline_apply``, the 1F1B and GPipe training steps (loss, stage
gradients, head gradients and input gradients) and the dryrun's hybrid dp x
pp x tp step, on the reference tests' shapes and seeded numpy inputs: the
JAX functions under ``shard_map`` on the conftest's CPU mesh, the port's
over virtual stages (the stage axis leading).  f32; outputs within 1e-5 and
gradients within 1e-4 (the reference tests' pipeline tolerance), absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as JP

from bluefog_tpu.ops import collectives as jcoll
from bluefog_tpu.parallel import pipeline as jpp
from bluefog_tpu.parallel import tensor as jtp
from bluefog_tpu.parallel.api import shard_map
from bluefog_tpu.topology import RingGraph as JRing
from bluefog_tpu.topology.schedule import build_schedule as jbuild
from bluefog_tpu_torch import convert
from bluefog_tpu_torch.ops import collectives as pcoll
from bluefog_tpu_torch.parallel import pipeline as ppp
from bluefog_tpu_torch.parallel import tensor as ptp
from bluefog_tpu_torch.parallel.axes import Axis
from bluefog_tpu_torch.topology import RingGraph

D, L, PP, MICRO, MB = 16, 8, 4, 6, 4
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
AXIS = Axis("pp", PP, 0)


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _layers(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(
                np.float32),
            "b": (0.01 * rng.standard_normal((L, D))).astype(np.float32)}


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jstage(sp, x):
    def body(x, wb):
        return jnp.tanh(x @ wb[0] + wb[1]), None
    return lax.scan(body, x, (sp["w"], sp["b"]))[0]


def _pstage(sp, x):
    # sp: (R, L/S, ...) stage rows; x: (R, MB, D)
    for i in range(sp["w"].shape[1]):
        x = torch.tanh(x @ sp["w"][:, i] + sp["b"][:, i, None])
    return x


def _jsq(head, y, t):
    return jnp.sum((y - t) ** 2)


def _psq(head, y, t):
    return torch.sum((y - t) ** 2)


def _jmesh():
    return jtp.make_hybrid_mesh({"pp": PP}, devices=jax.devices()[:PP])


def _pstaged(layers):
    return {k: torch.from_numpy(v) for k, v in
            ppp.stack_stage_params(layers, PP).items()}


def test_stack_stage_params_and_specs_match_jax():
    layers = _layers(0)
    staged = ppp.stack_stage_params(
        {k: torch.from_numpy(v) for k, v in layers.items()}, PP)
    want = jpp.stack_stage_params(layers, PP)
    for k in layers:
        np.testing.assert_array_equal(staged[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError):
        ppp.stack_stage_params({"w": torch.zeros(L, D)}, 3)
    assert ppp.pipeline_spmd_axis_perm(PP) == jpp.pipeline_spmd_axis_perm(PP)
    from bluefog_tpu.sharding.rules import RuleTable as JTable
    from bluefog_tpu_torch.sharding.rules import RuleTable

    rules = [("w$", ("tp",)), (".*", ())]
    got = ppp.stage_param_specs(RuleTable(rules), staged)
    jwant = jpp.stage_param_specs(JTable([(p, jax.sharding.PartitionSpec(*s))
                                          for p, s in rules]), want)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in jwant.items()}


def test_pipeline_apply_matches_jax():
    layers = _layers(0)
    xs = _normal(1, (MICRO, MB, D))

    def body(staged, xs):
        sp = jax.tree_util.tree_map(lambda t: t[0], staged)
        out = jpp.pipeline_apply(_jstage, sp, xs, pp_axis="pp",
                                 num_stages=PP)
        last = lax.axis_index("pp") == PP - 1
        return lax.psum(jnp.where(last, out, 0.0), "pp")

    want = np.asarray(jax.jit(shard_map(
        body, mesh=_jmesh(), in_specs=(JP("pp"), JP()), out_specs=JP(),
        check_vma=False))(jpp.stack_stage_params(layers, PP), xs))
    got = ppp.pipeline_apply(_pstage, _pstaged(layers),
                             torch.from_numpy(xs), axis=AXIS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_TOL)
    with pytest.raises(ValueError, match="lead"):
        ppp.pipeline_apply(_pstage, _pstaged(layers), torch.from_numpy(xs),
                           axis=Axis("pp", PP, 1))


def _jax_step(schedule, layers, xs, tgt, *, head=None, loss=_jsq, **kw):
    step = (jpp.pipeline_train_step_1f1b if schedule == "1f1b"
            else jpp.pipeline_train_step_gpipe)

    def body(staged, xs):
        sp = jax.tree_util.tree_map(lambda t: t[0], staged)
        lsum, g, gh, dxs = step(_jstage, sp, xs, tgt, loss, pp_axis="pp",
                                num_stages=PP, head_params=head, **kw)
        first = lax.axis_index("pp") == 0
        out = (lax.psum(lsum, "pp"),
               jax.tree_util.tree_map(lambda t: t[None], g),
               jax.tree_util.tree_map(lambda t: lax.psum(t, "pp"), gh))
        if dxs is not None:
            out += (lax.psum(jnp.where(first, dxs, 0.0), "pp"),)
        return out

    n_out = 4 if kw.get("collect_input_grads") else 3
    res = jax.jit(shard_map(
        body, mesh=_jmesh(), in_specs=(JP("pp"), JP()),
        out_specs=(JP(), JP("pp"), JP(), JP())[:n_out], check_vma=False))(
            jpp.stack_stage_params(layers, PP), xs)
    return jax.tree_util.tree_map(np.asarray, res)


def _port_step(schedule, layers, xs, tgt, *, head=None, loss=_psq, **kw):
    step = (ppp.pipeline_train_step_1f1b if schedule == "1f1b"
            else ppp.pipeline_train_step_gpipe)
    head = None if head is None else {k: torch.from_numpy(v)
                                      for k, v in head.items()}
    return step(_pstage, _pstaged(layers), torch.from_numpy(xs),
                torch.from_numpy(tgt), loss, axis=AXIS, head_params=head,
                **kw)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe", "gpipe_remat"])
def test_train_step_matches_jax(schedule):
    layers = _layers(0)
    xs, tgt = _normal(1, (MICRO, MB, D)), _normal(2, (MICRO, MB, D))
    kw = {"remat": True} if schedule == "gpipe_remat" else {}
    sched = "1f1b" if schedule == "1f1b" else "gpipe"
    want = _jax_step(sched, layers, xs, tgt, **kw)
    loss, g, _, dxs = _port_step(sched, layers, xs, tgt, **kw)
    assert dxs is None
    np.testing.assert_allclose(loss.numpy(), want[0], rtol=1e-5)
    for k in layers:
        np.testing.assert_allclose(g[k].numpy(), want[1][k], rtol=0,
                                   atol=GRAD_TOL, err_msg=k)


def test_1f1b_and_gpipe_agree_with_jax_on_input_grads():
    """M = 7, not a multiple of S: the uneven drain; loss, stage and input
    gradients of both schedules against the JAX package's."""
    m = 7
    layers = _layers(3)
    xs, tgt = _normal(4, (m, MB, D)), _normal(5, (m, MB, D))
    for sched in ("1f1b", "gpipe"):
        want = _jax_step(sched, layers, xs, tgt, collect_input_grads=True)
        loss, g, _, dxs = _port_step(sched, layers, xs, tgt,
                                     collect_input_grads=True)
        np.testing.assert_allclose(loss.numpy(), want[0], rtol=1e-5)
        for k in layers:
            np.testing.assert_allclose(g[k].numpy(), want[1][k], rtol=0,
                                       atol=GRAD_TOL, err_msg=(sched, k))
        np.testing.assert_allclose(dxs.numpy(), want[3], rtol=0,
                                   atol=GRAD_TOL, err_msg=sched)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_embed_and_head_stages_match_jax(schedule):
    """Tokens embedded before injection (input grads chained into the
    embedding's backward) and a projection head inside loss_fn."""
    v, m = 11, 6
    layers = _layers(6)
    emb = (_normal(7, (v, D)) / np.sqrt(D)).astype(np.float32)
    head = {"w": (_normal(8, (D, v)) / np.sqrt(D)).astype(np.float32)}
    rng = np.random.default_rng(9)
    toks, tgt = rng.integers(0, v, (m, MB)), rng.integers(0, v, (m, MB))

    def jhead(hp, y, t):
        logp = jax.nn.log_softmax(y @ hp["w"])
        return -jnp.sum(jnp.take_along_axis(logp, t[..., None], -1))

    def phead(hp, y, t):
        logp = torch.log_softmax(y @ hp["w"], -1)
        return -logp.gather(-1, t[..., None]).sum()

    xs = emb[toks]
    want = _jax_step(schedule, layers, xs, tgt, head=head, loss=jhead,
                     collect_input_grads=True)
    loss, g, gh, dxs = _port_step(schedule, layers, xs, tgt, head=head,
                                  loss=phead, collect_input_grads=True)
    np.testing.assert_allclose(loss.numpy(), want[0], rtol=1e-5)
    for k in layers:
        np.testing.assert_allclose(g[k].numpy(), want[1][k], rtol=0,
                                   atol=GRAD_TOL, err_msg=k)
    np.testing.assert_allclose(gh["w"].numpy(), want[2]["w"], rtol=0,
                               atol=GRAD_TOL)
    # the embedding's gradient: the input cotangents scattered onto its rows
    ge = torch.zeros(v, D).index_add_(0, torch.from_numpy(toks).flatten(),
                                      dxs.reshape(-1, D))
    ge_want = np.zeros((v, D), np.float32)
    np.add.at(ge_want, toks.flatten(), want[3].reshape(-1, D))
    np.testing.assert_allclose(ge.numpy(), ge_want, rtol=0, atol=GRAD_TOL)


def test_hybrid_dp_pp_tp_step_matches_the_dryrun():
    """``__graft_entry__.dryrun_multichip``'s hybrid step: dp 2 x pp 2 x tp
    2, column and row parallel layers inside each GPipe stage, the masked
    last-stage loss / tp, SGD, and the shards gossiped over dp (K1's twin);
    the port's new parameters against the JAX step's."""
    dp, pp, tp, n_l, d, h, micro, mb = 2, 2, 2, 4, 16, 32, 4, 2
    rng = np.random.default_rng(0)
    w1 = (rng.standard_normal((n_l, d, h)) / np.sqrt(d)).astype(np.float32)
    w2 = (rng.standard_normal((n_l, h, d)) / np.sqrt(h)).astype(np.float32)
    xs = rng.standard_normal((dp, micro, mb, d)).astype(np.float32)
    tgt = rng.standard_normal((micro, mb, d)).astype(np.float32)
    jmesh = jtp.make_hybrid_mesh({"bf": dp, "pp": pp, "tp": tp},
                                 devices=jax.devices())
    sched = jbuild(JRing(dp))

    def step(w1l, w2l, xs_blk):
        w1l, w2l, x = w1l[0], w2l[0], xs_blk[0]

        def stage_fn(sp, x):
            def layer(x, w):
                hh = jnp.maximum(jtp.column_parallel_dense(x, w[0]), 0)
                return jnp.tanh(jtp.row_parallel_dense(hh, w[1])), None
            return lax.scan(layer, x, sp)[0]

        def loss_fn(sp):
            out = jpp.pipeline_apply(stage_fn, sp, x, pp_axis="pp",
                                     num_stages=pp)
            last = lax.axis_index("pp") == pp - 1
            return jnp.sum(jnp.where(last, (out - tgt) ** 2, 0.0)) / (
                tgt.size * tp)

        g1, g2 = jax.grad(loss_fn)((w1l, w2l))
        n1, n2 = w1l - 0.1 * g1, w2l - 0.1 * g2
        n1 = jcoll.neighbor_allreduce(n1, sched, "bf")
        n2 = jcoll.neighbor_allreduce(n2, sched, "bf")
        return n1[None, None], n2[None, None]

    want = jax.tree_util.tree_map(np.asarray, jax.jit(shard_map(
        step, mesh=jmesh,
        in_specs=(JP("pp", None, None, "tp"), JP("pp", None, "tp", None),
                  JP("bf")),
        out_specs=(JP("bf", "pp", None, None, "tp"),
                   JP("bf", "pp", None, "tp", None)), check_vma=False))(
        jpp.stack_stage_params(w1, pp), jpp.stack_stage_params(w2, pp), xs))

    # the port: one (pp, tp) group a dp rank, parameters (dp, pp, tp, L/S,
    # local), the stage axis leading within a dp rank's slice
    pmesh = ptp.make_hybrid_mesh({"bf": dp, "pp": pp, "tp": tp},
                                 ranks=range(8))
    cut = lambda a, s: torch.from_numpy(  # noqa: E731
        convert.shard_from_global(a, s, pmesh))
    # each device's stage block is (1, L/S, ...), as in the dryrun's body
    pw1 = cut(jpp.stack_stage_params(w1, pp), ("pp", None, None, "tp"))[
        :, :, :, 0]
    pw2 = cut(jpp.stack_stage_params(w2, pp), ("pp", None, "tp", None))[
        :, :, :, 0]
    tp_axis, pp_axis = Axis("tp", tp, 1), Axis("pp", pp, 0)

    def stage_fn(sp, x):
        for i in range(sp[0].shape[2]):
            hh = torch.relu(ptp.column_parallel_dense(x, sp[0][:, :, i],
                                                      axis=tp_axis))
            x = torch.tanh(ptp.row_parallel_dense(hh, sp[1][:, :, i],
                                                  axis=tp_axis))
        return x

    new1, new2 = torch.empty_like(pw1), torch.empty_like(pw2)
    for r in range(dp):
        sp = (pw1[r].requires_grad_(), pw2[r].requires_grad_())
        x = torch.from_numpy(xs[r])[:, None].expand(micro, tp, mb, d)
        out = ppp.pipeline_apply(stage_fn, sp, x, axis=pp_axis)
        # the last stage's masked loss on every tp rank, / tp
        loss = ((out - torch.from_numpy(tgt)[:, None]) ** 2).sum() / (
            tgt.size * tp)
        g1, g2 = torch.autograd.grad(loss, sp)
        new1[r], new2[r] = (sp[0] - 0.1 * g1).detach(), (
            sp[1] - 0.1 * g2).detach()
    mixed = pcoll.neighbor_allreduce([new1, new2], RingGraph(dp),
                                     backend="kernel")
    for got, w, spec in zip(mixed, want, (("bf", "pp", None, None, "tp"),
                                          ("bf", "pp", None, "tp", None))):
        np.testing.assert_allclose(
            got.numpy(), convert.shard_from_global(w, spec, pmesh).reshape(
                got.shape), rtol=0, atol=OUT_TOL)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_pipelined_tp_blocks_take_k3_and_match_the_tp_model(schedule,
                                                             monkeypatch):
    """pp 2 x tp 2 over TPBlocks (D = 32, T = 128: K3's route, its twins
    here): tokens embedded before injection, the head in the loss; the
    corrected gradients equal the unpipelined tensor-parallel model's (held
    against the JAX package in test_torch_tensor_parallel.py)."""
    from torch.func import functional_call

    from bluefog_tpu_torch.models.transformer import GPTConfig
    from bluefog_tpu_torch.ops import ring_attention as pra

    cfg = GPTConfig(vocab_size=64, hidden_size=128, num_layers=4,
                    num_heads=4, max_position=128, dtype=torch.float32)
    pp, tp, micro, t = 2, 2, 2, 128
    n_l = cfg.num_layers // pp
    mesh = ptp.make_hybrid_mesh({"tp": tp}, ranks=range(tp))
    model = ptp.TPTransformerLM(cfg, mesh)
    params = dict(model.named_parameters())
    suffixes = [k[len("block_0."):] for k in params
                if k.startswith("block_0.")]
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (micro, t)))
    tp_in_stage, tp_axis = Axis("tp", tp, 1), Axis("tp", tp, 0)
    calls = []
    real = pra.flash_attention
    monkeypatch.setattr(pra, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    attn = lambda q, k, v: pra.local_attention(  # noqa: E731
        q, k, v, causal=True, backend="auto")

    def stage_fn(sp, x):
        for i in range(n_l):
            x = functional_call(model.block_0,
                                {s: v[:, :, i] for s, v in sp.items()},
                                (x, attn), {"axis": tp_in_stage})
        return x

    def head_loss(head, y, tgt):
        z = torch.nn.functional.layer_norm(y, y.shape[-1:], eps=1e-6)
        z = z * head["scale"][:, None, None] + head["bias"][:, None, None]
        logits = torch.matmul(z.flatten(1, 2), head["kernel"])
        return torch.nn.functional.cross_entropy(
            logits.flatten(0, 1), tgt.flatten().repeat(tp),
            reduction="sum") / ids.numel()

    sp = {s: torch.stack([torch.stack(
        [params[f"block_{st * n_l + i}.{s}"] for i in range(n_l)], dim=1)
        for st in range(pp)]) for s in suffixes}
    tok = params["tok.embedding"].detach().requires_grad_()
    pos = params["pos.embedding"].detach().requires_grad_()
    x = tok[torch.arange(tp)[:, None, None], ids] + pos[:, None]
    xs = x.unflatten(1, (micro, 1)).transpose(0, 1)
    tgt = torch.roll(ids, -1, -1).unflatten(0, (micro, 1))
    step = (ppp.pipeline_train_step_1f1b if schedule == "1f1b"
            else ppp.pipeline_train_step_gpipe)
    _, sg, hg, dxs = step(stage_fn, sp, xs.detach(), tgt, head_loss,
                          axis=Axis("pp", pp, 0),
                          head_params={"scale": params["ln_f.scale"],
                                       "bias": params["ln_f.bias"],
                                       "kernel": params["lm_head.kernel"]},
                          collect_input_grads=True)
    torch.autograd.backward(xs, dxs)
    raw = {"tok.embedding": tok.grad, "pos.embedding": pos.grad,
           "ln_f.scale": hg["scale"], "ln_f.bias": hg["bias"],
           "lm_head.kernel": hg["kernel"]}
    for st in range(pp):
        for i in range(n_l):
            for s in suffixes:
                raw[f"block_{st * n_l + i}.{s}"] = sg[s][st, :, i]
    got = ptp.tp_correct_grads(raw, model, tp_axis)
    assert calls, "the pipelined TPBlocks took no K3 call"

    def losses(p, i):
        logits = functional_call(model, p, (i,))
        ce = torch.nn.functional.cross_entropy(
            logits.flatten(0, -2),
            torch.roll(i, -1, -1).expand(logits.shape[:-1]).flatten(),
            reduction="none")
        return ce.view(tp, -1).mean(-1)

    _, want = ptp.tp_value_and_grad(losses, model, tp_axis)(params, ids)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   rtol=0, atol=GRAD_TOL, err_msg=name)

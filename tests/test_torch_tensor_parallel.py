"""The port's tensor parallelism against the JAX package's.

The JAX functions and models run under ``shard_map`` on the conftest's CPU
mesh; the port's over virtual ranks, each parameter stacked over the mesh
(``parallel/tensor.py``).  The tensor-parallel GPT's weights are the JAX
model's own initialisation, gathered and cut into the port's shards by
``convert.tp_from_flax``.  Its width (128, 4 heads: D = 32) and T = 128 put
the port's attention on K3's route, through its twins on the CPU, where the
JAX package's CPU run takes its dense path.  f32, with the reference tests'
tolerances: outputs within 1e-5 and gradients within 5e-5, absolute.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from bluefog_tpu.models.transformer import GPTConfig as JConfig
from bluefog_tpu.ops import collectives as jcoll
from bluefog_tpu.parallel import tensor as jt
from bluefog_tpu.parallel.api import shard_map
from bluefog_tpu.topology import RingGraph as JRing
from bluefog_tpu.topology.schedule import build_schedule as jbuild
from bluefog_tpu_torch import convert
from bluefog_tpu_torch.models.transformer import GPTConfig, TransformerLM
from bluefog_tpu_torch.ops import collectives as pcoll
from bluefog_tpu_torch.ops import ring_attention as pra
from bluefog_tpu_torch.parallel import tensor as pt
from bluefog_tpu_torch.topology import RingGraph

OUT_TOL, GRAD_TOL = 1e-5, 5e-5
LM = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
          max_position=256)
T, BATCH, TP = 128, 2, 2


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jcfg():
    return JConfig(**LM, dtype=jnp.float32)


def _pcfg():
    return GPTConfig(**LM, dtype=torch.float32)


def _tokens():
    return np.random.default_rng(7).integers(0, LM["vocab_size"],
                                             (BATCH, T)).astype(np.int32)


def _ce(logits, tokens):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.roll(tokens, -1, axis=1)).mean()


@pytest.fixture(scope="module")
def jax_tp():
    """The JAX tp=2 GPT: its gathered parameters, each rank's loss, the
    corrected gradients gathered, and each rank's raw gradients."""
    model = jt.TPTransformerLM(_jcfg(), tp_size=TP)
    mesh = jt.make_hybrid_mesh({"tp": TP}, devices=jax.devices()[:TP])
    tokens = jnp.asarray(_tokens())

    def body(tokens):
        boxed = model.init(jax.random.PRNGKey(0), tokens)["params"]
        plain = jt.unbox_params(boxed)

        def loss_fn(p):
            return _ce(model.apply({"params": p}, tokens), tokens)

        loss, grads = jt.tp_value_and_grad(loss_fn, boxed, "tp")(boxed)
        raw = jax.grad(loss_fn)(plain)
        return (loss[None], jt.gather_tp_params(boxed, "tp"),
                jt.gather_tp_params(grads, "tp", template=boxed),
                jax.tree_util.tree_map(lambda g: g[None], raw),
                model.apply({"params": plain}, tokens)[None])

    out = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(JP(),),
        out_specs=(JP("tp"), JP(), JP(), JP("tp"), JP("tp")),
        check_vma=False))(tokens)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_model(params):
    mesh = pt.make_hybrid_mesh({"tp": TP}, ranks=range(TP))
    model = pt.TPTransformerLM(_pcfg(), mesh)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.tp_from_flax(params, mesh,
                                                pt.tp_param_rules()).items()})
    return model, mesh


def _port_losses(model, params, ids, axis=None):
    logits = torch.func.functional_call(model, params, (ids,),
                                        {"axis": axis})
    tgt = torch.roll(ids, -1, -1).expand(logits.shape[:-1])
    ce = torch.nn.functional.cross_entropy(
        logits.flatten(0, -2), tgt.flatten(), reduction="none")
    return ce.view(logits.shape[0], -1).mean(-1)


def _flat(tree):
    return {"/".join(k.key for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_make_hybrid_mesh_shapes(devices8):
    jm = jt.make_hybrid_mesh({"bf": 4, "tp": 2}, devices=devices8)
    pm = pt.make_hybrid_mesh({"bf": 4, "tp": 2}, ranks=range(8))
    assert pm.axis_names == jm.axis_names and pm.shape == jm.devices.shape
    np.testing.assert_array_equal(
        pm.ranks, np.vectorize(lambda d: d.id)(jm.devices))
    assert pm.axis("tp") == pt.ax.Axis("tp", 2, 1)
    with pytest.raises(ValueError):
        pt.make_hybrid_mesh({"bf": 16}, ranks=range(8))


@pytest.mark.parametrize("gather", [False, True], ids=["pair", "gather"])
def test_column_and_row_parallel_dense_match_jax(gather):
    tp = 4
    mesh = jt.make_hybrid_mesh({"tp": tp}, devices=jax.devices()[:tp])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    w1 = rng.standard_normal((16, 24)).astype(np.float32)
    w2 = rng.standard_normal((24, 16)).astype(np.float32)
    b1 = rng.standard_normal(24).astype(np.float32)

    def body(w1l, w2l, b1l):
        h = jt.column_parallel_dense(x, w1l, b1l, tp_axis="tp",
                                     gather_output=gather)
        if gather:
            return h
        return jt.row_parallel_dense(jnp.maximum(h, 0), w2l, tp_axis="tp")

    want = np.asarray(jax.jit(shard_map(
        body, mesh=mesh, in_specs=(JP(None, "tp"), JP("tp", None), JP("tp")),
        out_specs=JP(), check_vma=False))(w1, w2, b1))
    pm = pt.make_hybrid_mesh({"tp": tp}, ranks=range(tp))
    axis = pm.axis("tp")
    cut = lambda a, s: torch.from_numpy(  # noqa: E731
        convert.shard_from_global(a, s, pm))
    xs = torch.from_numpy(x).expand(tp, *x.shape)
    h = pt.column_parallel_dense(xs, cut(w1, (None, "tp")), cut(b1, ("tp",)),
                                 axis=axis, gather_output=gather)
    got = h if gather else pt.row_parallel_dense(
        torch.relu(h), cut(w2, ("tp", None)), axis=axis)
    for r in range(tp):   # every rank holds the replicated result
        np.testing.assert_allclose(got[r].numpy(), want, rtol=0,
                                   atol=OUT_TOL)


def jra_local(q, k, v):
    return importlib.import_module(
        "bluefog_tpu.ops.ring_attention").local_attention(q, k, v,
                                                          causal=True)


def test_tp_block_matches_jax():
    cfg = _jcfg()
    block = jt.TPBlock(cfg, TP)
    mesh = jt.make_hybrid_mesh({"tp": TP}, devices=jax.devices()[:TP])
    x = np.random.default_rng(1).standard_normal(
        (BATCH, T, cfg.hidden_size)).astype(np.float32)
    attn = jra_local

    def body(x):
        boxed = block.init(jax.random.PRNGKey(3), x, attn)["params"]
        return (jt.gather_tp_params(boxed, "tp"),
                block.apply({"params": jt.unbox_params(boxed)}, x, attn))

    params, want = jax.tree_util.tree_map(np.asarray, jax.jit(shard_map(
        body, mesh=mesh, in_specs=(JP(),), out_specs=(JP(), JP()),
        check_vma=False))(x))
    pm = pt.make_hybrid_mesh({"tp": TP}, ranks=range(TP))
    pblock = pt.TPBlock(_pcfg(), pm)
    pblock.load_state_dict({k: torch.from_numpy(v) for k, v in
                            convert.tp_from_flax(params, pm,
                                                 pt.tp_param_rules()).items()})
    calls = []
    real = pra.flash_attention

    def k3(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    pra.flash_attention, saved = k3, pra.flash_attention
    try:
        got = pblock(torch.from_numpy(x).expand(TP, *x.shape),
                     lambda q, k, v: pra.local_attention(
                         q, k, v, causal=True, backend="auto"))
    finally:
        pra.flash_attention = saved
    # one K3 call for the whole group: the tp ranks fold into its batch
    assert calls == [(TP * BATCH, cfg.num_heads // TP, T,
                      cfg.hidden_size // cfg.num_heads)]
    for r in range(TP):
        np.testing.assert_allclose(got[r].detach().numpy(), want, rtol=0,
                                   atol=OUT_TOL)


@pytest.mark.parametrize("rules", [False, True], ids=["boxes", "rule_table"])
def test_tp_value_and_grad_matches_jax(jax_tp, rules):
    loss, params, grads, _, _ = jax_tp
    model, mesh = _port_model(params)
    axis = mesh.axis("tp")
    ids = torch.from_numpy(_tokens()).long()
    p = dict(model.named_parameters())
    got_loss, got = pt.tp_value_and_grad(
        lambda p, i: _port_losses(model, p, i), model, axis,
        rule_table=pt.tp_param_rules() if rules else None)(p, ids)
    np.testing.assert_allclose(got_loss.numpy(), loss, rtol=2e-5)
    gathered = pt.gather_tp_params(got, model, axis)
    want = _flat(grads)
    assert set(want) == {k.replace(".", "/") for k in gathered}
    for name, g in gathered.items():
        for r in range(TP):
            np.testing.assert_allclose(
                g[r].numpy(), want[name.replace(".", "/")], rtol=0,
                atol=GRAD_TOL, err_msg=name)


def test_raw_gradient_convention_is_the_reference_shard_map_one(jax_tp):
    """Pins the convention: the port's raw gradients (autograd of the sum of
    the ranks' losses) are, rank by rank, JAX's raw gradients inside
    shard_map: a sharded leaf tp x its true shard, a replicated leaf its own
    shard's path only."""
    _, params, _, raw, _ = jax_tp
    model, mesh = _port_model(params)
    ids = torch.from_numpy(_tokens()).long()
    p = dict(model.named_parameters())
    got = torch.autograd.grad(_port_losses(model, p, ids).sum(),
                              list(p.values()))
    want = _flat(raw)
    for (name, _), g in zip(p.items(), got):
        w = want[name.replace(".", "/")]
        np.testing.assert_allclose(g.numpy(), w.reshape(g.shape), rtol=0,
                                   atol=GRAD_TOL, err_msg=name)
    emb = got[list(p).index("tok.embedding")]
    assert not torch.allclose(emb[0], emb[1], atol=1e-4)   # not yet meaned


def test_gather_and_tp1_replay_through_the_dense_transformer(jax_tp):
    """The gathered tp=2 parameters equal the JAX package's gathered ones,
    and replayed at tp = 1 through the port's dense TransformerLM they give
    the tp=2 model's logits."""
    _, params, _, _, logits = jax_tp
    model, mesh = _port_model(params)
    axis = mesh.axis("tp")
    gathered = pt.gather_tp_params(pt.unbox_params(model), model, axis)
    flat = _flat(params)
    for name, g in gathered.items():
        np.testing.assert_array_equal(g[1].numpy(),
                                      flat[name.replace(".", "/")])
    dense = TransformerLM(_pcfg())
    dense.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.gpt_from_tp({k: v[0] for k, v in
                                                gathered.items()}).items()})
    ids = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        want = model(ids)
        got = dense(ids)
    np.testing.assert_allclose(got.numpy(), want[0].numpy(), rtol=0,
                               atol=OUT_TOL)
    np.testing.assert_allclose(want[1].numpy(), logits[1], rtol=0,
                               atol=OUT_TOL)
    back = convert.flax_from_tp(model.state_dict(), mesh,
                                pt.tp_param_rules())["params"]
    for name, a in _flat(back).items():
        np.testing.assert_array_equal(a, flat[name])


def test_rule_table_agrees_with_the_boxes_and_disagreement_raises(jax_tp):
    _, params, _, _, _ = jax_tp
    model, mesh = _port_model(params)
    table = pt.tp_param_rules()
    assert pt.check_rule_agreement(model, table) == []
    # the JAX package's box metadata and the port's agree leaf by leaf
    jmodel = jt.TPTransformerLM(_jcfg(), tp_size=TP)
    jmesh = jt.make_hybrid_mesh({"tp": TP}, devices=jax.devices()[:TP])
    shapes = jax.eval_shape(lambda t: shard_map(
        lambda t: jmodel.init(jax.random.PRNGKey(0), t)["params"],
        mesh=jmesh, in_specs=(JP(),), out_specs=JP(), check_vma=False)(t),
        jnp.zeros((1, T), jnp.int32))
    jspecs = _flat(jt.box_specs(shapes))
    pspecs = pt.box_specs(model)
    from bluefog_tpu.sharding.rules import norm_spec as jnorm
    from bluefog_tpu_torch.sharding.rules import norm_spec

    assert {k.replace(".", "/"): norm_spec(v) for k, v in pspecs.items()} \
        == {k: jnorm(v) for k, v in jspecs.items()}
    p = model.block_0.up.kernel
    saved = p.partition
    p.partition = (None, None)         # a box that contradicts the table
    try:
        with pytest.raises(pt.PartitionDisagreement, match="up.kernel"):
            pt.tp_value_and_grad(lambda p, i: _port_losses(model, p, i),
                                 model, mesh.axis("tp"), rule_table=table)
    finally:
        p.partition = saved


def test_hybrid_gossip_tp_train_step_keeps_consensus():
    """4 gossip ranks x 2-way TP (the reference test's hybrid step): one
    step of each bf rank's tp group, then the shards gossiped over bf on
    K1's twin; identical tokens keep every rank equal, and the port's step
    matches the JAX step's parameters."""
    cfg = dataclasses.replace(_pcfg(), num_layers=1)
    jcfg = dataclasses.replace(_jcfg(), num_layers=1)
    tokens = _tokens()[:, :16]
    jmodel = jt.TPTransformerLM(jcfg, tp_size=TP)
    jmesh = jt.make_hybrid_mesh({"bf": 4, "tp": TP},
                                devices=jax.devices())
    sched = jbuild(JRing(4))

    def body(toks):
        boxed = jmodel.init(jax.random.PRNGKey(0), toks)["params"]

        def loss_fn(p):
            return _ce(jmodel.apply({"params": p}, toks), toks)

        _, grads = jt.tp_value_and_grad(loss_fn, boxed, "tp")(boxed)
        new = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g,
                                     jt.unbox_params(boxed), grads)
        new = jax.tree_util.tree_map(
            lambda p: jcoll.neighbor_allreduce(p, sched, "bf"), new)
        return (jt.gather_tp_params(boxed, "tp"),
                jt.gather_tp_params(new, "tp", template=boxed))

    init, want = jax.tree_util.tree_map(np.asarray, jax.jit(shard_map(
        body, mesh=jmesh, in_specs=(JP(),), out_specs=(JP(), JP()),
        check_vma=False))(jnp.asarray(tokens)))
    pm = pt.make_hybrid_mesh({"bf": 4, "tp": TP}, ranks=range(8))
    model = pt.TPTransformerLM(cfg, pm)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.tp_from_flax(init, pm,
                                                pt.tp_param_rules()).items()})
    ids = torch.from_numpy(tokens).long()
    axis = pt.ax.Axis("tp", TP, 0)          # within one bf rank's slice
    params = dict(model.named_parameters())
    new = {k: torch.empty_like(v) for k, v in params.items()}
    for r in range(4):
        p_r = {k: v[r] for k, v in params.items()}
        _, g = pt.tp_value_and_grad(
            lambda p, i: _port_losses(model, p, i, axis), model,
            axis)(p_r, ids)
        for k in new:
            new[k][r] = (p_r[k] - 0.1 * g[k]).detach()
    mixed = pcoll.neighbor_allreduce(new, RingGraph(4), backend="kernel")
    for k, v in mixed.items():
        torch.testing.assert_close(v, new[k], rtol=0, atol=1e-6)
        full = pt.gather_tp_params({k: v}, model, pm.axis("tp"))[k]
        np.testing.assert_allclose(full[0, 0].numpy(), _flat(want)[
            k.replace(".", "/")], rtol=0, atol=GRAD_TOL, err_msg=k)


def test_rule_table_resolution_matches_jax():
    """The port's rule table resolves, covers and derives optimizer-state
    specs as the JAX package's does, and raises the same errors."""
    from bluefog_tpu.sharding import rules as jr
    from bluefog_tpu_torch.sharding import rules as pr

    rules = [("qkv/kernel$", (None, "tp")), (r"up/(kernel|bias)$", ("tp",)),
             ("emb", "tp"), (".*", ())]
    jtable = jr.RuleTable([(p, jax.sharding.PartitionSpec(*s)
                            if isinstance(s, tuple) else s)
                           for p, s in rules])
    ptable = pr.RuleTable([(p, pr.PartitionSpec(*s)
                            if isinstance(s, tuple) else s)
                           for p, s in rules])
    params = {"block_0": {"qkv": {"kernel": np.zeros((4, 12))},
                          "up": {"kernel": np.zeros((8, 4)),
                                 "bias": np.zeros(8)}},
              "emb": np.zeros((16, 4)), "scale": np.zeros(1)}
    opt = {"mu": params, "nu": params, "count": np.zeros(())}
    norm = lambda tree: {k: pr.norm_spec(v) for k, v in  # noqa: E731
                         pr.named_leaves(tree, is_leaf=lambda s: isinstance(
                             s, (pr.PartitionSpec,
                                 jax.sharding.PartitionSpec)))}
    assert norm(ptable.resolve_tree(params)) == norm(
        jtable.resolve_tree(params))
    assert norm(pr.opt_state_specs(ptable, params, opt)) == norm(
        jr.opt_state_specs(jtable, params, opt))
    assert ptable.coverage(params) == jtable.coverage(params)
    assert ptable.replaced("emb", pr.PartitionSpec()).resolve(
        "emb", (16, 4)) == ()
    with pytest.raises(pr.UnmatchedLeafError):
        pr.RuleTable([("x$", ())]).resolve("y", (2, 2))
    with pytest.raises(pr.UnusedRuleError):
        pr.RuleTable(rules + [("never$", ())]).check(params)
    with pytest.raises(pr.ShardingRuleError, match="axis"):
        pr.RuleTable(rules, axes={"bf": 2})
    # a module's dotted names are path components
    assert ptable.resolve_tree({"block_0.qkv.kernel": np.zeros((4, 12))}) \
        == {"block_0.qkv.kernel": (None, "tp")}

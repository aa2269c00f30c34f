"""The port's mixture-of-experts against the JAX package's.

Both routers, ``expert_parallel_ffn`` against ``moe_ffn_reference`` and
against the JAX expert-parallel FFN (forward and gradients, the replicated
router's gradient summed over ``ep`` as the reference's ``lax.psum``), the
dryrun's dp x ep step, and ``MoETransformerLM`` unsharded and expert-parallel
(weights converted from the JAX model's own initialisation by
``convert.moe_from_flax``).  Seeded numpy inputs; the JAX functions under
``shard_map`` on the conftest's CPU mesh; ``noise_scale`` stays 0 (the
reference draws its router noise from ``jax.random``).  f32, with the
reference tests' tolerances: outputs within 1e-5, expert gradients within
1e-5 and the router's within 1e-4, absolute.  The LM's width (128, 4
heads: D = 32) and T = 128 put its attention on K3's route (the twins on
the CPU) where the JAX package's CPU run takes its dense path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as JP

from bluefog_tpu.models import moe as jmm
from bluefog_tpu.models.transformer import GPTConfig as JConfig
from bluefog_tpu.ops import moe as jmoe
from bluefog_tpu.parallel.api import shard_map
from bluefog_tpu.parallel.tensor import make_hybrid_mesh as jmesh_of
from bluefog_tpu_torch import convert
from bluefog_tpu_torch.models import moe as pmm
from bluefog_tpu_torch.models.transformer import GPTConfig
from bluefog_tpu_torch.ops import moe as pmoe
from bluefog_tpu_torch.ops import ring_attention as pra
from bluefog_tpu_torch.parallel.axes import Axis, make_hybrid_mesh

D, H, E, EP = 8, 16, 8, 4
T_LOCAL = 16
T = EP * T_LOCAL
OUT_TOL, GRAD_TOL, ROUTER_TOL = 1e-5, 1e-5, 1e-4
AXIS = Axis("ep", EP, 0)


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _weights(seed):
    rng = np.random.default_rng(seed)
    return {"router": rng.standard_normal((D, E)).astype(np.float32),
            "wi": (rng.standard_normal((E, D, H)) / np.sqrt(D)).astype(
                np.float32),
            "wo": (rng.standard_normal((E, H, D)) / np.sqrt(H)).astype(
                np.float32)}


def _x(seed, shape=(T, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("router", ["top1", "top2"])
def test_routers_match_jax(router):
    """Dispatch, combine, aux and metrics on random tokens at a capacity
    that drops some, and on colliding tokens (ties in the router go to the
    first expert in both)."""
    rk = _x(1, (D, E))
    for x, cap in ((_x(0, (24, D)), 3), (np.ones((5, D), np.float32), 3)):
        want = jmoe.get_router(router)(jnp.asarray(x), jnp.asarray(rk),
                                       num_experts=E, capacity=cap)
        got = pmoe.get_router(router)(_t(x), _t(rk), num_experts=E,
                                      capacity=cap)
        np.testing.assert_array_equal(got.dispatch.numpy(),
                                      np.asarray(want.dispatch))
        np.testing.assert_allclose(got.combine.numpy(),
                                   np.asarray(want.combine), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got.aux.numpy(), np.asarray(want.aux),
                                   rtol=1e-6)
        for k, v in want.metrics.items():
            np.testing.assert_allclose(got.metrics[k].numpy(), np.asarray(v),
                                       rtol=0, atol=1e-7, err_msg=k)
    # Switch's capacity drop, as the reference test pins it
    d, c, _, m = pmoe.switch_router(torch.ones(4, D), _t(rk), num_experts=E,
                                    capacity=2)
    assert d.sum((1, 2)).tolist() == [1, 1, 0, 0] and c[2:].sum() == 0
    assert float(m["dropped_frac"]) == 0.5 == float(m["fully_dropped_frac"])
    with pytest.raises(ValueError, match="num_experts >= 2"):
        pmoe.top2_router(_t(x), _t(rk[:, :1]), num_experts=1, capacity=2)
    with pytest.raises(ValueError, match="unknown router"):
        pmoe.get_router("top3")


def test_top2_drop_accounting_is_monotone_in_capacity():
    x, rk = _t(_x(5, (64, D))), _t(_x(6, (D, E)))
    drops = [float(pmoe.top2_router(x, rk, num_experts=E, capacity=c)
                   .metrics["dropped_frac"])
             for c in (1, 2, 4, 8, 16, 32, 64, 128)]
    assert all(a >= b for a, b in zip(drops, drops[1:])), drops
    assert drops[-1] == 0.0 < drops[0]


def _jax_ep(x, w, cap, router, ref_cap):
    """The JAX expert-parallel FFN's output and gradients (router summed
    over ep), and the dense reference's gradients."""
    mesh = jmesh_of({"ep": EP}, devices=jax.devices()[:EP])

    def ref_loss(w):
        y, _, _ = jmoe.moe_ffn_reference(x, w["router"], w["wi"], w["wo"],
                                         num_experts=E, capacity=ref_cap,
                                         router=router)
        return jnp.sum(y ** 2) / T

    def body(xl, wi_l, wo_l, rk):
        def loss_fn(p):
            y, _, _ = jmoe.expert_parallel_ffn(
                xl, p["router"], p["wi"], p["wo"], ep_axis="ep",
                num_experts=E, capacity=cap, router=router)
            return jnp.sum(y ** 2) / T, y

        g, y = jax.grad(loss_fn, has_aux=True)(
            {"router": rk, "wi": wi_l, "wo": wo_l})
        return y, g["wi"], g["wo"], lax.psum(g["router"], "ep")

    out = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(JP("ep"),) * 3 + (JP(),),
        out_specs=(JP("ep"),) * 3 + (JP(),), check_vma=False))(
            x, w["wi"], w["wo"], w["router"])
    return [np.asarray(a) for a in out], jax.tree_util.tree_map(
        np.asarray, jax.grad(ref_loss)(w))


@pytest.mark.parametrize("router", ["top1", "top2"])
def test_expert_parallel_ffn_matches_reference_and_jax(router):
    k = 2 if router == "top2" else 1
    w, x = _weights(0), _x(1)
    cap = k * T_LOCAL          # ample: sharded and global routing agree
    (y, gwi, gwo, grouter), gref = _jax_ep(x, w, cap, router, k * T)
    p = {n: _t(a).requires_grad_() for n, a in w.items()}
    xs = _t(x).view(EP, T_LOCAL, D)
    out, aux, metrics = pmoe.expert_parallel_ffn(
        xs, p["router"], p["wi"].view(EP, E // EP, D, H),
        p["wo"].view(EP, E // EP, H, D), axis=AXIS, num_experts=E,
        capacity=cap, router=router)
    assert aux.shape == (EP,) and metrics["expert_load"].shape == (EP, E)
    np.testing.assert_allclose(out.detach().reshape(T, D).numpy(), y,
                               rtol=0, atol=OUT_TOL)
    dense, _, _ = pmoe.moe_ffn_reference(
        _t(x), p["router"], p["wi"], p["wo"], num_experts=E,
        capacity=k * T, router=router)
    np.testing.assert_allclose(out.detach().reshape(T, D).numpy(),
                               dense.detach().numpy(), rtol=0, atol=OUT_TOL)
    # global-token-count loss: exact expert grads, the shared router's
    # gradient is the reference's psum over ep
    g = dict(zip(p, torch.autograd.grad((out ** 2).sum() / T,
                                        list(p.values()))))
    for name, want in (("wi", gwi), ("wo", gwo)):
        np.testing.assert_allclose(g[name].numpy(), want, rtol=0,
                                   atol=GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(g[name].numpy(), gref[name], rtol=0,
                                   atol=GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(g["router"].numpy(), grouter, rtol=0,
                               atol=ROUTER_TOL)
    np.testing.assert_allclose(g["router"].numpy(), gref["router"], rtol=0,
                               atol=ROUTER_TOL)


def test_dryrun_dp_ep_step_matches_jax():
    """``__graft_entry__.dryrun_multichip``'s dp x ep step: dp 2 x ep 4,
    top-2, loss ``sum(y^2) / (T_loc ep) + 0.01 aux``, the router's gradient
    summed over ep, every gradient averaged over dp, SGD."""
    dp, ep, e, t_loc, d, h = 2, 4, 4, 8, 16, 32
    rng = np.random.default_rng(0)
    router = rng.standard_normal((d, e)).astype(np.float32)
    wi = (rng.standard_normal((e, d, h)) / np.sqrt(d)).astype(np.float32)
    wo = (rng.standard_normal((e, h, d)) / np.sqrt(h)).astype(np.float32)
    toks = rng.standard_normal((dp, ep, t_loc, d)).astype(np.float32)
    mesh = jmesh_of({"bf": dp, "ep": ep}, devices=jax.devices())

    def step(rk, wi_l, wo_l, x_blk):
        x = x_blk[0, 0]

        def loss_fn(p):
            y, aux, _ = jmoe.expert_parallel_ffn(
                x, p[0], p[1], p[2], ep_axis="ep", num_experts=e,
                capacity=t_loc, router="top2")
            return jnp.sum(y ** 2) / (t_loc * ep) + 0.01 * aux

        gr, gwi, gwo = jax.grad(loss_fn)((rk, wi_l, wo_l))
        gr = lax.psum(gr, "ep")
        gr, gwi, gwo = (lax.pmean(g, "bf") for g in (gr, gwi, gwo))
        return rk - 0.1 * gr, wi_l - 0.1 * gwi, wo_l - 0.1 * gwo

    want = [np.asarray(a) for a in jax.jit(shard_map(
        step, mesh=mesh, in_specs=(JP(), JP("ep"), JP("ep"), JP("bf", "ep")),
        out_specs=(JP(), JP("ep"), JP("ep")), check_vma=False))(
            router, wi, wo, toks)]
    axis = Axis("ep", ep, 0)
    grads = []
    for r in range(dp):   # each dp rank's ep group; the dp mean after
        p = [_t(router).requires_grad_(),
             _t(wi).view(ep, e // ep, d, h).requires_grad_(),
             _t(wo).view(ep, e // ep, h, d).requires_grad_()]
        y, aux, _ = pmoe.expert_parallel_ffn(
            _t(toks[r]), *p, axis=axis, num_experts=e, capacity=t_loc,
            router="top2")
        loss = (y ** 2).sum() / (t_loc * ep) + 0.01 * aux.sum()
        grads.append(torch.autograd.grad(loss, p))
    for i, (w0, name) in enumerate(((router, "router"), (wi, "wi"),
                                    (wo, "wo"))):
        g = (grads[0][i] + grads[1][i]) / dp
        new = _t(w0).view(g.shape) - 0.1 * g
        np.testing.assert_allclose(new.reshape(want[i].shape).numpy(),
                                   want[i], rtol=0, atol=ROUTER_TOL,
                                   err_msg=name)


LM = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
          max_position=256)


def _jmoe_cfg(ep, router):
    return jmm.MoEConfig(gpt=JConfig(**LM, dtype=jnp.float32), num_experts=4,
                         ep_size=ep, capacity_factor=2.0, router=router)


def _pmoe_cfg(ep, router):
    return pmm.MoEConfig(gpt=GPTConfig(**LM, dtype=torch.float32),
                         num_experts=4, ep_size=ep, capacity_factor=2.0,
                         router=router)


@pytest.mark.parametrize("ep", [1, 2], ids=["unsharded", "ep2"])
def test_moe_lm_matches_jax(ep, monkeypatch):
    """The MoE GPT's logits, each layer's aux loss and drop metrics, and the
    gradients (the JAX package's replicated ones summed over ep) against the
    JAX model's, with the JAX model's own weights; the attention takes K3's
    route (one call a layer for the whole ep group)."""
    router, bsz, t = "top2", 2, 128
    jcfg, pcfg = _jmoe_cfg(ep, router), _pmoe_cfg(ep, router)
    model = jmm.MoETransformerLM(jcfg)
    toks = np.random.default_rng(3).integers(0, LM["vocab_size"],
                                             (ep, bsz, t)).astype(np.int32)

    def loss_of(p, x):
        logits, st = model.apply({"params": p}, x,
                                 mutable=["aux_loss", "moe_metrics"])
        ce = -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                           jnp.roll(x, -1, 1)[..., None], -1))
        aux = sum(jnp.sum(a) for a in jax.tree_util.tree_leaves(
            st["aux_loss"]))
        return ce + jcfg.aux_loss_weight * aux, (logits, st)

    def body(x_blk):
        x = x_blk[0]
        params = model.init(jax.random.PRNGKey(1), x)["params"]
        g, (logits, st) = jax.grad(loss_of, has_aux=True)(params, x)
        # the port's loss is the group's mean of the ranks' losses: its
        # expert gradients are JAX's raw ones / ep, its shared leaves' the
        # mean over ep of JAX's raw ones (the reference's psum, / ep)
        g = jax.tree_util.tree_map_with_path(
            lambda path, a: (a / ep if path[-1].key in ("wi", "wo")
                             else lax.pmean(a, "ep")), g)
        return (params, g, logits[None],
                jax.tree_util.tree_map(lambda a: a[None], st))

    mesh = jmesh_of({"ep": ep}, devices=jax.devices()[:ep])
    shapes = jax.eval_shape(   # the tree's structure: the unsharded model's
        lambda x: jmm.MoETransformerLM(_jmoe_cfg(1, router)).init(
            jax.random.PRNGKey(1), x[0])["params"], jnp.asarray(toks))
    specs = jax.tree_util.tree_map_with_path(
        lambda path, _: JP("ep") if path[-1].key in ("wi", "wo") else JP(),
        shapes)
    params, g, logits, st = jax.tree_util.tree_map(np.asarray, jax.jit(
        shard_map(body, mesh=mesh, in_specs=(JP("ep"),),
                  out_specs=(specs, specs, JP("ep"), JP("ep")),
                  check_vma=False))(jnp.asarray(toks)))
    pmesh = make_hybrid_mesh({"ep": ep}, ranks=range(ep)) if ep > 1 else None
    pmodel = pmm.MoETransformerLM(pcfg)
    pmodel.load_state_dict({k: _t(v) for k, v in convert.moe_from_flax(
        params, pmesh).items()})
    back = convert.flax_from_moe(pmodel.state_dict())["params"]
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(jax.tree_util.tree_leaves(back)) == len(flat)
    for path, a in jax.tree_util.tree_leaves_with_path(back):
        np.testing.assert_array_equal(a, flat[path])
    calls = []
    real = pra.flash_attention
    monkeypatch.setattr(pra, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or
                        real(*a, **kw))
    ids = _t(toks).long() if ep > 1 else _t(toks[0]).long()
    out = pmodel(ids)
    assert calls == [(ep * bsz, LM["num_heads"], t, 32)] * LM["num_layers"]
    np.testing.assert_allclose(out.detach().numpy().reshape(logits.shape),
                               logits, rtol=0, atol=OUT_TOL)
    aux = pmm.moe_aux_losses(pmodel)
    jaux = [a for a in jax.tree_util.tree_leaves(st["aux_loss"])]
    for a, w in zip(aux, jaux):
        np.testing.assert_allclose(a.detach().numpy().reshape(-1),
                                   np.asarray(w).reshape(-1), rtol=1e-5)
    for m, name in ((pmm.moe_metrics(pmodel)[0], "dropped_frac"),):
        want = np.asarray(st["moe_metrics"]["block_0"]["moe"][name]).reshape(
            -1)
        np.testing.assert_allclose(m[name].numpy().reshape(-1), want,
                                   rtol=0, atol=1e-7)
    # gradients: JAX's per-rank gradients of each rank's loss; the port's
    # loss is the group's mean of them, so the expert gradients are 1/ep of
    # JAX's raw ones and the shared leaves the mean over ep
    tgt = torch.roll(ids, -1, -1)
    loss = pmm.moe_lm_loss(pmodel, out, tgt, pcfg)
    names, leaves = zip(*pmodel.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = convert.moe_from_flax(g, pmesh)
    for name, gp in grads.items():
        np.testing.assert_allclose(gp.numpy(), want[name], rtol=0,
                                   atol=GRAD_TOL, err_msg=name)


def test_moe_param_rules_resolve_the_port_names():
    model = pmm.MoETransformerLM(_pmoe_cfg(2, "top1"))
    table = pmm.moe_param_rules(tp_axis="tp")
    table.check({k: v for k, v in model.named_parameters()
                 if not k.startswith("block_1")})
    specs = table.resolve_tree(dict(model.named_parameters()))
    assert specs["block_0.mlp.wi"] == ("ep",)
    assert specs["block_0.mlp.router"] == ()
    assert specs["block_0.qkv.weight"] == ("tp", None)
    assert specs["block_0.proj.weight"] == (None, "tp")
    assert specs["tok.weight"] == ()
    cfg = dataclasses.replace(_pmoe_cfg(1, "top2"))
    assert cfg.capacity(64) == jmm.MoEConfig(
        gpt=JConfig.tiny(), num_experts=4, capacity_factor=2.0,
        router="top2").capacity(64)

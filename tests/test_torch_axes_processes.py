"""The mesh-axis collectives with a group spread over processes, against the
one-process port and against the JAX package.

A module fixture starts ``P = 2`` gloo processes with the port's launcher,
each running this file's worker (``_worker``) on seeded numpy inputs over
the mesh positions of the ranks it owns, and writing its rows of every
result to an ``.npz``; the tests put the rows back together.

- The four collectives (``psum``, ``ppermute`` with ``shift``,
  ``all_to_all`` tiled and untiled, ``all_gather``), forward and backward
  (the gradients of ``sum(out * g)`` for a seeded ``g``), on a 1-axis mesh
  of 8 ranks (``sp``: 4 of its ranks in each process) and along the outer
  axis of a ``(a 2, b 4)`` mesh (one index of ``a`` in each process, ``b``
  carried whole): against the port in one process, bit for bit where the
  collective only moves data or sums a pair; the 8-rank ``psum`` and the
  gradients it sums to 1e-6 of the largest magnitude; against JAX's
  ``shard_map`` collectives on the conftest's CPU mesh to the same 1e-6.
- ``ring_attention`` (contiguous and zigzag, causal) and Ulysses
  (``all_to_all_attention``) over 8 ``sp`` ranks, output and gradients,
  against the reference's under ``shard_map`` (the reference tests'
  tolerances: 1e-5 and 5e-5 absolute) and the one-process port (1e-6).
- One tensor-parallel step of a 2-layer GPT (width 64) with the two ``tp``
  ranks in different processes: losses and corrected gradients against the
  JAX package's TP step (the weights are its own initialisation) to 2e-5
  relative and 5e-5 absolute.
- ``examples.longcontext_lm`` under the launcher (the zigzag ring, 6
  steps): finite, falling losses reported once.
- The expert-parallel FFN over ``ep = 4`` with two ranks a process: the
  output against ``moe_ffn_reference`` (JAX's) to 1e-5, the expert
  gradients against the one-process port to 1e-6, and the router's
  gradient summed over the group's processes (``reduce_partials``) to 1e-5.

The card's form (peer memory) runs in ``chip_smoke.py``.
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCS = 2
WORKER_THREADS = 2
N = 8
BLOCK = (8, 6)
TOL = 1e-6
ATT_OUT, ATT_GRAD = 1e-5, 5e-5
ATT = dict(b=1, t_local=8, h=8, d=8)
LM = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
          max_position=64)
T, BATCH, TP = 32, 2, 2
D, H, E, EP, T_LOCAL = 8, 16, 8, 4, 16
MESHES = {"sp": ({"sp": N}, "sp"), "ab": ({"a": 2, "b": 4}, "a")}
PERMS = {8: [(0, 3), (3, 5), (5, 0), (1, 2), (2, 1), (6, 7)],
         2: [(0, 1)]}
OPS = ("psum", "pmean", "ppermute", "shift", "all_to_all", "all_to_all_u",
       "all_gather")


def _data():
    rng = np.random.default_rng(77)
    f = np.float32
    return {"x": rng.standard_normal((N, *BLOCK)).astype(f),
            "g": rng.standard_normal((N, *BLOCK)).astype(f),
            "u": rng.standard_normal((N, N, 5)).astype(f),
            "gu": rng.standard_normal((N, N, 5)).astype(f),
            "u2": rng.standard_normal((N, 2, 5)).astype(f),
            "gu2": rng.standard_normal((N, 2, 5)).astype(f),
            "ggather": rng.standard_normal((N, BLOCK[0] * N, BLOCK[1])
                                           ).astype(f),
            "ggather2": rng.standard_normal((N, BLOCK[0] * 2, BLOCK[1])
                                            ).astype(f)}


def _att_inputs():
    rng = np.random.default_rng(9)
    b, t, h, d = ATT["b"], ATT["t_local"] * N, ATT["h"], ATT["d"]
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(4)]


def _ep_inputs():
    rng = np.random.default_rng(0)
    w = {"router": rng.standard_normal((D, E)).astype(np.float32),
         "wi": (rng.standard_normal((E, D, H)) / np.sqrt(D)).astype(
             np.float32),
         "wo": (rng.standard_normal((E, H, D)) / np.sqrt(H)).astype(
             np.float32)}
    x = np.random.default_rng(1).standard_normal((EP * T_LOCAL, D)).astype(
        np.float32)
    return w, x


def _tokens():
    return np.random.default_rng(7).integers(0, LM["vocab_size"],
                                             (BATCH, T)).astype(np.int64)


# ---------------------------------------------------------------------------
# The collectives, as the worker and the one-process port run them
# ---------------------------------------------------------------------------


def _apply(op, x, axis):
    from bluefog_tpu_torch.parallel import axes as ax

    n = axis.size
    if op == "psum":
        return ax.psum(x, axis)
    if op == "pmean":
        return ax.pmean(x, axis)
    if op == "ppermute":
        return ax.ppermute(x, axis, PERMS[n])
    if op == "shift":
        return ax.shift(x, axis, 1)
    if op == "all_to_all":
        return ax.all_to_all(x, axis, -2, -1, tiled=True)
    if op == "all_to_all_u":
        return ax.all_to_all(x, axis, -2, -2)
    return ax.all_gather(x, axis, -2)


def _inputs_of(op, d, n):
    if op == "all_to_all_u":
        return (d["u"], d["gu"]) if n == N else (d["u2"], d["gu2"])
    if op == "all_gather":
        return d["x"], d["ggather"] if n == N else d["ggather2"]
    if op == "all_to_all":      # (8, 6) out as (8 / n, 6 n)
        return d["x"], d["g"].reshape(N, BLOCK[0] // n, BLOCK[1] * n)
    return d["x"], d["g"]


def _run_ops(mesh, axis, owned, d):
    """``{op: (out, grad)}`` on this process's mesh positions."""
    out = {}
    for op in OPS:
        xa, ga = _inputs_of(op, d, axis.size)
        shape = mesh.shape
        x = torch.from_numpy(xa.reshape(*shape, *xa.shape[1:])[owned].copy())
        g = torch.from_numpy(ga.reshape(*shape, *ga.shape[1:])[owned].copy())
        x.requires_grad_()
        y = _apply(op, x, axis)
        (grad,) = torch.autograd.grad(y, x, g)
        out[op] = (y.detach().numpy(), grad.numpy())
    return out


def _worker(outdir):
    torch.set_num_threads(WORKER_THREADS)
    from torch.func import functional_call

    from bluefog_tpu_torch.runtime.launch import initialize_cluster

    initialize_cluster()
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.models.transformer import GPTConfig
    from bluefog_tpu_torch.ops import moe as pmoe
    from bluefog_tpu_torch.ops import ring_attention as pra
    from bluefog_tpu_torch.parallel import axes as ax
    from bluefog_tpu_torch.parallel import tensor as pt

    ctx = bf.init(size=N, device="cpu")
    p = ctx.process_rank
    res = {}
    d = _data()
    for name, (sizes, axname) in MESHES.items():
        mesh = ax.make_hybrid_mesh(sizes)
        axis = mesh.axis(axname)
        assert axis.spans_processes and axis.count == axis.size // PROCS
        for op, (y, g) in _run_ops(mesh, axis, mesh.owned(), d).items():
            res[f"{name}/{op}/out"], res[f"{name}/{op}/grad"] = y, g

    # sequence parallelism: 4 of the 8 sp ranks here
    mesh = ax.make_hybrid_mesh({"sp": N})
    axis = mesh.axis("sp")
    q, k, v, cot = _att_inputs()
    own = slice(axis.start, axis.start + axis.local)

    def shard(a, zig=False):
        t = torch.from_numpy(a)
        if zig:
            t = pra.zigzag_shard(t, N)
        return t.unflatten(1, (N, -1)).movedim(1, 0)[own].contiguous()

    for kind in ("ring", "zigzag", "ulysses"):
        zig = kind == "zigzag"
        ins = [shard(a, zig).requires_grad_() for a in (q, k, v)]
        if kind == "ulysses":
            out = pra.all_to_all_attention(*ins, axis=axis, causal=True)
        else:
            out = pra.ring_attention(*ins, axis=axis, causal=True,
                                     layout="zigzag" if zig else
                                     "contiguous")
        grads = torch.autograd.grad(out, ins, shard(cot, zig))
        res[f"att/{kind}/out"] = out.detach().numpy()
        for nm, gr in zip("qkv", grads):
            res[f"att/{kind}/d{nm}"] = gr.numpy()

    # the expert-parallel FFN: ep 4 over 4 ranks, two a process
    bf.init(size=EP, device="cpu")
    axis = ax.make_hybrid_mesh({"ep": EP}).axis("ep")
    w, x = _ep_inputs()
    own = slice(axis.start, axis.start + axis.local)
    prm = {n: torch.from_numpy(a) for n, a in w.items()}
    loc = {"router": prm["router"].clone().requires_grad_(),
           "wi": prm["wi"].view(EP, E // EP, D, H)[own].clone()
           .requires_grad_(),
           "wo": prm["wo"].view(EP, E // EP, H, D)[own].clone()
           .requires_grad_()}
    xs = torch.from_numpy(x).view(EP, T_LOCAL, D)[own]
    y, aux, _ = pmoe.expert_parallel_ffn(
        xs, loc["router"], loc["wi"], loc["wo"], axis=axis, num_experts=E,
        capacity=T_LOCAL, router="top1")
    g = dict(zip(loc, torch.autograd.grad((y ** 2).sum() / (EP * T_LOCAL),
                                          list(loc.values()))))
    (router_g,) = ax.reduce_partials([g["router"]], axis)
    res.update({"ep/out": y.detach().numpy(), "ep/aux": aux.detach().numpy(),
                "ep/wi": g["wi"].numpy(), "ep/wo": g["wo"].numpy(),
                "ep/router": router_g.numpy()})

    # one TP step: each process one of the two tp ranks
    bf.init(size=TP, device="cpu")
    mesh = pt.make_hybrid_mesh({"tp": TP})
    axis = mesh.axis("tp")
    model = pt.TPTransformerLM(GPTConfig(**LM, dtype=torch.float32),
                               pt.make_hybrid_mesh({"tp": TP},
                                                   ranks=range(TP)))
    state = np.load(os.path.join(outdir, "tp_init.npz"))
    model.load_state_dict({k: torch.from_numpy(state[k]) for k in state})
    params = {k: v.detach()[axis.start:axis.start + 1].clone()
              .requires_grad_() for k, v in model.named_parameters()}
    ids = torch.from_numpy(_tokens())

    def losses(prm, ids):
        logits = functional_call(model, prm, (ids,), {"axis": axis})
        tgt = torch.roll(ids, -1, -1).expand(logits.shape[:-1])
        ce = torch.nn.functional.cross_entropy(
            logits.flatten(0, -2), tgt.flatten(), reduction="none")
        return ce.view(logits.shape[0], -1).mean(-1)

    loss, grads = pt.tp_value_and_grad(losses, model, axis,
                                       rule_table=pt.tp_param_rules())(
                                           params, ids)
    full = pt.gather_tp_params(grads, model, axis)
    res["tp/loss"] = loss.numpy()
    for k2, v2 in full.items():
        res[f"tp/grad/{k2}"] = v2.numpy()
    res["_stats"] = np.asarray(json.dumps(ax.COLLECTIVE_STATS))
    bf.shutdown()
    np.savez(os.path.join(outdir, f"p{p}.npz"), **res)
    return 0


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_tp():
    """The JAX tp = 2 GPT: its gathered parameters, each rank's loss and the
    corrected gradients gathered."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as JP

    from bluefog_tpu.models.transformer import GPTConfig as JConfig
    from bluefog_tpu.parallel import tensor as jt
    from bluefog_tpu.parallel.api import shard_map

    model = jt.TPTransformerLM(JConfig(**LM, dtype=jnp.float32), tp_size=TP)
    mesh = jt.make_hybrid_mesh({"tp": TP}, devices=jax.devices()[:TP])
    tokens = jnp.asarray(_tokens().astype(np.int32))

    def body(tokens):
        boxed = model.init(jax.random.PRNGKey(0), tokens)["params"]

        def loss_fn(p):
            logits = model.apply({"params": p}, tokens)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.roll(tokens, -1, axis=1)).mean()

        loss, grads = jt.tp_value_and_grad(loss_fn, boxed, "tp")(boxed)
        return (loss[None], jt.gather_tp_params(boxed, "tp"),
                jt.gather_tp_params(grads, "tp", template=boxed))

    out = jax.jit(shard_map(body, mesh=mesh, in_specs=(JP(),),
                            out_specs=(JP("tp"), JP(), JP()),
                            check_vma=False))(tokens)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def spread(jax_tp, tmp_path_factory):
    """Every worker result, the processes' rows put back together."""
    from bluefog_tpu_torch import convert
    from bluefog_tpu_torch.parallel import tensor as pt

    outdir = tmp_path_factory.mktemp("axes")
    mesh = pt.make_hybrid_mesh({"tp": TP}, ranks=range(TP))
    np.savez(outdir / "tp_init.npz", **convert.tp_from_flax(
        jax_tp[1], mesh, pt.tp_param_rules()))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = str(WORKER_THREADS)
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.runtime.launch",
         "--no-build", "-np", str(PROCS), os.path.abspath(__file__),
         str(outdir)], capture_output=True, text=True, timeout=300, env=env,
        cwd=REPO)
    assert r.returncode == 0, (r.stdout[-4000:], r.stderr[-8000:])
    # the long-context example, its 8 sp ranks over the processes
    lc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.runtime.launch",
         "--no-build", "-np", str(PROCS), "-m",
         "bluefog_tpu_torch.examples.longcontext_lm", "--device", "cpu",
         "--attn", "ring-zigzag", "--steps", "6", "--batch", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    parts = [dict(np.load(outdir / f"p{q}.npz")) for q in range(PROCS)]
    got = {}
    for key in parts[0]:
        if key.startswith("tp/") or key == "ep/router" or key == "_stats":
            got[key] = [part[key] for part in parts]
        else:
            # the outer axis of (a 2, b 4) leads; every other result leads
            # with the ranks
            got[key] = np.concatenate([part[key] for part in parts])
    got["_seconds"] = time.monotonic() - t0
    got["_longcontext"] = lc
    return got


def _virtual(name, op):
    """The one-process port's output and gradient on the whole mesh."""
    from bluefog_tpu_torch.parallel import axes as ax

    sizes, axname = MESHES[name]
    mesh = ax.make_hybrid_mesh(sizes, ranks=range(N))
    axis = mesh.axis(axname)
    xa, ga = _inputs_of(op, _data(), axis.size)
    x = torch.from_numpy(xa.reshape(*mesh.shape, *xa.shape[1:]).copy())
    g = torch.from_numpy(ga.reshape(*mesh.shape, *ga.shape[1:]).copy())
    x.requires_grad_()
    y = _apply(op, x, axis)
    (grad,) = torch.autograd.grad(y, x, g)
    return y.detach().numpy(), grad.numpy()


def _jax(name, op):
    """JAX's collective under shard_map on the same mesh: output and the
    gradient of sum(out * g)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    from bluefog_tpu.parallel.api import shard_map

    sizes, axname = MESHES[name]
    names = tuple(sizes)
    n = sizes[axname]
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(tuple(sizes.values())),
                names)
    xa, ga = _inputs_of(op, _data(), n)
    shape = tuple(sizes.values())
    x = jnp.asarray(xa.reshape(*shape, *xa.shape[1:]))
    g = jnp.asarray(ga.reshape(*shape, *ga.shape[1:]))
    lead = len(names)

    def local(t):                   # the block, without the mesh dims
        return t.reshape(t.shape[lead:])

    def fn(t):
        b = local(t)
        if op == "psum":
            y = lax.psum(b, axname)
        elif op == "pmean":
            y = lax.pmean(b, axname)
        elif op == "ppermute":
            y = lax.ppermute(b, axname, PERMS[n])
        elif op == "shift":
            y = lax.ppermute(b, axname, [(i, (i + 1) % n) for i in range(n)])
        elif op == "all_to_all":
            y = lax.all_to_all(b, axname, 0, 1, tiled=True)
        elif op == "all_to_all_u":
            y = lax.all_to_all(b, axname, 0, 0)
        else:
            y = lax.all_gather(b, axname, axis=0, tiled=True)
        return y.reshape((1,) * lead + y.shape)

    spec = JP(*names)
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,), out_specs=spec,
                          check_vma=False))
    y, vjp = jax.vjp(f, x)
    (grad,) = vjp(g)
    return np.asarray(y), np.asarray(grad)


def _close(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


# data movement, or a sum of two blocks: bit for bit against one process
EXACT_OUT = {"ppermute", "shift", "all_to_all", "all_to_all_u", "all_gather"}
EXACT_GRAD = {"ppermute", "shift", "all_to_all", "all_to_all_u"}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", list(MESHES))
def test_collective_against_one_process_and_jax(spread, name, op):
    got_y, got_g = (spread[f"{name}/{op}/out"], spread[f"{name}/{op}/grad"])
    want_y, want_g = _virtual(name, op)
    pair = MESHES[name][0][MESHES[name][1]] == 2
    _close(got_y, want_y, op in EXACT_OUT or (pair and op == "psum"))
    _close(got_g, want_g, op in EXACT_GRAD or (pair and op in
                                               ("psum", "all_gather")))
    jy, jg = _jax(name, op)
    _close(got_y, jy, False)
    _close(got_g, jg, False)


@pytest.fixture(scope="module")
def jax_att():
    """The reference's ring (contiguous, zigzag) and Ulysses attention under
    shard_map over 8 sp devices: output and gradients of sum(out * cot),
    in the global sequence layout (zigzag order for the zigzag ring)."""
    import importlib

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    from bluefog_tpu.parallel.api import shard_map

    jra = importlib.import_module("bluefog_tpu.ops.ring_attention")
    q, k, v, cot = _att_inputs()
    mesh = Mesh(np.array(jax.devices()[:N]), ("sp",))
    out = {}
    for kind in ("ring", "zigzag", "ulysses"):
        zig = kind == "zigzag"
        if kind == "ulysses":
            jfn = lambda q, k, v: jra.all_to_all_attention(  # noqa: E731
                q, k, v, "sp", causal=True)
        else:
            jfn = functools.partial(jra.ring_attention, axis_name="sp",
                                    causal=True, layout="zigzag" if zig
                                    else "contiguous")
        f = jax.jit(shard_map(jfn, mesh=mesh,
                              in_specs=(JP(None, "sp"),) * 3,
                              out_specs=JP(None, "sp"), check_vma=False))
        arrs = [jnp.asarray(a) for a in (q, k, v)]
        jcot = jnp.asarray(cot)
        if zig:
            arrs = [jra.zigzag_shard(a, N) for a in arrs]
            jcot = jra.zigzag_shard(jcot, N)
        o, vjp = jax.vjp(f, *arrs)
        out[kind] = [np.asarray(a) for a in (o, *vjp(jcot))]
    return out


@pytest.mark.parametrize("kind", ["ring", "zigzag", "ulysses"])
def test_sequence_parallel_over_processes(spread, jax_att, kind):
    from bluefog_tpu_torch.ops import ring_attention as pra
    from bluefog_tpu_torch.parallel.axes import Axis

    q, k, v, cot = _att_inputs()
    zig = kind == "zigzag"
    want = jax_att[kind]

    def unshard(a):               # (n, B, t, H, D) -> (B, n t, H, D)
        return np.moveaxis(a, 0, 1).reshape(a.shape[1], -1, *a.shape[3:])

    got = [unshard(spread[f"att/{kind}/{n}"])
           for n in ("out", "dq", "dk", "dv")]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATT_OUT)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATT_GRAD)
    # the one-process port on the same shards
    axis = Axis("sp", N, 0)

    def shard(a):
        t = torch.from_numpy(a)
        t = pra.zigzag_shard(t, N) if zig else t
        return t.unflatten(1, (N, -1)).movedim(1, 0).contiguous()

    ins = [shard(a).requires_grad_() for a in (q, k, v)]
    fn = (pra.all_to_all_attention if kind == "ulysses" else
          functools.partial(pra.ring_attention,
                            layout="zigzag" if zig else "contiguous"))
    o = fn(*ins, axis=axis, causal=True)
    ref = [o] + list(torch.autograd.grad(o, ins, shard(cot)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, unshard(r.detach().numpy()), rtol=0,
                                   atol=TOL)


def test_tp_step_with_tp_across_processes_matches_jax(spread, jax_tp):
    loss, _, grads = jax_tp
    for q in range(PROCS):
        np.testing.assert_allclose(spread["tp/loss"][q], loss[q:q + 1],
                                   rtol=2e-5)
    import jax

    want = {"/".join(k.key for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(grads)}
    for key, parts in spread.items():
        if not key.startswith("tp/grad/"):
            continue
        name = key[len("tp/grad/"):].replace(".", "/")
        for part in parts:      # each process's one rank holds the whole
            np.testing.assert_allclose(part[0], want[name], rtol=0,
                                       atol=5e-5, err_msg=name)
    assert len([k for k in spread if k.startswith("tp/grad/")]) == len(want)


def test_expert_parallel_ffn_with_ep_across_processes(spread):
    import jax.numpy as jnp

    from bluefog_tpu.ops import moe as jmoe
    from bluefog_tpu_torch.ops import moe as pmoe
    from bluefog_tpu_torch.parallel.axes import Axis

    w, x = _ep_inputs()
    want, _, _ = jmoe.moe_ffn_reference(
        jnp.asarray(x), jnp.asarray(w["router"]), jnp.asarray(w["wi"]),
        jnp.asarray(w["wo"]), num_experts=E, capacity=EP * T_LOCAL,
        router="top1")
    np.testing.assert_allclose(spread["ep/out"].reshape(-1, D),
                               np.asarray(want), rtol=0, atol=1e-5)
    # the one-process port: the same FFN over the whole ep axis
    prm = {n: torch.from_numpy(a).requires_grad_() for n, a in w.items()}
    y, aux, _ = pmoe.expert_parallel_ffn(
        torch.from_numpy(x).view(EP, T_LOCAL, D), prm["router"],
        prm["wi"].view(EP, E // EP, D, H), prm["wo"].view(EP, E // EP, H, D),
        axis=Axis("ep", EP, 0), num_experts=E, capacity=T_LOCAL,
        router="top1")
    g = dict(zip(prm, torch.autograd.grad((y ** 2).sum() / (EP * T_LOCAL),
                                          list(prm.values()))))
    np.testing.assert_allclose(spread["ep/aux"], aux.detach().numpy(),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(spread["ep/wi"].reshape(E, D, H),
                               g["wi"].numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(spread["ep/wo"].reshape(E, H, D),
                               g["wo"].numpy(), rtol=0, atol=TOL)
    for part in spread["ep/router"]:
        np.testing.assert_allclose(part, g["router"].numpy(), rtol=0,
                                   atol=1e-5)


def test_longcontext_example_under_the_launcher(spread):
    """``examples.longcontext_lm`` under bfrun: the zigzag ring's KV
    rotation across the processes, the losses summed over them; one report,
    from process 0, with finite falling losses."""
    r = spread["_longcontext"]
    assert r.returncode == 0, (r.stdout[-4000:], r.stderr[-4000:])
    assert r.stdout.count("attn=ring-zigzag") == 1, r.stdout
    assert f"processes={PROCS}" in r.stdout
    steps = [float(line.split()[-1]) for line in r.stdout.splitlines()
             if line.startswith("step")]
    assert steps and np.isfinite(steps).all() and steps[-1] < steps[0]


def test_collectives_count_their_bytes(spread):
    """The stats each process keeps: every collective called, and each
    moved bytes from the other process."""
    for part in spread["_stats"]:
        stats = json.loads(str(part))
        for op in ("psum", "ppermute", "all_to_all", "all_gather",
                   "reduce_scatter", "reduce_partials", "blocks"):
            assert stats[op]["calls"] > 0 and stats[op]["remote_bytes"] > 0


def test_axis_parts_from_the_mesh():
    """Which part of each axis a process holds, without processes: the
    mesh's layout arithmetic on its own."""
    from bluefog_tpu_torch.parallel import axes as ax

    ranks = np.arange(8).reshape(2, 2, 2)      # (dp, pp, tp), 2 ranks each
    assert [ax._owned_block(ranks, q, 2) for q in range(4)][3] == (
        slice(1, 2), slice(1, 2), slice(0, 2))
    with pytest.raises(ValueError, match="one box"):
        ax._owned_block(np.array([[0, 2], [3, 1]]), 0, 2)
    assert ax.Axis("tp", 2, 1).local == 2
    part = ax.Axis("sp", 8, 0, start=4, count=4, groups=((0, 1), (0, 1)))
    assert part.spans_processes and list(part.local_ranks()) == [4, 5, 6, 7]
    assert part.at(2).dim == 2 and part.at(2).start == 4


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))

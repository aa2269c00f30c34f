"""The port spread over processes against the JAX package and against the
port in one process.

A module fixture starts ``P = 2`` and ``P = 4`` gloo processes with the
port's launcher (``python -m bluefog_tpu_torch.runtime.launch -np P``),
each running this file's worker (``_worker``, below) over its owned block of
the 8 ranks on seeded numpy inputs, and each writing its rows of every
result to an ``.npz``.  The tests put the blocks back together and compare
them with the JAX package's stacked API on its 8-device CPU mesh (gossip,
allreduce, broadcast, allgather, hierarchical gossip with the process as
the machine, window put/accumulate/get/update/collect; the aperiodic gossip
over the one-peer Exp-2 matrices and a dense one, full and capped,
``neighbor_allgather``, ``pair_gossip``, sender-weighted gossip and CHOCO
rounds with each compressor), with the port in one process (push-sum
rounds, one step of each optimizer of a narrow ResNet-18, two of gradient
tracking, exact diffusion, CHOCO-SGD flat and hierarchical and the callable
topology, one of a 2-layer GPT), and with the closed forms.

Tolerances.  Gossip over the processes is bit-equal to the one-process port
in f32 and bf16 (every process folds its rows in the same slot order, with
the same rounding).  Against the JAX package, f32 gossip on Exponential-2
is bit-equal (its weights are dyadic, so every product is exact); on the
ring (weights 1/3, 0.3 and 0.35) to rtol 1e-6, one f32 ulp, since XLA's CPU
code contracts some products and sums into FMAs; bf16 to one bf16 ulp (rtol
2**-7; both sides round an f32 sum once).  The flat collectives and the hierarchical gossip: f32 to rtol
1e-6 with a floor of 1e-6 times the largest magnitude, bf16 to one ulp, as
in one process.  Windows: f32 to 1e-6, bf16 one ulp.  The aperiodic gossip,
pair gossip, sender-weighted gossip and CHOCO rounds against the JAX
package: f32 to 1e-6 (XLA's CPU FMAs), bf16 to one ulp; ``random_block_k``
gets the JAX package's block offsets (written by the fixture, injected into
``compression.shared_offset``).  Push-sum and the steps of the
neighbor, allreduce, hierarchical and WinPut optimizers against the
one-process port: bit-equal (the same arithmetic on the same rows, with the
same two torch threads; measured so), asserted to 1e-6 of each tensor's
scale; the steps of gradient tracking, exact diffusion, CHOCO-SGD, the
callable topology and the GPT are asserted bit for bit.

The CUDA form (peer memory) runs on the card only: its test is marked
``cuda`` and skips here; ``chip_smoke.py`` drives it at the main path's
size.
"""

import functools
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
L = 37
WORKER_THREADS = 2
PROCESSES = (2, 4)
BF16_RTOL = 2.0 ** -7
F32_RTOL = 1e-6
SEQ_WAITS = 60
WINDOW_CASES = ("put_update", "weighted_put", "accumulate", "get",
                "collect")


def _data():
    """The seeded inputs every process and the parent share."""
    rng = np.random.default_rng(2024)
    f = np.float32
    return {
        "x": rng.standard_normal((N, L)).astype(f),
        "h": rng.standard_normal((N, 3, 7)).astype(f),
        "w0": rng.standard_normal((N, 3, 4)).astype(f),
        "w1": rng.standard_normal((N, 3, 4)).astype(f),
        "z": rng.standard_normal((N, 29)).astype(f),
        "p0": (1 + np.arange(N) / N).astype(f),
        # a dense random row-stochastic matrix, a zero here and there
        "W": _row_stochastic(rng),
        "send": rng.uniform(0.5, 1.5, (N, 2)).astype(f),
        "i64": rng.integers(-2 ** 62, 2 ** 62, (N, 5), dtype=np.int64),
        "i32": rng.integers(-2 ** 31, 2 ** 31 - 1, (N, 5), dtype=np.int64
                            ).astype(np.int32),
    }


def _row_stochastic(rng):
    w = rng.uniform(0.1, 1.0, (N, N)) * (rng.uniform(size=(N, N)) > 0.3)
    np.fill_diagonal(w, 1.0)
    return (w / w.sum(1, keepdims=True)).astype(np.float32)


def _matrices():
    """The aperiodic matrices: the three one-peer Exp-2 phases and the
    dense one."""
    from bluefog_tpu_torch.topology import one_peer_exp2_mixing_matrix

    return ([one_peer_exp2_mixing_matrix(N, t).numpy() for t in range(3)]
            + [_data()["W"]])


def _gossip_kw(topo, k):
    if topo == "ring-weights":
        return {"self_weight": 0.3,
                "recv_weights": np.full((k,), 0.35, np.float32)}
    return {}


TOPOLOGIES = ("exp2", "ring", "ring-weights")
GOSSIP = [(t, dt, b) for t in TOPOLOGIES for dt in ("f32", "bf16")
          for b in ("auto", "plain")]
HIER = [(form, dt) for form in ("flat", "2d") for dt in ("f32", "bf16")]
COMMS = ("neighbor", "neighbor-atc", "allreduce", "hierarchical", "winput")
# two steps of each, then the trainer's state; "gpt" is one step of a
# 2-layer GPT
ALGOS = ("gt", "ed", "choco", "choco-hier", "callable", "gpt")
OPT_SPEC = dict(model="resnet18", size=N, batch_size=2, image_size=32,
                num_classes=10, num_filters=8, dtype=torch.float32, seed=3,
                device="cpu")
PAIRS = [(0, 1), (1, 0), (2, 5), (5, 2), (3, 7), (6, 4)]
COMPRESSORS = ("identity", "random_block_k", "top_k")
CHOCO_ROUNDS, CHOCO_KEY, CHOCO_GAMMA = 2, 42, 0.5
AGATHER = [(g, dt) for g in ("exp2", "grid") for dt in ("f32", "bf16")]
CACHE_MATRICES = 200


# ---------------------------------------------------------------------------
# The worker: one process of the group
# ---------------------------------------------------------------------------


def _compressor(name):
    from bluefog_tpu_torch.ops import compression as CP

    return {"identity": CP.identity, "random_block_k": lambda: (
        CP.random_block_k(0.25)), "top_k": lambda: CP.top_k(0.25)}[name]()


def _algo_steps(algo, sb):
    """Two steps of one algorithm on the narrow ResNet-18 (one of a 2-layer
    GPT): the trainer's state after them, each tensor flattened per rank."""
    from bluefog_tpu_torch import optim as popt
    from bluefog_tpu_torch.models import GPTConfig, TransformerLM
    from bluefog_tpu_torch.topology import (
        ExponentialTwoGraph, MeshGrid2DGraph, RingGraph,
        one_peer_exp2_mixing_matrix)

    if algo == "gpt":
        spec = sb.MODELS["gpt-small"]
        tiny = sb.ModelSpec(lambda dtype, gen, classes, filters: TransformerLM(
            GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                      num_heads=4, max_position=16, dtype=torch.float32),
            generator=gen), spec.loss, tokens=True)
        sb.MODELS["gpt-tiny"] = tiny
        try:
            trainer = sb.build("gpt-tiny", "neighbor", "exp2", size=N,
                               batch_size=2, seq_len=16,
                               dtype=torch.float32, seed=3, device="cpu")
        finally:
            del sb.MODELS["gpt-tiny"]
        trainer.opt = popt.DistributedNeighborAllreduceOptimizer(
            trainer.opt.base, topology=ExponentialTwoGraph(N))
        steps = 1
    else:
        trainer = sb.build(comm="none", **OPT_SPEC)
        base = trainer.opt.base
        trainer.opt = {
            "gt": lambda: popt.DistributedGradientTrackingOptimizer(
                base, MeshGrid2DGraph(N)),
            "ed": lambda: popt.DistributedExactDiffusionOptimizer(
                base, RingGraph(N)),
            "choco": lambda: popt.DistributedChocoSGDOptimizer(
                base, RingGraph(N), compressor=_compressor("random_block_k"),
                gamma=0.5),
            "choco-hier": lambda: popt.DistributedChocoSGDOptimizer(
                base, RingGraph(N // 2), compressor=_compressor("top_k"),
                gamma=0.5, local_size=2),
            "callable": lambda: popt.DistributedNeighborAllreduceOptimizer(
                base, topology=functools.partial(one_peer_exp2_mixing_matrix,
                                                 N)),
        }[algo]()
        steps = 2
    for _ in range(steps):
        trainer.step()
    state = trainer.state()
    return torch.cat([v.detach().reshape(v.shape[0], -1).float()
                      for _, v in sorted(state.items())], dim=1)


def _train_step(comm, sb, local):
    if comm == "neighbor-atc":
        from bluefog_tpu_torch.optim import (
            DistributedNeighborAllreduceOptimizer)
        from bluefog_tpu_torch.topology import ExponentialTwoGraph

        trainer = sb.build(comm="none", **OPT_SPEC)
        trainer.opt = DistributedNeighborAllreduceOptimizer(
            trainer.opt.base, topology=ExponentialTwoGraph(N), atc=True)
    else:
        trainer = sb.build(comm=comm, local_size=local, **OPT_SPEC)
    trainer.step()
    return torch.cat([v.detach().reshape(v.shape[0], -1)
                      for v in trainer.params.values()], dim=1)


def _worker(outdir):
    torch.set_num_threads(WORKER_THREADS)
    import torch.distributed as dist

    from bluefog_tpu_torch.runtime.launch import initialize_cluster

    initialize_cluster()
    import bluefog_tpu_torch as pbf
    from bluefog_tpu_torch.examples import synthetic_benchmark as sb
    from bluefog_tpu_torch.ops import windows as PW
    from bluefog_tpu_torch.topology import (
        ExponentialTwoGraph, RingGraph, build_schedule)

    p, procs = dist.get_rank(), dist.get_world_size()
    m = N // procs
    own = slice(p * m, (p + 1) * m)
    d = {k: torch.from_numpy(v) for k, v in _data().items()}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    out = {}
    topo_of = {"exp2": ExponentialTwoGraph, "ring": RingGraph,
               "ring-weights": RingGraph}

    # gossip, through the stacked API of a context over the processes
    for topo, dt, backend in GOSSIP:
        ctx = pbf.init(topology=topo_of[topo](N), device="cpu")
        assert (pbf.process_rank(), pbf.process_count()) == (p, procs)
        assert pbf.rank() == p * m and list(pbf.owned_ranks()) == list(
            range(p * m, (p + 1) * m))
        kw = _gossip_kw(topo, ctx.schedule.num_slots)
        out[f"gossip/{topo}/{dt}/{backend}"] = pbf.neighbor_allreduce(
            d["x"][own].to(tdt[dt]), backend=backend, **kw)

    # the flat collectives and the parameter helpers
    pbf.init(size=N, device="cpu")
    xo = d["x"][own]
    out["allreduce/mean"] = pbf.allreduce(xo)
    out["allreduce/sum"] = pbf.allreduce(xo, average=False)
    out["allreduce/int"] = pbf.allreduce(
        torch.arange(N)[own, None] * 3 + torch.zeros(m, 2, dtype=torch.long))
    out["broadcast"] = pbf.broadcast(xo, root_rank=5)
    out["allgather"] = pbf.allgather(xo)
    out["broadcast_parameters"] = pbf.broadcast_parameters(
        {"a": xo, "b": d["h"][own]}, root_rank=3)["b"]
    out["rank_stack"] = pbf.rank_stack(torch.arange(3.0))

    # hierarchical gossip, a machine per process, machines on a ring
    for form, dt in HIER:
        pbf.init(size=N, machine_topology=RingGraph(procs), device="cpu")
        assert pbf.local_size() == m and pbf.machine_rank() == p
        out[f"hier/{form}/{dt}"] = pbf.hierarchical_neighbor_allreduce(
            d["h"][own].to(tdt[dt]), two_level_mesh=form == "2d")

    # windows, through the name-keyed registry
    for case in WINDOW_CASES:
        topo = {"put_update": ExponentialTwoGraph(N), "get":
                ExponentialTwoGraph(N), "collect": RingGraph(
                    N, connect_style=1)}.get(case, RingGraph(N))
        pbf.init(topology=topo, device="cpu")
        tree = {"a": d["w0"][own], "b": d["w1"][own].to(torch.bfloat16)}
        if case in ("accumulate", "collect"):
            pbf.win_create(tree, "w", zero_init=True)
        else:
            pbf.win_create(tree, "w")
        if case == "put_update":
            pbf.win_put(tree, "w")
            res = pbf.win_update("w")
        elif case == "weighted_put":
            pbf.win_put(tree, "w", dst_weight=0.5)
            res = pbf.win_update("w", self_weight=1.0,
                                 recv_weights=[1.0, 1.0])
        elif case == "accumulate":
            pbf.win_accumulate(tree, "w")
            pbf.win_accumulate(tree, "w", dst_weight=0.25)
            res = pbf.win_update("w", self_weight=1.0,
                                 recv_weights=[1.0, 1.0])
        elif case == "get":
            pbf.win_get("w")
            res = pbf.win_update("w")
        else:
            pbf.win_accumulate(tree, "w")
            first = {k: v.clone() for k, v in
                     pbf.win_update_then_collect("w").items()}
            second = pbf.win_update_then_collect("w")
            out[f"window/{case}/first/a"] = first["a"]
            res = second
        out[f"window/{case}/a"] = res["a"]
        out[f"window/{case}/b"] = res["b"]
        pbf.win_free("w")

    # push-sum: win_accumulate with p on the directed ring, 3 rounds
    pbf.init(size=N, device="cpu")
    sched = build_schedule(RingGraph(N, connect_style=1))
    st = PW.win_create(torch.zeros(m, d["z"].shape[1]), sched,
                       associated_p=True)
    st.assoc_self.copy_(d["p0"][own])
    PW.win_sync(st, d["z"][own] * d["p0"][own, None])
    for _ in range(3):
        PW.win_accumulate(st, None, dst_weight=0.5)
        st.self_buf.mul_(0.5)
        st.assoc_self.mul_(0.5)
        PW.win_update_then_collect(st)
    out["pushsum/x"] = st.self_buf
    out["pushsum/p"] = st.assoc_self

    # write after read: the same schedule's buffers reused by three calls
    # with different payloads, the first process late to each
    for t in range(3):
        if p == 0:
            time.sleep(0.05)
        out[f"war/{t}"] = pbf.neighbor_allreduce(d["x"][own] * (t + 1) + t)
    # and two exchanges of one shape a step, as gradient tracking makes
    for t in range(3):
        if p == 0:
            time.sleep(0.05)
        for j in range(2):
            out[f"war2/{t}/{j}"] = pbf.neighbor_allreduce(
                d["x"][own] * (t + 1) - j)

    # the CUDA form's host barrier (a sequence number per process in a
    # shared file), with one process late now and then: arrival and
    # departure times of every wait
    from bluefog_tpu_torch.ops.transport import _HostSeq

    seq = _HostSeq(pbf.get_context().transport)
    times = np.zeros((SEQ_WAITS, 2))
    for k in range(SEQ_WAITS):
        if (k + p) % 7 == 0:
            time.sleep(0.003)
        times[k, 0] = time.monotonic()
        seq.wait()
        times[k, 1] = time.monotonic()
    out["seq/times"] = torch.from_numpy(times)[None]

    # one step of each optimizer ported across processes
    for comm in COMMS:
        pbf.init(size=N, device="cpu")
        out[f"opt/{comm}"] = _train_step(comm, sb, m)
    _worker_slice(outdir, out, d, own, m)
    for algo in ALGOS:
        pbf.init(size=N, device="cpu")
        out[f"algo/{algo}"] = _algo_steps(algo, sb)
    pbf.shutdown()
    np.savez(os.path.join(outdir, f"p{p}.npz"),
             **{k: v.detach().numpy() if v.dtype in (
                 torch.float64, torch.int64, torch.int32)
                else v.detach().float().numpy() for k, v in out.items()})


def _worker_slice(outdir, out, d, own, m):
    """The aperiodic gossip, ``neighbor_allgather``, ``pair_gossip``,
    sender-weighted gossip, CHOCO rounds, the transport's caches, a
    mismatched matrix and ``win_free``, over the processes."""
    import torch.distributed as dist

    import bluefog_tpu_torch as pbf
    from bluefog_tpu_torch.ops import collectives as C
    from bluefog_tpu_torch.ops import compression as CP
    from bluefog_tpu_torch.topology import (
        ExponentialTwoGraph, MeshGrid2DGraph, RingGraph,
        one_peer_exp2_mixing_matrix)

    p = dist.get_rank()
    ctx = pbf.init(size=N, device="cpu")
    tr = ctx.transport
    xo = d["x"][own]
    for i, w in enumerate(_matrices()):
        out[f"aper/{i}"] = pbf.neighbor_allreduce_aperiodic(xo, w)
    out["aper/bf16"] = pbf.neighbor_allreduce_aperiodic(
        xo.to(torch.bfloat16), d["W"].numpy())
    out["aper/capped"] = C.neighbor_allreduce_aperiodic(
        xo, d["W"].numpy(), max_rotations=1)
    out["aper/capped-within"] = C.neighbor_allreduce_aperiodic(
        xo, one_peer_exp2_mixing_matrix(N, 1), max_rotations=1)

    graphs = {"exp2": ExponentialTwoGraph(N), "grid": MeshGrid2DGraph(N)}
    for g, dt in AGATHER:
        slots, mask = pbf.neighbor_allgather(
            xo.to({"f32": torch.float32, "bf16": torch.bfloat16}[dt]),
            topology=graphs[g])
        out[f"agather/{g}/{dt}"] = slots
        out[f"agather/{g}/mask"] = mask
    # integer payloads cross unchanged: gathered by every in-neighbour
    for key in ("i64", "i32"):
        out[f"agather/ints/{key}"] = pbf.neighbor_allgather(
            d[key][own], topology=graphs["exp2"])[0]

    for dt in ("f32", "bf16", "f64"):
        tdt = {"f32": torch.float32, "bf16": torch.bfloat16,
               "f64": torch.float64}[dt]
        out[f"pair/{dt}"] = C.pair_gossip(xo.to(tdt), perm=PAIRS,
                                          self_weight=0.3)
    for dt in ("f32", "bf16"):
        out[f"send/{dt}"] = pbf.neighbor_allreduce(
            xo.to({"f32": torch.float32, "bf16": torch.bfloat16}[dt]),
            topology=RingGraph(N), send_weights=d["send"].numpy())

    # CHOCO rounds with each compressor, random_block_k at the JAX offsets
    with open(os.path.join(outdir, "offsets.json")) as f:
        table = json.load(f)
    real = CP.shared_offset
    CP.shared_offset = lambda *key: table[",".join(map(str, key))]
    try:
        for name in COMPRESSORS:
            out[f"choco/{name}"] = _choco_rounds(name, xo)
    finally:
        CP.shared_offset = real

    # 200 distinct matrices: the transport keeps what the LRU keeps
    C._aperiodic_tables.cache_clear()
    gc.collect()
    out["cache/plans-before"] = torch.full((m, 1), len(tr._plans))
    rng = np.random.default_rng(5)
    tiny = xo[:, :3].contiguous()
    for _ in range(CACHE_MATRICES):
        C.neighbor_allreduce_aperiodic(tiny, _row_stochastic(rng))
    gc.collect()
    out["cache/plans"] = torch.full((m, 1), len(tr._plans))
    out["cache/lru"] = torch.full(
        (m, 1), C._aperiodic_tables.cache_info().currsize)

    # a matrix that differs between the processes raises in every one
    w = np.roll(np.eye(N, dtype=np.float32), p + 1, axis=1) * 0.5 + 0.5 * \
        np.eye(N, dtype=np.float32)
    try:
        C.neighbor_allreduce_aperiodic(xo, w)
        raised = 0
    except ValueError as e:
        raised = int("disagree" in str(e))
    out["mismatch"] = torch.full((m, 1), raised)

    # windows created and freed again and again, then one more that works
    for _ in range(20):
        pbf.win_create({"a": d["w0"][own]}, "cycle")
        pbf.win_free("cycle")
    pbf.win_create({"a": d["w0"][own]}, "cycle")
    pbf.win_put(None, "cycle")
    out["winfree/a"] = pbf.win_update("cycle")["a"]
    out["winfree/count"] = torch.full((m, 1), len(ctx.windows) + len(
        tr._arenas))
    pbf.win_free()


def _choco_rounds(name, x):
    from bluefog_tpu_torch.ops import compression as CP
    from bluefog_tpu_torch.topology import RingGraph, build_schedule

    sched = build_schedule(RingGraph(N))
    st = CP.choco_init(x, sched)
    comp = _compressor(name)
    for _ in range(CHOCO_ROUNDS):
        x, st = CP.choco_gossip(x, st, sched, compressor=comp,
                                gamma=CHOCO_GAMMA, key=CHOCO_KEY)
    return x


def _jax_offsets():
    """``random_block_k``'s block offsets in the JAX package for the CHOCO
    rounds: ``"seed,round,leaf,n" -> offset``."""
    import jax

    out = {}
    for rnd in range(CHOCO_ROUNDS):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(CHOCO_KEY), rnd), 0)
        out[f"{CHOCO_KEY},{rnd},0,{L}"] = int(
            jax.random.randint(key, (), 0, L))
    return out


# ---------------------------------------------------------------------------
# The parent: the JAX package and the one-process port on the same inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=PROCESSES, ids=lambda p: f"P{p}")
def spread(request, tmp_path_factory):
    """Every result of the workers at ``P`` processes, each the ``(8,
    ...)`` whole put back together from the processes' blocks."""
    procs = request.param
    outdir = tmp_path_factory.mktemp(f"mp{procs}")
    with open(outdir / "offsets.json", "w") as f:
        json.dump(_jax_offsets(), f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = str(WORKER_THREADS)
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.runtime.launch",
         "--no-build", "-np", str(procs), os.path.abspath(__file__),
         str(outdir)], capture_output=True, text=True, timeout=600, env=env,
        cwd=REPO)
    assert r.returncode == 0, (r.stdout[-4000:], r.stderr[-8000:])
    parts = [np.load(outdir / f"p{q}.npz") for q in range(procs)]
    got = {k: np.concatenate([part[k] for part in parts])
           for k in parts[0].files}
    got["_procs"] = procs
    got["_seconds"] = time.monotonic() - t0
    return got


@pytest.fixture(scope="module")
def jax_side():
    import jax.numpy as jnp

    import bluefog_tpu as bf
    import bluefog_tpu.topology as jt

    d = _data()
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    topo_of = {"exp2": jt.ExponentialTwoGraph, "ring": jt.RingGraph,
               "ring-weights": jt.RingGraph}
    want = {}
    for topo in TOPOLOGIES:
        ctx = bf.init(topology=topo_of[topo](N))
        for dt in ("f32", "bf16"):
            kw = _gossip_kw(topo, ctx.schedule.num_slots)
            want[f"gossip/{topo}/{dt}"] = bf.neighbor_allreduce(
                jnp.asarray(d["x"], jdt[dt]), **kw)
    bf.init()
    x = jnp.asarray(d["x"])
    want["allreduce/mean"] = bf.allreduce(x)
    want["allreduce/sum"] = bf.allreduce(x, average=False)
    want["broadcast"] = bf.broadcast(x, root_rank=5)
    want["allgather"] = bf.allgather(x)
    want["broadcast_parameters"] = bf.broadcast_parameters(
        {"a": x, "b": jnp.asarray(d["h"])}, root_rank=3)["b"]
    for procs in PROCESSES:
        bf.init(local_size=N // procs,
                machine_topology=jt.RingGraph(procs))
        for form, dt in HIER:
            want[f"hier/{procs}/{form}/{dt}"] = \
                bf.hierarchical_neighbor_allreduce(
                    jnp.asarray(d["h"], jdt[dt]),
                    two_level_mesh=form == "2d")
    for case in WINDOW_CASES:
        topo = {"put_update": jt.ExponentialTwoGraph(N), "get":
                jt.ExponentialTwoGraph(N), "collect": jt.RingGraph(
                    N, connect_style=1)}.get(case, jt.RingGraph(N))
        bf.init(topology=topo)
        tree = {"a": jnp.asarray(d["w0"]),
                "b": jnp.asarray(d["w1"], jnp.bfloat16)}
        bf.win_create(tree, "w", zero_init=case in ("accumulate",
                                                    "collect"))
        if case == "put_update":
            bf.win_put(tree, "w")
            res = bf.win_update("w")
        elif case == "weighted_put":
            bf.win_put(tree, "w", dst_weight=0.5)
            res = bf.win_update("w", self_weight=1.0,
                                recv_weights=[1.0, 1.0])
        elif case == "accumulate":
            bf.win_accumulate(tree, "w")
            bf.win_accumulate(tree, "w", dst_weight=0.25)
            res = bf.win_update("w", self_weight=1.0,
                                recv_weights=[1.0, 1.0])
        elif case == "get":
            bf.win_get("w")
            res = bf.win_update("w")
        else:
            bf.win_accumulate(tree, "w")
            want[f"window/{case}/first/a"] = bf.win_update_then_collect(
                "w")["a"]
            res = bf.win_update_then_collect("w")
        want[f"window/{case}/a"] = res["a"]
        want[f"window/{case}/b"] = res["b"]
        bf.win_free("w")
    want.update(_jax_slice(d))
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in want.items()}


def _jax_slice(d):
    """The JAX package's aperiodic gossip, ``neighbor_allgather``,
    ``pair_gossip``, sender-weighted gossip and CHOCO rounds on the
    inputs of :func:`_worker_slice`."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    import bluefog_tpu as bf
    import bluefog_tpu.topology as jt
    from bluefog_tpu.ops import collectives as jcoll
    from bluefog_tpu.ops import compression as JCP
    from bluefog_tpu.parallel.api import shard_map

    want = {}
    ctx = bf.init()
    x = jnp.asarray(d["x"])
    for i, w in enumerate(_matrices()):
        want[f"aper/{i}"] = bf.neighbor_allreduce_aperiodic(x, w)
    want["aper/bf16"] = bf.neighbor_allreduce_aperiodic(
        jnp.asarray(d["x"], jnp.bfloat16), d["W"])
    want["aper/capped"] = bf.neighbor_allreduce_aperiodic(
        x, d["W"], max_rotations=1)
    want["aper/capped-within"] = bf.neighbor_allreduce_aperiodic(
        x, _matrices()[1], max_rotations=1)
    graphs = {"exp2": jt.ExponentialTwoGraph(N), "grid": jt.MeshGrid2DGraph(N)}
    for g, dt in AGATHER:
        slots, mask = bf.neighbor_allgather(
            jnp.asarray(d["x"], {"f32": jnp.float32,
                                 "bf16": jnp.bfloat16}[dt]),
            topology=graphs[g])
        want[f"agather/{g}/{dt}"] = slots
        want[f"agather/{g}/mask"] = mask

    def smap(body, *inputs):
        return jax.jit(shard_map(body, mesh=ctx.mesh,
                                 in_specs=(P("bf"),) * len(inputs),
                                 out_specs=P("bf"), check_vma=False))(*inputs)

    for dt in ("f32", "bf16"):
        xd = jnp.asarray(d["x"], {"f32": jnp.float32,
                                  "bf16": jnp.bfloat16}[dt])
        want[f"pair/{dt}"] = smap(lambda xs: jcoll.pair_gossip(
            xs, "bf", perm=PAIRS, self_weight=0.3), xd)
        want[f"send/{dt}"] = bf.neighbor_allreduce(
            xd, topology=jt.RingGraph(N), send_weights=d["send"])
    sched = jt.build_schedule(jt.RingGraph(N))
    for name in COMPRESSORS:
        comp = {"identity": JCP.identity, "random_block_k": lambda: (
            JCP.random_block_k(0.25)), "top_k": lambda: JCP.top_k(0.25)}[
                name]()

        def run(xs, comp=comp):
            xr = xs[0]
            st = JCP.choco_init(xr, sched)

            def body(carry, _):
                xr, st = carry
                return JCP.choco_gossip(
                    xr, st, sched, "bf", compressor=comp, gamma=CHOCO_GAMMA,
                    key=jax.random.PRNGKey(CHOCO_KEY)), None

            (xr, _), _ = lax.scan(body, (xr, st), None, length=CHOCO_ROUNDS)
            return xr[None]

        want[f"choco/{name}"] = smap(run, x)
    return want


@pytest.fixture(scope="module")
def one_process():
    """The port in one process on the same inputs: push-sum rounds, the
    write-after-read payloads' gossip, and each optimizer's step."""
    import bluefog_tpu_torch as pbf
    from bluefog_tpu_torch.examples import synthetic_benchmark as sb
    from bluefog_tpu_torch.ops import collectives as C
    from bluefog_tpu_torch.ops import compression as CP
    from bluefog_tpu_torch.ops import windows as PW
    from bluefog_tpu_torch.topology import (
        ExponentialTwoGraph, RingGraph, build_schedule)

    prev = torch.get_num_threads()
    torch.set_num_threads(WORKER_THREADS)
    try:
        d = {k: torch.from_numpy(v) for k, v in _data().items()}
        want = {}
        sched = build_schedule(RingGraph(N, connect_style=1))
        st = PW.win_create(torch.zeros_like(d["z"]), sched,
                           associated_p=True)
        st.assoc_self.copy_(d["p0"])
        PW.win_sync(st, d["z"] * d["p0"][:, None])
        for _ in range(3):
            PW.win_accumulate(st, None, dst_weight=0.5)
            st.self_buf.mul_(0.5)
            st.assoc_self.mul_(0.5)
            PW.win_update_then_collect(st)
        want["pushsum/x"] = st.self_buf.numpy().copy()
        want["pushsum/p"] = st.assoc_self.numpy().copy()
        topo_of = {"exp2": ExponentialTwoGraph, "ring": RingGraph,
                   "ring-weights": RingGraph}
        for topo in TOPOLOGIES:
            ctx = pbf.init(topology=topo_of[topo](N), device="cpu")
            kw = _gossip_kw(topo, ctx.schedule.num_slots)
            for dt, tdt in (("f32", torch.float32),
                            ("bf16", torch.bfloat16)):
                want[f"gossip/{topo}/{dt}"] = pbf.neighbor_allreduce(
                    d["x"].to(tdt), **kw).float().numpy()
        pbf.init(size=N, device="cpu")
        for t in range(3):
            want[f"war/{t}"] = pbf.neighbor_allreduce(
                d["x"] * (t + 1) + t).numpy()
            for j in range(2):
                want[f"war2/{t}/{j}"] = pbf.neighbor_allreduce(
                    d["x"] * (t + 1) - j).numpy()
        for procs in PROCESSES:
            for comm in COMMS:
                want[f"opt/{procs}/{comm}"] = _train_step(
                    comm, sb, N // procs).numpy()
        for algo in ALGOS:
            pbf.init(size=N, device="cpu")
            want[f"algo/{algo}"] = _algo_steps(algo, sb).numpy()
        pbf.init(size=N, device="cpu")
        x = d["x"]
        for dt, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16),
                        ("f64", torch.float64)):
            want[f"pair/{dt}"] = C.pair_gossip(
                x.to(tdt), perm=PAIRS, self_weight=0.3).double().numpy()
        for dt, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            want[f"send/{dt}"] = pbf.neighbor_allreduce(
                x.to(tdt), topology=RingGraph(N),
                send_weights=d["send"].numpy()).float().numpy()
        for i, w in enumerate(_matrices()):
            want[f"aper/{i}"] = C.neighbor_allreduce_aperiodic(x, w).numpy()
        want["aper/bf16"] = C.neighbor_allreduce_aperiodic(
            x.to(torch.bfloat16), d["W"].numpy()).float().numpy()
        table = _jax_offsets()
        real = CP.shared_offset
        CP.shared_offset = lambda *key: table[",".join(map(str, key))]
        try:
            for name in COMPRESSORS:
                want[f"choco/{name}"] = _choco_rounds(name, x).numpy()
        finally:
            CP.shared_offset = real
        pbf.shutdown()
        return want
    finally:
        torch.set_num_threads(prev)


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("topo,dt,backend", GOSSIP,
                         ids=["-".join(c) for c in GOSSIP])
def test_gossip_across_processes_matches_jax(spread, jax_side, one_process,
                                             topo, dt, backend):
    got = spread[f"gossip/{topo}/{dt}/{backend}"]
    # spreading the ranks changes nothing: bit-equal to one process
    np.testing.assert_array_equal(got, one_process[f"gossip/{topo}/{dt}"])
    want = jax_side[f"gossip/{topo}/{dt}"]
    if topo == "exp2" and dt == "f32":
        # dyadic weights: every product exact, so no FMA can differ
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want, F32_RTOL if dt == "f32" else BF16_RTOL)


@pytest.mark.parametrize("op", ["allreduce/mean", "allreduce/sum",
                                "broadcast", "allgather",
                                "broadcast_parameters"])
def test_flat_collectives_across_processes_match_jax(spread, jax_side, op):
    got = spread[op]
    assert got.shape == jax_side[op].shape
    _close(got, jax_side[op], F32_RTOL)


def test_integer_allreduce_and_rank_stack_across_processes(spread):
    # the mean of 0, 3, ..., 21 is 10.5, cast back to an integer
    np.testing.assert_array_equal(spread["allreduce/int"],
                                  np.full((N, 2), 10))
    np.testing.assert_array_equal(spread["rank_stack"],
                                  np.tile(np.arange(3.0), (N, 1)))


@pytest.mark.parametrize("form,dt", HIER, ids=["-".join(c) for c in HIER])
def test_hierarchical_with_process_as_machine_matches_jax(spread, jax_side,
                                                          form, dt):
    got = spread[f"hier/{form}/{dt}"]
    want = jax_side[f"hier/{spread['_procs']}/{form}/{dt}"]
    _close(got, want, F32_RTOL if dt == "f32" else BF16_RTOL)
    local = N // spread["_procs"]
    lanes = got.reshape(spread["_procs"], local, -1)
    np.testing.assert_array_equal(lanes, np.repeat(lanes[:, :1], local, 1))


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_windows_across_processes_match_jax(spread, jax_side, case):
    keys = [f"window/{case}/a", f"window/{case}/b"]
    if case == "collect":
        keys.append(f"window/{case}/first/a")
    for key in keys:
        _close(spread[key], jax_side[key],
               BF16_RTOL if key.endswith("/b") else F32_RTOL)


def test_push_sum_across_processes(spread, one_process):
    p = spread["pushsum/p"]
    assert float(p.astype(np.float64).sum()) == float(_data()["p0"].sum())
    _close(p, one_process["pushsum/p"], F32_RTOL)
    _close(spread["pushsum/x"], one_process["pushsum/x"], F32_RTOL)


def test_write_after_read_payloads_stay_apart(spread, one_process):
    """Three calls over the same schedule, one process late to each: every
    result is that call's gossip, none another call's payload."""
    for t in range(3):
        np.testing.assert_array_equal(spread[f"war/{t}"],
                                      one_process[f"war/{t}"])
    assert not np.array_equal(spread["war/0"], spread["war/1"])
    # two exchanges of one shape a step (gradient tracking's y, then x)
    for t in range(3):
        for j in range(2):
            np.testing.assert_array_equal(spread[f"war2/{t}/{j}"],
                                          one_process[f"war2/{t}/{j}"])
    assert not np.array_equal(spread["war2/0/0"], spread["war2/0/1"])


def test_host_barrier_releases_no_process_early(spread):
    """Every process arrives at wait k before any process leaves it."""
    times = spread["seq/times"].astype(np.float64)  # (P, waits, 2)
    assert times.shape == (spread["_procs"], SEQ_WAITS, 2)
    last_arrival = times[:, :, 0].max(axis=0)
    first_departure = times[:, :, 1].min(axis=0)
    assert (last_arrival <= first_departure).all()


@pytest.mark.parametrize("comm", COMMS)
def test_optimizer_step_across_processes_matches_one_process(
        spread, one_process, comm):
    got = spread[f"opt/{comm}"]
    want = one_process[f"opt/{spread['_procs']}/{comm}"]
    assert got.shape == want.shape
    _close(got, want, F32_RTOL)


APER = [f"aper/{i}" for i in range(len(_matrices()))] + ["aper/bf16"]


@pytest.mark.parametrize("key", APER)
def test_aperiodic_across_processes_matches_jax(spread, jax_side,
                                                one_process, key):
    """The one-peer Exp-2 phases and a dense matrix: bit-equal to one
    process, and to the JAX package within an f32 ulp (bf16: one ulp)."""
    got = spread[key]
    np.testing.assert_array_equal(got, one_process[key])
    _close(got, jax_side[key], BF16_RTOL if key.endswith("bf16")
           else F32_RTOL)


def test_capped_aperiodic_across_processes(spread, jax_side):
    """Over the cap every rank is NaN, as in the JAX package; within it the
    capped form equals the full one."""
    assert np.isnan(spread["aper/capped"]).all()
    assert np.isnan(jax_side["aper/capped"]).all()
    np.testing.assert_array_equal(spread["aper/capped-within"],
                                  spread["aper/1"])
    _close(spread["aper/capped-within"], jax_side["aper/capped-within"],
           F32_RTOL)


@pytest.mark.parametrize("graph,dt", AGATHER,
                         ids=["-".join(c) for c in AGATHER])
def test_neighbor_allgather_across_processes_matches_jax(spread, jax_side,
                                                         graph, dt):
    """A gather moves values: bit-equal to the JAX package, the padding
    mask too (the grid's ranks have different in-degrees)."""
    np.testing.assert_array_equal(spread[f"agather/{graph}/{dt}"],
                                  jax_side[f"agather/{graph}/{dt}"])
    np.testing.assert_array_equal(spread[f"agather/{graph}/mask"],
                                  jax_side[f"agather/{graph}/mask"])


@pytest.mark.parametrize("key", ["i64", "i32"])
def test_integer_payloads_cross_the_processes(spread, key):
    """int64 and int32 rows arrive unchanged (``top_k``'s indices ride
    the same path)."""
    from bluefog_tpu_torch.topology import ExponentialTwoGraph, build_schedule

    src = build_schedule(ExponentialTwoGraph(N)).recv_src
    got = spread[f"agather/ints/{key}"]
    assert got.dtype == _data()[key].dtype
    np.testing.assert_array_equal(got, _data()[key][src])


@pytest.mark.parametrize("dt", ["f32", "bf16", "f64"])
def test_pair_gossip_across_processes(spread, jax_side, one_process, dt):
    """Bit-equal to one process (f32 and bf16 through K1's peer form, f64
    plain), and to the JAX package within an f32 ulp or a bf16 ulp."""
    got = spread[f"pair/{dt}"]
    np.testing.assert_array_equal(got, one_process[f"pair/{dt}"])
    if dt != "f64":
        _close(got, jax_side[f"pair/{dt}"],
               F32_RTOL if dt == "f32" else BF16_RTOL)
    x = _data()["x"]
    for r in (2, 4, 7):  # 2 and 4 receive across processes, 7 too
        assert not np.array_equal(got[r], x[r])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_send_weights_across_processes(spread, jax_side, one_process, dt):
    got = spread[f"send/{dt}"]
    np.testing.assert_array_equal(got, one_process[f"send/{dt}"])
    _close(got, jax_side[f"send/{dt}"], F32_RTOL if dt == "f32"
           else BF16_RTOL)


@pytest.mark.parametrize("name", COMPRESSORS)
def test_choco_rounds_across_processes_match_jax(spread, jax_side,
                                                 one_process, name):
    got = spread[f"choco/{name}"]
    np.testing.assert_array_equal(got, one_process[f"choco/{name}"])
    _close(got, jax_side[f"choco/{name}"], F32_RTOL)


@pytest.mark.parametrize("algo", ALGOS)
def test_algorithm_steps_across_processes_equal_one_process(
        spread, one_process, algo):
    """Gradient tracking (MeshGrid2D), exact diffusion (ring), CHOCO-SGD
    (flat, and hierarchical with machines of two ranks), the callable
    one-peer topology and a 2-layer GPT: every tensor of the state after
    the steps bit-equal to one process's."""
    got = spread[f"algo/{algo}"]
    assert got.shape == one_process[f"algo/{algo}"].shape
    np.testing.assert_array_equal(got, one_process[f"algo/{algo}"])


def test_transport_caches_stay_bounded(spread):
    """After 200 distinct matrices the CPU form's send and receive lists
    are those of the schedules the LRU still holds, no more."""
    lru = int(spread["cache/lru"][0, 0])
    assert lru == 64
    assert (spread["cache/plans"] <= spread["cache/plans-before"] + lru
            ).all()


def test_a_matrix_that_differs_between_processes_raises(spread):
    assert (spread["mismatch"] == 1).all()


def test_windows_freed_and_made_again(spread):
    """20 windows created and freed, then one more that gossips; nothing
    left registered after its ``win_free``."""
    from bluefog_tpu_torch.topology import ExponentialTwoGraph, build_schedule

    d = _data()
    w = build_schedule(ExponentialTwoGraph(N)).mixing_matrix()
    _close(spread["winfree/a"], np.einsum("ij,jkl->ikl", w, d["w0"]),
           F32_RTOL)
    assert (spread["winfree/count"] == 1).all()


# ---------------------------------------------------------------------------
# The peer-memory tables without the card: P blocks in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("procs", PROCESSES)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_k1_peer_plain_over_block_tables_equals_k1_plain(procs, dt):
    """K1's peer form (its plain twin, on CPU tensors) over the row table
    ``peer_rows`` builds from ``P`` blocks, for each block's owner, equals
    the virtual K1's plain version on the whole stack, bit for bit."""
    from bluefog_tpu_torch.ops import gossip_kernel as k1
    from bluefog_tpu_torch.ops.transport import peer_rows
    from bluefog_tpu_torch.topology import (
        ExponentialTwoGraph, MeshGrid2DGraph, build_schedule)

    x = torch.from_numpy(_data()["x"]).to(dt)
    m = N // procs
    blocks = list(x.split(m))
    for topo in (ExponentialTwoGraph(N), MeshGrid2DGraph(N)):
        sched = build_schedule(topo)
        sw, rw, src = k1.schedule_tables(sched, "cpu")
        want = k1.gossip_mix_plain(x, sw, rw, src)
        for q in range(procs):
            rows = peer_rows(sched, q * m, blocks)
            assert rows.ptrs is None  # no card, no address table
            own = slice(q * m, (q + 1) * m)
            got = k1.gossip_mix_peer(blocks[q], sw[own], rw[own], rows)
            assert torch.equal(got, want[own])
            assert torch.equal(
                k1.gossip_mix_peer_plain(blocks[q], sw[own], rw[own], rows),
                want[own])


@pytest.mark.parametrize("procs", PROCESSES)
@pytest.mark.parametrize("accumulate", [False, True])
def test_k2_peer_plain_over_target_tables_equals_k2_plain(procs, accumulate):
    """K2's peer form (its plain twin on CPU tensors) run by every block's
    owner in turn, storing into the ``P`` landing blocks ``peer_targets``
    names, equals the virtual K2's plain version on the whole stack."""
    from bluefog_tpu_torch.ops import deliver_kernel as k2
    from bluefog_tpu_torch.ops.transport import peer_targets
    from bluefog_tpu_torch.topology import (
        ExponentialTwoGraph, RingGraph, build_schedule)

    d = _data()
    x = torch.from_numpy(d["x"])
    m = N // procs
    for topo in (ExponentialTwoGraph(N), RingGraph(N, connect_style=1)):
        sched = build_schedule(topo)
        k = sched.num_slots
        start = torch.from_numpy(d["x"][:, None].repeat(k, 1)) * 0.5
        src, mask = k2.deliver_tables(sched, "cpu")
        want = k2.window_deliver_plain(x, start.clone(), src, mask, 1 / 3,
                                       accumulate=accumulate)
        landing = start.clone()
        blocks = list(landing.split(m))
        k2.window_deliver_peer.launches = 0
        for q in range(procs):
            targets = peer_targets(sched, q * m, blocks)
            assert targets.dsts is None
            k2.window_deliver_peer(x[q * m:(q + 1) * m], targets, 1 / 3,
                                   accumulate=accumulate)
        assert k2.window_deliver_peer.launches == 0  # CPU: no launch
        assert torch.equal(landing, want)


def test_peer_wrappers_check_their_inputs():
    from bluefog_tpu_torch.ops import deliver_kernel as k2
    from bluefog_tpu_torch.ops import gossip_kernel as k1
    from bluefog_tpu_torch.ops.transport import peer_rows, peer_targets
    from bluefog_tpu_torch.topology import RingGraph, build_schedule

    sched = build_schedule(RingGraph(N))
    x = torch.zeros(N, 5)
    rows = peer_rows(sched, 0, list(x.split(4)))
    sw, rw = torch.ones(4), torch.ones(4, sched.num_slots)
    with pytest.raises(ValueError):
        k1.gossip_mix_peer(x[:4, :3], sw, rw, rows)  # wrong length
    with pytest.raises(TypeError):
        k1.gossip_mix_peer(x[:4].double(), sw, rw, rows)
    with pytest.raises(ValueError):
        k1.gossip_mix_peer(x[:4], sw[:3], rw, rows)
    targets = peer_targets(sched, 0, list(torch.zeros(
        N, sched.num_slots, 5).split(4)))
    with pytest.raises(ValueError):
        k2.window_deliver_peer(x[:4, :2], targets, accumulate=False)


def test_context_over_processes_needs_a_divisible_size(monkeypatch):
    """``init`` inside a process group splits the ranks evenly or raises;
    without a group nothing changes."""
    import bluefog_tpu_torch as pbf
    from bluefog_tpu_torch.parallel import context

    monkeypatch.setattr(context, "_process_group", lambda: (1, 3))
    with pytest.raises(ValueError, match="split over 3"):
        pbf.init(size=8, device="cpu")
    assert not pbf.initialized()
    monkeypatch.undo()
    ctx = pbf.init(size=8, device="cpu")
    try:
        assert (ctx.process_count, ctx.transport) == (1, None)
        assert pbf.rank() == 0 and pbf.owned_ranks() == range(8)
        assert pbf.local_size() == 1
    finally:
        pbf.shutdown()


@pytest.mark.cuda
def test_peer_memory_form_on_the_card(tmp_path):
    """The CUDA form at P = 2: K1's and K2's peer forms bit-equal to the
    virtual kernels (also under ``fuse_apply``, whose pack is published
    without a copy), and the staged buffers reused by calls with different
    payloads while one process's reads run late (they would see a later
    payload if a pack overwrote a buffer before they ran), one exchange or
    two a step; the aperiodic gossip on K1's peer form, its address tables
    bounded over 200 matrices; int32 and int64 payloads; windows freed 20
    times without their peer memory staying."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the peer-memory form runs on the "
                    "card only")
    script = tmp_path / "card.py"
    script.write_text(_CARD_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.runtime.launch", "-np",
         "2", str(script)], capture_output=True, text=True, timeout=600,
        env=env, cwd=REPO)
    assert r.returncode == 0, (r.stdout[-4000:], r.stderr[-8000:])
    assert r.stdout.count("CARD OK") == 2, r.stdout


_CARD_WORKER = '''
import torch
from bluefog_tpu_torch.runtime.launch import initialize_cluster
initialize_cluster()
import bluefog_tpu_torch as bf
from bluefog_tpu_torch.ops import collectives as C, deliver_kernel as K2
from bluefog_tpu_torch.ops import gossip_kernel as K1, windows as W
from bluefog_tpu_torch.topology import ExponentialTwoGraph, build_schedule
ctx = bf.init(size=8)
p, m = bf.process_rank(), 8 // bf.process_count()
own = slice(p * m, (p + 1) * m)
dev = ctx.device
sched = build_schedule(ExponentialTwoGraph(8))
sw, rw, src = K1.schedule_tables(sched, dev)
gen = torch.Generator(device=dev).manual_seed(5)
for dt in (torch.float32, torch.bfloat16):
    x = torch.randn(8, 1 << 20, generator=gen, device=dev).to(dt)
    got = C.neighbor_allreduce(x[own].clone(), sched, backend="kernel")
    assert torch.equal(got, K1.gossip_mix(x, sw, rw, src)[own]), ("k1", dt)
# fuse_apply packs every leaf, the one above 8 MiB too, into one staged
# buffer that the exchange publishes as it is: one launch
leaves = [torch.randn(8, *s, generator=gen, device=dev)
          for s in ((3, 5), ((1 << 21) + 3,), (7,))]
K1.gossip_mix_peer.launches = 0
got = C.fuse_apply(lambda t: C.neighbor_allreduce(t, sched, backend="kernel"),
                   [v[own].clone() for v in leaves])
assert K1.gossip_mix_peer.launches == 1, K1.gossip_mix_peer.launches
for g, v in zip(got, leaves):
    want = K1.gossip_mix(v.reshape(8, -1), sw, rw, src)[own]
    assert torch.equal(g, want.reshape(g.shape)), ("fuse_apply", g.shape)
# write after read: process 0's kernel is queued behind 0.1 s of device
# sleep after its rows were published, so the others run ahead into the next
# calls; a buffer reused before process 0 read it would show their payloads
tr = ctx.transport
sw_o, rw_o = sw[own].contiguous(), rw[own].contiguous()
got = []
for t in range(4):
    x = torch.full((m, 1 << 20), float(t), device=dev)
    x += torch.arange(p * m, (p + 1) * m, device=dev, dtype=x.dtype)[:, None]
    with tr.exchange(sched, [x]) as (rows,):
        if p == 0:
            torch.cuda._sleep(100_000_000)
        got.append(K1.gossip_mix_peer(x, sw_o, rw_o, rows))
for t, g in enumerate(got):
    x = torch.full((8, 1 << 20), float(t), device=dev)
    x += torch.arange(8.0, device=dev)[:, None]
    assert torch.equal(g, K1.gossip_mix(x, sw, rw, src)[own]), ("war", t)
# two exchanges of one shape a call pair, as gradient tracking's step: the
# same staged buffers by parity, process 0 late to each step
got = []
for t in range(3):
    for j in range(2):
        x = torch.full((m, 1 << 20), float(2 * t + j), device=dev)
        x += torch.arange(p * m, (p + 1) * m, device=dev,
                          dtype=x.dtype)[:, None]
        with tr.exchange(sched, [x]) as (rows,):
            if p == 0 and j == 0:
                torch.cuda._sleep(100_000_000)
            got.append(K1.gossip_mix_peer(x, sw_o, rw_o, rows))
for i, g in enumerate(got):
    x = torch.full((8, 1 << 20), float(i), device=dev)
    x += torch.arange(8.0, device=dev)[:, None]
    assert torch.equal(g, K1.gossip_mix(x, sw, rw, src)[own]), ("war2", i)
# the aperiodic gossip on K1's peer form, bit-equal to the virtual K1, and
# the address tables of 200 distinct matrices kept only while the LRU
# keeps their schedules
from bluefog_tpu_torch.ops import transport as T
from bluefog_tpu_torch.topology import one_peer_exp2_mixing_matrix
x = torch.randn(8, 4099, generator=gen, device=dev)
for step in range(3):
    w = one_peer_exp2_mixing_matrix(8, step)
    K1.gossip_mix_peer.launches = 0
    got = C.neighbor_allreduce_aperiodic(x[own].clone(), w)
    assert K1.gossip_mix_peer.launches == 1
    T.activate(None)
    want = C.neighbor_allreduce_aperiodic(x, w)[own]
    T.activate(tr)
    assert torch.equal(got, want), ("aperiodic", step)
staged = [st for pool in tr._staged.values() for st in pool]
import gc, numpy as np
C._aperiodic_tables.cache_clear()
gc.collect()
before = sum(len(st._rows) for st in staged)
rng = np.random.default_rng(3)
for _ in range(200):
    w = rng.uniform(0, 1, (8, 8)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    C.neighbor_allreduce_aperiodic(x[own, :64].clone(), w)
gc.collect()
after = sum(len(st._rows) for pool in tr._staged.values() for st in pool)
assert after <= before + 64, (before, after)
# integer payloads cross the peer memory unchanged
for dt in (torch.int32, torch.int64):
    ints = torch.arange(8 * 5, device=dev, dtype=dt).reshape(8, 5) * 7919
    slots, _ = C.neighbor_allgather(ints[own].clone(), sched)
    src_l = src.long()
    assert torch.equal(slots, ints[src_l][own]), dt
# windows created and freed 20 times: their peer memory goes each time
arenas = len(tr._arenas)
for _ in range(20):
    st = W.win_create(x[own].clone(), sched)
    W.win_free(st)
assert len(tr._arenas) == arenas, (arenas, len(tr._arenas))
srcs, mask = K2.deliver_tables(sched, dev)
y = torch.randn(8, 4099, generator=gen, device=dev)
full = y[:, None].expand(-1, sched.num_slots, -1).clone()
K2.window_deliver(y * 2, full, srcs, mask, 0.5, accumulate=True)
st = W.win_create(y[own].clone(), sched)
W.win_accumulate(st, (y * 2)[own].clone(), dst_weight=0.5)
bf.barrier()
with ctx.transport.updating(st.links):
    torch.cuda.synchronize()
assert torch.equal(st.peers[torch.float32], full[own])
bf.shutdown()
print("CARD OK", p)
'''


if __name__ == "__main__":
    _worker(sys.argv[1])

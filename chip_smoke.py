#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
its last line:

1. Build: compile the hand-written CUDA kernels from ``bluefog_tpu_torch/csrc``
   (K1 ``gossip_mix.cu``, K2 ``window_deliver.cu``, K3
   ``flash_attention.cu`` and ``flash_attention_bwd.cu``, which share
   ``flash_wgmma.cuh``) with nvcc for sm_90a, one process per source, and
   print the seconds it took and ptxas's report: each kernel's registers
   and spills (the bf16 forward's four instantiations among them) and any
   warning.
1b. Ranks over processes (run right after the build, while this process
   holds no tensors): the ResNet-50 main path of phase 3 in this process,
   2 + 3 steps under deterministic cuDNN, as the reference; then the same
   8 ranks spread over P = 2 and P = 4 processes that share the card,
   each group started by the port's launcher (``python -m
   bluefog_tpu_torch.runtime.launch -np P chip_smoke.py --mp-worker ...``),
   each process owning 8 / P ranks.  Each process checks K1's peer form
   (its source rows read from the other processes' buffers through CUDA
   IPC) bit for bit against the virtual K1 on the same stacked inputs, in
   f32 at the main path's length and bf16, through the op layer's kernel
   and plain routes, and times it at that length on a packed staged buffer
   as the main path runs it (all processes' launches of a step between two
   barriers, against the bound of the rows each process's launch must read
   and write); runs the main path for 2 + 3 steps under deterministic cuDNN
   (img/s per process and over all, each process's own device idle share in
   one profiled step, K1's peer launches, one a step since every leaf fuses
   into one staged buffer, the handshake's host microseconds, the pack's
   device time) and saves its parameters, which this process holds against the reference
   within 2^-7; checks K2's peer put then acc bit for bit against the virtual
   K2 and times them; and runs 6 push-sum rounds on the directed Ring(8)
   through K2's peer form (sum(p) exactly 11.5 over the processes, x and p
   bit-equal to the same rounds in one process) and times K2's peer acc.
   At P = 2 the group then runs every other algorithm over the processes,
   against one-process runs this process makes first: gradient tracking on
   MeshGrid2D(8) (BASELINE.json ``configs[3]``) and exact diffusion on
   Ring(8) over ResNet-50, 2 + 3 steps each under deterministic cuDNN
   (parameters and trackers, or master and last psi, within 2^-7 of one
   process's, bit-equality reported; 2 and 1 K1 peer launches a step a
   process); the callable one-peer Exp-2 topology's matrices, 6 rounds of
   the aperiodic gossip over ResNet-50's buffer, each bit-equal to the
   virtual K1 on the same ``W``, the capped form within its cap and over it
   (NaN), and the host time of a call on a new matrix and on a cached one;
   60 CHOCO rounds (``random_block_k(0.25)``) and 2 of ``top_k(0.01)``
   over that buffer, bit-equal to one process; ``pair_gossip``,
   ``neighbor_allgather``, sender-weighted gossip and int64 rows at that
   length, bit-equal to one process; GPT-small at seq 1024 and batch 8 a
   rank, 2 + 3 steps (96 launches of each K3 kernel a step over the
   processes, 1 K1 peer launch a step a process, parameters within 2^-7 of
   one process's), and K1's peer form on GPT's one staged payload, bit-equal
   to its plain twin on the same rows (folded in column slices) and timed
   against its bytes bound.
   Then P = 8, one rank a process, K1's check and times only.  A process
   that fails, or a group that outlives its time limit, fails the phase.
2. K1 against its plain version on the card: ``gossip_mix`` against
   ``gossip_mix_plain`` in f32 and bf16, over Exponential-2(8) and Ring(8), at
   an unaligned length and at the lengths the main path gives it, plus the
   closed form ``W @ x`` on rank-valued rows.  Then times at the main path's
   shapes: the kernel, its plain version, its bound, and one PyTorch call
   that computes the same function (``torch.matmul(W, x)``), which the port
   itself never calls.
3. The main path: decentralized SGD of a full-width ResNet-50 (bf16 compute,
   f32 parameters, 224x224 inputs, per-rank batch 32) over 8 virtual ranks on
   Exponential-2 with ``DistributedNeighborAllreduceOptimizer`` over SGD (lr
   0.01, momentum 0.9), through ``bluefog_tpu_torch.examples.
   synthetic_benchmark``: 2 warm-up and 3 timed steps.  Checks finite losses,
   K1's launch count against the fuse plan, and one step through K1 against
   the same step through the plain gossip path; one more step under
   ``torch.profiler`` gives the device's busy time and idle share.  A full
   garbage collection runs before the timed steps of each path, and each
   step prints the time Python's garbage collector ran in it and the
   caching allocator's cudaMalloc and cudaFree calls; three more steps
   split the host time into the ranks' forward and backward, the SGD step
   and the gossip.
4. K2 against its plain version on the card: ``window_deliver`` against
   ``window_deliver_plain``, put then acc, in f32 and bf16 (and f16, f64),
   at dst_weight 1.0, 0.5 and 1/3, over Exponential-2(8) and the directed
   Ring(8), at an unaligned length and at the WinPut path's window length
   (an aligned 1,000,000 for f16 and f64), plus the closed form
   ``2 * dst_weight * recv_src`` on rank-valued rows.  Then times at the
   main-path shapes (put and acc on Exponential-2, push-sum's acc on the
   directed ring): the kernel, its plain version, its bound, and the PyTorch
   yardstick the port never calls (``torch.index_select`` of the source rows
   for put; the same plus ``add_`` for acc, two calls).
5. The WinPut main path: the same ResNet-50 over 8 virtual ranks with
   ``DistributedWinPutOptimizer`` (``--comm winput``), 2 warm-up and 3 timed
   steps.  Checks finite losses, K2's launch count against the window's
   layout (one launch per dtype per put); profiles one step; splits three
   more steps' host time as in phase 3, with the window round split into
   ``win_sync``, ``win_put``, ``win_update`` and the copy back, and three
   more under deterministic cuDNN.  Then every rank's parameters get their
   own seeded offset, and one step through K2 is held against the same step
   through the plain window path, and against an ATC
   ``DistributedNeighborAllreduceOptimizer`` step from the same state (the
   closed form); last, ``win_update`` is timed.
6. Push-sum: ``win_accumulate`` with the associated scalar ``p`` on the
   directed Ring(8), dst_weight 0.5, over 25,557,032 f32 per rank (ResNet-50's
   parameter count), from unequal weights p_r = 1 + r/8.  Checks that sum(p)
   stays 11.5 exactly and p equals its closed form, that the mass sum(x)
   stays within f32 rounding of its start, that the spread of x / p falls,
   and that the rounds through K2 equal the rounds through the plain path;
   times the rounds and ``win_update_then_collect``.
7. K3 against its twins on the card: the forward kernel's ``o``, ``l`` and
   ``m`` and the backward kernels' ``dq``, ``di``, ``dk`` and ``dv``, each
   kernel fed the same inputs as its twin, at (B, H, T, D) = (8, 12, 1024,
   64) bf16 causal (the GPT path's, q, k and v views of one projection) and
   at small shapes that cover every instantiated kernel: bf16 at D = 32, 64,
   96 and 128, causal and full, and f32 both ways; q, k and v as views of
   one projection, contiguous, or views whose token stride refuses 16-byte
   loads (which the bf16 backward wrappers must copy, and no other case
   may; the forward wrapper copies those too), and the bf16 forward at a
   negative scale.  Each kernel runs twice on the same inputs and must give
   bit-equal results.  Then the three
   kernels' times at the path's shape,
   by profiler device time per call (and by CUDA events, which also count
   the host's pace): each against its bound, its twin and, for the forward,
   ``F.scaled_dot_product_attention``; the backward through the autograd
   function (dQ with di, then dK/dV) against the library call's backward,
   which the port never calls, by CUDA events and by profiler device time,
   kernel by kernel, and the forwards' device time kernel by kernel too.
8. The transformer path: decentralized SGD of a full-width GPT-small (vocab
   50304, width 768, 12 layers, 12 heads, bf16 compute, f32 params) over 8
   virtual ranks on Exponential-2 with
   ``DistributedNeighborAllreduceOptimizer`` over SGD (lr 0.01, momentum
   0.9), ``--model gpt-small --seq-len 1024`` of the synthetic benchmark at
   a per-rank batch of 8: 2 warm-up and 3 timed steps.  Checks finite and
   falling losses, K1's launches against the fuse plan and K3's (12 layers x
   8 ranks = 96 of each kernel per step), and that K3's wrappers copied
   none of the path's q, k, v and dO; one step through K3 against the
   same step through K3's twins from the same state (every gradient, the
   losses and the state after the step); a profiled step and the host
   breakdown, as for the ResNet paths.
9. The centralized baseline: the ResNet-50 path of phase 3 with
   ``DistributedGradientAllreduceOptimizer`` (``--comm allreduce``), 2
   warm-up and 3 timed steps, profiled as phase 3; every rank's parameters
   and momentum must be bit-equal after the steps (the ranks start equal and
   see different batches).  Then the allreduce alone at the fuse plan's
   lengths, against the f64 mean, its bytes bound and
   ``torch.mean(dim=0)``; and, since a step after ``torch.profiler`` has
   run in the process is slower than one before it, the gossip and the
   allreduce paths timed in turns, 16 steps each.  About 21 s on an H100
   80GB HBM3 at 700 W.
10. Hierarchical gossip: the same ResNet-50 with
   ``DistributedHierarchicalNeighborAllreduceOptimizer`` (``--comm
   hierarchical``) at local size 2 (Ring(4) of machines) and 4 (Ring(2)),
   each 2 + 3 steps: K1's launches against the fuse plan, one step through
   K1 against the plain step, each machine's local ranks bit-equal after
   the mix, and the mix's time through K1 and the plain path.  About 6 s
   for each local size on that card.
11. ``examples.imagenet_resnet`` (BASELINE.json ``configs[1]``) on uint8
   TFRecord shards written here (1,024 train and 256 val 224x224x3 images,
   1000 classes) through the port's writer and its native CRC library: 8
   ranks x 32, 2 epochs of 4 steps with 1 warm-up epoch, once with
   ``--optimizer neighbor`` (K1's launches against the fuse plan) and once
   with ``allreduce``; per epoch img/s, the host's wait on the loader, val
   top-1 and the idle share of a profiled step (the profiler's reading
   of its trace left out of the epoch's time); finite losses.  About 21 s
   on that card, 1-2 s of it writing the shards.
12. ``examples.mnist_decentralized`` (``configs[0]``) at its defaults, 8
   ranks on a ring, 48 steps: it must reach its own OK (mean local accuracy
   over 0.9), with one K1 launch a step.  About 1-2 s on that card.
13. Routing: MeshGrid2D(8) (3 slots) and Star(8) (7 slots) are not
   circulant, and ``'auto'`` sends them to K1 and K2 all the same (the
   TPU's remote DMA needs a uniform shift; a read of a neighbour's row
   does not).  K1 against its plain version bit for bit in f32 and bf16
   at an unaligned length and the main path's first, through the op layer
   too (one launch, equal to the plain path), K2 put then acc likewise,
   one K2 launch for a put on such a window, and K1's time on each at the
   main path's lengths against its bound.
14. Dynamic: the ResNet-50 path of phase 3 with one-peer dynamic Exp-2
   (``one_peer_exponential_two_schedules(8)``), 2 + 3 steps and a profiled
   one: 5 one-slot K1 launches a step, the phases cycling 1, 2, 4, 1, 2, 4
   by communication round, a step through K1 against the plain step, and
   3 steps of the callable form (``one_peer_exp2_mixing_matrix``, full and
   ``max_rotations=1``) bit-equal to the sequence form from one state (the
   JAX dryrun's check); then K1 at one slot against its bound.
15. Tracking: the same path under gradient tracking on Exp-2 and on
   MeshGrid2D (BASELINE.json ``configs[3]``), then exact diffusion on
   Ring(8): K1 10, 10 and 5 times a step, a step through K1 against the
   plain step, and GT's invariant (per coordinate, sum_i y_i = sum_i u_i
   within 1e-5 of max |sum_i u_i|) after three of the steps.
16. CHOCO: ``choco_gossip`` alone over an (8, 25,557,032) f32 buffer of
   random values (ResNet-50's parameter count), ``random_block_k(0.25)``
   at gamma 0.3 on Ring(8): the dryrun's two measures after its 60 rounds
   (the max deviation from the mean against its start, printed; the
   mean's drift, under 1e-4) and the round where the max deviation first
   falls under 5% of its start (it must, within 200); at this width the
   contiguous blocks cover the least-covered stretch a few times in 60
   rounds, so the 5% the dryrun asserts at 6 values a rank comes a few
   rounds later.  Then the ResNet-50 path under
   ``DistributedChocoSGDOptimizer`` (``random_block_k(0.1)``), which
   launches no kernel.
17. Examples: ``average_consensus`` on its five topologies (50 K1 launches
   each), ``choco_sgd`` and ``convergence_comparison`` at their defaults,
   each to its OK, with its seconds.
18. Report: a ``kernels:`` line, a line for K1 on this slice's paths and a
   line for the allreduce (not a TPU kernel), the kernels' JSON line (K1,
   K2 and K3's three kernels; K1's entry also carries its one-slot times,
   its launches on the new paths and its times on the grid and the star),
   the card's name and power limit from nvidia-smi, and the result line.
   The JSON line also holds K1's and K2's peer forms
   (``gossip_mix_peer``, ``window_deliver_peer``) at P = 4, with the other
   process counts under ``by_processes``, and a line sums phase 1b up.

It needs one CUDA device and exits with status 2 when there is none.
"""

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import torch

N_RANKS = 8
BATCH = 32
WARMUP, TIMED = 2, 3
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
F32_TOL = 1e-6                # |kernel - plain| <= tol * (1 + |plain|)
BF16_TOL = 2.0 ** -7          # one bf16 ulp, relative
F16_TOL = 2.0 ** -10          # one f16 ulp, relative
F64_TOL = 1e-15
STEP_TOL = 2.0 ** -7          # kernel-path step vs plain-path step
ALLREDUCE_TOL = 4e-6          # f32 mean of 8 ranks vs the f64 mean
PUSH_ROUNDS = 6


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps, warm=2):
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls,
    between two CUDA events, after ``warm`` untimed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, warm=2):
    """Mean device milliseconds of ``fn``'s kernels, copies and fills per
    call, summed from a ``torch.profiler`` trace of ``reps`` calls, and the
    same per kernel name, largest first."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
    return (sum(by_name.values()),
            sorted(by_name.items(), key=lambda kv: -kv[1]))


def max_err(out, ref):
    """(max |out - ref|, max |out - ref| / (1 + |ref|)) in f64."""
    d = (out.double() - ref.double()).abs()
    return float(d.max()), float((d / (1 + ref.double().abs())).max())


def _ptxas_report(log):
    """ptxas's ``-v`` report per kernel: (name, registers, spill stores,
    spill loads), in build order, and the log's warning lines and notes on
    wgmma.  Names are demangled by ``c++filt`` where the host has it."""
    rows, name, spills, warnings = [], None, (0, 0), []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append([name, int(m.group(1)), *spills])
            name, spills = None, (0, 0)
        # warnings, and ptxas's notes on serialised wgmma (C7512, C7519,
        # C7520)
        if "arning" in line or "C75" in line:
            warnings.append(line.strip())
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and rows:
        names = subprocess.run([cxxfilt], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
        for row, pretty in zip(rows, names):
            row[0] = pretty.replace("(anonymous namespace)::", "")
    return rows, warnings


def phase_build():
    from bluefog_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    print(f"[build] {', '.join(p.name for p in _build._sources())} -> "
          f"sm_90a in {secs:.2f} s")
    rows, warnings = _ptxas_report(_build.build_log())
    if not rows:
        print("[build] the library was already built: no ptxas report")
    for name, regs, st, ld in rows:
        print(f"[build] {name[:70]}: {regs} registers, spill stores {st} "
              f"bytes, spill loads {ld} bytes")
    for line in warnings:
        print(f"[build] {line}")
    fwd = [r for r in rows if "fwd_wgmma" in r[0]]
    check(not rows or len(fwd) == 4,
          f"ptxas reported {len(fwd)} instantiations of the bf16 forward, "
          "expected 4 (D = 32, 64, 96, 128)")
    return secs


def phase_k1(device, main_lengths):
    """K1 against its plain version, and K1's times at the main path's
    shapes.  ``main_lengths``: the per-rank lengths of the f32 buffers one
    main-path step hands the kernel."""
    from bluefog_tpu_torch.ops.gossip_kernel import (
        gossip_mix, gossip_mix_plain, schedule_tables)
    from bluefog_tpu_torch.topology import (
        ExponentialTwoGraph, RingGraph, build_schedule)

    gen = torch.Generator(device=device).manual_seed(1234)
    main_err = 0.0
    for topo in (ExponentialTwoGraph(N_RANKS), RingGraph(N_RANKS)):
        sched = build_schedule(topo)
        sw, rw, src = schedule_tables(sched, device)
        cases = ([(torch.float32, n)
                  for n in [1_000_003] + sorted(set(main_lengths))]
                 + [(torch.bfloat16, n) for n in (1_000_003, main_lengths[0])])
        for dtype, length in cases:
            x = torch.randn(N_RANKS, length, generator=gen, device=device,
                            dtype=torch.float32).to(dtype)
            out = gossip_mix(x, sw, rw, src)
            ref = gossip_mix_plain(x, sw, rw, src)
            torch.cuda.synchronize()
            check(out.dtype == dtype and out.shape == x.shape,
                  f"K1 returned {out.dtype} {tuple(out.shape)}")
            abs_err, rel_err = max_err(out, ref)
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            print(f"[k1] {topo.name} {str(dtype)[6:]} L={length}: max abs "
                  f"err {abs_err:.3e}, max rel err {rel_err:.3e} "
                  f"(tol {tol:.3e})")
            check(rel_err <= tol, f"K1 disagrees with its plain version on "
                  f"{topo.name} {dtype} L={length}: {rel_err} > {tol}")
            if dtype == torch.float32 and length in main_lengths:
                main_err = max(main_err, abs_err)
        # closed form on rank-valued rows: out[i] = (W @ arange(n))[i]
        xr = torch.arange(N_RANKS, device=device, dtype=torch.float32)
        out = gossip_mix(xr[:, None].expand(N_RANKS, 257).contiguous(),
                         sw, rw, src)
        want = torch.as_tensor(topo.weights, device=device) @ xr.double()
        err = float((out.double() - want[:, None]).abs().max())
        print(f"[k1] {topo.name} closed form W @ arange: max abs err "
              f"{err:.3e}")
        check(err <= 1e-5, f"K1 misses the closed form on {topo.name}")

    # times at the main path's shapes, Exponential-2, f32
    sched = build_schedule(ExponentialTwoGraph(N_RANKS))
    sw, rw, src = schedule_tables(sched, device)
    w = torch.as_tensor(sched.mixing_matrix(), dtype=torch.float32,
                        device=device)
    k = sched.num_slots
    ms = plain_ms = lib_ms = 0.0
    n_bytes = 0
    for length in main_lengths:
        x = torch.randn(N_RANKS, length, generator=gen, device=device)
        t_k = time_ms(lambda: gossip_mix(x, sw, rw, src), reps=20)
        t_p = time_ms(lambda: gossip_mix_plain(x, sw, rw, src), reps=5)
        t_l = time_ms(lambda: torch.matmul(w, x), reps=20)
        print(f"[k1] time exp2 f32 ({N_RANKS}, {length}): kernel {t_k:.4f} "
              f"ms, plain {t_p:.4f} ms, torch.matmul(W, x) {t_l:.4f} ms")
        ms, plain_ms, lib_ms = ms + t_k, plain_ms + t_p, lib_ms + t_l
        # x read once, out written once, plus the (n,), (n,K), (n,K) tables
        n_bytes += 2 * x.numel() * 4 + N_RANKS * (1 + 2 * k) * 4
    n_flops = sum(N_RANKS * n * (2 * k + 1) for n in main_lengths)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = n_flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_flops)
    print(f"[k1] one main-path step's gossip ({len(main_lengths)} launches, "
          f"{n_bytes / 1e9:.3f} GB, {n_flops / 1e9:.3f} GFLOP): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms "
          f"({'bytes' if t_bytes >= t_flops else 'operations'}), "
          f"{bound_ms / ms:.1%} of the bound")
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "library_ms": lib_ms}


@contextlib.contextmanager
def step_probe(trainer):
    """Per-step host counters around ``trainer.step``, one dict per step in
    the yielded list: the milliseconds Python's garbage collector ran and
    the generations it collected, and the cudaMalloc and cudaFree calls of
    PyTorch's caching allocator (``torch.cuda.memory_stats`` segment
    counts)."""
    rows = []
    gc_now = {"t0": 0.0, "ms": 0.0, "gens": []}

    def on_gc(phase, info):
        if phase == "start":
            gc_now["t0"] = time.perf_counter()
        else:
            gc_now["ms"] += (time.perf_counter() - gc_now["t0"]) * 1e3
            gc_now["gens"].append(info["generation"])

    inner = trainer.step

    def step():
        before = torch.cuda.memory_stats()
        gc_now["ms"], gc_now["gens"] = 0.0, []
        out = inner()
        after = torch.cuda.memory_stats()
        rows.append({
            "gc_ms": gc_now["ms"], "gc_gens": list(gc_now["gens"]),
            "mallocs": (after["segment.all.allocated"]
                        - before["segment.all.allocated"]),
            "frees": after["segment.all.freed"] - before["segment.all.freed"]})
        return out

    gc.callbacks.append(on_gc)
    trainer.step = step
    try:
        yield rows
    finally:
        gc.callbacks.remove(on_gc)
        del trainer.step


def _probe_text(row):
    return (f"gc {row['gc_ms']:.2f} ms (generations {row['gc_gens']}), "
            f"cudaMalloc {row['mallocs']}, cudaFree {row['frees']}")


def phase_main_path(trainer, kernels, tag, what, unit="img", top=8):
    """Drive a trainer's path: every kernel wrapper's launch count in
    ``kernels`` (wrapper -> launches per step) is set to 0 just before the
    run and read just after it, and must equal its launches per step times
    the steps.  Returns the counts, wrapper name -> launches."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import (
        profile_step, run)

    # collect the garbage of earlier phases (the profiler's events among it)
    # here, so that no path's steps pay for another's
    tracked = len(gc.get_objects())
    t0 = time.perf_counter()
    unreachable = gc.collect()
    gc_ms = (time.perf_counter() - t0) * 1e3
    print(f"[{tag}] before the run: gc.collect() {gc_ms:.2f} ms, "
          f"{unreachable} unreachable of {tracked} tracked objects")
    torch.cuda.reset_peak_memory_stats()
    with step_probe(trainer) as probe:
        for kernel in kernels:
            kernel.launches = 0
        res = run(trainer, WARMUP, TIMED)
        launches = {kernel.__name__: kernel.launches for kernel in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, loss in enumerate(res["losses"]):
        ms = (f"{res['step_ms'][i - WARMUP]:.2f} ms, " if i >= WARMUP
              else "warm-up, ")
        print(f"[{tag}] step {i}: {ms}mean loss {loss.mean():.5f} "
              f"(per rank {[round(float(v), 4) for v in loss]}); "
              f"{_probe_text(probe[i])}")
        check(all(math.isfinite(float(v)) for v in loss),
              f"non-finite loss at step {i} of the {tag} path")
    steps = WARMUP + TIMED
    mean_ms = sum(res["step_ms"]) / TIMED
    print(f"[{tag}] {what}: step ms {[round(t, 2) for t in res['step_ms']]}, "
          f"mean {mean_ms:.2f} ms, {res['samples_per_s']:.1f} {unit}/s over "
          f"all ranks, peak memory {peak_gb:.2f} GB")
    for kernel, per_step in kernels.items():
        got = launches[kernel.__name__]
        print(f"[{tag}] {kernel.__name__} launches {got} = {per_step} per "
              f"step x {steps} steps expected")
        check(got == per_step * steps,
              f"{kernel.__name__} launched {got} times on the {tag} path, "
              f"expected {per_step * steps}")
    prof = profile_step(trainer, top=top)
    print(f"[{tag}] one more step under torch.profiler: {prof['busy_ms']:.2f}"
          f" ms on the device in {prof['kernels']} kernels, copies and "
          f"fills; device idle {1 - prof['busy_ms'] / mean_ms:.1%} of the "
          f"unprofiled mean step ({prof['idle_share']:.1%} of the profiled "
          f"one, {prof['wall_ms']:.2f} ms)")
    for name, ms, count in prof["top"]:
        print(f"[{tag}]   {ms:8.3f} ms {count:5d}x {name[:90]}")
    return launches, res


def _snapshot(trainer, skip=()):
    """Detached views of the trainer's state (the same storage, outside
    autograd) and a copy of each."""
    state = {k: v.detach() for k, v in trainer.state().items()
             if not k.startswith(skip)}
    return state, {k: v.clone() for k, v in state.items()}


def _compare(state, after, tag, what, loss_a, loss_b):
    worst = 0.0
    for k, v in state.items():
        d = float((after[k].double() - v.double()).abs().max())
        scale = float(v.double().abs().max())
        worst = max(worst, d / max(scale, 1e-12))
    loss_d = float((loss_a - loss_b).abs().max())
    print(f"[{tag}] {what} over {len(state)} tensors: max |diff| / max "
          f"|value| {worst:.3e} (tol {STEP_TOL:.3e}), max loss diff "
          f"{loss_d:.3e}")
    check(worst <= STEP_TOL, f"{tag}: {what} differs: {worst}")
    check(loss_d <= STEP_TOL, f"{tag}: {what}: losses differ: {loss_d}")


@contextlib.contextmanager
def deterministic_cudnn():
    """Deterministic cuDNN algorithms inside, the caller's settings after."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def _counters(opt):
    """The optimizer's step counters, to put back after a trial step."""
    return {k: getattr(opt, k) for k in ("count", "comm_count", "first")
            if hasattr(opt, k)}


def _restore(opt, counters):
    for k, v in counters.items():
        setattr(opt, k, v)


def phase_step_parity(trainer, tag):
    """One step through the kernel backend against the same step through the
    plain backend, from the same state, with deterministic cuDNN."""
    opt = trainer.opt
    state, snap = _snapshot(trainer)
    counters = _counters(opt)
    try:
        with deterministic_cudnn():
            opt.backend = "kernel"
            loss_k = trainer.step()
            after_k = {k: v.clone() for k, v in state.items()}
            for k, v in state.items():
                v.copy_(snap[k])
            _restore(opt, counters)
            opt.backend = "plain"
            loss_p = trainer.step()
            torch.cuda.synchronize()
    finally:
        opt.backend = "auto"
    _compare(state, after_k, tag, "kernel-path step vs plain-path step",
             loss_k, loss_p)


def spread_ranks(trainer, seed):
    """Give every rank's parameters their own seeded offset, 10% of each
    tensor's mean magnitude, so that a step reading a wrong rank's slot
    lands well outside the parity tolerance."""
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    with torch.no_grad():
        for p in trainer.params.values():
            p.add_(torch.randn(p.shape, generator=gen, device=p.device)
                   * (0.1 * p.abs().mean()))


def phase_closed_form(trainer):
    """A WinPut step against an ATC gossip step (K1) from the same state:
    with one static topology the put lands every neighbour's new parameters
    before the merge, so the two are the same step."""
    from bluefog_tpu_torch.optim import DistributedNeighborAllreduceOptimizer
    from bluefog_tpu_torch.topology import ExponentialTwoGraph

    win_opt = trainer.opt
    state, snap = _snapshot(trainer, skip=("window.",))
    count = win_opt.count
    try:
        with deterministic_cudnn():
            loss_w = trainer.step()
            after_w = {k: v.clone() for k, v in state.items()}
            for k, v in state.items():
                v.copy_(snap[k])
            trainer.opt = DistributedNeighborAllreduceOptimizer(
                win_opt.base, topology=ExponentialTwoGraph(N_RANKS), atc=True)
            trainer.opt.count = count
            loss_a = trainer.step()
            torch.cuda.synchronize()
    finally:
        trainer.opt = win_opt
    _compare(state, after_w, "winput", "WinPut step vs ATC "
             "neighbor_allreduce step (closed form)", loss_w, loss_a)


def phase_host_breakdown(trainer, tag, steps=3):
    """Where a step's host time goes: ``steps`` more steps with each part of
    the optimizer's step between two device synchronizes on the host clock
    (the base step, and the combine: the gossip or the window round that
    computes the mixed parameters; the ranks' forward and backward and the
    writes of the mix into the parameters are the rest of the step),
    beside the step probe's counters."""
    from bluefog_tpu_torch.ops import windows as W

    opt = trainer.opt
    parts = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                parts[name] = (parts.get(name, 0.0)
                               + (time.perf_counter() - t0) * 1e3)
        return call

    names = (["win_sync", "win_put", "win_update"] if opt.window is not None
             else [])
    saved = {n: getattr(W, n) for n in names}
    opt.base.step = timed("base", opt.base.step)
    opt._mix = timed("combine", opt._mix)
    for n in names:
        setattr(W, n, timed(n, saved[n]))
    rows = []
    try:
        with step_probe(trainer) as probe:
            for _ in range(steps):
                parts.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.step()
                torch.cuda.synchronize()
                rows.append(((time.perf_counter() - t0) * 1e3, dict(parts)))
    finally:
        del opt.base.step, opt._mix
        for n, fn in saved.items():
            setattr(W, n, fn)
    for i, ((total, t), row) in enumerate(zip(rows, probe)):
        window = ""
        if names:
            rest = t["combine"] - sum(t[n] for n in names)
            window = (f" (win_sync {t['win_sync']:.2f}, win_put "
                      f"{t['win_put']:.2f}, win_update {t['win_update']:.2f},"
                      f" rest {rest:.2f})")
        print(f"[{tag}] host breakdown, step {i}: {total:.2f} ms = ranks' "
              f"forward and backward, and the mix's writes "
              f"{total - t['base'] - t['combine']:.2f} "
              f"+ SGD step {t['base']:.2f} + combine {t['combine']:.2f}"
              f"{window}; {_probe_text(row)}")


def _bound(n_bytes, n_flops, flops_per_s=F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = n_flops / flops_per_s * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def phase_k2(device, win_len):
    """K2 against its plain version, the closed form, and K2's times at the
    main-path shapes.  ``win_len``: the per-rank length of the WinPut
    path's one f32 window buffer."""
    from bluefog_tpu_torch.ops.deliver_kernel import (
        deliver_tables, window_deliver, window_deliver_plain)
    from bluefog_tpu_torch.topology import (
        ExponentialTwoGraph, RingGraph, build_schedule)

    gen = torch.Generator(device=device).manual_seed(4321)
    main_err = 0.0
    for topo in (ExponentialTwoGraph(N_RANKS),
                 RingGraph(N_RANKS, connect_style=1)):
        sched = build_schedule(topo)
        src, mask = deliver_tables(sched, device)
        k = sched.num_slots
        # f32 and bf16 at the WinPut path's length; f16 (f32 arithmetic) and
        # f64 at an aligned one, which takes the 16-byte vector path
        for dtype, tol, lengths in (
                (torch.float32, F32_TOL, (1_000_003, win_len)),
                (torch.bfloat16, BF16_TOL, (1_000_003, win_len)),
                (torch.float16, F16_TOL, (1_000_003, 1_000_000)),
                (torch.float64, F64_TOL, (1_000_003, 1_000_000))):
            for length in lengths:
                x = torch.randn(N_RANKS, length, generator=gen,
                                device=device).to(dtype)
                start = torch.randn(N_RANKS, k, length, generator=gen,
                                    device=device).to(dtype)
                for w in (1.0, 0.5, 1 / 3):
                    b_k, b_p = start.clone(), start.clone()
                    for acc in (False, True):
                        window_deliver(x, b_k, src, mask, w, accumulate=acc)
                        window_deliver_plain(x, b_p, src, mask, w,
                                             accumulate=acc)
                        torch.cuda.synchronize()
                        abs_err, rel_err = max_err(b_k, b_p)
                        mode = "acc" if acc else "put"
                        print(f"[k2] {topo.name} {str(dtype)[6:]} "
                              f"L={length} dst_weight={w:.6g} {mode}: max abs "
                              f"err {abs_err:.3e}, max rel err "
                              f"{rel_err:.3e} (tol {tol:.3e})")
                        check(rel_err <= tol,
                              f"K2 disagrees with its plain version on "
                              f"{topo.name} {dtype} L={length} {mode}: "
                              f"{rel_err} > {tol}")
                        if dtype == torch.float32 and length == win_len:
                            main_err = max(main_err, abs_err)
                    del b_k, b_p
                del x, start
        # closed form on rank-valued rows: put then acc leave 2 w recv_src
        xr = torch.arange(N_RANKS, device=device, dtype=torch.float32)
        bufs = torch.full((N_RANKS, k, 257), -1.0, device=device)
        for acc in (False, True):
            window_deliver(xr[:, None].expand(N_RANKS, 257).contiguous(),
                           bufs, src, mask, 0.5, accumulate=acc)
        want = 2 * 0.5 * src.double()[:, :, None]
        err = float((bufs.double() - want).abs().max())
        print(f"[k2] {topo.name} closed form put+acc = 2 w recv_src: max abs "
              f"err {err:.3e}")
        check(err == 0.0, f"K2 misses the closed form on {topo.name}")

    def timed(topo, accumulate, w, label):
        sched = build_schedule(topo)
        src, mask = deliver_tables(sched, device)
        k = sched.num_slots
        x = torch.randn(N_RANKS, win_len, generator=gen, device=device)
        bufs = torch.randn(N_RANKS, k, win_len, generator=gen, device=device)
        t_k = time_ms(lambda: window_deliver(x, bufs, src, mask, w,
                                             accumulate=accumulate), reps=20)
        t_p = time_ms(lambda: window_deliver_plain(
            x, bufs, src, mask, w, accumulate=accumulate), reps=5)
        idx = src.reshape(-1).long()
        if accumulate:
            flat = bufs.view(N_RANKS * k, win_len)
            t_l = time_ms(lambda: flat.add_(torch.index_select(x, 0, idx)),
                          reps=20)
        else:
            t_l = time_ms(lambda: torch.index_select(x, 0, idx), reps=20)
        # the payload read once, every slot written once (and read once for
        # acc), the (n, K) int32 tables read once
        n_bytes = (x.numel() * 4 + (2 if accumulate else 1) * bufs.numel() * 4
                   + 2 * N_RANKS * k * 4)
        n_flops = bufs.numel() * (2 if accumulate else 1)
        bound_ms, bound_by = _bound(n_bytes, n_flops)
        lib = ("torch.index_select + add_ (two calls)" if accumulate
               else "torch.index_select")
        print(f"[k2] time {label} f32 ({N_RANKS}, {k}, {win_len}), "
              f"dst_weight={w}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"{lib} {t_l:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{n_bytes / 1e9:.3f} GB), {bound_ms / t_k:.1%} of the bound")
        del x, bufs
        return {"ms": t_k, "plain_ms": t_p, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": t_l}

    put = timed(ExponentialTwoGraph(N_RANKS), False, 1.0, "put exp2")
    acc = timed(ExponentialTwoGraph(N_RANKS), True, 1.0, "acc exp2")
    push = timed(RingGraph(N_RANKS, connect_style=1), True, 0.5,
                 "push-sum acc ring(directed)")
    return {"max_abs_err": main_err, **put}, acc, push


BF16_PEAK_FLOPS_PER_S = 989e12  # H100 SXM dense bf16, NVIDIA's data sheet
K3_PATH_SHAPE = (8, 12, 1024, 64)  # GPT-small at T = 1024, per-rank batch 8
# (B, H, T, D, dtype, causal, layout): the path's shape; the JAX default
# seq-len; the reference's own f32 shape both ways; every bf16 head dim the
# kernels instantiate, causal and full, at T that are no power of two among
# them; a T that is no power of two at the least eligible D.  Layout "proj":
# q, k and v are views of one (B, T, 3 H D) projection, as the GPT passes
# them; "dense": contiguous (B, H, T, D); "odd": views of a (B, T, 3 H D +
# 4) buffer, whose token stride refuses 16-byte loads, so that the bf16
# backward wrappers copy them first.
K3_CASES = [(*K3_PATH_SHAPE, torch.bfloat16, True, "proj"),
            (32, 12, 128, 64, torch.bfloat16, True, "dense"),
            (2, 4, 256, 64, torch.bfloat16, False, "proj"),
            (2, 4, 256, 64, torch.bfloat16, True, "odd"),
            (2, 4, 256, 64, torch.float32, True, "dense"),
            (2, 4, 256, 64, torch.float32, False, "dense"),
            (1, 2, 384, 32, torch.bfloat16, True, "dense"),
            (1, 2, 384, 32, torch.bfloat16, False, "proj"),
            (1, 2, 384, 32, torch.float32, True, "dense"),
            (2, 3, 320, 96, torch.bfloat16, True, "proj"),
            (2, 3, 320, 96, torch.bfloat16, False, "dense"),
            (2, 3, 192, 128, torch.bfloat16, True, "dense"),
            (2, 3, 192, 128, torch.bfloat16, False, "proj")]
# max |kernel - twin| over max |twin|: o and the gradients one bf16 step
# (2^-8) of slack past a rounding the two may place differently; f32 sums in
# another order; l, m and di are f32 in both
K3_TOL = {torch.bfloat16: {"o": 2.0 ** -7, "grad": 2.0 ** -6},
          torch.float32: {"o": 1e-5, "grad": 1e-5}}
K3_RESIDUAL_TOL = 1e-5


def _qkv_views(b, h, t, d, dtype, gen, device, pad=0):
    """q, k, v as the GPT passes them to K3: (B, H, T, D) views of one
    (B, T, 3 H D + pad) projection."""
    qkv = torch.randn(b, t, 3 * h * d + pad, generator=gen, device=device,
                      dtype=torch.float32).to(dtype)
    return [x.unflatten(-1, (h, d)).transpose(1, 2)
            for x in qkv[..., :3 * h * d].split(h * d, dim=-1)]


def _k3_inputs(b, h, t, d, dtype, layout, gen, device):
    if layout == "dense":
        return [torch.randn(b, h, t, d, generator=gen, device=device)
                .to(dtype) for _ in range(3)]
    return _qkv_views(b, h, t, d, dtype, gen, device,
                      pad=4 if layout == "odd" else 0)


def _k3_work(b, h, t, d, causal, elem):
    """(flops, bytes) of each K3 kernel on these inputs: the (query, key)
    pairs the mask keeps times 2 D per product (forward: S and P V; dK/dV: S,
    dP, dV, dK; dQ: S, dP, dQ), and each input read and each output written
    once (dQ reads o too and writes di)."""
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tile = b * h * t * d * elem
    rows = b * h * t * 4
    return {"fwd": (4 * d * pairs, 4 * tile + 2 * rows),
            "dkv": (8 * d * pairs, 6 * tile + 3 * rows),
            "dq": (6 * d * pairs, 6 * tile + 3 * rows)}


def _rel(got, ref):
    """(max |got - ref|, that over max |ref|) in f64."""
    abs_err = float((got.double() - ref.double()).abs().max())
    return abs_err, abs_err / max(float(ref.double().abs().max()), 1e-30)


def phase_k3(device):
    """K3's three kernels against their twins at every shape of K3_CASES,
    each kernel fed the same inputs as its twin, dQ's di against the f32
    sum, and each kernel launched twice on the same inputs for bit-equal
    results; then their times at the GPT path's shape against their bounds,
    their twins and ``F.scaled_dot_product_attention``, which the port never
    calls."""
    import torch.nn.functional as F
    from bluefog_tpu_torch.ops import flash_kernel as fk

    gen = torch.Generator(device=device).manual_seed(2024)
    path_err = {}
    for b, h, t, d, dtype, causal, layout in K3_CASES:
        scale = 1.0 / math.sqrt(d)
        q, k, v = _k3_inputs(b, h, t, d, dtype, layout, gen, device)
        do = torch.randn(b, h, t, d, generator=gen, device=device).to(dtype)
        kw = {"causal": causal, "scale": scale}
        copies = fk.flash_backward_dq.copies + fk.flash_backward_dkv.copies
        fwd_copies = fk.flash_forward.copies
        o, l, m = fk.flash_forward(q, k, v, **kw)
        o_2, l_2, m_2 = fk.flash_forward(q, k, v, **kw)
        o_p, l_p, m_p = fk.flash_forward_plain(q, k, v, **kw)
        dq, di = fk.flash_backward_dq(q, k, v, do, l_p, m_p, o_p, **kw)
        dq_p, di_p = fk.flash_backward_dq_plain(q, k, v, do, l_p, m_p, o_p,
                                                **kw)
        dk, dv = fk.flash_backward_dkv(q, k, v, do, l_p, m_p, di_p, **kw)
        dk_p, dv_p = fk.flash_backward_dkv_plain(q, k, v, do, l_p, m_p, di_p,
                                                 **kw)
        # a second launch of each backward kernel on the same inputs
        dq_2, di_2 = fk.flash_backward_dq(q, k, v, do, l_p, m_p, o_p, **kw)
        dk_2, dv_2 = fk.flash_backward_dkv(q, k, v, do, l_p, m_p, di_p, **kw)
        torch.cuda.synchronize()
        copies = (fk.flash_backward_dq.copies + fk.flash_backward_dkv.copies
                  - copies)
        fwd_copies = fk.flash_forward.copies - fwd_copies
        # q, k and v of the four backward calls and of the two forward ones
        odd = layout == "odd" and dtype == torch.bfloat16
        want, fwd_want = (12, 6) if odd else (0, 0)
        check(copies == want, f"K3's backward wrappers copied {copies} "
              f"inputs of a {layout} {dtype} case, expected {want}")
        check(fwd_copies == fwd_want, f"K3's forward wrapper copied "
              f"{fwd_copies} inputs of a {layout} {dtype} case, expected "
              f"{fwd_want}")
        same = all(torch.equal(x, y) for x, y in (
            (o, o_2), (l, l_2), (m, m_2)))
        check(same, f"two launches of K3's forward differ at ({b}, {h}, "
              f"{t}, {d}) {dtype} causal={causal}")
        same = all(torch.equal(x, y) for x, y in (
            (dq, dq_2), (di, di_2), (dk, dk_2), (dv, dv_2)))
        check(same, f"two launches of K3's backward differ at ({b}, {h}, "
              f"{t}, {d}) {dtype} causal={causal}")
        tol = K3_TOL[dtype]
        readings = []
        for name, got, ref, lim in (
                ("o", o, o_p, tol["o"]), ("l", l, l_p, K3_RESIDUAL_TOL),
                ("m", m, m_p, K3_RESIDUAL_TOL),
                ("di", di, di_p, K3_RESIDUAL_TOL),
                ("dk", dk, dk_p, tol["grad"]), ("dv", dv, dv_p, tol["grad"]),
                ("dq", dq, dq_p, tol["grad"])):
            check(got.dtype == ref.dtype and got.shape == ref.shape,
                  f"K3 {name} is {got.dtype} {tuple(got.shape)}, its twin "
                  f"{ref.dtype} {tuple(ref.shape)}")
            abs_err, rel = _rel(got, ref)
            readings.append(f"{name} {rel:.2e}/{lim:.1e}")
            check(math.isfinite(rel) and rel <= lim,
                  f"K3 {name} disagrees with its twin at (B, H, T, D) = "
                  f"({b}, {h}, {t}, {d}) {dtype} causal={causal}: {rel} > "
                  f"{lim}")
            if (b, h, t, d) == K3_PATH_SHAPE:
                kernel = {"o": "fwd", "l": "fwd", "m": "fwd", "di": "dq",
                          "dk": "dkv", "dv": "dkv", "dq": "dq"}[name]
                path_err[kernel] = max(path_err.get(kernel, 0.0), abs_err)
        print(f"[k3] (B, H, T, D) = ({b}, {h}, {t}, {d}) {str(dtype)[6:]} "
              f"causal={causal} {layout}: max |kernel - twin| / max |twin| "
              f"(tol): {', '.join(readings)}; forward and backward twice "
              f"bit-equal; inputs copied: {fwd_copies} by the forward, "
              f"{copies} by the backward")
        del q, k, v, do, o, l, m, o_p, l_p, m_p, di, di_p, dk, dv, dk_p
        del dv_p, dq, dq_p, dq_2, di_2, dk_2, dv_2, o_2, l_2, m_2

    # a negative scale, which the bf16 forward's wrapper folds into q
    q, k, v = _qkv_views(2, 4, 256, 64, torch.bfloat16, gen, device)
    kw = {"causal": True, "scale": -0.125}
    readings = [_rel(x, y)[1] for x, y in zip(
        fk.flash_forward(q, k, v, **kw),
        fk.flash_forward_plain(q, k, v, **kw))]
    print(f"[k3] bf16 causal forward at scale -0.125: o, l, m "
          f"{', '.join(f'{r:.2e}' for r in readings)} of the twin's scale")
    check(readings[0] <= K3_TOL[torch.bfloat16]["o"]
          and max(readings[1:]) <= K3_RESIDUAL_TOL,
          f"K3's forward disagrees with its twin at a negative scale: "
          f"{readings}")

    # times at the path's shape, causal bf16, q, k, v views of one projection
    b, h, t, d = K3_PATH_SHAPE
    kw = {"causal": True, "scale": 1.0 / math.sqrt(d)}
    q, k, v = _qkv_views(b, h, t, d, torch.bfloat16, gen, device)
    do = torch.randn(b, h, t, d, generator=gen, device=device).to(
        torch.bfloat16)
    o, l, m = fk.flash_forward(q, k, v, **kw)
    _, di = fk.flash_backward_dq(q, k, v, do, l, m, o, **kw)
    calls = {
        "fwd": (lambda: fk.flash_forward(q, k, v, **kw),
                lambda: fk.flash_forward_plain(q, k, v, **kw)),
        "dkv": (lambda: fk.flash_backward_dkv(q, k, v, do, l, m, di, **kw),
                lambda: fk.flash_backward_dkv_plain(q, k, v, do, l, m, di,
                                                    **kw)),
        "dq": (lambda: fk.flash_backward_dq(q, k, v, do, l, m, o, **kw),
               lambda: fk.flash_backward_dq_plain(q, k, v, do, l, m, o,
                                                  **kw)),
    }
    # the library's fused attention on the same (B, H, T, D) views
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), reps=20)[0]
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), do, retain_graph=True), reps=20)
    work = _k3_work(b, h, t, d, True, 2)
    res = {}
    for name, (kernel, plain) in calls.items():
        # the kernel's time is its device time per call: CUDA events around
        # back-to-back calls also count the host's pace of issuing them,
        # which is near a backward kernel's own time
        t_k = device_ms(kernel, reps=20)[0]
        t_ev = time_ms(kernel, reps=20)
        t_p = time_ms(plain, reps=3)
        n_flops, n_bytes = work[name]
        bound_ms, bound_by = _bound(n_bytes, n_flops, BF16_PEAK_FLOPS_PER_S)
        lib = sdpa_fwd if name == "fwd" else None
        print(f"[k3] time {name} bf16 causal (B, H, T, D) = ({b}, {h}, {t}, "
              f"{d}): kernel {t_k:.4f} ms by device time ({t_ev:.4f} ms by "
              f"CUDA events), twin {t_p:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {n_flops / 1e9:.2f} GFLOP, "
              f"{n_bytes / 1e6:.2f} MB), {bound_ms / t_k:.1%} of "
              f"the bound" + (f"; scaled_dot_product_attention forward "
                              f"{lib:.4f} ms by device time"
                              if lib is not None else ""))
        res[name] = {"max_abs_err": path_err[name], "ms": t_k,
                     "plain_ms": t_p, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib}
    # the backward as the autograd function runs it: dQ with di, then dK/dV
    qa, ka, va = (x.detach().requires_grad_() for x in (q, k, v))
    oa = fk.flash_attention(qa, ka, va, causal=True, sm_scale=kw["scale"])
    t_bwd = time_ms(lambda: torch.autograd.grad(
        oa, (qa, ka, va), do, retain_graph=True), reps=20)
    print(f"[k3] backward through FlashAttention (dQ with di, then dK/dV) "
          f"{t_bwd:.4f} ms against scaled_dot_product_attention's backward "
          f"{sdpa_bwd:.4f} ms (CUDA events around back-to-back calls)")
    # the same calls by the device time of their kernels, which the host's
    # pace of issuing autograd calls cannot inflate
    dev = {name: device_ms(fn, reps=10) for name, fn in (
        ("k3_fwd", lambda: fk.flash_attention(q, k, v, causal=True,
                                              sm_scale=kw["scale"])),
        ("sdpa_fwd", lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        ("k3_bwd", lambda: torch.autograd.grad(
            oa, (qa, ka, va), do, retain_graph=True)),
        ("sdpa_bwd", lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True)))}
    print(f"[k3] device time per call (torch.profiler, the call's kernels, "
          f"copies and fills summed): forward K3 {dev['k3_fwd'][0]:.4f} ms, "
          f"scaled_dot_product_attention {dev['sdpa_fwd'][0]:.4f} ms; "
          f"backward K3 (dQ with di + dK/dV) {dev['k3_bwd'][0]:.4f} ms, "
          f"scaled_dot_product_attention {dev['sdpa_bwd'][0]:.4f} ms")
    for name in ("k3_fwd", "sdpa_fwd", "k3_bwd", "sdpa_bwd"):
        for kname, ms in dev[name][1]:
            print(f"[k3]   {name}: {ms:.4f} ms per call in {kname[:90]}")
    return res


def phase_window_update(window):
    """``win_update`` (plain PyTorch) on the WinPut path's window."""
    from bluefog_tpu_torch.ops import windows as W

    t = time_ms(lambda: W.win_update(window), reps=5)
    print(f"[winput] win_update on the ({N_RANKS}, "
          f"{window.spec.schedule.num_slots}, "
          f"{next(iter(window.bufs.values())).shape[1]}) f32 window: "
          f"{t:.4f} ms")
    return t


def phase_pushsum(device, win_len):
    """Push-sum rounds on the directed ring through K2's acc mode, against
    the same rounds through the plain path."""
    from bluefog_tpu_torch.ops import windows as W
    from bluefog_tpu_torch.ops.deliver_kernel import window_deliver
    from bluefog_tpu_torch.topology import RingGraph, build_schedule

    sched = build_schedule(RingGraph(N_RANKS, connect_style=1))
    gen = torch.Generator(device=device).manual_seed(99)
    # unequal starting weights p_r = 1 + r / n, so that p's delivery and
    # merge move it (with p = 1 everywhere the ring keeps it 1), and x
    # scaled to match: the de-biased start x / p is the random z0
    p0 = 1 + torch.arange(N_RANKS, dtype=torch.float64) / N_RANKS
    z0 = torch.randn(N_RANKS, win_len, generator=gen, device=device)
    x0 = z0 * p0.to(device=device, dtype=torch.float32)[:, None]

    def window():
        st = W.win_create(torch.zeros(N_RANKS, win_len, device=device),
                          sched, associated_p=True)
        st.assoc_self.copy_(p0)
        return W.win_sync(st, x0)

    def one_round(st, backend):
        # send half the (x, p) mass to the out-neighbour, keep half, collect
        W.win_accumulate(st, None, dst_weight=0.5, backend=backend)
        st.self_buf.mul_(0.5)
        st.assoc_self.mul_(0.5)
        W.win_update_then_collect(st)

    # p after the rounds, on the host in f64: each rank keeps half its p and
    # receives half of its in-neighbour's; dyadic, so f32 holds it exactly
    src = sched.recv_src[:, 0]
    p_want = p0.clone()
    for _ in range(PUSH_ROUNDS):
        p_want = 0.5 * p_want + 0.5 * p_want[src]
    mass0 = x0.double().sum(0)
    spread0 = float((z0.max(0).values - z0.min(0).values).max())
    st = window()
    round_ms = []
    window_deliver.launches = 0
    for _ in range(PUSH_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_round(st, "kernel")
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
    launches = window_deliver.launches
    check(launches == PUSH_ROUNDS,
          f"push-sum launched K2 {launches} times, expected {PUSH_ROUNDS}")
    ref = window()
    for _ in range(PUSH_ROUNDS):
        one_round(ref, "plain")
    torch.cuda.synchronize()
    abs_err, rel_err = max_err(st.self_buf, ref.self_buf)
    p_err = float((st.assoc_self - ref.assoc_self).abs().max())
    print(f"[pushsum] {PUSH_ROUNDS} rounds through K2 vs the plain path: x "
          f"max abs err {abs_err:.3e}, max rel err {rel_err:.3e} (tol "
          f"{F32_TOL:.3e}); p max abs err {p_err:.3e}")
    check(rel_err <= F32_TOL and p_err == 0.0,
          "push-sum through K2 differs from the plain path")
    p_sum = float(st.assoc_self.double().sum())
    p_closed = float((st.assoc_self.double().cpu() - p_want).abs().max())
    mass_err = float((st.self_buf.double().sum(0) - mass0).abs().max())
    # one rounding per element per round (the collect's add), summed over
    # the ranks
    mass_tol = PUSH_ROUNDS * N_RANKS * float(x0.abs().max()) * 2.0 ** -24
    z = st.self_buf / st.assoc_self[:, None]
    spread = float((z.max(0).values - z.min(0).values).max())
    print(f"[pushsum] ring(directed) x {N_RANKS} ranks x {win_len} f32, "
          f"dst_weight 0.5, p from {[float(v) for v in p0]}: sum(p) = "
          f"{p_sum!r} (want {float(p0.sum())!r}), p against its closed form:"
          f" max abs err {p_closed!r}; max |sum(x) - sum(x0)| {mass_err:.3e} "
          f"(tol {mass_tol:.3e}), spread of x / p {spread0:.4f} -> "
          f"{spread:.4f}; p = {[float(v) for v in st.assoc_self]}")
    check(p_sum == float(p0.sum()),
          f"push-sum p mass {p_sum} != {float(p0.sum())}")
    check(p_closed == 0.0, f"push-sum p misses its closed form: {p_closed}")
    check(mass_err <= mass_tol, f"push-sum lost mass: {mass_err}")
    check(spread < spread0, "push-sum consensus spread did not fall")
    collect_ms = time_ms(lambda: W.win_update_then_collect(st), reps=5)
    print(f"[pushsum] round ms {[round(t, 3) for t in round_ms]}, mean "
          f"{sum(round_ms) / PUSH_ROUNDS:.3f} ms; K2 launches {launches} "
          f"({PUSH_ROUNDS} rounds x 1); win_update_then_collect "
          f"{collect_ms:.4f} ms")
    return launches


GPT_BATCH, GPT_SEQ = 8, 1024    # per rank; GPT-2's published context
GPT_GRAD_TOL = 2.0 ** -5        # K3 step vs twin step, per gradient tensor


def phase_k3_step_parity(trainer):
    """One GPT step through K3 against the same step from the same state
    with K3's three wrappers swapped for their twins (run on the card):
    losses, every rank's gradient of every parameter, and the state after
    the optimizer step."""
    from bluefog_tpu_torch.ops import flash_kernel as fk

    opt = trainer.opt
    state, snap = _snapshot(trainer)
    count = opt.count
    names = ("flash_forward", "flash_backward_dkv", "flash_backward_dq")
    saved = {n: getattr(fk, n) for n in names}
    loss_k = trainer.step()
    grads_k = {k: v.grad.clone() for k, v in trainer.params.items()}
    after_k = {k: v.clone() for k, v in state.items()}
    for k, v in state.items():
        v.copy_(snap[k])
    opt.count = count
    try:
        for n in names:
            setattr(fk, n, getattr(fk, n + "_plain"))
        loss_p = trainer.step()
        torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(fk, n, fn)
    worst, where = -1.0, ""
    for k, v in trainer.params.items():
        ref = v.grad.double()
        d = float((grads_k[k].double() - ref).abs().max())
        rel = d / max(float(ref.abs().max()), 1e-30)
        if rel > worst:
            worst, where = rel, k
    print(f"[gpt parity] K3 step vs twin step over {len(grads_k)} gradients "
          f"({N_RANKS} ranks each): max |diff| / max |grad| {worst:.3e} "
          f"({where}; tol {GPT_GRAD_TOL:.3e}); losses {loss_k.mean():.6f} / "
          f"{loss_p.mean():.6f}")
    check(worst <= GPT_GRAD_TOL, f"K3 step gradients differ from the twin "
          f"step's: {worst} at {where}")
    del grads_k, snap
    _compare(state, after_k, "gpt parity", "K3 step vs twin step", loss_k,
             loss_p)


def phase_gpt(device):
    """The transformer path: decentralized SGD of a full-width GPT-small
    over 8 virtual ranks on Exponential-2 at T = GPT_SEQ, K3 in every block
    and K1 in the gossip; launch counts, falling losses, parity with the
    twins, profile and host breakdown.  Returns K3's launch counts."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import build
    from bluefog_tpu_torch.ops import flash_kernel as fk
    from bluefog_tpu_torch.ops.collectives import fuse_plan
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix

    t0 = time.perf_counter()
    trainer = build("gpt-small", "neighbor", "exp2", size=N_RANKS,
                    batch_size=GPT_BATCH, seq_len=GPT_SEQ, device=device)
    cfg = trainer.model.cfg
    leaves = list(trainer.params.values())
    groups, big = fuse_plan(leaves)
    per_rank = sum(p[0].numel() for p in leaves)
    k3_per_step = cfg.num_layers * N_RANKS
    print(f"[gpt] GPT-small (vocab {cfg.vocab_size}, width "
          f"{cfg.hidden_size}, {cfg.num_layers} layers, {cfg.num_heads} "
          f"heads): {per_rank:,} f32 params per rank in {len(leaves)} "
          f"leaves, built in {time.perf_counter() - t0:.2f} s; fuse plan = "
          f"{len(groups)} fused buffer(s) + {len(big)} leaves >= 8 MiB; "
          f"tokens {tuple(trainer.batch[0].shape)}")
    fk.flash_forward.copies = 0
    fk.flash_backward_dq.copies = fk.flash_backward_dkv.copies = 0
    launches, res = phase_main_path(
        trainer, {gossip_mix: len(groups) + len(big),
                  fk.flash_forward: k3_per_step,
                  fk.flash_backward_dkv: k3_per_step,
                  fk.flash_backward_dq: k3_per_step}, "gpt",
        f"GPT-small x {N_RANKS} virtual ranks, exp2, batch {GPT_BATCH} x seq "
        f"{GPT_SEQ}/rank, bf16", unit="seq", top=24)
    copies = (fk.flash_forward.copies + fk.flash_backward_dq.copies
              + fk.flash_backward_dkv.copies)
    print(f"[gpt] inputs the K3 wrappers copied for 16-byte loads: "
          f"{copies}")
    check(copies == 0, f"the GPT path's q, k, v or dO took {copies} copies")
    mean_ms = sum(res["step_ms"]) / TIMED
    first, last = res["losses"][0].mean(), res["losses"][-1].mean()
    print(f"[gpt] {N_RANKS * GPT_BATCH * GPT_SEQ / mean_ms * 1e3:.1f} tokens/s"
          f" over all ranks; mean loss {first:.5f} -> {last:.5f} in "
          f"{WARMUP + TIMED} steps")
    check(last < first, f"GPT losses did not fall: {first} -> {last}")
    phase_k3_step_parity(trainer)
    phase_host_breakdown(trainer, "gpt")
    del trainer, leaves
    torch.cuda.empty_cache()
    return launches


def _ranks_equal(t):
    return torch.equal(t, t[:1].expand_as(t))


def phase_allreduce(device, main_lengths):
    """The centralized baseline: the ResNet-50 path with the gradients'
    allreduce; ranks bit-equal after the steps; the allreduce alone at the
    fuse plan's lengths against its bytes bound and ``torch.mean``."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import build, run
    from bluefog_tpu_torch.ops import collectives as C

    t0 = time.perf_counter()
    trainer = build("resnet50", "allreduce", "exp2", size=N_RANKS,
                    batch_size=BATCH, image_size=224, device=device)
    _, res = phase_main_path(
        trainer, {}, "allreduce",
        f"ResNet-50 x {N_RANKS} virtual ranks, gradient allreduce, batch "
        f"{BATCH}/rank, bf16")
    state = {k: v for k, v in trainer.state().items()
             if k.startswith(("param.", "momentum."))}
    unequal = [k for k, v in state.items() if not _ranks_equal(v)]
    print(f"[allreduce] parameters and momentum bit-equal on every rank "
          f"after {WARMUP + TIMED} steps from equal parameters: "
          f"{len(state) - len(unequal)} of {len(state)} tensors")
    check(len(state) > 300 and not unequal,
          f"the allreduce left ranks apart in {unequal[:5]}")
    grad_ms = time_ms(trainer.opt._average_grads, reps=10)
    print(f"[allreduce] the optimizer's gradient mean (fuse, mean, write "
          f"back into .grad): {grad_ms:.4f} ms per step")
    # decentralized vs allreduce under the same conditions: a step after
    # torch.profiler has run in a process is slower than one before, so
    # the paths' own phases do not compare; here each warmed-up path runs
    # 4 steps at a time, in turns (neighbor, allreduce, allreduce,
    # neighbor, twice)
    gossip = build("resnet50", "neighbor", "exp2", size=N_RANKS,
                   batch_size=BATCH, image_size=224, device=device)
    run(gossip, WARMUP, 0)
    turns = {"neighbor": [], "allreduce": []}
    for name in ("neighbor", "allreduce", "allreduce", "neighbor") * 2:
        gc.collect()
        tr = gossip if name == "neighbor" else trainer
        turns[name] += run(tr, 0, 4)["step_ms"]
    means = {k: sum(v) / len(v) for k, v in turns.items()}
    print(f"[allreduce] in turns, 16 steps each: neighbor "
          f"{[round(t, 2) for t in turns['neighbor']]} mean "
          f"{means['neighbor']:.2f} ms, allreduce "
          f"{[round(t, 2) for t in turns['allreduce']]} mean "
          f"{means['allreduce']:.2f} ms ({N_RANKS * BATCH / means['neighbor'] * 1e3:.1f} "
          f"and {N_RANKS * BATCH / means['allreduce'] * 1e3:.1f} img/s); the "
          f"virtual ranks share one card, so neither moves bytes between "
          f"cards")
    del trainer, gossip, state
    torch.cuda.empty_cache()

    gen = torch.Generator(device=device).manual_seed(99)
    ms = lib_ms = 0.0
    n_bytes = n_flops = 0
    for length in main_lengths:
        x = torch.randn(N_RANKS, length, generator=gen, device=device)
        out = C.allreduce(x)
        ref = x.double().mean(0)
        abs_err, rel_err = max_err(out, ref.expand_as(out))
        # eight f32 additions and a division by 8: a few f32 ulps
        check(rel_err <= ALLREDUCE_TOL and _ranks_equal(out),
              f"allreduce off its f64 mean at L={length}: {rel_err}")
        t_a = time_ms(lambda: C.allreduce(x), reps=20)
        t_m = time_ms(lambda: torch.mean(x, dim=0), reps=20)
        print(f"[allreduce] ({N_RANKS}, {length}) f32: allreduce {t_a:.4f} "
              f"ms, torch.mean(x, dim=0) {t_m:.4f} ms; max rel err against "
              f"the f64 mean {rel_err:.3e} (tol {ALLREDUCE_TOL:.0e})")
        ms, lib_ms = ms + t_a, lib_ms + t_m
        # every rank's value read once, every rank's result written once
        n_bytes += 2 * x.numel() * 4
        n_flops += x.numel()
    bound_ms, by = _bound(n_bytes, n_flops)
    print(f"[allreduce] one step's allreduce at the fuse plan's lengths "
          f"({len(main_lengths)} buffers): {ms:.4f} ms against a "
          f"{bound_ms:.4f} ms bound ({by}), {bound_ms / ms:.1%} of it; "
          f"torch.mean(dim=0) {lib_ms:.4f} ms (writes one row, not {N_RANKS})"
          f"; phase {time.perf_counter() - t0:.1f} s")
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib_ms, "grad_ms": grad_ms,
            "step_ms": sum(res["step_ms"]) / TIMED, "turns": means}


def phase_hierarchical(device, main_lengths):
    """The hierarchical path at local sizes 2 and 4: ResNet-50 with the
    machine gossip on K1 (launches against the fuse plan), one step through
    K1 against the plain step, each machine's local ranks equal after the
    mix, and the mix's time through K1 and the plain path."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import build
    from bluefog_tpu_torch.ops.gossip_kernel import (
        auto_gossip_backend, gossip_mix)

    out = {}
    for local in (2, 4):
        t0 = time.perf_counter()
        tag = f"hier L{local}"
        trainer = build("resnet50", "hierarchical", "exp2", size=N_RANKS,
                        batch_size=BATCH, image_size=224, device=device,
                        local_size=local)
        opt = trainer.opt
        machines = opt.machine_schedule.size
        route = auto_gossip_backend(opt.machine_schedule)
        print(f"[{tag}] {machines} machines of {local} ranks on "
              f"{opt.machine_schedule.name}, 'auto' -> {route}: the machine "
              f"gossip runs on K1, {len(main_lengths)} launches a step over "
              f"({machines}, L) rows")
        check(route == "kernel", f"{tag}: the machine gossip is not on K1")
        launches, res = phase_main_path(
            trainer, {gossip_mix: len(main_lengths)}, tag,
            f"ResNet-50 x {N_RANKS} virtual ranks, hierarchical (local size "
            f"{local}), batch {BATCH}/rank, bf16")
        phase_step_parity(trainer, tag)
        mixed = opt._mix()
        equal = all(_ranks_equal(m.reshape(machines, local, -1)
                                 .transpose(0, 1)) for m in mixed)
        print(f"[{tag}] each machine's {local} local ranks bit-equal after "
              f"the mix: {equal}")
        check(equal, f"{tag}: local ranks differ after the mix")
        times = {}
        for backend in ("kernel", "plain"):
            opt.backend = backend
            times[backend] = time_ms(opt._mix, reps=5)
        opt.backend = "auto"
        print(f"[{tag}] the hierarchical mix of the parameters (fuse, local "
              f"means, machine fold, lanes): through K1 {times['kernel']:.4f}"
              f" ms, plain {times['plain']:.4f} ms; phase "
              f"{time.perf_counter() - t0:.1f} s")
        out[local] = {"launches": launches["gossip_mix"],
                      "step_ms": sum(res["step_ms"]) / TIMED,
                      "mix_ms": times["kernel"],
                      "mix_plain_ms": times["plain"]}
        del trainer, opt, mixed
        torch.cuda.empty_cache()
    return out


IMAGENET_TRAIN, IMAGENET_VAL, IMAGENET_EPOCHS = 1024, 256, 2


def phase_imagenet(main_lengths):
    """``examples.imagenet_resnet`` on uint8 TFRecord shards written here:
    8 ranks x 32, 2 epochs of 4 steps, once per optimizer; per epoch img/s,
    the loader wait, val top-1 and a profiled step's idle share."""
    import tempfile

    import numpy as np

    from bluefog_tpu_torch.data import tfrecord
    from bluefog_tpu_torch.examples import imagenet_resnet
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="bf-imagenet-")
    try:
        rng = np.random.default_rng(0)
        n_bytes = 0
        for split, n in (("train", IMAGENET_TRAIN), ("val", IMAGENET_VAL)):
            images = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
            labels = rng.integers(0, 1000, n)
            paths = tfrecord.write_image_classification_shards(
                tmp, images, labels, shard_size=256, prefix=split)
            n_bytes += sum(os.path.getsize(p) for p in paths)
        write_s = time.perf_counter() - t0
        print(f"[imagenet] wrote {IMAGENET_TRAIN} train and {IMAGENET_VAL} "
              f"val 224x224x3 uint8 images in 1000 classes as TFRecord "
              f"shards, {n_bytes / 1e6:.1f} MB, in {write_s:.2f} s; native "
              f"CRC library loaded: {tfrecord.native_loaded()}")
        check(tfrecord.native_loaded(), "the native TFRecord library was "
              "not loaded")
        steps = IMAGENET_EPOCHS * IMAGENET_TRAIN // (N_RANKS * BATCH)
        out = {}
        for optimizer in ("neighbor", "allreduce"):
            gc.collect()
            gossip_mix.launches = 0
            res = imagenet_resnet.main([
                "--data-dir", tmp, "--size", str(N_RANKS), "--batch-size",
                str(BATCH), "--epochs", str(IMAGENET_EPOCHS),
                "--warmup-epochs", "1", "--optimizer", optimizer,
                "--profile"])
            launches = gossip_mix.launches
            for e, row in enumerate(res["epochs"]):
                print(f"[imagenet] {optimizer} epoch {e}: {row['img_per_s']:.1f}"
                      f" img/s over all ranks, {row['step_ms']:.2f} ms a step,"
                      f" the host waited {row['loader_wait_ms']:.2f} ms a step"
                      f" on the loader, val top-1 {row['val_top1']:.4f}, "
                      f"profiled step {row['profiled_step_ms']:.2f} ms with "
                      f"device idle {row['idle_share']:.1%}")
            check(len(res["losses"]) == steps,
                  f"imagenet ran {len(res['losses'])} steps, not {steps}")
            check(all(np.isfinite(loss).all() for loss in res["losses"]),
                  f"non-finite loss in the imagenet example ({optimizer})")
            want = len(main_lengths) * steps if optimizer == "neighbor" else 0
            print(f"[imagenet] {optimizer}: K1 launches {launches} = "
                  f"{want} expected; mean loss "
                  f"{res['losses'][0].mean():.4f} -> "
                  f"{res['losses'][-1].mean():.4f}")
            check(launches == want, f"imagenet {optimizer}: K1 launched "
                  f"{launches} times, expected {want}")
            out[optimizer] = res["epochs"]
            del res
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[imagenet] phase {time.perf_counter() - t0:.1f} s")
    return out


def phase_mnist():
    """``examples.mnist_decentralized`` at its defaults (8 ranks on a ring,
    3 epochs of 16 steps): it must reach its own OK; K1 gossips every
    step."""
    from bluefog_tpu_torch.examples import mnist_decentralized
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix

    t0 = time.perf_counter()
    gossip_mix.launches = 0
    res = mnist_decentralized.main([])
    secs = time.perf_counter() - t0
    launches = gossip_mix.launches
    print(f"[mnist] {res['total_steps']} steps, final mean local acc "
          f"{res['final_acc']:.3f}, K1 launches {launches}, {secs:.1f} s")
    check(res["total_steps"] >= 30 and res["final_acc"] > 0.9,
          f"mnist did not converge: {res['final_acc']}")
    check(launches == res["total_steps"],
          f"mnist's gossip launched K1 {launches} times, expected one a "
          f"step ({res['total_steps']})")
    return secs


def phase_routing(device, main_lengths):
    """K1 and K2 on the schedules that are not circulant (MeshGrid2D(8),
    Star(8)): ``'auto'`` routes them to the kernels, and each kernel is
    bit-equal to its plain version in f32 and bf16; K1 through the op layer
    is one launch, bit-equal to the plain path; one put on such a window is
    one K2 launch.  Then K1's time on the grid at the main path's lengths
    against its bound."""
    from bluefog_tpu_torch.ops import collectives as C
    from bluefog_tpu_torch.ops import windows as W
    from bluefog_tpu_torch.ops.deliver_kernel import (
        auto_window_backend, deliver_tables, window_deliver,
        window_deliver_plain)
    from bluefog_tpu_torch.ops.gossip_kernel import (
        auto_gossip_backend, gossip_mix, gossip_mix_plain, schedule_tables)
    from bluefog_tpu_torch.topology import (
        MeshGrid2DGraph, StarGraph, build_schedule)

    gen = torch.Generator(device=device).manual_seed(4321)
    times = {}
    for topo in (MeshGrid2DGraph(N_RANKS), StarGraph(N_RANKS)):
        sched = build_schedule(topo)
        routes = (auto_gossip_backend(sched), auto_window_backend(sched))
        print(f"[routing] {topo.name}: {sched.num_slots} slots, circulant "
              f"{sched.is_circulant}; 'auto' -> K1 {routes[0]}, K2 "
              f"{routes[1]}")
        check(not sched.is_circulant and routes == ("kernel", "kernel"),
              f"{topo.name} is not routed to the kernels")
        sw, rw, src = schedule_tables(sched, device)
        for dtype, length in ((torch.float32, 1_000_003),
                              (torch.float32, main_lengths[0]),
                              (torch.bfloat16, 1_000_003),
                              (torch.bfloat16, main_lengths[0])):
            x = torch.randn(N_RANKS, length, generator=gen,
                            device=device).to(dtype)
            same = torch.equal(gossip_mix(x, sw, rw, src),
                               gossip_mix_plain(x, sw, rw, src))
            print(f"[routing] K1 {topo.name} {str(dtype)[6:]} L={length}: "
                  f"bit-equal to its plain version: {same}")
            check(same, f"K1 differs from its plain version on {topo.name} "
                  f"{dtype} L={length}")
            gossip_mix.launches = 0
            via_op = C.neighbor_allreduce(x, sched)
            plain = C.neighbor_allreduce(x, sched, backend="plain")
            check(gossip_mix.launches == 1 and torch.equal(via_op, plain),
                  f"{topo.name}: 'auto' launched K1 {gossip_mix.launches} "
                  "times, or differs from the plain path")
        src2, mask = deliver_tables(sched, device)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(N_RANKS, 1_000_003, generator=gen,
                            device=device).to(dtype)
            bufs = [torch.zeros(N_RANKS, sched.num_slots, x.shape[1],
                                dtype=dtype, device=device)
                    for _ in range(2)]
            for fn, b in zip((window_deliver, window_deliver_plain), bufs):
                fn(x, b, src2, mask, 0.5, accumulate=False)
                fn(x, b, src2, mask, 1.0, accumulate=True)
            same = torch.equal(bufs[0], bufs[1])
            print(f"[routing] K2 {topo.name} {str(dtype)[6:]} L=1000003, put "
                  f"at 0.5 then acc: bit-equal to its plain version: {same}")
            check(same, f"K2 differs from its plain version on {topo.name}")
        st = W.win_create(torch.randn(N_RANKS, 4096, generator=gen,
                                      device=device), sched)
        window_deliver.launches = 0
        W.win_put(st, None)
        check(window_deliver.launches == 1,
              f"{topo.name}: a put launched K2 {window_deliver.launches} "
              "times")
        k = sched.num_slots
        ms = n_bytes = 0
        for length in main_lengths:
            x = torch.randn(N_RANKS, length, generator=gen, device=device)
            ms += time_ms(lambda: gossip_mix(x, sw, rw, src), reps=20)
            n_bytes += 2 * x.numel() * 4 + N_RANKS * (1 + 2 * k) * 4
        bound_ms, by = _bound(n_bytes, sum(N_RANKS * n * (2 * k + 1)
                                           for n in main_lengths))
        times[topo.name] = {"ms": ms, "bound_ms": bound_ms, "slots": k}
        print(f"[routing] K1 on {topo.name} ({k} slots) at the main path's "
              f"lengths: {ms:.4f} ms a step against a {bound_ms:.4f} ms "
              f"bound ({by}), {bound_ms / ms:.1%} of it")
    return times


def phase_dynamic(device, main_lengths):
    """One-peer dynamic Exp-2 on the ResNet-50 path: the phases cycle by
    communication round, one one-slot K1 launch per fused buffer a step;
    a step through K1 against the plain step; the callable form (full and
    ``max_rotations=1``) bit-equal to the sequence form over 3 steps; K1's
    one-slot time against its bound."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import build
    from bluefog_tpu_torch.ops import collectives as C
    from bluefog_tpu_torch.ops.gossip_kernel import (
        gossip_mix, gossip_mix_plain, schedule_tables)
    from bluefog_tpu_torch.optim import DistributedNeighborAllreduceOptimizer
    from bluefog_tpu_torch.topology import (
        build_schedule, one_peer_exp2_mixing_matrix,
        one_peer_exponential_two_schedules)

    t0 = time.perf_counter()
    trainer = build("resnet50", "neighbor", "exp2", size=N_RANKS,
                    batch_size=BATCH, image_size=224, device=device)
    base = trainer.opt.base
    phases = one_peer_exponential_two_schedules(N_RANKS)
    trainer.opt = opt = DistributedNeighborAllreduceOptimizer(
        base, topology=phases)
    used = []
    mix = opt._mix

    def logged(change=False):
        used.append(opt.schedule.name)
        return mix(change)

    opt._mix = logged
    launches, res = phase_main_path(
        trainer, {gossip_mix: len(main_lengths)}, "dynamic",
        f"ResNet-50 x {N_RANKS} virtual ranks, one-peer dynamic exp2, batch "
        f"{BATCH}/rank, bf16")
    del opt._mix
    want = [p.name for p in phases] * 2
    print(f"[dynamic] phases of the {len(used)} steps: {used}")
    check(used == want, f"the dynamic phases did not cycle: {used}")
    phase_step_parity(trainer, "dynamic")

    # the callable form against the sequence form, 3 steps from one state
    state, snap = _snapshot(trainer)
    params = {}
    forms = (
        ("sequence", dict(topology=phases)),
        ("callable", dict(topology=functools.partial(
            one_peer_exp2_mixing_matrix, N_RANKS))),
        ("callable, max_rotations=1", dict(
            topology=functools.partial(one_peer_exp2_mixing_matrix,
                                       N_RANKS), max_rotations=1)))
    try:
        with deterministic_cudnn():
            for form, kw in forms:
                for k, v in state.items():
                    v.copy_(snap[k])
                trainer.opt = DistributedNeighborAllreduceOptimizer(base,
                                                                    **kw)
                gossip_mix.launches = 0
                for _ in range(3):
                    trainer.step()
                torch.cuda.synchronize()
                check(gossip_mix.launches == 3 * len(main_lengths),
                      f"{form}: K1 launched {gossip_mix.launches} times")
                params[form] = {k: v.clone() for k, v in state.items()
                                if k.startswith("param.")}
    finally:
        trainer.opt = opt
    for form, _ in forms[1:]:
        same = all(torch.equal(params[form][k], v)
                   for k, v in params["sequence"].items())
        print(f"[dynamic] 3 steps, {form} vs the sequence form: parameters "
              f"bit-equal: {same}")
        check(same, f"the {form} form differs from the sequence form")
    del trainer, opt, base, state, snap, params
    torch.cuda.empty_cache()

    # what the aperiodic gossip pays on the host for its K1 tables: a first
    # matrix builds them and copies them to the card, a repeat hashes its
    # bytes (the LRU's key)
    w1 = one_peer_exp2_mixing_matrix(N_RANKS, 1)

    def lookup():
        return C._aperiodic_tables(C._host_matrix(w1).tobytes(), N_RANKS,
                                   str(device))

    C._aperiodic_tables.cache_clear()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lookup()
    torch.cuda.synchronize()
    miss_us = (time.perf_counter() - t1) * 1e6
    t1 = time.perf_counter()
    for _ in range(1000):
        lookup()
    hit_us = (time.perf_counter() - t1) * 1e3
    print(f"[dynamic] the aperiodic gossip's K1 tables on the host: a new "
          f"matrix {miss_us:.1f} us (built and copied to the card), a "
          f"repeated one {hit_us:.2f} us a call (its {4 * N_RANKS ** 2} "
          f"bytes hashed for the LRU)")

    # K1 at one slot, at the main path's lengths
    sched = build_schedule(phases[0])
    sw, rw, src = schedule_tables(sched, device)
    w = torch.as_tensor(sched.mixing_matrix(), dtype=torch.float32,
                        device=device)
    gen = torch.Generator(device=device).manual_seed(77)
    ms = plain_ms = lib_ms = err = 0.0
    n_bytes = 0
    for length in main_lengths:
        x = torch.randn(N_RANKS, length, generator=gen, device=device)
        err = max(err, max_err(gossip_mix(x, sw, rw, src),
                               gossip_mix_plain(x, sw, rw, src))[0])
        ms += time_ms(lambda: gossip_mix(x, sw, rw, src), reps=20)
        plain_ms += time_ms(lambda: gossip_mix_plain(x, sw, rw, src), reps=5)
        lib_ms += time_ms(lambda: torch.matmul(w, x), reps=20)
        n_bytes += 2 * x.numel() * 4 + N_RANKS * 3 * 4
    bound_ms, by = _bound(n_bytes, sum(N_RANKS * n * 3
                                       for n in main_lengths))
    print(f"[dynamic] K1 at one slot, one step's {len(main_lengths)} "
          f"launches: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.matmul(W, x) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({by}), {bound_ms / ms:.1%} of the bound; max abs err {err:.3e}; "
          f"phase {time.perf_counter() - t0:.1f} s")
    check(err == 0.0, f"K1 at one slot differs from its plain version: {err}")
    return {"launches": launches["gossip_mix"],
            "step_ms": sum(res["step_ms"]) / TIMED,
            "one_slot": {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": by, "library_ms": lib_ms},
            "tables_us": {"new": miss_us, "repeat": hit_us}}


GT_TOL = 1e-5    # |sum_i y_i - sum_i u_i| against max |sum_i u_i|


def _tracking_gap(opt):
    """max over parameters of ``max |sum_i y_i - sum_i u_i| / max |sum_i
    u_i|`` in f64: gradient tracking's invariant."""
    worst = 0.0
    for y, u in zip(opt.y, opt.u_prev):
        sy, su = y.double().sum(0), u.double().sum(0)
        scale = float(su.abs().max())
        if scale > 0:
            worst = max(worst, float((sy - su).abs().max()) / scale)
    return worst


def phase_tracking(device, main_lengths):
    """Gradient tracking on Exp-2 and on MeshGrid2D (BASELINE.json
    ``configs[3]``), then exact diffusion on Ring(8), on the ResNet-50
    path: K1's launches a step (two fused mixes for GT, one for ED), a step
    through K1 against the plain step, and GT's invariant after each of
    the steps checked."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import build
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix
    from bluefog_tpu_torch.optim import (
        DistributedExactDiffusionOptimizer,
        DistributedGradientTrackingOptimizer)
    from bluefog_tpu_torch.topology import (
        ExponentialTwoGraph, MeshGrid2DGraph, RingGraph)

    out = {}
    paths = (
        ("gt exp2", DistributedGradientTrackingOptimizer,
         ExponentialTwoGraph, 2),
        ("gt grid", DistributedGradientTrackingOptimizer, MeshGrid2DGraph, 2),
        ("ed ring", DistributedExactDiffusionOptimizer, RingGraph, 1))
    for tag, make, graph, mixes in paths:
        t0 = time.perf_counter()
        trainer = build("resnet50", "neighbor", "exp2", size=N_RANKS,
                        batch_size=BATCH, image_size=224, device=device)
        trainer.opt = make(trainer.opt.base, graph(N_RANKS))
        launches, res = phase_main_path(
            trainer, {gossip_mix: mixes * len(main_lengths)}, tag,
            f"ResNet-50 x {N_RANKS} virtual ranks, {make.__name__} on "
            f"{graph.__name__}, batch {BATCH}/rank, bf16")
        gaps = []
        if mixes == 2:
            gaps.append(_tracking_gap(trainer.opt))
        phase_step_parity(trainer, tag)
        if mixes == 2:
            for _ in range(2):
                trainer.step()
                gaps.append(_tracking_gap(trainer.opt))
            print(f"[{tag}] invariant sum_i y_i = sum_i u_i: max gap over "
                  f"parameters / max |sum_i u_i| after 3 of the steps "
                  f"{[f'{g:.3e}' for g in gaps]} (tol {GT_TOL:.0e})")
            check(max(gaps) <= GT_TOL, f"{tag}: the tracking invariant "
                  f"broke: {gaps}")
        print(f"[{tag}] phase {time.perf_counter() - t0:.1f} s")
        out[tag] = {"launches": launches["gossip_mix"],
                    "step_ms": sum(res["step_ms"]) / TIMED}
        del trainer
        torch.cuda.empty_cache()
    return out


CHOCO_ROUNDS, CHOCO_MAX_ROUNDS = 60, 200


def phase_choco(device, win_len):
    """CHOCO-Gossip alone over the ResNet-50 parameter buffer (random start
    values), ``random_block_k(0.25)`` at gamma 0.3 on Ring(8): the dryrun's
    two measures (the max deviation from the mean against its start, the
    mean's drift) after its 60 rounds, and the round where the max
    deviation first falls below 5% of its start; then the ResNet-50 path
    under ``DistributedChocoSGDOptimizer`` (``random_block_k(0.1)``), which
    launches no kernel."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import build
    from bluefog_tpu_torch.ops import compression as CP
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix
    from bluefog_tpu_torch.optim import DistributedChocoSGDOptimizer
    from bluefog_tpu_torch.topology import RingGraph, build_schedule

    t0 = time.perf_counter()
    sched = build_schedule(RingGraph(N_RANKS))
    comp = CP.random_block_k(0.25)
    gen = torch.Generator(device=device).manual_seed(9)
    x = torch.randn(N_RANKS, win_len, generator=gen, device=device)
    target = x.double().mean(0)

    def measures(x):
        return (float((x.double() - target).abs().max()),
                float((x.double().mean(0) - target).abs().max()))

    err0, _ = measures(x)
    st = CP.choco_init(x, sched)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(CHOCO_ROUNDS):
        x, st = CP.choco_gossip(x, st, sched, compressor=comp, gamma=0.3)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t1) * 1e3 / CHOCO_ROUNDS
    err, drift = measures(x)
    ratio_60 = err / err0
    crossed = CHOCO_ROUNDS if ratio_60 < 0.05 else None
    print(f"[choco] ring x {N_RANKS} ranks x {win_len} f32, random_block_k"
          f"(0.25), gamma 0.3: after {CHOCO_ROUNDS} rounds max |x - mean| "
          f"{err:.4e} = {err / err0:.2%} of its start {err0:.4f}, mean drift "
          f"{drift:.3e}; {round_ms:.3f} ms a round")
    check(drift < 1e-4, f"CHOCO drifted the mean: {drift}")
    rounds = CHOCO_ROUNDS
    while crossed is None and rounds < CHOCO_MAX_ROUNDS:
        x, st = CP.choco_gossip(x, st, sched, compressor=comp, gamma=0.3)
        rounds += 1
        err, drift = measures(x)
        if err < 0.05 * err0:
            crossed = rounds
    print(f"[choco] the max deviation fell below 5% of its start at round "
          f"{crossed} ({err / err0:.2%} there, mean drift {drift:.3e})")
    check(crossed is not None and drift < 1e-4,
          f"CHOCO did not contract below 5% in {CHOCO_MAX_ROUNDS} rounds")
    del x, st, target
    torch.cuda.empty_cache()

    trainer = build("resnet50", "neighbor", "exp2", size=N_RANKS,
                    batch_size=BATCH, image_size=224, device=device)
    trainer.opt = DistributedChocoSGDOptimizer(
        trainer.opt.base, RingGraph(N_RANKS),
        compressor=CP.random_block_k(0.1))
    _, res = phase_main_path(
        trainer, {gossip_mix: 0}, "choco",
        f"ResNet-50 x {N_RANKS} virtual ranks, CHOCO-SGD on Ring(8), "
        f"random_block_k(0.1), batch {BATCH}/rank, bf16")
    print(f"[choco] phase {time.perf_counter() - t0:.1f} s")
    del trainer
    torch.cuda.empty_cache()
    return {"round_ms": round_ms, "ratio_60": ratio_60, "crossed": crossed,
            "step_ms": sum(res["step_ms"]) / TIMED}


def phase_examples():
    """``examples.average_consensus`` on each of its five topologies (one
    K1 launch a step on each), ``examples.choco_sgd`` and
    ``examples.convergence_comparison`` (two gossip flavors, one K1 launch a
    step each), each to its own OK, with its seconds."""
    from bluefog_tpu_torch.examples import (
        average_consensus, choco_sgd, convergence_comparison)
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix

    out = {}
    steps = 50
    for topo in sorted(average_consensus.TOPOLOGIES):
        gossip_mix.launches = 0
        t0 = time.perf_counter()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            average_consensus.main(["--topology", topo, "--steps",
                                    str(steps)])
        secs = time.perf_counter() - t0
        lines = text.getvalue().splitlines()
        print(f"[examples] average_consensus --topology {topo}: "
              f"{lines[1]}; {lines[-2]}; {lines[-1]}; K1 launches "
              f"{gossip_mix.launches}; {secs:.2f} s")
        check(lines[-1] == "OK" and gossip_mix.launches == steps,
              f"average_consensus on {topo}: {lines[-1]}, K1 launched "
              f"{gossip_mix.launches} times")
        out[f"average_consensus {topo}"] = secs
    gossip_mix.launches = 0
    t0 = time.perf_counter()
    res = choco_sgd.main([])
    out["choco_sgd"] = time.perf_counter() - t0
    print(f"[examples] choco_sgd: max |w_i - w*| {res['err']:.2e}, spread "
          f"{res['spread']:.2e}, K1 launches {gossip_mix.launches}; "
          f"{out['choco_sgd']:.2f} s")
    gossip_mix.launches = 0
    t0 = time.perf_counter()
    res = convergence_comparison.main([])
    out["convergence_comparison"] = time.perf_counter() - t0
    steps = 2 * res["steps"]
    print(f"[examples] convergence_comparison: accuracies {res['acc']}, K1 "
          f"launches {gossip_mix.launches} ({steps} expected: exp2 and ring "
          f"gossip, one fused LeNet buffer a step); "
          f"{out['convergence_comparison']:.2f} s")
    check(gossip_mix.launches == steps,
          f"convergence_comparison launched K1 {gossip_mix.launches} times")
    return out


# ---------------------------------------------------------------------------
# Phase 19: the ranks spread over processes that share the card
# ---------------------------------------------------------------------------

MP_PROCESSES = (2, 4, 8)       # P = 8: one rank a process, K1's check only
MP_TIMEOUT_S = 600


@contextlib.contextmanager
def _one_process():
    """Inside: the ops run as in one process (no transport), so a process
    of the group can compute the one-process reference on the whole
    stack."""
    from bluefog_tpu_torch.ops import transport as T

    tr = T.active()
    T.activate(None)
    try:
        yield
    finally:
        T.activate(tr)


def _wall_ms(tr, fn, reps):
    """Milliseconds a call of ``fn`` takes over every process: from a
    barrier of the group, ``reps`` calls in each process, each process's
    device drained, to a second barrier (the processes' kernels time-slice
    the card, so this is the time all of them take together)."""
    torch.cuda.synchronize()
    tr.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    tr.barrier()
    return (time.perf_counter() - t0) * 1e3 / reps


def _k1_peer_rows(sched, procs):
    """Rows K1's peer form must move for one gossip of the ``sched.size``
    ranks over ``procs`` processes: each process's launch reads its own
    rows and the distinct source rows of its ranks once, and writes its
    rows.  Inside one launch a row several ranks read comes from L2 once,
    as the virtual K1's bound of 2 rows a rank assumes; across processes it
    cannot, since their kernels time-slice the card."""
    m = sched.size // procs
    rows = 0
    for q in range(procs):
        src = sched.recv_src[q * m:(q + 1) * m, :sched.num_slots]
        read = set(range(q * m, (q + 1) * m)) | {int(j) for j in src.ravel()
                                                 if j >= 0}
        rows += len(read) + m
    return rows


def mp_k1(ctx, lengths):
    """K1's peer form against the virtual K1 on the same stacked inputs (f32
    at the main path's lengths and an unaligned one, bf16 at the first and
    the unaligned one), bit for bit, through the op layer's kernel and
    plain routes; then its time at the main path's lengths, each payload
    packed into its staged buffer as ``fuse_apply`` packs it, so that the
    buffer holds the launch's own rows as well as its peers'."""
    from bluefog_tpu_torch.ops import collectives as C
    from bluefog_tpu_torch.ops.gossip_kernel import (
        gossip_mix, gossip_mix_peer, gossip_mix_peer_plain, schedule_tables)
    from bluefog_tpu_torch.topology import ExponentialTwoGraph, build_schedule

    tr, dev = ctx.transport, ctx.device
    own = slice(ctx.owned_ranks.start, ctx.owned_ranks.stop)
    sched = build_schedule(ExponentialTwoGraph(N_RANKS))
    sw, rw, src = schedule_tables(sched, dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    cases = ([(torch.float32, n) for n in sorted(set(lengths)) + [1_000_003]]
             + [(torch.bfloat16, n) for n in (lengths[0], 1_000_003)])
    worst, checked = 0.0, []
    for dtype, length in cases:
        x = torch.randn(N_RANKS, length, generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        want = gossip_mix(x, sw, rw, src)[own].clone()
        got = C.neighbor_allreduce(x[own].clone(), sched, backend="kernel")
        plain = C.neighbor_allreduce(x[own].clone(), sched, backend="plain")
        torch.cuda.synchronize()
        err = max(max_err(got, want)[0], max_err(plain, want)[0])
        worst = max(worst, err)
        checked.append([str(dtype)[6:], length, torch.equal(got, want),
                        torch.equal(plain, want)])
        del x, want, got, plain
    m = len(ctx.owned_ranks)
    bufs = [tr.pack([torch.randn(m, n, generator=gen, device=dev)])
            for n in lengths]
    with tr.exchange(sched, bufs) as rows:
        sw_o, rw_o = sw[own].contiguous(), rw[own].contiguous()
        step = lambda fn: [fn(b, sw_o, rw_o, r)  # noqa: E731
                           for b, r in zip(bufs, rows)]
        step(gossip_mix_peer)
        ms = _wall_ms(tr, lambda: step(gossip_mix_peer), reps=20)
        plain_ms = _wall_ms(tr, lambda: step(gossip_mix_peer_plain), reps=2)
    # the handshake alone, the processes in step: records, one barrier and
    # the waits of a call, over 20 calls of one small payload each
    small = [torch.zeros(m, 1024, device=dev)]
    torch.cuda.synchronize()
    tr.barrier()
    tr.handshake_us, tr.handshakes = 0.0, 0
    for _ in range(20):
        with tr.exchange(sched, small):
            pass
    handshake_us = tr.handshake_us / tr.handshakes
    n_rows = _k1_peer_rows(sched, ctx.process_count)
    n_bytes = sum(n_rows * n * 4 for n in lengths)
    n_flops = sum(N_RANKS * n * (2 * sched.num_slots + 1) for n in lengths)
    bound_ms, bound_by = _bound(n_bytes, n_flops)
    return {"checked": checked, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "rows_a_rank": n_rows / N_RANKS,
            "handshake_us": handshake_us}


def mp_main_path(ctx, outdir):
    """The ResNet-50 main path over this process's ranks, 2 + 3 steps under
    deterministic cuDNN (each timed step's wait in its handshake read
    apart), its parameters saved for the parent's comparison, then one
    profiled step; then the time of a step's pack alone (every parameter
    laid into the staged buffer, all processes together) beside the pack
    of the one-process fuse plan (the fused buffer packed, the leaves of 8
    MiB and more copied apart)."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import (
        build, profile_step, run)
    from bluefog_tpu_torch.ops.collectives import fuse_plan
    from bluefog_tpu_torch.ops.gossip_kernel import (
        gossip_mix, gossip_mix_peer)

    tr = ctx.transport
    with deterministic_cudnn():
        trainer = build("resnet50", "neighbor", "exp2", size=N_RANKS,
                        batch_size=BATCH, image_size=224, device=ctx.device)
        gossip_mix_peer.launches = gossip_mix.launches = 0
        tr.handshakes = 0
        res = run(trainer, WARMUP, 0)
        waits_us = []
        for _ in range(TIMED):
            before = tr.handshake_us
            one = run(trainer, 0, 1)
            waits_us.append(tr.handshake_us - before)
            res["losses"] += one["losses"]
            res.setdefault("step_ms", []).extend(one["step_ms"])
        launches = gossip_mix_peer.launches
        virtual = gossip_mix.launches
        handshakes = tr.handshakes
    torch.save({k: v.detach().cpu() for k, v in trainer.params.items()},
               os.path.join(outdir, f"params_{ctx.process_rank}.pt"))
    finite = all(math.isfinite(float(v)) for loss in res["losses"]
                 for v in loss)
    prof = profile_step(trainer)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    leaves = [v.detach() for v in trainer.params.values()]
    m = len(ctx.owned_ranks)
    flat = [v.reshape(m, -1) for v in leaves]

    def pack():
        for idxs in fuse_plan(leaves, None)[0].values():
            tr.pack([flat[i] for i in idxs])
        tr.settle()

    small, big = fuse_plan(leaves)
    small = [i for idxs in small.values() for i in idxs]
    to = [torch.empty(m, sum(flat[i].shape[1] for i in small),
                      device=ctx.device)] + [torch.empty_like(flat[i])
                                             for i in big]

    def split_pack():
        torch.cat([flat[i] for i in small], dim=1, out=to[0])
        for t, i in zip(to[1:], big):
            t.copy_(flat[i])

    pack_ms = _wall_ms(tr, pack, reps=10)
    split_ms = _wall_ms(tr, split_pack, reps=10)
    del to
    n_bytes = 2 * N_RANKS * sum(v[0].numel() * v.element_size()
                                for v in leaves)
    mean_ms = sum(res["step_ms"]) / TIMED
    samples = trainer.batch[0].shape[0] * trainer.batch[0].shape[1]
    out = {"step_ms": res["step_ms"], "img_s": samples / (mean_ms / 1e3),
           "pack_ms": pack_ms, "split_pack_ms": split_ms,
           "pack_bound_ms": _bound(n_bytes, 0)[0],
           "launches": launches, "virtual_launches": virtual,
           "waits_us": waits_us, "handshakes": handshakes,
           "finite": finite, "busy_ms": prof["busy_ms"],
           "idle": 1 - prof["busy_ms"] / mean_ms,
           "peak_gb": peak_gb}
    del trainer, leaves, flat
    torch.cuda.empty_cache()
    return out


def mp_k2(ctx, win_len):
    """K2's peer form against the virtual K2 on the same stacked inputs:
    put at dst_weight 0.5 then acc at 1/3 on Exponential-2, f32 at the
    WinPut window's length and bf16 at an unaligned one, through the kernel
    and the plain routes, bit for bit; then put's and acc's times."""
    from bluefog_tpu_torch.ops import windows as W
    from bluefog_tpu_torch.ops.deliver_kernel import (
        deliver_tables, window_deliver, window_deliver_peer)
    from bluefog_tpu_torch.topology import ExponentialTwoGraph, build_schedule

    tr, dev = ctx.transport, ctx.device
    own = slice(ctx.owned_ranks.start, ctx.owned_ranks.stop)
    sched = build_schedule(ExponentialTwoGraph(N_RANKS))
    src, mask = deliver_tables(sched, dev)
    gen = torch.Generator(device=dev).manual_seed(4321)
    worst, checked, times = 0.0, [], {}
    for dtype, length, routes in ((torch.float32, win_len, ("kernel",)),
                                  (torch.bfloat16, 1_000_003,
                                   ("kernel", "plain")),
                                  (torch.float32, 1_000_003, ("plain",))):
        x = torch.randn(N_RANKS, length, generator=gen, device=dev).to(dtype)
        y = torch.randn(N_RANKS, length, generator=gen, device=dev).to(dtype)
        full = y[:, None].expand(-1, sched.num_slots, -1).clone()
        window_deliver(x, full, src, mask, 0.5, accumulate=False)
        window_deliver(y, full, src, mask, 1 / 3, accumulate=True)
        want = full[own].clone()
        del full
        for route in routes:
            st = W.win_create(y[own].clone(), sched)
            W.win_put(st, x[own].clone(), dst_weight=0.5, backend=route)
            W.win_accumulate(st, y[own].clone(), dst_weight=1 / 3,
                             backend=route)
            with tr.updating(st.links):
                got = st.peers[dtype].clone()
            torch.cuda.synchronize()
            worst = max(worst, max_err(got, want)[0])
            checked.append([str(dtype)[6:], length, route,
                            torch.equal(got, want)])
            if length == win_len and route == "kernel":
                targets = tr.window_targets(st.links, sched, dtype)
                xo = x[own].contiguous()
                for name, acc in (("put", False), ("acc", True)):
                    times[name] = _wall_ms(tr, lambda: window_deliver_peer(
                        xo, targets, 0.5, accumulate=acc), reps=10)
            del st, got
        del x, y, want
    torch.cuda.empty_cache()
    return {"checked": checked, "max_abs_err": worst, **times}


def mp_pushsum(ctx, win_len):
    """Push-sum on the directed Ring(8) through K2's peer form, 6 rounds of
    ``win_accumulate`` with ``p`` from unequal weights, against the same
    rounds in one process on the whole stack; then K2's peer acc alone."""
    from bluefog_tpu_torch.ops import collectives as C
    from bluefog_tpu_torch.ops import windows as W
    from bluefog_tpu_torch.ops.deliver_kernel import (
        window_deliver_peer, window_deliver_peer_plain)
    from bluefog_tpu_torch.topology import RingGraph, build_schedule

    tr, dev = ctx.transport, ctx.device
    m = len(ctx.owned_ranks)
    own = slice(ctx.owned_ranks.start, ctx.owned_ranks.stop)
    sched = build_schedule(RingGraph(N_RANKS, connect_style=1))
    gen = torch.Generator(device=dev).manual_seed(99)
    p0 = 1 + torch.arange(N_RANKS, dtype=torch.float64) / N_RANKS
    x0 = (torch.randn(N_RANKS, win_len, generator=gen, device=dev)
          * p0.to(device=dev, dtype=torch.float32)[:, None])

    def window(rows, sl):
        st = W.win_create(torch.zeros(rows, win_len, device=dev), sched,
                          associated_p=True)
        st.assoc_self.copy_(p0[sl])
        return W.win_sync(st, x0[sl])

    def one_round(st):
        W.win_accumulate(st, None, dst_weight=0.5)
        st.self_buf.mul_(0.5)
        st.assoc_self.mul_(0.5)
        W.win_update_then_collect(st)

    st = window(m, own)
    window_deliver_peer.launches = 0
    round_ms = []
    for _ in range(PUSH_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_round(st)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
    launches = window_deliver_peer.launches
    p_sum = float(C.allreduce(st.assoc_self.double()[:, None].clone(),
                              average=False)[0, 0])
    with _one_process():
        ref = window(N_RANKS, slice(None))
        for _ in range(PUSH_ROUNDS):
            one_round(ref)
        want_x = ref.self_buf[own].clone()
        want_p = ref.assoc_self[own].clone()
        del ref
    torch.cuda.synchronize()
    equal = (torch.equal(st.self_buf, want_x)
             and torch.equal(st.assoc_self, want_p))
    err = max_err(st.self_buf, want_x)[0]
    targets = tr.window_targets(st.links, sched, torch.float32)
    xo = st.self_buf.contiguous()
    ms = _wall_ms(tr, lambda: window_deliver_peer(
        xo, targets, 0.5, accumulate=True), reps=10)
    plain_ms = _wall_ms(tr, lambda: window_deliver_peer_plain(
        xo, targets, 0.5, accumulate=True), reps=2)
    n_bytes = 3 * N_RANKS * win_len * 4
    bound_ms, bound_by = _bound(n_bytes, 2 * N_RANKS * win_len)
    del st, x0, want_x
    torch.cuda.empty_cache()
    return {"launches": launches, "p_sum": p_sum, "equal": equal,
            "max_abs_err": err, "round_ms": round_ms, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


# -- the slice's algorithms over processes (P = 2) ---------------------------

SLICE_PROCESSES = 2
APERIODIC_ROUNDS = 6


def _resnet_algo(device, algo):
    """The ResNet-50 main path's trainer with gradient tracking on
    MeshGrid2D(8) (``"gt"``, BASELINE.json ``configs[3]``) or exact
    diffusion on Ring(8) (``"ed"``) in place of its optimizer."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import build
    from bluefog_tpu_torch.optim import (
        DistributedExactDiffusionOptimizer,
        DistributedGradientTrackingOptimizer)
    from bluefog_tpu_torch.topology import MeshGrid2DGraph, RingGraph

    trainer = build("resnet50", "neighbor", "exp2", size=N_RANKS,
                    batch_size=BATCH, image_size=224, device=device)
    trainer.opt = (
        DistributedGradientTrackingOptimizer(trainer.opt.base,
                                             MeshGrid2DGraph(N_RANKS))
        if algo == "gt" else
        DistributedExactDiffusionOptimizer(trainer.opt.base,
                                           RingGraph(N_RANKS)))
    return trainer


def _gpt_trainer(device):
    from bluefog_tpu_torch.examples.synthetic_benchmark import build

    return build("gpt-small", "neighbor", "exp2", size=N_RANKS,
                 batch_size=GPT_BATCH, seq_len=GPT_SEQ, device=device)


def _slice_state(trainer, algo):
    """What the comparison holds: the parameters, and gradient tracking's
    trackers or exact diffusion's master and last psi."""
    keep = {"gt": ("param.", "tracker."), "ed": ("param.", "master.",
                                                 "prev_psi."),
            "gpt": ("param.",)}[algo]
    return {k: v.detach().cpu() for k, v in trainer.state().items()
            if k.startswith(keep)}


def slice_references(device):
    """The one-process runs the P = 2 group is held against: 2 + 3 steps
    of gradient tracking (grid) and exact diffusion (ring) over ResNet-50
    under deterministic cuDNN, and of GPT-small at seq 1024; their states
    on the host."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import run

    refs = {}
    for algo in ("gt", "ed", "gpt"):
        t0 = time.perf_counter()
        with deterministic_cudnn():
            trainer = (_gpt_trainer(device) if algo == "gpt"
                       else _resnet_algo(device, algo))
            res = run(trainer, WARMUP, TIMED)
        refs[algo] = _slice_state(trainer, algo)
        refs[f"{algo}/step_ms"] = sum(res["step_ms"]) / TIMED
        refs[f"{algo}/samples"] = (trainer.batch[0].shape[0]
                                   * trainer.batch[0].shape[1])
        print(f"[processes] one-process reference {algo}: "
              f"{refs[f'{algo}/step_ms']:.2f} ms a step, "
              f"{time.perf_counter() - t0:.1f} s")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def mp_algo(ctx, outdir, algo):
    """Gradient tracking (grid), exact diffusion (ring) or GPT-small over
    this process's ranks, 2 + 3 steps (deterministic cuDNN for ResNet-50):
    the launches of K1's peer form and of K3, the step times, and the state
    saved for the parent's comparison with one process."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import run
    from bluefog_tpu_torch.ops import flash_kernel as fk
    from bluefog_tpu_torch.ops.gossip_kernel import (
        gossip_mix, gossip_mix_peer)

    k3 = (fk.flash_forward, fk.flash_backward_dkv, fk.flash_backward_dq)
    with deterministic_cudnn():
        trainer = (_gpt_trainer(ctx.device) if algo == "gpt"
                   else _resnet_algo(ctx.device, algo))
        gossip_mix_peer.launches = gossip_mix.launches = 0
        for fn in k3:
            fn.launches = 0
        res = run(trainer, WARMUP, TIMED)
    out = {"launches": gossip_mix_peer.launches,
           "virtual_launches": gossip_mix.launches,
           "k3": [fn.launches for fn in k3],
           "step_ms": res["step_ms"],
           "samples": trainer.batch[0].shape[0] * trainer.batch[0].shape[1],
           "finite": all(math.isfinite(float(v)) for loss in res["losses"]
                         for v in loss),
           "losses": [float(loss.mean()) for loss in res["losses"]],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.save(_slice_state(trainer, algo),
               os.path.join(outdir, f"{algo}_{ctx.process_rank}.pt"))
    if algo == "gpt":
        out["payload"] = sum(v[0].numel() for v in trainer.params.values())
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _plain_slices(x, sw, rw, rows, chunks=8):
    """K1's plain peer twin on ``chunks`` column slices of the rows (it
    gathers every slot's rows at once, so a slice bounds its memory):
    yields ``(c0, c1, out[:, c0:c1])``."""
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix_peer_plain

    width = -(-x.shape[1] // chunks)
    for c0 in range(0, x.shape[1], width):
        c1 = min(c0 + width, x.shape[1])
        part = dataclasses.replace(
            rows, length=c1 - c0, ptrs=None,
            views=[[None if v is None else v[c0:c1] for v in row]
                   for row in rows.views])
        yield c0, c1, gossip_mix_peer_plain(x[:, c0:c1], sw, rw, part)


def mp_gpt_k1(ctx, length):
    """K1's peer form on GPT-small's one staged payload (every leaf fused,
    ``length`` f32 a rank) as the GPT path runs it: its output against its
    plain twin on the same rows, bit for bit, and all processes' launches
    of a step from barrier to barrier (the twin's, by column slices, too),
    against its bytes bound."""
    from bluefog_tpu_torch.ops.gossip_kernel import (
        gossip_mix_peer, schedule_tables)
    from bluefog_tpu_torch.topology import ExponentialTwoGraph, build_schedule

    tr, dev = ctx.transport, ctx.device
    own = slice(ctx.owned_ranks.start, ctx.owned_ranks.stop)
    sched = build_schedule(ExponentialTwoGraph(N_RANKS))
    sw, rw, _ = schedule_tables(sched, dev)
    m = len(ctx.owned_ranks)
    gen = torch.Generator(device=dev).manual_seed(1717)
    buf = tr.pack([torch.randn(m, length, generator=gen, device=dev)])
    with tr.exchange(sched, [buf]) as (rows,):
        sw_o, rw_o = sw[own].contiguous(), rw[own].contiguous()
        got = gossip_mix_peer(buf, sw_o, rw_o, rows)
        equal, err = True, 0.0
        for c0, c1, want in _plain_slices(buf, sw_o, rw_o, rows):
            equal = equal and torch.equal(got[:, c0:c1], want)
            err = max(err, max_err(got[:, c0:c1], want)[0])
        del got, want
        ms = _wall_ms(tr, lambda: gossip_mix_peer(buf, sw_o, rw_o, rows),
                      reps=10)
        plain_ms = _wall_ms(tr, lambda: [None for _ in _plain_slices(
            buf, sw_o, rw_o, rows)], reps=1)
    n_rows = _k1_peer_rows(sched, ctx.process_count)
    bound_ms, bound_by = _bound(n_rows * length * 4,
                                N_RANKS * length * (2 * sched.num_slots + 1))
    del buf
    torch.cuda.empty_cache()
    return {"equal": equal, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "rows_a_rank": n_rows / N_RANKS, "length": length}


def mp_aperiodic(ctx, win_len):
    """The callable one-peer Exp-2 topology's matrices, 6 rounds of the
    aperiodic gossip on K1's peer form over ResNet-50's buffer, each round
    bit-equal to the virtual K1 on the same ``W``; the capped form within
    its cap and over it (NaN, as the virtual form); the host time of a
    call on a new matrix and on a cached one (both parities' address
    tables built), from call to return."""
    from bluefog_tpu_torch.ops import collectives as C
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix_peer
    from bluefog_tpu_torch.topology import one_peer_exp2_mixing_matrix

    dev = ctx.device
    own = slice(ctx.owned_ranks.start, ctx.owned_ranks.stop)
    gen = torch.Generator(device=dev).manual_seed(606)
    x = torch.randn(N_RANKS, win_len, generator=gen, device=dev)
    mine = x[own].clone()
    C._aperiodic_tables.cache_clear()
    equal, host_ms = [], []
    gossip_mix_peer.launches = 0
    for t in range(2 * APERIODIC_ROUNDS):
        # the first rounds against the virtual K1; then as many more, whose
        # matrices and address tables (both parities) are cached
        w = one_peer_exp2_mixing_matrix(N_RANKS, t)
        torch.cuda.synchronize()
        ctx.transport.barrier()
        t0 = time.perf_counter()
        mine = C.neighbor_allreduce_aperiodic(mine, w)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if t < APERIODIC_ROUNDS:
            with _one_process():
                x = C.neighbor_allreduce_aperiodic(x, w)
            torch.cuda.synchronize()
            equal.append(torch.equal(mine, x[own]))
        if t == APERIODIC_ROUNDS - 1:
            launches = gossip_mix_peer.launches
    mine = x[own].clone()
    phases = 3  # ceil(log2 8) distinct matrices
    w1 = one_peer_exp2_mixing_matrix(N_RANKS, 1)
    capped = C.neighbor_allreduce_aperiodic(mine, w1, max_rotations=1)
    with _one_process():
        want = C.neighbor_allreduce_aperiodic(x, w1, max_rotations=1)[own]
    torch.cuda.synchronize()
    equal.append(torch.equal(capped, want))
    dense = torch.full((N_RANKS, N_RANKS), 1.0 / N_RANKS)
    nan = C.neighbor_allreduce_aperiodic(mine, dense, max_rotations=1)
    with _one_process():
        nan_virtual = C.neighbor_allreduce_aperiodic(x, dense,
                                                     max_rotations=1)
    nan_ok = bool(nan.isnan().all()) and bool(nan_virtual.isnan().all())
    del x, mine, capped, want, nan, nan_virtual
    torch.cuda.empty_cache()
    return {"equal": equal, "launches": launches, "nan": nan_ok,
            "new_ms": host_ms[:phases],
            "cached_ms": host_ms[APERIODIC_ROUNDS:]}


def mp_choco(ctx, win_len):
    """60 CHOCO rounds (``random_block_k(0.25)``, gamma 0.3, Ring(8)) over
    ResNet-50's buffer, each round's payloads in one exchange, against the
    same rounds in one process on the whole stack (this process computes
    them too), bit for bit; then 2 rounds of ``top_k(0.01)``, whose int32
    indices cross beside the values."""
    from bluefog_tpu_torch.ops import compression as CP
    from bluefog_tpu_torch.topology import RingGraph, build_schedule

    dev = ctx.device
    own = slice(ctx.owned_ranks.start, ctx.owned_ranks.stop)
    sched = build_schedule(RingGraph(N_RANKS))
    out = {}
    for name, comp, rounds in (("random_block_k", CP.random_block_k(0.25),
                                CHOCO_ROUNDS),
                               ("top_k", CP.top_k(0.01), 2)):
        gen = torch.Generator(device=dev).manual_seed(9)
        x = torch.randn(N_RANKS, win_len, generator=gen, device=dev)
        mine = x[own].clone()
        st = CP.choco_init(mine, sched)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            mine, st = CP.choco_gossip(mine, st, sched, compressor=comp,
                                       gamma=0.3)
        torch.cuda.synchronize()
        round_ms = (time.perf_counter() - t0) * 1e3 / rounds
        mirrors = st.xhat_nbrs
        del st
        with _one_process():
            ref = CP.choco_init(x, sched)
            for _ in range(rounds):
                x, ref = CP.choco_gossip(x, ref, sched, compressor=comp,
                                         gamma=0.3)
        torch.cuda.synchronize()
        out[name] = {"equal": torch.equal(mine, x[own])
                     and torch.equal(mirrors, ref.xhat_nbrs[own]),
                     "max_abs_err": max_err(mine, x[own])[0],
                     "round_ms": round_ms, "rounds": rounds}
        del x, mine, mirrors, ref
        torch.cuda.empty_cache()
    return out


def mp_ops(ctx, win_len):
    """``pair_gossip`` (K1's peer form, one partial slot), ``neighbor_
    allgather``, sender-weighted gossip (plain) and int64 rows, at the main
    path's length, each bit-equal to the same call in one process on the
    whole stack."""
    from bluefog_tpu_torch.ops import collectives as C
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix_peer
    from bluefog_tpu_torch.topology import (
        ExponentialTwoGraph, RingGraph, build_schedule)

    dev = ctx.device
    own = slice(ctx.owned_ranks.start, ctx.owned_ranks.stop)
    gen = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(N_RANKS, win_len, generator=gen, device=dev)
    perm = [(0, 1), (1, 0), (2, 5), (5, 2), (3, 7), (6, 4)]
    exp2 = build_schedule(ExponentialTwoGraph(N_RANKS))
    ring = build_schedule(RingGraph(N_RANKS))
    send_w = torch.rand(N_RANKS, ring.num_slots, generator=gen,
                        device=dev) + 0.5
    ints = torch.randint(-2 ** 62, 2 ** 62, (N_RANKS, 1001), generator=gen,
                         device=dev)
    gossip_mix_peer.launches = 0
    got = {"pair": C.pair_gossip(x[own].clone(), perm=perm,
                                 self_weight=0.3)}
    pair_launches = gossip_mix_peer.launches
    got["allgather"] = C.neighbor_allgather(x[own].clone(), exp2)[0]
    got["send_weights"] = C.neighbor_allreduce(
        x[own].clone(), ring, send_weights=send_w)
    got["int64"] = C.neighbor_allgather(ints[own].clone(), exp2)[0]
    checked = {}
    with _one_process():
        want = {"pair": lambda: C.pair_gossip(x, perm=perm, self_weight=0.3),
                "allgather": lambda: C.neighbor_allgather(x, exp2)[0],
                "send_weights": lambda: C.neighbor_allreduce(
                    x, ring, send_weights=send_w),
                "int64": lambda: C.neighbor_allgather(ints, exp2)[0]}
        for k, fn in want.items():
            ref = fn()[own]
            checked[k] = torch.equal(got[k], ref)
            del ref
    del x, got
    torch.cuda.empty_cache()
    return {"checked": checked, "pair_launches": pair_launches}


def mp_worker(argv):
    """One process of phase 19, started by the launcher: ``--mp-worker
    OUTDIR WHAT LENGTHS WIN_LEN`` (WHAT is ``all``, ``slice`` (all, then
    the slice's algorithms) or ``k1``; LENGTHS the main path's
    comma-separated per-rank lengths).  Writes its results to
    ``OUTDIR/p<process>.json``."""
    outdir, what, lengths, win_len = (argv[0], argv[1],
                                      [int(v) for v in argv[2].split(",")],
                                      int(argv[3]))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from bluefog_tpu_torch.runtime.launch import initialize_cluster

    initialize_cluster()
    import bluefog_tpu_torch as bf

    t0 = time.perf_counter()
    ctx = bf.init(size=N_RANKS)
    out = {"process": ctx.process_rank, "processes": ctx.process_count,
           "ranks": list(ctx.owned_ranks), "device": str(ctx.device)}
    parts = {"init": time.perf_counter() - t0}
    steps = [("k1", lambda: mp_k1(ctx, lengths))]
    if what in ("all", "slice"):
        steps += [("main", lambda: mp_main_path(ctx, outdir)),
                  ("k2", lambda: mp_k2(ctx, win_len)),
                  ("pushsum", lambda: mp_pushsum(ctx, win_len))]
    if what == "slice":
        steps += [("gt", lambda: mp_algo(ctx, outdir, "gt")),
                  ("ed", lambda: mp_algo(ctx, outdir, "ed")),
                  ("aperiodic", lambda: mp_aperiodic(ctx, win_len)),
                  ("choco", lambda: mp_choco(ctx, win_len)),
                  ("ops", lambda: mp_ops(ctx, win_len)),
                  ("gpt", lambda: mp_algo(ctx, outdir, "gpt")),
                  ("gpt_k1", lambda: mp_gpt_k1(ctx, out["gpt"]["payload"]))]
    for name, fn in steps:
        t1 = time.perf_counter()
        out[name] = fn()
        parts[name] = time.perf_counter() - t1
    out["seconds"] = parts
    bf.shutdown()
    with open(os.path.join(outdir, f"p{out['process']}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _run_processes(procs, what, lengths, win_len, outdir):
    """Start ``procs`` processes of this script through the launcher, wait
    for them (stopping the whole group at the time limit), and return their
    results in process order; a failed or late process fails the phase."""
    # the library is built (phase 1): the launcher need not look
    cmd = [sys.executable, "-m", "bluefog_tpu_torch.runtime.launch",
           "--no-build", "-np", str(procs), os.path.abspath(__file__),
           "--mp-worker", outdir, what,
           ",".join(map(str, lengths)), str(win_len)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=MP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        print(log[-6000:])
        check(False, f"{procs} processes did not finish in {MP_TIMEOUT_S} s")
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        print(log[-6000:])
    check(proc.returncode == 0,
          f"{procs} processes: the launcher exited {proc.returncode}")
    res = []
    for q in range(procs):
        with open(os.path.join(outdir, f"p{q}.json")) as f:
            res.append(json.load(f))
    return res, secs


def phase_processes(device, lengths, win_len):
    """Phase 19 (see the module docstring): the one-process reference run,
    then P = 2 and 4 processes (all checks) and P = 8 (K1's), each group
    started by the launcher."""
    import tempfile

    from bluefog_tpu_torch.examples.synthetic_benchmark import build, run

    t_phase = time.perf_counter()
    with deterministic_cudnn():
        trainer = build("resnet50", "neighbor", "exp2", size=N_RANKS,
                        batch_size=BATCH, image_size=224, device=device)
        run(trainer, WARMUP, TIMED)
    ref = {k: v.detach().cpu() for k, v in trainer.params.items()}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    refs = slice_references(device)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for procs in MP_PROCESSES:
            outdir = os.path.join(tmp, f"P{procs}")
            os.makedirs(outdir)
            what = ("k1" if procs == N_RANKS else
                    "slice" if procs == SLICE_PROCESSES else "all")
            res, secs = _run_processes(procs, what, lengths, win_len, outdir)
            tag = f"[processes P={procs}]"
            k1 = [r["k1"] for r in res]
            ok = all(c[2] and c[3] for r in k1 for c in r["checked"])
            parts = {k: round(max(r["seconds"][k] for r in res), 1)
                     for k in res[0]["seconds"]}
            print(f"{tag} {secs:.1f} s for the group ({what}; the slowest "
                  f"process's seconds after start-up: {parts}); ranks "
                  f"{[r['ranks'] for r in res]} on {res[0]['device']}")
            print(f"{tag} K1 peer form vs the virtual K1 (kernel, plain): "
                  f"{k1[0]['checked']}; bit-equal in every process: {ok}")
            check(ok, f"{tag} K1's peer form differs from the virtual K1")
            k1_ms = max(r["ms"] for r in k1)
            k1_plain = max(r["plain_ms"] for r in k1)
            print(f"{tag} K1 peer form at the main path's lengths, all "
                  f"processes together: {k1_ms:.4f} ms a step "
                  f"({len(lengths)} launch(es) a process), plain twin "
                  f"{k1_plain:.4f} ms, bound {k1[0]['bound_ms']:.4f} ms "
                  f"({k1[0]['bound_by']}: {k1[0]['bytes'] / 1e9:.3f} GB, "
                  f"{k1[0]['rows_a_rank']:g} rows a rank), "
                  f"{k1[0]['bound_ms'] / k1_ms:.1%} of it; the "
                  f"handshake alone (processes in step) "
                  f"{max(r['handshake_us'] for r in k1):.1f} us a call")
            entry = {"k1": {"ms": k1_ms, "plain_ms": k1_plain,
                            "bound_ms": k1[0]["bound_ms"],
                            "bound_by": k1[0]["bound_by"],
                            "rows_a_rank": k1[0]["rows_a_rank"],
                            "max_abs_err": max(r["max_abs_err"] for r in k1),
                            "handshake_us": max(r["handshake_us"]
                                                for r in k1)},
                     "seconds": secs}
            if what != "k1":
                entry.update(_report_processes(tag, procs, res, ref, outdir,
                                               len(lengths)))
            if what == "slice":
                entry["slice"] = _report_slice(tag, procs, res, refs, outdir)
            out[procs] = entry
    print(f"[processes] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _report_processes(tag, procs, res, ref, outdir, per_step):
    main = [r["main"] for r in res]
    for q, r in enumerate(main):
        print(f"{tag} process {q}: step ms "
              f"{[round(t, 2) for t in r['step_ms']]}, {r['img_s']:.1f} "
              f"img/s, device busy {r['busy_ms']:.2f} ms a step, idle "
              f"{r['idle']:.1%}; K1 peer launches {r['launches']}, virtual "
              f"{r['virtual_launches']}; handshakes {r['handshakes']}, one a "
              f"step, the timed steps' waits in them (for the other "
              f"processes) {[round(w) for w in r['waits_us']]} us; peak "
              f"{r['peak_gb']:.2f} GB")
        check(r["finite"], f"{tag} process {q}: non-finite loss")
        check(r["launches"] == per_step * (WARMUP + TIMED) and
              r["virtual_launches"] == 0,
              f"{tag} process {q}: K1 peer launches {r['launches']}, virtual "
              f"{r['virtual_launches']}")
        check(r["handshakes"] == WARMUP + TIMED,
              f"{tag} process {q}: {r['handshakes']} handshakes in "
              f"{WARMUP + TIMED} steps")
    total = sum(r["img_s"] for r in main)
    rates = ", ".join(f"{r['img_s']:.1f}" for r in main)
    print(f"{tag} ResNet-50 x {N_RANKS} ranks over {procs} processes, exp2, "
          f"batch {BATCH}/rank, deterministic cuDNN: {total:.1f} img/s over "
          f"all processes ({rates}); a step's pack into the staged buffers, "
          f"all processes: {max(r['pack_ms'] for r in main):.4f} ms against "
          f"a {main[0]['pack_bound_ms']:.4f} ms bound (bytes); the one-process"
          f" plan's pack (the fused buffer, then the 8 MiB leaves copied) "
          f"{max(r['split_pack_ms'] for r in main):.4f} ms")
    worst = 0.0
    for q in range(procs):
        got = torch.load(os.path.join(outdir, f"params_{q}.pt"))
        rows = res[q]["ranks"]
        for k, v in got.items():
            want = ref[k][rows[0]:rows[-1] + 1]
            d = float((v.double() - want.double()).abs().max())
            worst = max(worst, d / max(float(want.double().abs().max()),
                                       1e-12))
    print(f"{tag} parameters after {WARMUP + TIMED} steps against the "
          f"one-process run: max |diff| / max |value| {worst:.3e} (tol "
          f"{STEP_TOL:.3e})")
    check(worst <= STEP_TOL, f"{tag} parameters differ from one process")
    k2 = [r["k2"] for r in res]
    ok = all(c[3] for r in k2 for c in r["checked"])
    print(f"{tag} K2 peer form put then acc vs the virtual K2: "
          f"{k2[0]['checked']}; bit-equal in every process: {ok}; put "
          f"{max(r['put'] for r in k2):.4f} ms, acc "
          f"{max(r['acc'] for r in k2):.4f} ms (exp2, all processes)")
    check(ok, f"{tag} K2's peer form differs from the virtual K2")
    push = [r["pushsum"] for r in res]
    print(f"{tag} push-sum over processes: sum(p) = {push[0]['p_sum']!r} "
          f"(want 11.5), equal to one process: "
          f"{all(r['equal'] for r in push)}, K2 peer launches "
          f"{[r['launches'] for r in push]}; round ms "
          f"{[round(t, 3) for t in push[0]['round_ms']]}; K2 peer acc "
          f"{max(r['ms'] for r in push):.4f} ms a round (plain "
          f"{max(r['plain_ms'] for r in push):.4f}), bound "
          f"{push[0]['bound_ms']:.4f} ms")
    check(all(r["p_sum"] == 11.5 for r in push), f"{tag} push-sum lost p")
    check(all(r["equal"] for r in push),
          f"{tag} push-sum differs from one process")
    check(all(r["launches"] == PUSH_ROUNDS for r in push),
          f"{tag} push-sum K2 peer launches {[r['launches'] for r in push]}")
    return {
        "main": {"img_s": total, "process_img_s": [r["img_s"] for r in main],
                 "step_ms": [r["step_ms"] for r in main],
                 "idle": [r["idle"] for r in main],
                 "launches": sum(r["launches"] for r in main),
                 "handshake_waits_us": [r["waits_us"] for r in main],
                 "pack_ms": max(r["pack_ms"] for r in main),
                 "split_pack_ms": max(r["split_pack_ms"] for r in main),
                 "pack_bound_ms": main[0]["pack_bound_ms"],
                 "params_rel_err": worst},
        "k2": {"put_ms": max(r["put"] for r in k2),
               "acc_ms": max(r["acc"] for r in k2),
               "max_abs_err": max(r["max_abs_err"] for r in k2)},
        "pushsum": {"ms": max(r["ms"] for r in push),
                    "plain_ms": max(r["plain_ms"] for r in push),
                    "bound_ms": push[0]["bound_ms"],
                    "bound_by": push[0]["bound_by"],
                    "launches": sum(r["launches"] for r in push),
                    "max_abs_err": max(r["max_abs_err"] for r in push)},
    }


def _held(got_file, ref, rows):
    """max |diff| / max |value| of the saved state against the reference's
    rows, over every tensor, and whether every tensor is bit-equal."""
    got = torch.load(got_file)
    worst, equal = 0.0, True
    for k, v in got.items():
        want = ref[k][rows[0]:rows[-1] + 1]
        equal = equal and torch.equal(v, want)
        d = float((v.double() - want.double()).abs().max())
        worst = max(worst, d / max(float(want.double().abs().max()), 1e-12))
    return worst, equal


def _report_slice(tag, procs, res, refs, outdir):
    """The slice's checks at P = 2 (see the module docstring), printed and
    returned."""
    out = {}
    k3_per_step = 12 * N_RANKS
    for algo, per_step in (("gt", 2), ("ed", 1), ("gpt", 1)):
        runs = [r[algo] for r in res]
        worst, equal = 0.0, True
        for q, r in enumerate(res):
            w, e = _held(os.path.join(outdir, f"{algo}_{q}.pt"), refs[algo],
                         r["ranks"])
            worst, equal = max(worst, w), equal and e
        launches = [r["launches"] for r in runs]
        step_ms = [sum(r["step_ms"]) / TIMED for r in runs]
        rate = sum(r["samples"] / (ms / 1e3) for r, ms in zip(runs, step_ms))
        one = refs[f"{algo}/samples"] / (refs[f"{algo}/step_ms"] / 1e3)
        unit = "seq" if algo == "gpt" else "img"
        extra = ""
        if algo == "gpt":
            k3 = [sum(r["k3"][i] for r in runs) for i in range(3)]
            extra = (f"; K3 launches over the processes (forward, dK/dV, dQ)"
                     f" {k3}, {[v // (WARMUP + TIMED) for v in k3]} a step; "
                     f"{rate * GPT_SEQ:.1f} tokens/s over all processes "
                     f"against one process's {one * GPT_SEQ:.1f}")
            check(all(v == k3_per_step * (WARMUP + TIMED) for v in k3),
                  f"{tag} gpt: K3 launches {k3}")
        print(f"{tag} {algo}: step ms by process "
              f"{[round(v, 2) for v in step_ms]} (one process "
              f"{refs[f'{algo}/step_ms']:.2f}), {rate:.1f} {unit}/s over all "
              f"processes (one process {one:.1f}); K1 peer launches "
              f"{launches} ({per_step} a step a process), virtual "
              f"{[r['virtual_launches'] for r in runs]}; losses "
              f"{[round(v, 4) for v in runs[0]['losses']]}; peak "
              f"{max(r['peak_gb'] for r in runs):.2f} GB{extra}; state after "
              f"{WARMUP + TIMED} steps against one process: max |diff| / max "
              f"|value| {worst:.3e} (tol {STEP_TOL:.3e}), bit-equal: {equal}")
        check(all(r["finite"] for r in runs), f"{tag} {algo}: non-finite loss")
        check(all(v == per_step * (WARMUP + TIMED) for v in launches)
              and all(r["virtual_launches"] == 0 for r in runs),
              f"{tag} {algo}: K1 peer launches {launches}")
        check(worst <= STEP_TOL, f"{tag} {algo}: state differs from one "
              f"process: {worst}")
        out[algo] = {"step_ms": step_ms, "rate": rate, "one_process": one,
                     "launches": sum(launches), "rel_err": worst,
                     "bit_equal": equal}
        if algo == "gpt":
            out[algo]["k3"] = k3
    ap = [r["aperiodic"] for r in res]
    ok = all(all(r["equal"]) for r in ap)
    new_ms = [round(v, 3) for r in ap for v in r["new_ms"]]
    cached_ms = [round(v, 3) for r in ap for v in r["cached_ms"]]
    print(f"{tag} aperiodic (callable one-peer Exp-2, {APERIODIC_ROUNDS} "
          f"rounds + the capped form) on K1's peer form vs the virtual K1: "
          f"bit-equal in every process: {ok}; capped over its cap NaN as the "
          f"virtual form: {all(r['nan'] for r in ap)}; K1 peer launches "
          f"{[r['launches'] for r in ap]}; host ms of a call, new matrix "
          f"{new_ms}, cached {cached_ms}")
    check(ok and all(r["nan"] for r in ap),
          f"{tag} the aperiodic gossip differs from the virtual K1")
    check(all(r["launches"] == APERIODIC_ROUNDS for r in ap),
          f"{tag} aperiodic K1 peer launches {[r['launches'] for r in ap]}")
    out["aperiodic"] = {"new_ms": new_ms, "cached_ms": cached_ms,
                        "launches": sum(r["launches"] for r in ap)}
    ch = [r["choco"] for r in res]
    for name in ch[0]:
        ok = all(r[name]["equal"] for r in ch)
        print(f"{tag} CHOCO {name}, {ch[0][name]['rounds']} rounds over "
              f"ResNet-50's buffer: equal to one process: {ok}; "
              f"{max(r[name]['round_ms'] for r in ch):.3f} ms a round")
        check(ok, f"{tag} CHOCO {name} differs from one process")
    out["choco"] = {k: max(r[k]["round_ms"] for r in ch) for k in ch[0]}
    ops = [r["ops"] for r in res]
    ok = all(all(r["checked"].values()) for r in ops)
    print(f"{tag} pair_gossip, neighbor_allgather, send_weights, int64 rows "
          f"at {N_RANKS} x ResNet-50's length vs one process: "
          f"{ops[0]['checked']}, in every process: {ok}; pair_gossip's K1 "
          f"peer launches {[r['pair_launches'] for r in ops]}")
    check(ok, f"{tag} an op differs from one process: "
          f"{[r['checked'] for r in ops]}")
    check(all(r["pair_launches"] == 1 for r in ops),
          f"{tag} pair_gossip did not run K1's peer form")
    k1 = [r["gpt_k1"] for r in res]
    ms = max(r["ms"] for r in k1)
    plain_ms = max(r["plain_ms"] for r in k1)
    equal = all(r["equal"] for r in k1)
    err = max(r["max_abs_err"] for r in k1)
    print(f"{tag} K1 peer form on GPT-small's payload ({k1[0]['length']:,} "
          f"f32 a rank, one launch a process): bit-equal to its plain twin "
          f"in every process: {equal} (max |diff| {err:.3e}); {ms:.4f} ms a "
          f"step, all processes (plain twin by column slices "
          f"{plain_ms:.4f} ms), bound {k1[0]['bound_ms']:.4f} ms "
          f"({k1[0]['bound_by']}, {k1[0]['rows_a_rank']:g} rows a rank), "
          f"{k1[0]['bound_ms'] / ms:.1%} of it")
    check(equal, f"{tag} K1's peer form on GPT-small's payload differs from "
          f"its plain twin: {err}")
    out["gpt_k1"] = {**k1[0], "ms": ms, "plain_ms": plain_ms, "equal": equal,
                     "max_abs_err": err}
    return out


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--mp-worker":
        return mp_worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bluefog_tpu_torch.examples.synthetic_benchmark import build
    from bluefog_tpu_torch.ops.collectives import fuse_plan
    from bluefog_tpu_torch.ops.deliver_kernel import window_deliver
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix

    # f32 convolutions and matmuls in full f32 wherever a comparison runs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; TF32 off for cuDNN and matmul")

    phase_build()
    trainer = build("resnet50", "neighbor", "exp2", size=N_RANKS,
                    batch_size=BATCH, image_size=224, device=device)
    leaves = list(trainer.params.values())
    groups, big = fuse_plan(leaves)
    main_lengths = ([sum(leaves[i][0].numel() for i in idx)
                     for idx in groups.values()]
                    + [leaves[i][0].numel() for i in big])
    # across processes on the card every leaf fuses (fuse_apply)
    mp_lengths = [sum(leaves[i][0].numel() for i in idx)
                  for idx in fuse_plan(leaves, None)[0].values()]
    win_len = sum(p[0].numel() for p in leaves)
    print(f"[plan] ResNet-50: {win_len:,} f32 params in {len(leaves)} "
          f"leaves; fuse plan = {len(groups)} fused buffer(s) + {len(big)} "
          f"leaves >= 8 MiB -> per-rank lengths {main_lengths}; across "
          f"processes {mp_lengths}")
    del trainer, leaves
    torch.cuda.empty_cache()
    procs = phase_processes(device, mp_lengths, win_len)
    trainer = build("resnet50", "neighbor", "exp2", size=N_RANKS,
                    batch_size=BATCH, image_size=224, device=device)
    leaves = list(trainer.params.values())
    k1 = phase_k1(device, main_lengths)
    k1_launches = phase_main_path(
        trainer, {gossip_mix: len(main_lengths)}, "main",
        f"ResNet-50 x {N_RANKS} virtual ranks, exp2, batch {BATCH}/rank, "
        "bf16")[0]["gossip_mix"]
    phase_step_parity(trainer, "parity")
    phase_host_breakdown(trainer, "main")
    del trainer, leaves
    torch.cuda.empty_cache()

    k2, k2_acc, k2_push = phase_k2(device, win_len)
    torch.cuda.empty_cache()
    trainer = build("resnet50", "winput", "exp2", size=N_RANKS,
                    batch_size=BATCH, image_size=224, device=device)
    window = trainer.opt.window
    per_put = len(window.bufs)
    print(f"[winput] window layout: {per_put} buffer(s) "
          f"{[(str(dt)[6:], tuple(b.shape)) for dt, b in window.bufs.items()]}"
          f" + landing slots "
          f"{[tuple(b.shape) for b in window.peers.values()]} -> {per_put} "
          f"K2 launch(es) per put, one put per step")
    check(per_put == 1, f"ResNet-50's f32 window should be one buffer, got "
          f"{per_put}")
    k2_launches = phase_main_path(
        trainer, {window_deliver: per_put}, "winput",
        f"ResNet-50 x {N_RANKS} virtual ranks, exp2, WinPut, batch "
        f"{BATCH}/rank, bf16")[0]["window_deliver"]
    phase_host_breakdown(trainer, "winput")
    with deterministic_cudnn():
        phase_host_breakdown(trainer, "winput, deterministic cuDNN")
    spread_ranks(trainer, seed=7)
    phase_step_parity(trainer, "winput")
    phase_closed_form(trainer)
    update_ms = phase_window_update(window)
    del trainer, window
    torch.cuda.empty_cache()
    push_launches = phase_pushsum(device, win_len)

    k3 = phase_k3(device)
    torch.cuda.empty_cache()
    k3_launches = phase_gpt(device)

    allreduce = phase_allreduce(device, main_lengths)
    hier = phase_hierarchical(device, main_lengths)
    phase_imagenet(main_lengths)
    phase_mnist()

    routing = phase_routing(device, main_lengths)
    dynamic = phase_dynamic(device, main_lengths)
    tracking = phase_tracking(device, main_lengths)
    choco = phase_choco(device, win_len)
    examples = phase_examples()

    sl = procs[SLICE_PROCESSES]["slice"]
    fa = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    via = "(via bluefog_tpu/ops/ring_attention.py:122)"
    kernels = [{
        "name": "gossip_mix",
        "route": "cuda",
        "source": "bluefog_tpu_torch/csrc/gossip_mix.cu",
        "replaces": "bluefog_tpu/ops/pallas_gossip.py:388",
        "launches": k1_launches,
        **k1,
        "one_slot": dynamic["one_slot"],
        "launches_on_other_paths": {
            "dynamic": dynamic["launches"],
            **{tag: v["launches"] for tag, v in tracking.items()}},
        "non_circulant": routing,
    }, {
        "name": "window_deliver",
        "route": "cuda",
        "source": "bluefog_tpu_torch/csrc/window_deliver.cu",
        "replaces": "bluefog_tpu/ops/pallas_gossip.py:460",
        "launches": k2_launches,
        **k2,
    }, {
        "name": "gossip_mix_peer",
        "route": "cuda",
        "source": "bluefog_tpu_torch/csrc/gossip_mix.cu",
        "replaces": "bluefog_tpu/ops/pallas_gossip.py:388",
        "launches": procs[4]["main"]["launches"],
        "max_abs_err": max([v["k1"]["max_abs_err"] for v in procs.values()]
                           + [sl["gpt_k1"]["max_abs_err"]]),
        **{k: procs[4]["k1"][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "rows_a_rank")},
        "library_ms": k1["library_ms"],
        "processes": 4,
        "by_processes": {str(p): v["k1"] for p, v in procs.items()},
        "launches_on_slice_paths": {
            k: sl[k]["launches"] for k in ("gt", "ed", "gpt", "aperiodic")},
        "gpt_payload": sl["gpt_k1"],
    }, {
        "name": "window_deliver_peer",
        "route": "cuda",
        "source": "bluefog_tpu_torch/csrc/window_deliver.cu",
        "replaces": "bluefog_tpu/ops/pallas_gossip.py:460",
        "launches": procs[4]["pushsum"]["launches"],
        "max_abs_err": max(max(v["pushsum"]["max_abs_err"],
                               v["k2"]["max_abs_err"])
                           for v in procs.values() if "pushsum" in v),
        **{k: procs[4]["pushsum"][k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by")},
        "library_ms": k2_push["library_ms"],
        "processes": 4,
        "by_processes": {str(p): {**v["pushsum"], **v["k2"]}
                         for p, v in procs.items() if "pushsum" in v},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"bluefog_tpu_torch/csrc/{src}",
        "replaces": f"{fa}:{line} {via}",
        "launches": k3_launches[name],
        **k3[part],
        "launches_over_processes": sl["gpt"]["k3"][i],
    } for i, (name, part, src, line) in enumerate((
        ("flash_forward", "fwd", "flash_attention.cu", 589),
        ("flash_backward_dkv", "dkv", "flash_attention_bwd.cu", 941),
        ("flash_backward_dq", "dq", "flash_attention_bwd.cu", 1287)))]
    print("kernels: K1 gossip_mix (cuda, bluefog_tpu_torch/csrc/gossip_mix.cu"
          f", replaces neighbor_allreduce_pallas): {k1_launches} launches on "
          f"the main path, {k1['ms']:.4f} ms per step against a "
          f"{k1['bound_ms']:.4f} ms bound; K2 window_deliver (cuda, "
          "bluefog_tpu_torch/csrc/window_deliver.cu, replaces deliver_pallas)"
          f": {k2_launches} launches on the WinPut path, put {k2['ms']:.4f} "
          f"ms per step against a {k2['bound_ms']:.4f} ms bound, acc "
          f"{k2_acc['ms']:.4f} ms against {k2_acc['bound_ms']:.4f} ms, "
          f"push-sum acc {k2_push['ms']:.4f} ms against "
          f"{k2_push['bound_ms']:.4f} ms ({push_launches} launches in "
          f"{PUSH_ROUNDS} rounds); win_update {update_ms:.4f} ms; K3 (cuda,"
          " bluefog_tpu_torch/csrc/flash_attention.cu, replaces the library "
          "flash_attention of local_attention; the bf16 backward in "
          "flash_attention_bwd.cu) on the GPT path: "
          + ", ".join(f"{n} {k3_launches[n]} launches, {k3[p]['ms']:.4f} ms "
                      f"against a {k3[p]['bound_ms']:.4f} ms bound"
                      for n, p in (("flash_forward", "fwd"),
                                   ("flash_backward_dkv", "dkv"),
                                   ("flash_backward_dq", "dq"))))
    print(f"K1 on this slice's paths: one-slot (dynamic exp2) "
          f"{dynamic['one_slot']['ms']:.4f} ms a step against a "
          f"{dynamic['one_slot']['bound_ms']:.4f} ms bound; launches in "
          f"{WARMUP + TIMED} steps + 1 profiled: dynamic "
          f"{dynamic['launches']}, "
          + ", ".join(f"{tag} {v['launches']}" for tag, v in tracking.items())
          + "; on the grid and the star: "
          + ", ".join(f"{name} ({v['slots']} slots) {v['ms']:.4f} ms against "
                      f"{v['bound_ms']:.4f} ms" for name, v in routing.items())
          + f"; CHOCO (plain PyTorch, no kernel) {choco['round_ms']:.3f} ms a "
          f"round over ResNet-50's buffer, ResNet-50 step "
          f"{choco['step_ms']:.2f} ms; examples "
          + ", ".join(f"{k} {v:.2f} s" for k, v in examples.items()))
    print(f"not a TPU kernel: the allreduce (plain PyTorch; lax.psum in the "
          f"JAX package) {allreduce['ms']:.4f} ms per step against a "
          f"{allreduce['bound_ms']:.4f} ms bound, torch.mean(dim=0) "
          f"{allreduce['library_ms']:.4f} ms; K1 on the hierarchical path: "
          + ", ".join(f"local size {k} {v['launches']} launches in "
                      f"{WARMUP + TIMED} steps" for k, v in hier.items()))
    print("ranks over processes sharing the card: "
          + "; ".join(
              f"P={p}: K1 peer {v['k1']['ms']:.4f} ms a step against "
              f"{v['k1']['bound_ms']:.4f} ms"
              + f", handshake {v['k1']['handshake_us']:.1f} us"
              + (f", ResNet-50 {v['main']['img_s']:.1f} img/s, push-sum K2 "
                 f"peer acc "
                 f"{v['pushsum']['ms']:.4f} ms" if "main" in v else "")
              for p, v in procs.items()))
    print(f"the slice's algorithms over {SLICE_PROCESSES} processes: "
          + ", ".join(f"{k} {sl[k]['rate']:.1f} {'seq' if k == 'gpt' else 'img'}"
                      f"/s (one process {sl[k]['one_process']:.1f}), "
                      f"bit-equal {sl[k]['bit_equal']}"
                      for k in ("gt", "ed", "gpt"))
          + f"; K1 peer on GPT's payload {sl['gpt_k1']['ms']:.4f} ms against "
          f"{sl['gpt_k1']['bound_ms']:.4f} ms; aperiodic host ms new "
          f"{sl['aperiodic']['new_ms']}, cached {sl['aperiodic']['cached_ms']}")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

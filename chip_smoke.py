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
   1 + 2 steps under deterministic cuDNN, as the reference; then the same
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
   and write); runs the main path for 1 + 2 steps under deterministic cuDNN
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
   Ring(8) over ResNet-50, 1 + 2 steps each under deterministic cuDNN
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
   rank, 1 + 2 steps (96 launches of each K3 kernel a step over the
   processes, 1 K1 peer launch a step a process, parameters within 2^-7 of
   one process's), and K1's peer form on GPT's one staged payload, bit-equal
   to its plain twin on the same rows (folded in column slices) and timed
   against its bytes bound.
   P = 8, one rank a process (PyTorch's one process a GPU layout, m = 1),
   K1's check and times only, runs in phase 30's P = 8 group.  A process
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
   allreduce paths timed in turns, 6 steps each (once 16; phases 1c and
   18-22 took the time).
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
1c. (Run after phase 1b, while this process holds no tensors.) BERT-large
   over processes: phase 18's path with the same 8 ranks over 2 processes,
   each holding 2 machines of local size 2 (``--mp-worker ... bert``), 2 +
   3 steps under deterministic algorithms (cuDNN's, PyTorch's, and cuBLAS's
   workspace pinned by ``CUBLAS_WORKSPACE_CONFIG``), one K1 peer launch a
   step a process; each process's parameters are saved for phase 18, whose
   one-process run under the same settings they must equal bit for bit.
   Then K1's peer form on the machine rows (2 machine means of 335,141,892
   f32 a process, the fused rows padded to 16 bytes) bit for bit against
   its plain twin, and timed against its bytes bound.
18. BERT-large (BASELINE.json ``configs[4]``) at full width (vocab 30522,
   width 1024, 24 layers, 16 heads, FFN 4096, bf16 compute, f32 params)
   fine-tuned with ``DistributedHierarchicalNeighborAllreduceOptimizer``
   over 8 virtual ranks, machines of 2 on Ring(4), through
   ``synthetic_benchmark --model bert-large --comm hierarchical
   --local-size 2`` at seq 128 and batch 32 a rank: 2 + 3 steps under
   deterministic algorithms, K1's launches on the machine rows against the
   fuse plan (74 a step), seq/s, tokens/s, peak memory, a profiled step's
   idle share; its parameters after the 5 steps bit-equal to phase 1c's
   processes'; one K1 step bit-equal to the plain-fold step (the state's
   copies on the host), and K1 on the machine rows against its plain
   version, its bound and ``torch.matmul(W, x)``.
19. ``examples.bert_finetune_hierarchical --model large --local-size 2``
   at 1 epoch (its default 3, cut for the script's time limit when phases
   24-29 and then phase 30 came) and its ``--n-per-rank``, under
   deterministic algorithms,
   then with ``--two-level-mesh``: loss, accuracy and seq/s per epoch, the
   parameter spread, K1's launches, and the two forms' parameters, which
   must be bit-equal.
20. The gates: ``examples.mnist_epoch_gate`` at its defaults and
   ``examples.cifar_resnet_gate --filters 64`` at its defaults, each
   asserting its target and its parity with the allreduce arm; both arms'
   accuracy, img/s and seconds, and K1's launches.
21. Checkpoints: ``examples.imagenet_resnet`` (ResNet-50, 8 x 32 at 64x64,
   synthetic data) for 3 epochs with a checkpoint each epoch, and a fresh
   process resuming from a copy of its epoch-2 checkpoint to epoch 3, each
   under deterministic cuDNN: the epoch-3 parameters and momentum
   bit-equal, the saved BatchNorm statistics the rank mean; bytes, save and
   load ms.  Then
   ``examples.elastic_resume``, 8 ranks to 4, on K1 (210 launches).
22. ViT-base/16 at 224 over 8 virtual ranks through ``synthetic_benchmark
   --model vit-base --comm neighbor``: 2 + 3 steps, K1's launches, no K3
   launch (197 tokens take the dense path), img/s and idle share.
24. (Run right after phase 7.) K3 against its twins at the new paths'
   shapes, bf16 causal, q, k and v views of one projection: (16, 6, 1024,
   64) (the TP path, tp 2 x batch 8 folded into K3's batch) and (4, 3,
   4096, 64) (Ulysses, 4 ranks, 3 heads a rank): every output within K3's
   tolerances, the three kernels' device times against their bounds and
   twins, and SDPA's forward.
25. Sequence parallelism, GPT-small at batch 1: ring attention (contiguous
   and zigzag) over 8 virtual ranks of 1024 tokens (T = 8192), Ulysses over
   4 (T = 4096, K3 at the global T).  In f32 and in bf16, remat off and on:
   the logits and one step's gradients against the whole-sequence model
   (``local_attention`` on the full T, K3), within 2^-7 in f32 and 2^-4 in
   bf16; remat's gradients against no remat's (bit-equality recorded).
   Then bf16 AdamW steps with and without remat: tokens/s, peak memory,
   K3's launches a step (Ulysses: 12, 24 forwards with remat).
26. Tensor parallelism, ``TPTransformerLM`` at GPT-small's widths: in f32 on
   one tp 2 group at batch 2 x 1024, the gathered parameters replayed at tp
   = 1 through the dense ``TransformerLM`` give its logits and the
   corrected gradients (through the rule table) its gradients, within
   2^-7; then bf 4 x tp 2 in bf16, batch 8 x 1024 a bf rank, AdamW 3e-4
   (decay 0.01) gossiping over Exponential-2(4): 48 launches of each K3
   kernel a step and K1's per the fuse plan, tokens/s; then the AdamW step
   through K1 against the same step through the plain fold from the same
   state, bit for bit.
27. Hybrid dp 2 x pp 2 x tp 2: GPT-small's 12 TPBlocks, 6 a stage, bf16,
   M = 4 microbatches of 2 x 1024 a dp rank under 1F1B and GPipe (tokens
   embedded before injection, the head folded into the loss): in f32 both
   schedules' corrected gradients within 2^-7 of each other and of the
   unpipelined TP step's; in bf16 the two schedules within 2^-7 of each
   other, each one's peak memory, tokens/s and K3's launches; an SGD step
   of both dp ranks gossiped over dp on K1, bit-equal to the plain fold of
   the same fused buffers.
28. Expert parallelism: ``expert_parallel_ffn`` against
   ``moe_ffn_reference`` in f32 at width 768, 8 experts (4 x 512 tokens,
   ample capacity), both routers; then ``MoETransformerLM`` (GPT-small
   trunk, 8 experts), top-1 and top-2, dp 2 x ep 4, batch 4 x 1024 a rank
   in bf16, AdamW gossiping over dp on K1: the (T, E, C) dispatch memory
   reckoned first, the dropped fraction, tokens/s, 24 launches of each K3
   kernel a step and K1's per the fuse plan; the AdamW step through K1
   bit-equal to the plain fold's; each layer's dropped fraction, expert
   load and the mean cosine between a sequence's last 512 tokens at its
   input (the embeddings' routing beside them), and ``expert_parallel_ffn``
   against ``moe_ffn_reference`` on the inputs of the layer that drops the
   most, at the path's own capacity (640 / 1280), in f32.
29. ``examples.longcontext_lm`` at its defaults, once for each ``--attn``,
   each ending OK.
   After each of phases 25-29, K3 against its twins (correctness only) at
   every (shape, dtype, causal) that the phase handed it which no earlier
   check took: MoE's (16, 12, 1024, 64), the pipeline's stage shapes and
   the f32 parity runs' among them.
30. Gossip of meshes and the mesh axes over processes (GPT-small's
   published widths).  In this process first: path 1, TP bf 4 x tp 2 with
   its parameters placed by ``make_shard_and_gather_fns`` from
   ``tp_param_rules`` (full leaves gathered from a seeded tp-2 model), the
   AdamW state by ``shard_optimizer_state`` and the bf gossip through
   ``sharded_neighbor_allreduce`` on K1: 3 steps bit-equal to phase 26's
   optimizer on the same gradients, K1 against its plain fold, and WinPut
   over a window declared by ``win_create(rule_table=)`` on K2 against
   the plain put; then the f32 references the processes compare with
   (path 1's tp group, the ring, zigzag and Ulysses models, MoE, the
   hybrid's 1F1B step), saved in a temporary directory.  Then three groups
   through the launcher (``--mesh-worker``), each process holding the mesh
   positions of its ranks, the collectives of a group that spans
   processes going through the transport: P = 2, path 1 with bf across the
   processes (the state bit-equal to this process's, by sha1 of each row),
   its WinPut on K2's peer form, the sequence paths (ring and zigzag over 8
   sp ranks at T = 8192, Ulysses over 4 at 4,096; f32 logits and the
   gradients summed by ``reduce_partials`` within 2^-7, bf16 AdamW steps)
   and ``examples.longcontext_lm`` at 10 steps for each ``--attn``;
   P = 4, MoE top-1 dp 2 x ep 4 (each ep group over two processes; f32
   within 2^-7, bf16 steps, each block under remat, gossiping over dp on
   K1's peer form, K1 against its plain fold) and the hybrid dp 2 x pp 2 x tp 2 (the stage hops
   across processes; the f32 1F1B and GPipe gradients within 2^-7, bf16
   schedules, a dp step on K1's peer form bit-equal to the plain fold);
   P = 8, path 1 with tp across the processes (f32 logits and corrected
   gradients within 2^-7, the tp psum alone, bf16 steps).  Each path
   reports tokens/s against this run's one-process form, its collectives'
   calls, bytes and host seconds a step, one collective alone against its
   bytes bound, peak GB a process and K3's launches a process; K3 is held
   against its twins at every shape the processes handed it.
23. Report: a ``kernels:`` line, a line for K1 on this slice's paths and a
   line for the allreduce (not a TPU kernel), the kernels' JSON line (K1,
   K2 and K3's three kernels; K1's entry also carries its one-slot times,
   its launches on the new paths and its times on the grid and the star),
   the card's name and power limit from nvidia-smi, and the result line.
   The JSON line also holds K1's and K2's peer forms
   (``gossip_mix_peer``, ``window_deliver_peer``) at P = 4, with the other
   process counts under ``by_processes``, and a line sums phase 1b up.
   K1's entry carries its launches on phases 18-22's paths and its times
   on BERT's machine rows, the peer form's its launches on BERT over
   processes; a line sums phases 1c and 18-22 up.  K1's entry also carries
   its launches on phases 26-28's gossip and their parity with the plain
   fold, K3's their launches on the TP, Ulysses, pipeline and MoE paths,
   their times at phase 24's shapes and every shape held against the
   twins; a line sums phases 24-29 up.

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
import tempfile
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
    same per kernel name, largest first.  Three traces are taken and the
    one with the median total is kept: a trace can lose events (on an H100
    one read SDPA's forward as 0, another K3's as 0.0279 ms against
    0.0398 ms from a later trace of the same call)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    traces = []
    for _ in range(3):
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
        traces.append((sum(by_name.values()), by_name))
    total, by_name = sorted(traces, key=lambda t: t[0])[1]
    check(total > 0, "torch.profiler recorded no device time")
    return total, sorted(by_name.items(), key=lambda kv: -kv[1])


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


def phase_main_path(trainer, kernels, tag, what, unit="img", top=8,
                    after_run=None):
    """Drive a trainer's path: every kernel wrapper's launch count in
    ``kernels`` (wrapper -> launches per step) is set to 0 just before the
    run and read just after it, and must equal its launches per step times
    the steps.  ``after_run(trainer)``, if given, runs right after those
    steps, before the profiled one.  Returns the counts, wrapper name ->
    launches."""
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
    if after_run is not None:
        after_run(trainer)
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
    res["profile"], res["peak_gb"] = prof, peak_gb
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
    # 3 steps at a time, in turns (neighbor, allreduce, allreduce,
    # neighbor)
    gossip = build("resnet50", "neighbor", "exp2", size=N_RANKS,
                   batch_size=BATCH, image_size=224, device=device)
    run(gossip, WARMUP, 0)
    turns = {"neighbor": [], "allreduce": []}
    for name in ("neighbor", "allreduce", "allreduce", "neighbor"):
        gc.collect()
        tr = gossip if name == "neighbor" else trainer
        turns[name] += run(tr, 0, 3)["step_ms"]
    means = {k: sum(v) / len(v) for k, v in turns.items()}
    print(f"[allreduce] in turns, 6 steps each: neighbor "
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
# Phase 1b: the ranks spread over processes that share the card
# ---------------------------------------------------------------------------

# P = 8, one rank a process, K1's check only, runs in phase 30's P = 8 group
# (one group start fewer)
MP_PROCESSES = (2, 4)
# steps of phase 1b's runs over processes and of their one-process
# references (2 + 3 until PR 12; cut to make room for phase 30)
MP_WARMUP, MP_TIMED = 1, 2
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
    """The ResNet-50 main path over this process's ranks, 1 + 2 steps under
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
        res = run(trainer, MP_WARMUP, 0)
        waits_us = []
        for _ in range(MP_TIMED):
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
    mean_ms = sum(res["step_ms"]) / MP_TIMED
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
    """The one-process runs the P = 2 group is held against: 1 + 2 steps
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
            res = run(trainer, MP_WARMUP, MP_TIMED)
        refs[algo] = _slice_state(trainer, algo)
        refs[f"{algo}/step_ms"] = sum(res["step_ms"]) / MP_TIMED
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
    this process's ranks, 1 + 2 steps (deterministic cuDNN for ResNet-50):
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
        res = run(trainer, MP_WARMUP, MP_TIMED)
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
    """One process of phase 1b, started by the launcher: ``--mp-worker
    OUTDIR WHAT LENGTHS WIN_LEN`` (WHAT is ``all``, ``slice`` (all, then
    the slice's algorithms) or ``bert`` (BERT-large alone); LENGTHS
    the main path's comma-separated per-rank lengths).  Writes its results to
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
    steps = ([("bert", lambda: mp_bert(ctx, outdir))] if what == "bert"
             else [("k1", lambda: mp_k1(ctx, lengths)),
                   ("main", lambda: mp_main_path(ctx, outdir)),
                   ("k2", lambda: mp_k2(ctx, win_len)),
                   ("pushsum", lambda: mp_pushsum(ctx, win_len))])
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


def _run_processes(procs, what, lengths, win_len, outdir, env_extra=None):
    """Start ``procs`` processes of this script through the launcher (with
    ``env_extra`` added to their environment), wait for them (stopping the
    whole group at the time limit), and return their results in process
    order; a failed or late process fails the phase."""
    # the library is built (phase 1): the launcher need not look
    cmd = [sys.executable, "-m", "bluefog_tpu_torch.runtime.launch",
           "--no-build", "-np", str(procs), os.path.abspath(__file__),
           "--mp-worker", outdir, what,
           ",".join(map(str, lengths)), str(win_len)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.update(env_extra or {})
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
    """Phase 1b (see the module docstring): the one-process reference run,
    then P = 2 and 4 processes (all checks), each group started by the
    launcher (P = 8's K1 check runs in phase 30's P = 8 group)."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import build, run

    t_phase = time.perf_counter()
    with deterministic_cudnn():
        trainer = build("resnet50", "neighbor", "exp2", size=N_RANKS,
                        batch_size=BATCH, image_size=224, device=device)
        run(trainer, MP_WARMUP, MP_TIMED)
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
            what = "slice" if procs == SLICE_PROCESSES else "all"
            res, secs = _run_processes(procs, what, lengths, win_len, outdir)
            tag = f"[processes P={procs}]"
            parts = {k: round(max(r["seconds"][k] for r in res), 1)
                     for k in res[0]["seconds"]}
            print(f"{tag} {secs:.1f} s for the group ({what}; the slowest "
                  f"process's seconds after start-up: {parts}); ranks "
                  f"{[r['ranks'] for r in res]} on {res[0]['device']}")
            entry = {"k1": report_k1(tag, res, lengths), "seconds": secs}
            entry.update(_report_processes(tag, procs, res, ref, outdir,
                                           len(lengths)))
            if what == "slice":
                entry["slice"] = _report_slice(tag, procs, res, refs, outdir)
            out[procs] = entry
    print(f"[processes] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def report_k1(tag, res, lengths):
    """The group's check of K1's peer form against the virtual K1
    (:func:`mp_k1`, each process's ``res[q]["k1"]``): printed, checked, and
    its times as the kernels line takes them."""
    k1 = [r["k1"] for r in res]
    ok = all(c[2] and c[3] for r in k1 for c in r["checked"])
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
    return {"ms": k1_ms, "plain_ms": k1_plain,
            "bound_ms": k1[0]["bound_ms"], "bound_by": k1[0]["bound_by"],
            "rows_a_rank": k1[0]["rows_a_rank"],
            "max_abs_err": max(r["max_abs_err"] for r in k1),
            "handshake_us": max(r["handshake_us"] for r in k1)}


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
        check(r["launches"] == per_step * (MP_WARMUP + MP_TIMED) and
              r["virtual_launches"] == 0,
              f"{tag} process {q}: K1 peer launches {r['launches']}, virtual "
              f"{r['virtual_launches']}")
        check(r["handshakes"] == MP_WARMUP + MP_TIMED,
              f"{tag} process {q}: {r['handshakes']} handshakes in "
              f"{MP_WARMUP + MP_TIMED} steps")
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
    print(f"{tag} parameters after {MP_WARMUP + MP_TIMED} steps against the "
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
        step_ms = [sum(r["step_ms"]) / MP_TIMED for r in runs]
        rate = sum(r["samples"] / (ms / 1e3) for r, ms in zip(runs, step_ms))
        one = refs[f"{algo}/samples"] / (refs[f"{algo}/step_ms"] / 1e3)
        unit = "seq" if algo == "gpt" else "img"
        extra = ""
        if algo == "gpt":
            k3 = [sum(r["k3"][i] for r in runs) for i in range(3)]
            extra = (f"; K3 launches over the processes (forward, dK/dV, dQ)"
                     f" {k3}, {[v // (MP_WARMUP + MP_TIMED) for v in k3]} a step; "
                     f"{rate * GPT_SEQ:.1f} tokens/s over all processes "
                     f"against one process's {one * GPT_SEQ:.1f}")
            check(all(v == k3_per_step * (MP_WARMUP + MP_TIMED) for v in k3),
                  f"{tag} gpt: K3 launches {k3}")
        print(f"{tag} {algo}: step ms by process "
              f"{[round(v, 2) for v in step_ms]} (one process "
              f"{refs[f'{algo}/step_ms']:.2f}), {rate:.1f} {unit}/s over all "
              f"processes (one process {one:.1f}); K1 peer launches "
              f"{launches} ({per_step} a step a process), virtual "
              f"{[r['virtual_launches'] for r in runs]}; losses "
              f"{[round(v, 4) for v in runs[0]['losses']]}; peak "
              f"{max(r['peak_gb'] for r in runs):.2f} GB{extra}; state after "
              f"{MP_WARMUP + MP_TIMED} steps against one process: max |diff| / max "
              f"|value| {worst:.3e} (tol {STEP_TOL:.3e}), bit-equal: {equal}")
        check(all(r["finite"] for r in runs), f"{tag} {algo}: non-finite loss")
        check(all(v == per_step * (MP_WARMUP + MP_TIMED) for v in launches)
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


# ---------------------------------------------------------------------------
# Phases 1c and 18-22: BERT-large hierarchical (BASELINE.json configs[4])
# on K1 and its peer form, the convergence gates, the checkpoints, ViT-base
# ---------------------------------------------------------------------------

BERT_BATCH, BERT_SEQ, BERT_LOCAL = 32, 128, 2   # the JAX benchmark's
BERT_PROCESSES = 2
BERT_FT_EPOCHS = 1    # the example's 3 cut for the script's time limit
# (2 until PR 12; 1 since phase 30: no check depends on the epochs)


@contextlib.contextmanager
def deterministic():
    """Deterministic cuDNN and deterministic PyTorch algorithms inside (the
    embedding's backward among them; cuBLAS through the
    ``CUBLAS_WORKSPACE_CONFIG`` that ``main`` sets before the card starts),
    the caller's settings after."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with deterministic_cudnn():
            yield
    finally:
        torch.use_deterministic_algorithms(was)


def _bert_trainer(device):
    from bluefog_tpu_torch.examples.synthetic_benchmark import build

    return build("bert-large", "hierarchical", "exp2", size=N_RANKS,
                 batch_size=BERT_BATCH, seq_len=BERT_SEQ, device=device,
                 local_size=BERT_LOCAL)


def _aligned(width, esize=4):
    """``width`` elements of ``esize`` bytes padded to a multiple of 16
    bytes, as ``fuse_apply(align=True)`` pads a fused buffer's rows."""
    return width + -width % (16 // esize)


def _launches_a_step(params, align=False):
    """K1 launches one gossip of these rank-stacked f32 parameters makes in
    one process (the fuse plan's buffers and large leaves), and the
    per-rank lengths it hands the kernel (each fused buffer's padded to 16
    bytes with ``align``, as the hierarchical mix fuses)."""
    from bluefog_tpu_torch.ops.collectives import fuse_plan

    leaves = list(params)
    groups, big = fuse_plan(leaves)
    fused = [sum(leaves[i][0].numel() for i in idx)
             for idx in groups.values()]
    lengths = ([_aligned(w) if align else w for w in fused]
               + [leaves[i][0].numel() for i in big])
    return len(lengths), lengths


def bert_step_parity(trainer, tag):
    """One step through K1 against the same step through the plain fold,
    from the same state, under deterministic settings.  The state's copies
    live on the host (BERT-large's parameters and momentum over 8 ranks are
    21 GB); the parameters after the steps and the losses are compared."""
    opt = trainer.opt
    state = {k: v.detach() for k, v in trainer.state().items()}
    snap = {k: v.to("cpu", copy=True) for k, v in state.items()}
    counters = _counters(opt)
    try:
        with deterministic():
            opt.backend = "kernel"
            loss_k = trainer.step()
            after_k = {k: v.to("cpu", copy=True) for k, v in state.items()
                       if k.startswith("param.")}
            for k, v in state.items():
                v.copy_(snap[k])
            del snap
            _restore(opt, counters)
            opt.backend = "plain"
            loss_p = trainer.step()
            torch.cuda.synchronize()
    finally:
        opt.backend = "auto"
    worst, equal = 0.0, torch.equal(loss_k, loss_p)
    for k, v in after_k.items():
        got = state[k]
        want = v.to(got.device)
        equal = equal and torch.equal(got, want)
        d = float((got.double() - want.double()).abs().max())
        worst = max(worst, d / max(float(want.double().abs().max()), 1e-12))
        del want
    loss_d = float((loss_k - loss_p).abs().max())
    print(f"[{tag}] K1 step vs plain-fold step over {len(after_k)} "
          f"parameters: max |diff| / max |value| {worst:.3e}, max loss diff "
          f"{loss_d:.3e}, bit-equal (required): {equal}")
    # bit for bit: a LayerNorm scale of 1.0 moves far less than 2^-7 of
    # itself in a step, so a tolerance on max |value| would pass a fold of
    # the wrong rows; K1 and the plain fold round alike
    check(equal, f"{tag}: the K1 step differs from the plain step: {worst}")
    return {"rel_err": worst, "bit_equal": equal}


def bert_machine_k1(device, sched, lengths):
    """K1 on BERT-large's machine rows: the fold of one step, one launch a
    length over (machines, L) f32 rows, against its plain version (checked
    at every length), its bound and ``torch.matmul(W, x)``."""
    from bluefog_tpu_torch.ops.gossip_kernel import (
        gossip_mix, gossip_mix_plain, schedule_tables)

    gen = torch.Generator(device=device).manual_seed(4321)
    sw, rw, src = schedule_tables(sched, device)
    w = torch.as_tensor(sched.mixing_matrix(), dtype=torch.float32,
                        device=device)
    m, k = sched.size, sched.num_slots
    ms = plain_ms = lib_ms = 0.0
    n_bytes = n_flops = 0
    err = 0.0
    for length in sorted(set(lengths)):
        x = torch.randn(m, length, generator=gen, device=device)
        count = lengths.count(length)
        err = max(err, max_err(gossip_mix(x, sw, rw, src),
                               gossip_mix_plain(x, sw, rw, src))[0])
        ms += count * time_ms(lambda: gossip_mix(x, sw, rw, src), reps=10)
        plain_ms += count * time_ms(lambda: gossip_mix_plain(x, sw, rw, src),
                                    reps=3)
        lib_ms += count * time_ms(lambda: torch.matmul(w, x), reps=10)
        n_bytes += count * (2 * x.numel() * 4 + m * (1 + 2 * k) * 4)
        n_flops += count * m * length * (2 * k + 1)
        del x
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = n_flops / F32_FLOPS_PER_S * 1e3
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": max(t_bytes, t_flops),
           "bound_by": "bytes" if t_bytes >= t_flops else "operations",
           "launches_a_step": len(lengths), "max_abs_err": err}
    print(f"[bert] K1 on the machine rows ({m} machines on {sched.name}, "
          f"{len(lengths)} launches a step, {n_bytes / 1e9:.3f} GB): kernel "
          f"{ms:.4f} ms a step, plain {plain_ms:.4f} ms, torch.matmul(W, x) "
          f"{lib_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}), {out['bound_ms'] / ms:.1%} of it; max |K1 - "
          f"plain| {err:.3e}")
    check(err <= F32_TOL, f"K1 on BERT's machine rows differs from its "
          f"plain version: {err}")
    return out


def phase_bert(device, procs_dir, procs):
    """BERT-large fine-tuned with the hierarchical optimizer (BASELINE.json
    ``configs[4]``) at full width over 8 virtual ranks, machines of 2 on
    Ring(4), through ``synthetic_benchmark --model bert-large --comm
    hierarchical --local-size 2`` at seq 128 and batch 32 a rank: 2 + 3
    steps under deterministic settings, K1's launches on the machine rows,
    peak memory, a profiled step's idle share; the parameters after the 5
    steps are phase 1c's one-process reference (``procs``, its processes'
    parameters saved in ``procs_dir``), bit for bit; then a K1 step against
    the plain-fold step, and K1's time on the machine rows."""
    from bluefog_tpu_torch.ops.gossip_kernel import (
        auto_gossip_backend, gossip_mix)

    t0 = time.perf_counter()
    trainer = _bert_trainer(device)
    opt = trainer.opt
    n_params = sum(p[0].numel() for p in trainer.params.values())
    per_step, lengths = _launches_a_step(trainer.params.values(), align=True)
    route = auto_gossip_backend(opt.machine_schedule)
    print(f"[bert] BERT-large: {n_params:,} f32 parameters a rank in "
          f"{len(trainer.params)} tensors ({N_RANKS} ranks: "
          f"{n_params * N_RANKS * 4 / 1e9:.2f} GB a copy), built in "
          f"{time.perf_counter() - t0:.1f} s; {opt.machine_schedule.size} "
          f"machines of {BERT_LOCAL} on {opt.machine_schedule.name}, 'auto' "
          f"-> {route}, {per_step} K1 launches a step over machine rows")
    check(route == "kernel", "bert: the machine fold is not on K1")
    ref = {}
    with deterministic():
        launches, res = phase_main_path(
            trainer, {gossip_mix: per_step}, "bert",
            f"BERT-large x {N_RANKS} virtual ranks, hierarchical (local size "
            f"{BERT_LOCAL}), seq {BERT_SEQ}, batch {BERT_BATCH}/rank, bf16, "
            f"deterministic", unit="seq",
            after_run=lambda tr: ref.update(
                {k: v.detach().cpu() for k, v in tr.params.items()}))
    peak_gb = res["peak_gb"]
    mean_ms = sum(res["step_ms"]) / TIMED
    prof = res["profile"]
    out = {"step_ms": mean_ms, "seq_s": res["samples_per_s"],
           "tokens_s": res["samples_per_s"] * BERT_SEQ, "peak_gb": peak_gb,
           "idle": 1 - prof["busy_ms"] / mean_ms,
           "launches": launches["gossip_mix"], "launches_a_step": per_step,
           "losses": [float(v.mean()) for v in res["losses"]]}
    print(f"[bert] {out['seq_s']:.1f} seq/s, {out['tokens_s']:.1f} tokens/s "
          f"over all ranks, {mean_ms:.2f} ms a step, peak memory "
          f"{peak_gb:.2f} GB, device idle {out['idle']:.1%}")
    out["processes"] = bert_against_processes(ref, procs_dir, procs, out)
    del ref
    out["parity"] = bert_step_parity(trainer, "bert")
    sched = opt.machine_schedule
    del trainer, opt, prof, res
    gc.collect()
    torch.cuda.empty_cache()
    out["k1"] = bert_machine_k1(device, sched, lengths)
    print(f"[bert] phase {time.perf_counter() - t0:.1f} s")
    return out


def bert_against_processes(ref, procs_dir, procs, one):
    """Phase 1c's processes' parameters after their 5 steps against this
    process's (``ref``, the same steps under the same deterministic
    settings), bit for bit: a tolerance on max |value| would pass an
    exchange that dropped a machine, since a LayerNorm scale of 1.0 moves
    far less than 2^-7 of itself in 5 steps."""
    tag = f"[bert P={BERT_PROCESSES}]"
    worst, equal = 0.0, True
    for q, ranks in enumerate(procs["ranks"]):
        w, e = _held(os.path.join(procs_dir, f"bert_{q}.pt"), ref, ranks)
        worst, equal = max(worst, w), equal and e
    print(f"{tag} parameters after {WARMUP + TIMED} steps against one "
          f"process (phase 18's run): max |diff| / max |value| {worst:.3e}, "
          f"bit-equal (required): {equal}; {procs['seq_s']:.1f} seq/s over "
          f"all processes against one process's {one['seq_s']:.1f} "
          f"({one['step_ms']:.2f} ms a step)")
    check(equal, f"{tag} parameters differ from one process: {worst}")
    return {"rel_err": worst, "bit_equal": equal}


def phase_bert_finetune():
    """``examples.bert_finetune_hierarchical --model large --local-size 2``
    at ``BERT_FT_EPOCHS`` epochs and the example's ``--n-per-rank``, under
    deterministic
    settings, then again with ``--two-level-mesh``: per epoch loss,
    accuracy and seq/s, the parameter spread, K1's launches, and the two
    forms' parameters against each other."""
    from bluefog_tpu_torch.examples import bert_finetune_hierarchical as bft
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix

    t0 = time.perf_counter()
    out = {}
    for form, extra in (("one_level", []), ("two_level",
                                            ["--two-level-mesh"])):
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        with deterministic():
            gossip_mix.launches = 0
            res = bft.main(["--model", "large", "--local-size",
                            str(BERT_LOCAL), "--epochs",
                            str(BERT_FT_EPOCHS)] + extra)
            launches = gossip_mix.launches
        trainer = res.pop("trainer")
        per_step, _ = _launches_a_step(trainer.params.values())
        steps = res["steps_per_epoch"] * len(res["epochs"])
        res["launches"] = launches
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        for e, row in enumerate(res["epochs"]):
            print(f"[bert-finetune {form}] epoch {e}: loss {row['loss']:.4f},"
                  f" acc {row['acc']:.3f}, {row['seq_per_s']:.1f} seq/s")
        print(f"[bert-finetune {form}] {steps} steps, K1 launches {launches} "
              f"= {per_step} a step expected, parameter spread "
              f"{res['spread']:.3e}, peak {res['peak_gb']:.2f} GB")
        check(all(math.isfinite(row["loss"]) for row in res["epochs"]),
              f"bert-finetune {form}: non-finite loss")
        check(launches == per_step * steps,
              f"bert-finetune {form}: K1 launched {launches} times, expected "
              f"{per_step * steps}")
        check(res["two_level"] == (form == "two_level"),
              f"bert-finetune {form}: the form did not take")
        params = {k: v.detach().cpu() for k, v in trainer.params.items()}
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        out[form] = res
        if form == "one_level":
            first = params
        else:
            worst, equal = 0.0, True
            for k, v in params.items():
                equal = equal and torch.equal(v, first[k])
                d = float((v.double() - first[k].double()).abs().max())
                worst = max(worst, d / max(float(first[k].abs().max()),
                                           1e-12))
            print(f"[bert-finetune] two-level against one-level after "
                  f"{steps} steps: max |diff| / max |value| {worst:.3e}, "
                  f"bit-equal (required): {equal}")
            # with f32 parameters the two forms are one computation
            check(equal, f"bert-finetune: the two-level form differs from "
                  f"the one-level form: {worst}")
            out["two_vs_one"] = {"rel_err": worst, "bit_equal": equal}
            del first
    print(f"[bert-finetune] phase {time.perf_counter() - t0:.1f} s")
    return out


def mp_bert(ctx, outdir):
    """BERT-large hierarchical over this process's ranks (machines of 2 on
    Ring(4)), 2 + 3 steps under deterministic settings: K1's peer launches,
    the step times, and the parameters saved for the parent's comparison."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import run
    from bluefog_tpu_torch.ops.gossip_kernel import (
        gossip_mix, gossip_mix_peer)

    with deterministic():
        trainer = _bert_trainer(ctx.device)
        gossip_mix_peer.launches = gossip_mix.launches = 0
        res = run(trainer, WARMUP, TIMED)
    out = {"launches": gossip_mix_peer.launches,
           "virtual_launches": gossip_mix.launches,
           "step_ms": res["step_ms"],
           "samples": trainer.batch[0].shape[0] * trainer.batch[0].shape[1],
           "finite": all(math.isfinite(float(v)) for loss in res["losses"]
                         for v in loss),
           "losses": [float(loss.mean()) for loss in res["losses"]],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.save({k: v.detach().cpu() for k, v in trainer.params.items()},
               os.path.join(outdir, f"bert_{ctx.process_rank}.pt"))
    sched = trainer.opt.machine_schedule
    # every leaf fuses into one buffer over processes, its rows padded
    length = _aligned(sum(p[0].numel() for p in trainer.params.values()))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    out["k1"] = mp_bert_k1(ctx, sched, length)
    return out


def mp_bert_k1(ctx, sched, length):
    """K1's peer form on BERT-large's machine rows as the hierarchical mix
    runs it (this process's 2 machine means, ``length`` f32 each, its own
    rows read from them and the peers' from the staged buffer): against its
    plain twin on the same rows, bit for bit, and all processes' launches
    of a step from barrier to barrier, against its bytes bound."""
    from bluefog_tpu_torch.ops.gossip_kernel import (
        gossip_mix_peer, schedule_tables)

    tr, dev = ctx.transport, ctx.device
    m = sched.size // ctx.process_count
    own = slice(ctx.process_rank * m, (ctx.process_rank + 1) * m)
    sw, rw, _ = schedule_tables(sched, dev)
    gen = torch.Generator(device=dev).manual_seed(1919)
    x = torch.randn(m, length, generator=gen, device=dev)
    with tr.exchange(sched, [x]) as (rows,):
        sw_o, rw_o = sw[own].contiguous(), rw[own].contiguous()
        got = gossip_mix_peer(x, sw_o, rw_o, rows)
        equal, err = True, 0.0
        for c0, c1, want in _plain_slices(x, sw_o, rw_o, rows):
            equal = equal and torch.equal(got[:, c0:c1], want)
            err = max(err, max_err(got[:, c0:c1], want)[0])
        del got, want
        ms = _wall_ms(tr, lambda: gossip_mix_peer(x, sw_o, rw_o, rows),
                      reps=5)
        plain_ms = _wall_ms(tr, lambda: [None for _ in _plain_slices(
            x, sw_o, rw_o, rows)], reps=1)
    n_rows = _k1_peer_rows(sched, ctx.process_count)
    bound_ms, bound_by = _bound(n_rows * length * 4,
                                sched.size * length
                                * (2 * sched.num_slots + 1))
    del x
    torch.cuda.empty_cache()
    return {"equal": equal, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "rows_a_machine": n_rows / sched.size, "length": length,
            # the wrapper's choice: x and out come 16-byte aligned
            "vec": 4 if rows.aligned and length % 4 == 0 else 1}


def phase_bert_processes(outdir):
    """Phase 1c, BERT-large over processes: phase 18's path with the 8
    ranks over 2 processes (each 2 machines of local size 2), 2 + 3 steps
    under deterministic settings, K1's peer launches a step a process, and
    K1's peer form on the machine rows; each process's parameters are saved
    in ``outdir``, for phase 18 to hold against its one-process run."""
    tag = f"[bert P={BERT_PROCESSES}]"
    # two processes of 4 BERT-large ranks each hold 29-35 GB at the mix;
    # expandable segments keep the backward's cached blocks from
    # fragmenting what is left of the card
    res, secs = _run_processes(
        BERT_PROCESSES, "bert", [0], 0, outdir,
        {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    runs = [r["bert"] for r in res]
    step_ms = [sum(r["step_ms"]) / TIMED for r in runs]
    rate = sum(r["samples"] / (ms / 1e3) for r, ms in zip(runs, step_ms))
    launches = [r["launches"] for r in runs]
    steps = WARMUP + TIMED
    print(f"{tag} {secs:.1f} s for the group; step ms by process "
          f"{[round(v, 2) for v in step_ms]}, {rate:.1f} seq/s, "
          f"{rate * BERT_SEQ:.1f} tokens/s over all processes; K1 peer "
          f"launches {launches} ({[v / steps for v in launches]} a step a "
          f"process), virtual {[r['virtual_launches'] for r in runs]}; "
          f"losses {[round(v, 4) for v in runs[0]['losses']]}; peak "
          f"{max(r['peak_gb'] for r in runs):.2f} GB a process")
    check(all(r["finite"] for r in runs), f"{tag} non-finite loss")
    check(all(v == steps for v in launches)
          and all(r["virtual_launches"] == 0 for r in runs),
          f"{tag} K1 peer launches {launches}, expected one a step")
    k1 = [r["k1"] for r in runs]
    k1_ms = max(r["ms"] for r in k1)
    k1_equal = all(r["equal"] for r in k1)
    print(f"{tag} K1 peer form on the machine rows ({k1[0]['length']:,} f32 "
          f"a machine, 2 machines a process, one launch a step, "
          f"{k1[0]['vec']}-wide loads): bit-equal to its plain twin in every "
          f"process: {k1_equal}; {k1_ms:.4f} ms a step, all processes "
          f"(plain twin by column slices "
          f"{max(r['plain_ms'] for r in k1):.4f} ms), bound "
          f"{k1[0]['bound_ms']:.4f} ms ({k1[0]['bound_by']}, "
          f"{k1[0]['rows_a_machine']:g} rows a machine), "
          f"{k1[0]['bound_ms'] / k1_ms:.1%} of it")
    check(k1_equal, f"{tag} K1's peer form on BERT's machine rows differs "
          f"from its plain twin")
    return {"k1": {**k1[0], "ms": k1_ms,
                   "plain_ms": max(r["plain_ms"] for r in k1),
                   "max_abs_err": max(r["max_abs_err"] for r in k1)},
            "ranks": [r["ranks"] for r in res],
            "step_ms": step_ms, "seq_s": rate, "tokens_s": rate * BERT_SEQ,
            "launches": sum(launches), "launches_a_step_a_process": 1,
            "seconds": secs, "peak_gb": max(r["peak_gb"] for r in runs)}


def phase_gates():
    """``examples.mnist_epoch_gate`` at its defaults and
    ``examples.cifar_resnet_gate --filters 64`` at its defaults: each gate
    asserts its target and its parity with the allreduce arm; both arms'
    accuracy, steps, img/s and wall-clock, and K1's launches (the gossip
    arm's fuse plan a step; none in the allreduce arm)."""
    from bluefog_tpu_torch.examples import cifar_resnet_gate, mnist_epoch_gate
    from bluefog_tpu_torch.models import LeNet5
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix

    out = {}
    for name, mod, argv, model in (
            ("mnist", mnist_epoch_gate, [], LeNet5()),
            ("cifar", cifar_resnet_gate, ["--filters", "64"],
             cifar_resnet_gate.make_model(64))):
        per_step, _ = _launches_a_step(p[None] for p in model.parameters())
        gc.collect()
        t0 = time.perf_counter()
        gossip_mix.launches = 0
        res = mod.main(argv)
        launches = gossip_mix.launches
        secs = time.perf_counter() - t0
        steps = res["epochs"] * res["steps_per_epoch"]
        print(f"[gate {name}] decentralized acc "
              f"{res['decentralized']['acc']:.4f} "
              f"({res['decentralized']['img_per_s']:.1f} img/s, "
              f"{res['decentralized']['seconds']:.1f} s), allreduce acc "
              f"{res['allreduce']['acc']:.4f} "
              f"({res['allreduce']['img_per_s']:.1f} img/s, "
              f"{res['allreduce']['seconds']:.1f} s); {res['epochs']} epochs "
              f"x {res['steps_per_epoch']} steps a run; K1 launches "
              f"{launches} = {per_step} a step of the gossip arm expected; "
              f"{secs:.1f} s wall-clock")
        check(launches == per_step * steps,
              f"gate {name}: K1 launched {launches} times, expected "
              f"{per_step * steps}")
        out[name] = {"decentralized": res["decentralized"],
                     "allreduce": res["allreduce"], "epochs": res["epochs"],
                     "steps_per_epoch": res["steps_per_epoch"],
                     "wall_s": secs, "launches": launches}
        torch.cuda.empty_cache()
    return out


RESUME_ARGS = ["--size", str(N_RANKS), "--batch-size", str(BATCH),
               "--image-size", "64", "--steps-per-epoch", "2", "--epochs",
               "3", "--warmup-epochs", "1", "--eval-every", "0"]


def _imagenet_process(argv):
    """``examples.imagenet_resnet`` in a fresh process under deterministic
    cuDNN (TF32 off, as here); its checkpoint numbers."""
    code = ("import json, sys, torch\n"
            "torch.backends.cudnn.deterministic = True\n"
            "torch.backends.cudnn.benchmark = False\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "from bluefog_tpu_torch.examples.imagenet_resnet import main\n"
            "res = main(sys.argv[1:])\n"
            "print('CHECKPOINT ' + json.dumps(res['checkpoint']))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", code] + argv, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:])
    check(proc.returncode == 0, f"imagenet_resnet {argv} exited "
          f"{proc.returncode}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("CHECKPOINT ")][-1]
    return json.loads(line[len("CHECKPOINT "):])


def phase_checkpoint():
    """``examples.imagenet_resnet`` (ResNet-50, 8 ranks x 32 at 64x64) for
    3 epochs with a checkpoint each epoch, then a fresh process resumes
    from a copy of its epoch-2 checkpoint (what an interruption after epoch
    2 leaves) to epoch 3, each process under deterministic cuDNN: the two
    epoch-3 checkpoints' parameters and momentum bit-equal, the epoch-2
    checkpoint's BatchNorm statistics the rank mean; save and load ms and
    bytes a checkpoint.  Then ``examples.elastic_resume`` from 8 ranks to 4
    on K1."""
    from bluefog_tpu_torch.examples import elastic_resume
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix
    from bluefog_tpu_torch.utils.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cut, straight = os.path.join(tmp, "cut"), os.path.join(tmp, "all")
        whole = _imagenet_process(RESUME_ARGS + ["--checkpoint-dir",
                                                 straight])
        # the resume reads the latest step
        shutil.copytree(os.path.join(straight, "step_2"),
                        os.path.join(cut, "step_2"))
        resumed = _imagenet_process(RESUME_ARGS + ["--checkpoint-dir", cut,
                                                   "--resume"])
        a = CheckpointManager(cut).restore(3)
        b = CheckpointManager(straight).restore(3)
        mid = CheckpointManager(straight).restore(2)["batch_stats"]
        p_equal = all(torch.equal(a["params"][k], v)
                      for k, v in b["params"].items())
        m_a, m_b = a["opt_state"]["base"]["state"], b["opt_state"]["base"][
            "state"]
        m_equal = all(torch.equal(m_a[i]["momentum_buffer"],
                                  s["momentum_buffer"])
                      for i, s in m_b.items())
        counts = (a["opt_state"]["count"], b["opt_state"]["count"])
        bn_mean = all(torch.equal(v, v[:1].expand_as(v))
                      for v in mid.values())
        bn_d = max(float((a["batch_stats"][k].double()
                          - v.double()).abs().max())
                   for k, v in b["batch_stats"].items())
        n_bytes = whole["bytes"]
        print(f"[checkpoint] imagenet_resnet: 3 epochs with a checkpoint "
              f"each, then a fresh process resumed from a copy of the "
              f"epoch-2 one to epoch 3 (loaded in {resumed['load_ms']:.1f} "
              f"ms): parameters bit-equal {p_equal}, momentum bit-equal "
              f"{m_equal}, step counts {counts}; the epoch-2 checkpoint's "
              f"BatchNorm statistics are the rank mean: {bn_mean}; the "
              f"epoch-3 statistics differ by {bn_d:.3e} (the resumed run "
              f"started from the mean); {n_bytes:,} bytes a checkpoint, "
              f"save calls {[round(v, 1) for v in whole['save_ms']]} ms, the "
              f"last write joined in {whole['wait_ms']:.1f} ms")
        check(p_equal and m_equal and counts[0] == counts[1],
              "checkpoint: the resumed run differs from the uninterrupted "
              "one")
        check(bn_mean, "checkpoint: the saved BatchNorm statistics are not "
              "the rank mean")
        out["resume"] = {"params_bit_equal": p_equal,
                         "momentum_bit_equal": m_equal,
                         "bytes": n_bytes, "save_ms": whole["save_ms"],
                         "wait_ms": whole["wait_ms"],
                         "load_ms": resumed["load_ms"],
                         "bn_diff_epoch3": bn_d}
        del a, b, mid
    gossip_mix.launches = 0
    t1 = time.perf_counter()
    res = elastic_resume.main([])
    launches = gossip_mix.launches
    print(f"[checkpoint] elastic_resume 8 -> 4 ranks: gap {res['gap']:.4f}, "
          f"spread {res['spread']:.4f}, phase 2 resumed at chunk "
          f"{res['start']}, K1 launches {launches} (120 + 90 expected), "
          f"{time.perf_counter() - t1:.1f} s")
    check(res["ok"] and launches == 210,
          f"elastic_resume: ok {res['ok']}, K1 launches {launches}")
    out["elastic"] = {"gap": res["gap"], "spread": res["spread"],
                      "launches": launches}
    print(f"[checkpoint] phase {time.perf_counter() - t0:.1f} s")
    return out


def phase_vit(device):
    """ViT-base at 224/16 over 8 virtual ranks on Exponential-2 through
    ``synthetic_benchmark --model vit-base --comm neighbor``: 2 + 3 steps,
    K1's launches against the fuse plan, none of K3 (197 tokens take the
    dense path), step ms, img/s and a profiled step's idle share."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import build
    from bluefog_tpu_torch.ops import flash_kernel as fk
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix

    t0 = time.perf_counter()
    trainer = build("vit-base", "neighbor", "exp2", size=N_RANKS,
                    batch_size=BATCH, image_size=224, device=device)
    per_step, _ = _launches_a_step(trainer.params.values())
    kernels = {gossip_mix: per_step, fk.flash_forward: 0,
               fk.flash_backward_dkv: 0, fk.flash_backward_dq: 0}
    launches, res = phase_main_path(
        trainer, kernels, "vit",
        f"ViT-base/16 x {N_RANKS} virtual ranks, exp2, 224x224, batch "
        f"{BATCH}/rank, bf16")
    mean_ms = sum(res["step_ms"]) / TIMED
    prof = res["profile"]
    out = {"step_ms": mean_ms, "img_s": res["samples_per_s"],
           "idle": 1 - prof["busy_ms"] / mean_ms,
           "launches": launches["gossip_mix"],
           "k3_launches": sum(launches[fn.__name__] for fn in kernels
                              if fn is not gossip_mix)}
    print(f"[vit] {out['img_s']:.1f} img/s, {mean_ms:.2f} ms a step, device "
          f"idle {out['idle']:.1%}, K3 launches {out['k3_launches']}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    del trainer, res, prof
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- sequence, tensor, pipeline and expert parallelism (phases 24-29) -------

SP_T_LOCAL = 1024                                # tokens a rank, batch 1
SP_RANKS = {"ring": 8, "ring-zigzag": 8, "ulysses": 4}
PAR_STEPS = 2                    # timed steps of each path, after one more
TP_BF, TP_SIZE, TP_BATCH, TP_SEQ = 4, 2, 8, 1024
HYB_DP, HYB_PP, HYB_TP, HYB_MICRO, HYB_MB = 2, 2, 2, 4, 2
MOE_DP, MOE_EP, MOE_BATCH, MOE_SEQ, MOE_EXPERTS = 2, 4, 4, 1024, 8
MOE_CHECK_TOKENS = 512           # a rank, for the FFN against its reference
PARITY_BATCH = 2                 # the f32 parity runs' batch
K3_NEW_SHAPES = ((16, 6, 1024, 64), (4, 3, 4096, 64))   # TP, Ulysses
# f32 at full width: the sharded path against the whole one, the same math
# summed in another order; bf16 (the sequence phase's second check): a
# rounding of the attention's p (folded unnormalised on the ring, normalised
# in K3) placed elsewhere, through 12 layers
SLICE_TOL = 2.0 ** -7
BF16_SLICE_TOL = 2.0 ** -4     # 12-layer GPT at width 768 on the CPU, 8 x
# 128 tokens: the ring 1.1% off in logits, 1.6% in gradients


def slice_config():
    """GPT-small's published widths, the configuration of these phases."""
    from bluefog_tpu_torch.models.transformer import GPTConfig

    return GPTConfig.small()


def _slice_kernels():
    from bluefog_tpu_torch.ops import flash_kernel as fk
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix

    return (fk.flash_forward, fk.flash_backward_dkv, fk.flash_backward_dq,
            gossip_mix)


def _zero_launches():
    for fn in _slice_kernels():
        fn.launches = 0


def _launches(per=1):
    """Each kernel's launches since :func:`_zero_launches`, over ``per``."""
    return {fn.__name__: fn.launches / per for fn in _slice_kernels()}


def _worst(got, want):
    """The largest max |got - want| / max |want| over paired tensors, and
    where."""
    worst, where = 0.0, ""
    for name in want:
        rel = _rel(got[name], want[name])[1]
        if not rel <= worst:
            worst, where = rel, name
    return worst, where


def _timed(step, device, what):
    """One untimed step, then PAR_STEPS timed ones from zeroed launch
    counts and peak memory: (ms a step, launches a step, peak GB, the last
    step's result)."""
    step()
    torch.cuda.synchronize(device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    _zero_launches()
    t0 = time.perf_counter()
    for _ in range(PAR_STEPS):
        out = step()
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) / PAR_STEPS * 1e3
    launches = _launches(PAR_STEPS)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"[{what}] {ms:.2f} ms a step, peak {peak:.2f} GB, launches a "
          f"step: " + ", ".join(f"{k} {v:g}" for k, v in launches.items()))
    return ms, launches, peak, out


# K3's calls checked against the twins, by (B, H, T, D, dtype, causal): the
# largest max |kernel - twin| / max |twin| of each output
K3_TWIN_CHECKED = {}


def _k3_key(shape, dtype, causal):
    return (f"{'x'.join(map(str, shape))} {str(dtype)[6:]} "
            f"{'causal' if causal else 'full'}")


def k3_twin_check(shape, dtype, causal, device, gen, tag):
    """K3's three kernels against their twins on seeded q, k and v views of
    one projection at ``shape``: every output within K3's tolerances
    (correctness only).  Records the readings in :data:`K3_TWIN_CHECKED`;
    returns each kernel's max |kernel - twin|."""
    from bluefog_tpu_torch.ops import flash_kernel as fk

    b, h, t, d = shape
    kw = {"causal": causal, "scale": 1.0 / math.sqrt(d)}
    q, k, v = _qkv_views(b, h, t, d, dtype, gen, device)
    do = torch.randn(b, h, t, d, generator=gen, device=device).to(dtype)
    o_p, l_p, m_p = fk.flash_forward_plain(q, k, v, **kw)
    dq_p, di_p = fk.flash_backward_dq_plain(q, k, v, do, l_p, m_p, o_p, **kw)
    dk_p, dv_p = fk.flash_backward_dkv_plain(q, k, v, do, l_p, m_p, di_p,
                                             **kw)
    o, l, m = fk.flash_forward(q, k, v, **kw)
    dq, di = fk.flash_backward_dq(q, k, v, do, l_p, m_p, o_p, **kw)
    dk, dv = fk.flash_backward_dkv(q, k, v, do, l_p, m_p, di_p, **kw)
    tol = K3_TOL[dtype]
    err, rels, readings = {}, {}, []
    for name, got, ref, lim, kern in (
            ("o", o, o_p, tol["o"], "fwd"),
            ("l", l, l_p, K3_RESIDUAL_TOL, "fwd"),
            ("m", m, m_p, K3_RESIDUAL_TOL, "fwd"),
            ("di", di, di_p, K3_RESIDUAL_TOL, "dq"),
            ("dq", dq, dq_p, tol["grad"], "dq"),
            ("dk", dk, dk_p, tol["grad"], "dkv"),
            ("dv", dv, dv_p, tol["grad"], "dkv")):
        abs_err, rel = _rel(got, ref)
        readings.append(f"{name} {rel:.2e}/{lim:.1e}")
        check(math.isfinite(rel) and rel <= lim,
              f"K3 {name} disagrees with its twin at {shape} "
              f"{str(dtype)[6:]} causal={causal}: {rel} > {lim}")
        err[kern] = max(err.get(kern, 0.0), abs_err)
        rels[name] = rel
    key = _k3_key(shape, dtype, causal)
    K3_TWIN_CHECKED[key] = rels
    print(f"[{tag}] K3 at {key}: max |kernel - twin| / max |twin| (tol): "
          f"{', '.join(readings)}")
    return err


@contextlib.contextmanager
def k3_calls(seen):
    """Adds the (shape, dtype, causal) of every K3 call inside to ``seen``:
    the forward's q, whose shape the backward's launches share."""
    from bluefog_tpu_torch.ops import flash_kernel as fk

    fwd = fk.FlashAttention.forward

    def forward(ctx, q, k, v, causal, scale):
        seen.add((tuple(q.shape), q.dtype, causal))
        return fwd(ctx, q, k, v, causal, scale)

    fk.FlashAttention.forward = staticmethod(forward)
    try:
        yield seen
    finally:
        fk.FlashAttention.forward = staticmethod(fwd)


def check_k3_calls(seen, device, tag):
    """K3 against its twins at each shape a path gave it that no earlier
    check took (correctness only)."""
    gen = torch.Generator(device=device).manual_seed(24)
    shapes = sorted(seen, key=str)
    for shape, dtype, causal in shapes:
        if _k3_key(shape, dtype, causal) not in K3_TWIN_CHECKED:
            k3_twin_check(shape, dtype, causal, device, gen, tag)
    torch.cuda.empty_cache()
    keys = [_k3_key(*c) for c in shapes]
    print(f"[{tag}] the path's K3 calls, each held against the twins: "
          f"{keys}")
    return keys


def phase_k3_shapes(device):
    """K3's three kernels against their twins at the new paths' shapes, bf16
    causal, q, k and v views of one projection: each output within K3's
    tolerances; the times by device time against the bound, the twin and
    ``F.scaled_dot_product_attention``."""
    import torch.nn.functional as F
    from bluefog_tpu_torch.ops import flash_kernel as fk

    gen = torch.Generator(device=device).manual_seed(2026)
    out = {}
    for b, h, t, d in K3_NEW_SHAPES:
        kw = {"causal": True, "scale": 1.0 / math.sqrt(d)}
        err = k3_twin_check((b, h, t, d), torch.bfloat16, True, device, gen,
                            "k3 shapes")
        q, k, v = _qkv_views(b, h, t, d, torch.bfloat16, gen, device)
        do = torch.randn(b, h, t, d, generator=gen, device=device).to(
            torch.bfloat16)
        o, l, m = fk.flash_forward(q, k, v, **kw)
        _, di = fk.flash_backward_dq(q, k, v, do, l, m, o, **kw)
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=10)[0]
        work = _k3_work(b, h, t, d, True, 2)
        res = {}
        for name, kernel, plain in (
                ("fwd", lambda: fk.flash_forward(q, k, v, **kw),
                 lambda: fk.flash_forward_plain(q, k, v, **kw)),
                ("dkv", lambda: fk.flash_backward_dkv(q, k, v, do, l, m, di,
                                                      **kw),
                 lambda: fk.flash_backward_dkv_plain(q, k, v, do, l, m, di,
                                                     **kw)),
                ("dq", lambda: fk.flash_backward_dq(q, k, v, do, l, m, o,
                                                    **kw),
                 lambda: fk.flash_backward_dq_plain(q, k, v, do, l, m, o,
                                                    **kw))):
            t_k = device_ms(kernel, reps=10)[0]
            t_p = time_ms(plain, reps=2, warm=1)
            n_flops, n_bytes = work[name]
            bound_ms, bound_by = _bound(n_bytes, n_flops,
                                        BF16_PEAK_FLOPS_PER_S)
            lib = sdpa if name == "fwd" else None
            print(f"[k3 shapes] time {name} ({b}, {h}, {t}, {d}): kernel "
                  f"{t_k:.4f} ms by device time, twin {t_p:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / t_k:.1%} of "
                  f"the bound" + (f"; scaled_dot_product_attention "
                                  f"{lib:.4f} ms" if lib is not None else ""))
            res[name] = {"max_abs_err": err[name], "ms": t_k, "plain_ms": t_p,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": lib}
        out[f"{b}x{h}x{t}x{d}"] = res
        del q, k, v, do, o, l, m, di
        torch.cuda.empty_cache()
    return out


def phase_sequence(device):
    """Ring (contiguous and zigzag) over 8 virtual ranks of 1024 tokens and
    Ulysses over 4, GPT-small, batch 1: the logits and one step's
    gradients against the whole-sequence model (``local_attention`` on the
    full T, K3), with ``remat`` off and on, in f32 (the math) and in bf16
    (the path); remat's gradients against no remat's; then AdamW steps in
    bf16 with and without remat: tokens/s, peak memory, K3's launches."""
    import torch.nn.functional as F
    from bluefog_tpu_torch.examples.longcontext_lm import shard_sequence
    from bluefog_tpu_torch.models.transformer import TransformerLM
    from bluefog_tpu_torch.ops.ring_attention import (
        all_to_all_attention, ring_attention, zigzag_unshard)
    from bluefog_tpu_torch.parallel.axes import Axis

    t0 = time.perf_counter()
    base = slice_config()
    gen = torch.Generator(device=device).manual_seed(12)
    res = {}
    for kind, n in SP_RANKS.items():
        zig = kind == "ring-zigzag"
        axis = Axis("sp", n)
        attn = (functools.partial(all_to_all_attention, axis=axis,
                                  causal=True, backend="auto")
                if kind == "ulysses" else
                functools.partial(ring_attention, axis=axis, causal=True,
                                  layout="zigzag" if zig else "contiguous"))
        ids = torch.randint(0, base.vocab_size, (1, n * SP_T_LOCAL),
                            generator=gen, device=device)
        toks, tgts, pos = shard_sequence(ids, n, zig)
        targets = torch.roll(ids, -1, dims=1)
        out = {"ranks": n, "tokens": n * SP_T_LOCAL}
        for dtype in (torch.float32, torch.bfloat16):
            cfg = dataclasses.replace(base, dtype=dtype)
            model = TransformerLM(cfg, torch.Generator().manual_seed(0)).to(
                device)
            params = list(model.parameters())
            ref = model(ids)
            g_ref = torch.autograd.grad(F.cross_entropy(
                ref.flatten(0, -2), targets.flatten()), params)
            ref = ref.detach()
            got = {}
            for remat in (False, True):
                model.cfg = dataclasses.replace(cfg, remat=remat)
                logits = model(toks, attn_fn=attn, positions=pos)
                g = torch.autograd.grad(F.cross_entropy(
                    logits.flatten(0, -2), tgts.flatten()), params)
                logits = logits.detach().transpose(0, 1).flatten(1, 2)
                got[remat] = (zigzag_unshard(logits, n) if zig else logits,
                              g)
                del logits, g
            tol = SLICE_TOL if dtype == torch.float32 else BF16_SLICE_TOL
            name = str(dtype)[6:]
            rd = {"logits": _rel(got[False][0], ref)[1],
                  "grads": max(_rel(a, b)[1]
                               for a, b in zip(got[False][1], g_ref)),
                  "remat_grads": max(_rel(a, b)[1]
                                     for a, b in zip(got[True][1], g_ref)),
                  "remat_bit_equal": all(
                      torch.equal(a, b)
                      for a, b in zip(got[False][1], got[True][1]))}
            print(f"[seq {kind}] {name}: against the whole {n * SP_T_LOCAL}"
                  f"-token sequence, max |diff| / max |ref| logits "
                  f"{rd['logits']:.3e}, gradients {rd['grads']:.3e}, with "
                  f"remat {rd['remat_grads']:.3e} (tol {tol:.3e}); remat's "
                  f"gradients bit-equal to no remat's: "
                  f"{rd['remat_bit_equal']}")
            check(max(rd["logits"], rd["grads"], rd["remat_grads"]) <= tol,
                  f"{kind} ({name}) disagrees with the whole sequence: {rd}")
            out[name] = rd
            del ref, g_ref, got
            if dtype == torch.float32:
                del model, params
                torch.cuda.empty_cache()
        opt = torch.optim.AdamW(params, lr=3e-4, weight_decay=0.01)

        def step():
            logits = model(toks, attn_fn=attn, positions=pos)
            loss = F.cross_entropy(logits.flatten(0, -2), tgts.flatten())
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return float(loss.detach())

        for remat in (False, True):
            model.cfg = dataclasses.replace(cfg, remat=remat)
            ms, launches, peak, loss = _timed(
                step, device, f"seq {kind} remat={remat}")
            check(math.isfinite(loss), f"{kind}: loss {loss}")
            k3 = launches["flash_forward"]
            if kind == "ulysses":
                want = base.num_layers * (2 if remat else 1)
                check(k3 == want and launches["flash_backward_dq"]
                      == base.num_layers, f"Ulysses: K3 launches {launches},"
                      f" expected {want} forward, {base.num_layers} backward"
                      " a step")
            out[f"remat={remat}"] = {
                "ms": ms, "tokens_s": n * SP_T_LOCAL / ms * 1e3,
                "peak_gb": peak, "k3_launches": launches}
            print(f"[seq {kind}] remat={remat}: "
                  f"{n * SP_T_LOCAL / ms * 1e3:.1f} tokens/s, loss {loss:.4f}")
        res[kind] = out
        del model, params, opt
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[seq] phase {time.perf_counter() - t0:.1f} s")
    return res


def k1_step_parity(opt, tag):
    """The optimizer's step through K1 against the same step through the
    plain fold from the same state, so on the same fused buffers: the
    parameters after the two must be bit-equal (K1 rounds each product and
    sum on its own, as the plain fold does).  The plain step's state stays.
    Its launches are not the path's: the caller has read the path's
    counts."""
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix, gossip_mix_peer

    params = [p for g in opt.param_groups for p in g["params"]]
    state = params + [v for p in params for v in opt.state[p].values()
                      if torch.is_tensor(v)]
    snap = [t.detach().clone() for t in state]
    counters = _counters(opt)
    # over processes the step runs K1's peer form
    before = gossip_mix.launches + gossip_mix_peer.launches
    try:
        opt.backend = "kernel"
        opt.step()
        launched = gossip_mix.launches + gossip_mix_peer.launches - before
        after = [p.detach().clone() for p in params]
        with torch.no_grad():
            for t, v in zip(state, snap):
                t.copy_(v)
        del snap
        _restore(opt, counters)
        opt.backend = "plain"
        opt.step()
        torch.cuda.synchronize()
    finally:
        opt.backend = "auto"
    worst = max(_rel(p.detach(), a)[1] for p, a in zip(params, after))
    equal = all(torch.equal(p.detach(), a) for p, a in zip(params, after))
    print(f"[{tag}] K1 step ({launched} launches) vs plain-fold step over "
          f"{len(params)} parameters: max |diff| / max |value| {worst:.3e}, "
          f"bit-equal (required): {equal}")
    check(launched > 0, f"{tag}: the K1 step launched no K1")
    check(equal, f"{tag}: the K1 step differs from the plain step: {worst}")
    return {"rel_err": worst, "bit_equal": equal, "launches": launched}


def _tp_losses(model, params, ids, axis):
    """Each tp rank's mean next-token loss (the rolled targets)."""
    import torch.nn.functional as F
    from torch.func import functional_call

    logits = functional_call(model, params, (ids,), {"axis": axis})
    tgt = torch.roll(ids, -1, dims=-1).expand(logits.shape[:-1])
    ce = F.cross_entropy(logits.flatten(0, -2), tgt.flatten(),
                         reduction="none")
    return ce.view(logits.shape[0], -1).mean(-1)


def phase_tensor(device):
    """TPTransformerLM at GPT-small's widths.  In f32 on one bf rank's tp
    group: the parameters gathered and replayed at tp = 1 through the
    dense TransformerLM give its logits, and tp_value_and_grad's corrected
    gradients (through the rule table) equal the dense model's.  Then bf 4
    x tp 2 in bf16, batch 8 x 1024 a bf rank, AdamW 3e-4 (decay 0.01)
    gossiping over Exponential-2(4) on K1: tokens/s, K3's and K1's
    launches."""
    import torch.nn.functional as F
    from bluefog_tpu_torch import convert
    from bluefog_tpu_torch.models.transformer import TransformerLM
    from bluefog_tpu_torch.optim import DistributedNeighborAllreduceOptimizer
    from bluefog_tpu_torch.parallel import tensor as pt
    from bluefog_tpu_torch.parallel.axes import Axis
    from bluefog_tpu_torch.topology import ExponentialTwoGraph

    t0 = time.perf_counter()
    base = slice_config()
    gen = torch.Generator(device=device).manual_seed(13)
    axis = Axis("tp", TP_SIZE, 0)
    out = {}
    # parity, f32
    cfg = dataclasses.replace(base, dtype=torch.float32)
    mesh = pt.make_hybrid_mesh({"tp": TP_SIZE}, ranks=range(TP_SIZE))
    model = pt.TPTransformerLM(cfg, mesh).to(device)
    ids = torch.randint(0, cfg.vocab_size, (PARITY_BATCH, TP_SEQ),
                        generator=gen, device=device)
    p = dict(model.named_parameters())
    losses, grads = pt.tp_value_and_grad(
        lambda p, i: _tp_losses(model, p, i, axis), model, axis,
        rule_table=pt.tp_param_rules())(p, ids)
    full = pt.gather_tp_params(pt.unbox_params(model), model, axis)
    dense = TransformerLM(cfg).to(device)
    dense.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.gpt_from_tp({k: v[0] for k, v in
                                                full.items()}).items()})
    del full
    with torch.no_grad():
        tp_logits = model(ids)
    logits = dense(ids)
    loss = F.cross_entropy(logits.flatten(0, -2),
                           torch.roll(ids, -1, -1).flatten())
    names, leaves = zip(*dense.named_parameters())
    want = dict(zip(names, torch.autograd.grad(loss, leaves)))
    got = {k: torch.from_numpy(v).to(device) for k, v in convert.gpt_from_tp(
        {k: v[0] for k, v in
         pt.gather_tp_params(grads, model, axis).items()}).items()}
    rd = {"logits": max(_rel(tp_logits[r], logits.detach())[1]
                        for r in range(TP_SIZE)),
          "grads": _worst(got, want)}
    print(f"[tp] f32 parity at tp {TP_SIZE}, batch {PARITY_BATCH} x {TP_SEQ}:"
          f" gathered and replayed at tp = 1 through TransformerLM, logits "
          f"max |diff| / max |ref| {rd['logits']:.3e}; corrected gradients "
          f"against the dense model's {rd['grads'][0]:.3e} "
          f"({rd['grads'][1]}; tol {SLICE_TOL:.3e}); losses "
          f"{losses.tolist()} / {float(loss.detach()):.6f}")
    check(rd["logits"] <= SLICE_TOL and rd["grads"][0] <= SLICE_TOL,
          f"tensor-parallel parity: {rd}")
    out["parity"] = rd
    del model, dense, p, grads, got, want, logits, tp_logits, leaves
    gc.collect()
    torch.cuda.empty_cache()

    # bf 4 x tp 2 in bf16
    mesh = pt.make_hybrid_mesh({"bf": TP_BF, "tp": TP_SIZE},
                               ranks=range(TP_BF * TP_SIZE))
    model = pt.TPTransformerLM(base, mesh).to(device)
    params = dict(model.named_parameters())
    for v in params.values():
        v.grad = torch.zeros_like(v)
    opt = DistributedNeighborAllreduceOptimizer(
        torch.optim.AdamW(list(params.values()), lr=3e-4, weight_decay=0.01),
        topology=ExponentialTwoGraph(TP_BF))
    k1_per_step = _launches_a_step(params.values())[0]
    data = torch.randint(0, base.vocab_size, (TP_BF, TP_BATCH, TP_SEQ),
                         generator=gen, device=device)
    value_and_grad = pt.tp_value_and_grad(
        lambda p, i: _tp_losses(model, p, i, axis), model, axis)
    history = []

    def step():
        losses = []
        for r in range(TP_BF):
            p_r = {k: v[r] for k, v in params.items()}
            loss, g = value_and_grad(p_r, data[r])
            with torch.no_grad():
                for k, v in params.items():
                    v.grad[r].copy_(g[k])
            losses.append(loss.mean())
        opt.step()
        history.append(float(torch.stack(losses).mean()))
        return history[-1]

    ms, launches, peak, loss = _timed(
        step, device, f"tp bf {TP_BF} x tp {TP_SIZE}")
    tokens_s = TP_BF * TP_BATCH * TP_SEQ / ms * 1e3
    want_k3 = base.num_layers * TP_BF
    check(launches["flash_forward"] == want_k3
          and launches["flash_backward_dq"] == want_k3
          and launches["flash_backward_dkv"] == want_k3,
          f"tp: K3 launches {launches}, expected {want_k3} a step")
    check(launches["gossip_mix"] == k1_per_step,
          f"tp: K1 launches {launches['gossip_mix']}, expected {k1_per_step}")
    check(all(math.isfinite(x) for x in history), f"tp losses {history}")
    out["k1_parity"] = k1_step_parity(opt, "tp")
    print(f"[tp] {tokens_s:.1f} tokens/s over the {TP_BF} bf ranks; K3 at "
          f"({TP_SIZE * TP_BATCH}, {base.num_heads // TP_SIZE}, {TP_SEQ}, "
          f"{base.hidden_size // base.num_heads}); losses {history}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    out.update(ms=ms, tokens_s=tokens_s, peak_gb=peak, launches=launches,
               losses=history)
    del model, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _causal_auto(q, k, v):
    from bluefog_tpu_torch.ops.ring_attention import local_attention

    return local_attention(q, k, v, causal=True, backend="auto")


def phase_hybrid(device):
    """dp 2 x pp 2 x tp 2 on GPT-small's 12 TPBlocks, 6 a stage: each dp
    rank's (pp, tp) group runs M = 4 microbatches of 2 x 1024 under 1F1B and
    under GPipe, the tokens embedded before injection and the head folded
    into the loss.  In f32, both schedules' corrected gradients against each
    other and against the unpipelined TP step's; in bf16 the two schedules
    again, each one's peak memory, tokens/s and K3's launches; then an SGD
    step of both dp ranks gossiped over dp on K1."""
    from bluefog_tpu_torch.ops.collectives import (
        fuse_apply, neighbor_allreduce)
    from bluefog_tpu_torch.parallel import tensor as pt
    from bluefog_tpu_torch.parallel.axes import Axis
    from bluefog_tpu_torch.topology import ExponentialTwoGraph

    t0 = time.perf_counter()
    base = slice_config()
    mesh = pt.make_hybrid_mesh({"bf": HYB_DP, "tp": HYB_TP},
                               ranks=range(HYB_DP * HYB_TP))
    tp_axis = Axis("tp", HYB_TP, 0)
    stage_axis = Axis("pp", HYB_PP, 0)
    gen = torch.Generator(device=device).manual_seed(14)
    ids = torch.randint(0, base.vocab_size,
                        (HYB_DP, HYB_MICRO * HYB_MB, TP_SEQ), generator=gen,
                        device=device)
    n_tok = HYB_MICRO * HYB_MB * TP_SEQ

    def runner(model):
        params = dict(model.named_parameters())
        run = hybrid_runner(model, stage_axis, device)

        def run_rank(schedule, r):
            """One dp rank's pipelined step: (its loss, its corrected
            gradients keyed like the model's parameters)."""
            return run(schedule, {k: v[r] for k, v in params.items()},
                       ids[r])
        return params, run_rank

    res = {}
    # f32: the schedules against each other and against the TP step
    model = pt.TPTransformerLM(dataclasses.replace(base, dtype=torch.float32),
                               mesh).to(device)
    params, run = runner(model)
    f32 = {s: run(s, 0) for s in ("1f1b", "gpipe")}
    tp_loss, tp_grads = pt.tp_value_and_grad(
        lambda p, i: _tp_losses(model, p, i, tp_axis), model, tp_axis)(
            {k: v[0] for k, v in params.items()}, ids[0])
    between = _worst(f32["1f1b"][1], f32["gpipe"][1])
    against = _worst(f32["gpipe"][1], tp_grads)
    print(f"[hybrid] f32, dp {HYB_DP} x pp {HYB_PP} x tp {HYB_TP}, M = "
          f"{HYB_MICRO} x {HYB_MB} x {TP_SEQ}: losses 1F1B "
          f"{f32['1f1b'][0]:.6f}, GPipe {f32['gpipe'][0]:.6f}, unpipelined "
          f"{float(tp_loss[0]):.6f}; corrected gradients 1F1B vs GPipe "
          f"{between[0]:.3e} ({between[1]}), GPipe vs the TP step "
          f"{against[0]:.3e} ({against[1]}; tol {SLICE_TOL:.1e})")
    check(between[0] <= SLICE_TOL and against[0] <= SLICE_TOL,
          f"hybrid f32 gradients disagree: {between}, {against}")
    res.update(f32_between=between[0], f32_against_tp=against[0])
    del model, params, run, f32, tp_grads
    gc.collect()
    torch.cuda.empty_cache()

    # bf16: the schedules' memory and time, and the dp step
    model = pt.TPTransformerLM(base, mesh).to(device)
    params, run = runner(model)
    grads = {}
    for schedule in ("1f1b", "gpipe"):
        ms, launches, peak, (loss, g) = _timed(
            lambda: run(schedule, 0), device, f"hybrid {schedule}")
        check(launches["flash_forward"] > 0
              and launches["flash_backward_dq"] > 0
              and launches["flash_backward_dkv"] > 0,
              f"hybrid {schedule}: K3 launches {launches}")
        check(math.isfinite(loss), f"hybrid {schedule}: loss {loss}")
        grads[schedule] = g
        res[schedule] = {"ms": ms, "peak_gb": peak, "launches": launches,
                         "loss": loss, "tokens_s": n_tok / ms * 1e3}
    between = _worst(grads["1f1b"], grads["gpipe"])
    print(f"[hybrid] bf16: 1F1B vs GPipe corrected gradients "
          f"{between[0]:.3e} ({between[1]}; tol {SLICE_TOL:.1e}); peak 1F1B "
          f"{res['1f1b']['peak_gb']:.2f} GB, GPipe "
          f"{res['gpipe']['peak_gb']:.2f} GB; "
          f"{res['1f1b']['tokens_s']:.1f} / {res['gpipe']['tokens_s']:.1f} "
          f"tokens/s a dp rank")
    check(between[0] <= SLICE_TOL, f"hybrid bf16 schedules disagree: "
          f"{between}")
    res["bf16_between"] = between[0]
    del grads
    sched = ExponentialTwoGraph(HYB_DP)
    _zero_launches()
    new = {k: torch.empty_like(v) for k, v in params.items()}
    for r in range(HYB_DP):
        _, g = run("gpipe", r)
        with torch.no_grad():
            for k, v in params.items():
                new[k][r] = v[r] - 0.1 * g[k]
    with torch.no_grad():
        mixed = fuse_apply(lambda t: neighbor_allreduce(t, sched,
                                                        backend="kernel"),
                           new)
    torch.cuda.synchronize(device)
    res["dp_step_launches"] = _launches()
    check(res["dp_step_launches"]["gossip_mix"] > 0,
          "hybrid: the dp gossip launched no K1")
    check(all(bool(torch.isfinite(v).all()) for v in mixed.values()),
          "hybrid: non-finite parameters after the dp step")
    # the plain fold on the same fused buffers: bit for bit
    with torch.no_grad():
        plain = fuse_apply(lambda t: neighbor_allreduce(t, sched,
                                                        backend="plain"),
                           new)
    worst = _worst(mixed, plain)
    equal = all(torch.equal(mixed[k], plain[k]) for k in plain)
    print(f"[hybrid] the dp gossip through K1 vs the plain fold over "
          f"{len(plain)} parameters: max |diff| / max |value| {worst[0]:.3e}"
          f", bit-equal (required): {equal}")
    check(equal, f"hybrid: K1's dp gossip differs from the plain fold: "
          f"{worst}")
    res["k1_parity"] = {"rel_err": worst[0], "bit_equal": equal}
    del plain
    print(f"[hybrid] the dp step (GPipe on both dp ranks, SGD, gossip over "
          f"dp): launches {res['dp_step_launches']}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    del model, params, run, new, mixed
    gc.collect()
    torch.cuda.empty_cache()
    return res


def moe_routing(model, cfg, p0, ids, axis, tag):
    """Where the MoE path's tokens go: one forward of a dp rank's
    parameters on its tokens ``ids`` (ep, B, T), and for each layer the
    dropped fraction, each expert's load (the mean over the ep ranks) and
    the mean cosine between the last T/2 tokens of a sequence at the
    layer's input; the first layer's router on the embeddings alone (before
    any attention) beside it.  Then ``expert_parallel_ffn`` against
    ``moe_ffn_reference`` on the inputs of the layer that drops the most,
    at the path's own capacity, in f32: the same tokens dropped (each
    rank's queues its own: the reference's leading dimension), the outputs
    within the slice's tolerance."""
    import torch.nn.functional as F
    from torch.func import functional_call
    from bluefog_tpu_torch.models import moe as pmm
    from bluefog_tpu_torch.ops import moe as pmoe

    layers = [m for m in model.modules() if isinstance(m, pmm.MoEMLP)]
    inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: inputs.append(a[0].detach())) for m in layers]
    try:
        with torch.no_grad():
            functional_call(model, p0, (ids,))
    finally:
        for h in hooks:
            h.remove()
    e, c = cfg.num_experts, cfg.gpt.hidden_size
    t_local = ids[0].numel()
    cap = cfg.capacity(t_local)
    out = {"capacity": cap, "layers": []}
    with torch.no_grad():
        seq = torch.arange(ids.shape[-1], device=ids.device)
        emb = (functional_call(model.tok, {"weight": p0["tok.weight"]},
                               (ids,))
               + functional_call(model.pos, {"weight": p0["pos.weight"]},
                                 (seq,)))
        ln = functional_call(
            model.blocks[0].ln2, {"weight": p0["block_0.ln2.weight"],
                                  "bias": p0["block_0.ln2.bias"]}, (emb,))
        m0 = pmoe.get_router(cfg.router)(
            ln.reshape(cfg.ep_size, -1, c), p0["block_0.mlp.router"],
            num_experts=e, capacity=cap).metrics
        out["embeddings"] = {
            "dropped": float(m0["dropped_frac"].mean()),
            "load": m0["expert_load"].mean(0).tolist()}
        print(f"[{tag}] routing of the embeddings alone (layer 0's router "
              f"on its LayerNorm of tok + pos): dropped "
              f"{out['embeddings']['dropped']:.4f}, expert load "
              f"{[round(v, 3) for v in out['embeddings']['load']]}")
        del emb, ln
        for i, (mt, x) in enumerate(zip(pmm.moe_metrics(model), inputs)):
            tail = F.normalize(x[..., x.shape[-2] // 2:, :].float(), dim=-1)
            cos = float((tail @ tail.transpose(-1, -2)).mean())
            row = {"dropped": float(mt["dropped_frac"].mean()),
                   "load": mt["expert_load"].mean(0).tolist(), "cos": cos}
            out["layers"].append(row)
            print(f"[{tag}] layer {i}: dropped {row['dropped']:.4f}, expert "
                  f"load {[round(v, 3) for v in row['load']]}, mean cosine "
                  f"of a sequence's last {x.shape[-2] // 2} tokens "
                  f"{cos:.3f}")
            del tail
        worst = max(range(len(inputs)),
                    key=lambda i: out["layers"][i]["dropped"])
        x = inputs[worst].reshape(cfg.ep_size, t_local, c).float()
        del inputs
        pre = f"block_{worst}.mlp."
        router, wi, wo = (p0[pre + n].float() for n in ("router", "wi", "wo"))
        y, _, m = pmoe.expert_parallel_ffn(
            x, router, wi, wo, axis=axis, num_experts=e, capacity=cap,
            router=cfg.router)
        ref, _, m_ref = pmoe.moe_ffn_reference(
            x, router, wi.flatten(0, 1), wo.flatten(0, 1), num_experts=e,
            capacity=cap, router=cfg.router)
        rel = _rel(y, ref)[1]
        drop, drop_ref = (float(v["dropped_frac"].mean()) for v in (m, m_ref))
        print(f"[{tag}] expert_parallel_ffn against moe_ffn_reference on "
              f"layer {worst}'s inputs ({cfg.ep_size} x {t_local} tokens) at "
              f"the path's capacity {cap}, f32: max |diff| / max |ref| "
              f"{rel:.3e} (tol {SLICE_TOL:.1e}); dropped {drop:.4f} / "
              f"{drop_ref:.4f}")
        check(drop > 0 and drop == drop_ref,
              f"{tag}: the FFN check dropped {drop} / {drop_ref} tokens")
        check(rel <= SLICE_TOL, f"{tag}: expert_parallel_ffn at the path's "
              f"capacity: {rel}")
        out["ffn_at_capacity"] = {"layer": worst, "rel_err": rel,
                                  "dropped": drop}
        del x, y, ref
    torch.cuda.empty_cache()
    return out


def phase_moe(device):
    """Switch-MoE at GPT-small's widths, 8 experts.  In f32,
    ``expert_parallel_ffn`` over ep 4 against ``moe_ffn_reference`` on the
    same 4 x 512 tokens at ample capacity, both routers.  Then
    ``MoETransformerLM``, top-1 and top-2, dp 2 x ep 4, batch 4 x 1024 a
    rank in bf16, AdamW 3e-4 (decay 0.01) gossiping over dp on K1: the
    (T, E, C) dispatch memory reckoned first, the dropped fraction,
    tokens/s, K3's and K1's launches."""
    from torch.func import functional_call
    from bluefog_tpu_torch.models import moe as pmm
    from bluefog_tpu_torch.ops import moe as pmoe
    from bluefog_tpu_torch.optim import DistributedNeighborAllreduceOptimizer
    from bluefog_tpu_torch.parallel.axes import Axis
    from bluefog_tpu_torch.topology import ExponentialTwoGraph

    t0 = time.perf_counter()
    base = slice_config()
    gen = torch.Generator(device=device).manual_seed(15)
    c, e = base.hidden_size, MOE_EXPERTS
    hidden = base.mlp_ratio * c
    axis = Axis("ep", MOE_EP, 0)
    res = {}
    x = torch.randn(MOE_EP, MOE_CHECK_TOKENS, c, generator=gen, device=device)
    rk = torch.randn(c, e, generator=gen, device=device) / math.sqrt(c)
    wi = torch.randn(e, c, hidden, generator=gen, device=device) / math.sqrt(c)
    wo = torch.randn(e, hidden, c, generator=gen, device=device) / math.sqrt(
        hidden)
    for router in ("top1", "top2"):
        k = 2 if router == "top2" else 1
        y, _, m = pmoe.expert_parallel_ffn(
            x, rk, wi.view(MOE_EP, e // MOE_EP, c, hidden),
            wo.view(MOE_EP, e // MOE_EP, hidden, c), axis=axis,
            num_experts=e, capacity=k * MOE_CHECK_TOKENS, router=router)
        ref, _, _ = pmoe.moe_ffn_reference(
            x.reshape(-1, c), rk, wi, wo, num_experts=e,
            capacity=k * MOE_EP * MOE_CHECK_TOKENS, router=router)
        rel = _rel(y.reshape(-1, c), ref)[1]
        print(f"[moe] expert_parallel_ffn ({router}) against "
              f"moe_ffn_reference on {MOE_EP} x {MOE_CHECK_TOKENS} tokens, "
              f"f32: max |diff| / max |ref| {rel:.3e} (tol {SLICE_TOL:.1e}); "
              f"dropped {float(m['dropped_frac'].mean()):.4f}")
        check(rel <= SLICE_TOL, f"expert_parallel_ffn ({router}): {rel}")
        res[f"ffn_{router}"] = rel
    del x, wi, wo, y, ref
    tokens = MOE_BATCH * MOE_SEQ
    data = torch.randint(0, base.vocab_size,
                         (MOE_DP, MOE_EP, MOE_BATCH, MOE_SEQ), generator=gen,
                         device=device)
    for router in ("top1", "top2"):
        cfg = pmm.MoEConfig(gpt=base, num_experts=e, ep_size=MOE_EP,
                            router=router)
        cap = cfg.capacity(tokens)
        tec = MOE_EP * tokens * e * cap * 4
        print(f"[moe {router}] (T, E, C) = ({tokens}, {e}, {cap}) a rank: "
              f"{tec / 1e9:.3f} GB in f32 for the group's dispatch (the "
              f"same for combine and each slot tensor) a layer, x "
              f"{base.num_layers} layers")
        model = pmm.MoETransformerLM(cfg).to(device)
        params = {k: v.detach().unsqueeze(0).expand(MOE_DP, *v.shape)
                  .clone().requires_grad_()
                  for k, v in model.named_parameters()}
        for v in params.values():
            v.grad = torch.zeros_like(v)
        opt = DistributedNeighborAllreduceOptimizer(
            torch.optim.AdamW(list(params.values()), lr=3e-4,
                              weight_decay=0.01),
            topology=ExponentialTwoGraph(MOE_DP))
        k1_per_step = _launches_a_step(params.values())[0]
        history, dropped = [], []

        def step():
            losses, drops = [], []
            for r in range(MOE_DP):
                p_r = {k: v[r] for k, v in params.items()}
                ids = data[r]
                logits = functional_call(model, p_r, (ids,))
                loss = pmm.moe_lm_loss(model, logits,
                                       torch.roll(ids, -1, dims=-1), cfg)
                g = torch.autograd.grad(loss, list(p_r.values()))
                with torch.no_grad():
                    for v, gv in zip(params.values(), g):
                        v.grad[r].copy_(gv)
                losses.append(float(loss.detach()))
                drops.append(float(torch.stack([
                    mt["dropped_frac"].mean()
                    for mt in pmm.moe_metrics(model)]).mean()))
            opt.step()
            history.append(sum(losses) / MOE_DP)
            dropped.append(sum(drops) / MOE_DP)
            return history[-1]

        ms, launches, peak, _ = _timed(step, device, f"moe {router}")
        want_k3 = base.num_layers * MOE_DP
        check(launches["flash_forward"] == want_k3
              and launches["flash_backward_dkv"] == want_k3,
              f"moe {router}: K3 launches {launches}, expected {want_k3}")
        check(launches["gossip_mix"] == k1_per_step,
              f"moe {router}: K1 launches {launches['gossip_mix']}, "
              f"expected {k1_per_step}")
        check(all(math.isfinite(v) for v in history),
              f"moe {router}: losses {history}")
        parity = k1_step_parity(opt, f"moe {router}")
        routing = moe_routing(model, cfg, {k: v[0] for k, v in
                                           params.items()}, data[0], axis,
                              f"moe {router}")
        tokens_s = MOE_DP * MOE_EP * tokens / ms * 1e3
        print(f"[moe {router}] dp {MOE_DP} x ep {MOE_EP}: {tokens_s:.1f} "
              f"tokens/s, dropped fraction {dropped[-1]:.4f}, losses "
              f"{history}, K3 at ({MOE_EP * MOE_BATCH}, {base.num_heads}, "
              f"{MOE_SEQ}, {base.hidden_size // base.num_heads})")
        res[router] = {"ms": ms, "tokens_s": tokens_s, "peak_gb": peak,
                       "launches": launches, "dropped": dropped[-1],
                       "capacity": cap, "losses": history,
                       "k1_parity": parity, "routing": routing}
        del model, params, opt
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[moe] phase {time.perf_counter() - t0:.1f} s")
    return res


def phase_longcontext():
    """``examples.longcontext_lm`` at its defaults on the card, once for
    each ``--attn``, each ending OK."""
    from bluefog_tpu_torch.examples import longcontext_lm as lc

    res = {}
    for kind in lc.ATTNS:
        t0 = time.perf_counter()
        out = lc.main(["--attn", kind])
        res[kind] = {"s": time.perf_counter() - t0,
                     "tokens_s": out["tokens_s"], "first": out["losses"][0],
                     "last": out["losses"][-1]}
        check(out["ok"], f"longcontext_lm --attn {kind} did not reach OK: "
              f"{out['losses'][0]} -> {out['losses'][-1]}")
        print(f"[longcontext] --attn {kind}: OK, loss {res[kind]['first']:.3f}"
              f" -> {res[kind]['last']:.4f}, {res[kind]['s']:.1f} s")
    return res


# --- gossip of meshes and the axes over processes (phase 30) ---------------

MESH_STEPS = 1                   # timed steps over processes, after one more
MESH_TIMEOUT_S = 900
MESH_SEQ = {"ring": 8, "ring-zigzag": 8, "ulysses": 4}    # ranks, 1024 each
MESH_MOE_BATCH = 1               # the f32 MoE check's batch a rank
MESH_GROUPS = {2: ("path1", "seq", "longcontext"), 4: ("moe", "hybrid"),
               8: ("path1",)}
MESH_REPS = 5                    # calls of a collective timed alone
MESH_LC_STEPS = 10               # the loss is near 0.2 of its first by then
MESH_P8_CHUNKS = 4               # path 1 at P = 8: batch 8 as 4 slices of 2


def _set_compute_dtype(model, dtype):
    """Switch a model's compute dtype in place (its parameters stay f32):
    every config's ``dtype`` and every layer's ``dtype`` attribute."""
    for mod in model.modules():
        cfg = getattr(mod, "cfg", None)
        if dataclasses.is_dataclass(cfg):
            if hasattr(cfg, "gpt"):
                mod.cfg = dataclasses.replace(
                    cfg, gpt=dataclasses.replace(cfg.gpt, dtype=dtype))
            elif hasattr(cfg, "dtype"):
                mod.cfg = dataclasses.replace(cfg, dtype=dtype)
        if isinstance(getattr(mod, "dtype", None), torch.dtype):
            mod.dtype = dtype
    return model


def _rows_digest(params, box):
    """sha1 of each stacked parameter's row at every position of ``box``
    (the mesh positions its leading dimensions hold), ``name@position``."""
    import hashlib
    import itertools

    out = {}
    for name, v in params.items():
        host = v.detach().cpu()
        for pos in itertools.product(*(range(s.start, s.stop) for s in box)):
            loc = tuple(i - s.start for i, s in zip(pos, box))
            out[f"{name}@{pos}"] = hashlib.sha1(
                host[loc].contiguous().view(torch.uint8).numpy().tobytes()
            ).hexdigest()
    return out


def _tp_template(base):
    """A tp-2 TPTransformerLM on the host (seed 0: phase 26's shards) and
    GPT-small's full leaves gathered from it, which the shard functions
    place.  Build it with no transport active."""
    from bluefog_tpu_torch.parallel import tensor as pt

    tmesh = pt.make_hybrid_mesh({"tp": TP_SIZE}, ranks=range(TP_SIZE))
    model = pt.TPTransformerLM(base, tmesh)
    full = {k: v[0] for k, v in pt.gather_tp_params(
        pt.unbox_params(model), model, tmesh.axis("tp")).items()}
    return model, full


def _tp_place(full, mesh, device, optimizer=True):
    """Path 1's state: the parameters placed by make_shard_and_gather_fns
    from tp_param_rules (the rows this process owns, on the card), AdamW
    3e-4 (decay 0.01) with its state placed by shard_optimizer_state, and
    the gossip over Exponential-2(bf) through sharded_neighbor_allreduce."""
    from bluefog_tpu_torch import sharding as S
    from bluefog_tpu_torch.optim import (DistributedNeighborAllreduceOptimizer,
                                         shard_optimizer_state)
    from bluefog_tpu_torch.parallel import tensor as pt
    from bluefog_tpu_torch.topology import ExponentialTwoGraph

    table = pt.tp_param_rules()
    specs = {k: table.resolve(k.replace(".", "/"), v.shape)
             for k, v in full.items()}
    fns, _ = S.make_shard_and_gather_fns(specs, mesh)
    params = {k: fns[k](v).to(device).requires_grad_()
              for k, v in full.items()}
    if not optimizer:
        return params, None
    for v in params.values():
        v.grad = torch.zeros_like(v)
    base_opt = torch.optim.AdamW(list(params.values()), lr=3e-4,
                                 weight_decay=0.01)
    shard_optimizer_state(table, full, torch.optim.AdamW(
        list(full.values())), mesh, into=base_opt)
    opt = DistributedNeighborAllreduceOptimizer(
        base_opt, topology=ExponentialTwoGraph(TP_BF), rule_table=table,
        param_names=list(params), inner_axes={"tp": TP_SIZE})
    return params, opt


def _tp_data(device, batch=TP_BATCH):
    gen = torch.Generator(device=device).manual_seed(31)
    return torch.randint(0, slice_config().vocab_size,
                         (TP_BF, batch, TP_SEQ), generator=gen,
                         device=device)


def _moe_data(device, batch):
    gen = torch.Generator(device=device).manual_seed(33)
    return torch.randint(0, slice_config().vocab_size,
                         (MOE_DP, MOE_EP, batch, MOE_SEQ), generator=gen,
                         device=device)


def _hybrid_data(device):
    gen = torch.Generator(device=device).manual_seed(34)
    return torch.randint(0, slice_config().vocab_size,
                         (HYB_DP, HYB_MICRO * HYB_MB, TP_SEQ),
                         generator=gen, device=device)


def _seq_ids(device, i, n):
    gen = torch.Generator(device=device).manual_seed(50 + i)
    return torch.randint(0, slice_config().vocab_size, (1, n * SP_T_LOCAL),
                         generator=gen, device=device)


def _seq_attn(kind, axis):
    from bluefog_tpu_torch.ops.ring_attention import (all_to_all_attention,
                                                       ring_attention)

    if kind == "ulysses":
        return functools.partial(all_to_all_attention, axis=axis,
                                 causal=True, backend="auto")
    return functools.partial(ring_attention, axis=axis, causal=True,
                             layout="zigzag" if kind == "ring-zigzag"
                             else "contiguous")


def _tp_step_fn(model, params, opt, data, axis, bf_rows, chunks=1):
    """One path-1 step: each held bf rank's corrected gradients (its tp
    group; ``axis`` on dimension 0 of its slice), averaged over ``chunks``
    equal slices of its batch, then the optimizer."""
    from bluefog_tpu_torch.parallel import tensor as pt

    vg = pt.tp_value_and_grad(lambda p, i: _tp_losses(model, p, i, axis),
                              model, axis)
    check(data.shape[1] % chunks == 0, f"batch {data.shape[1]} in {chunks}")

    def step():
        losses = []
        for r, b in enumerate(bf_rows):
            p_r = {k: v[r] for k, v in params.items()}
            for c, ids in enumerate(data[b].split(data.shape[1] // chunks)):
                loss, g = vg(p_r, ids)
                with torch.no_grad():
                    for k, v in params.items():
                        if c:
                            v.grad[r].add_(g[k])
                        else:
                            v.grad[r].copy_(g[k])
                losses.append(float(loss.mean()))
                del g
            if chunks > 1:
                with torch.no_grad():
                    for v in params.values():
                        v.grad[r].div_(chunks)
        opt.step()
        return sum(losses) / len(losses)
    return step


def mesh_winput(params, tag):
    """The WinPut variant of path 1: a window over the placed parameters,
    its partition declared by ``win_create(rule_table=)``; one put through
    K2 (its peer form over processes) and ``win_update``, then from the same
    self buffers the plain put and ``win_update``: the updates bit for bit
    (a landing slot is read only through ``win_update``, which waits for
    the other processes' deliveries)."""
    from bluefog_tpu_torch.ops import deliver_kernel as k2
    from bluefog_tpu_torch.ops import windows as W
    from bluefog_tpu_torch.parallel import tensor as pt
    from bluefog_tpu_torch.topology import ExponentialTwoGraph, build_schedule

    table = pt.tp_param_rules()
    sched = build_schedule(ExponentialTwoGraph(TP_BF))
    x = {k: v.detach() for k, v in params.items()}
    win = W.win_create(x, sched, rule_table=table, inner_axes={"tp": TP_SIZE})
    part = W.win_partition(win)
    want = {k.replace(".", "/"): table.resolve(k.replace(".", "/"),
                                              v.shape[2:])
            for k, v in x.items()}
    check(part == want, f"{tag}: the window's partition {part}")
    published = {dt: b.clone() for dt, b in win.bufs.items()}
    counters = (k2.window_deliver, k2.window_deliver_peer)
    before = [c.launches for c in counters]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    W.win_put(win, None, backend="kernel")
    torch.cuda.synchronize()
    put_ms = (time.perf_counter() - t0) * 1e3
    launched = sum(c.launches - b for c, b in zip(counters, before))
    W.win_update(win)
    got = {dt: b.clone() for dt, b in win.bufs.items()}
    for dt, b in win.bufs.items():
        b.copy_(published[dt])
    W.win_put(win, None, backend="plain")
    W.win_update(win)
    equal = all(torch.equal(got[dt], b) for dt, b in win.bufs.items())
    nbytes = sum(p.numel() * p.element_size() for p in win.peers.values())
    W.win_free(win)
    del got, published
    print(f"[{tag}] WinPut over the partitioned window ({len(part)} leaves "
          f"declared from tp_param_rules, {nbytes / 1e9:.2f} GB of landing "
          f"slots here): {launched} K2 launch(es), {put_ms:.2f} ms host; "
          f"the update after it bit-equal to the one after the plain put "
          f"(required): {equal}")
    check(launched > 0 and equal, f"{tag}: K2's put over the partitioned "
          f"window: {launched} launches, bit-equal {equal}")
    return {"k2_launches": launched, "bit_equal": equal, "put_ms": put_ms,
            "landing_bytes": nbytes}


def mesh_references(device, refdir):
    """Phase 30 in this process, before the groups: path 1's one-process
    form against phase 26's step from the same state (bit for bit), the
    digests of its state after 1 + MESH_STEPS steps (P = 2 holds its rows
    to them), its WinPut variant, path 1's f32 tp-group run (P = 8), and
    the virtual-rank f32 runs of the sequence, MoE and hybrid paths, saved
    under ``refdir``."""
    import torch.nn.functional as F
    from torch.func import functional_call
    from bluefog_tpu_torch import sharding as S
    from bluefog_tpu_torch.examples.longcontext_lm import shard_sequence
    from bluefog_tpu_torch.models import moe as pmm
    from bluefog_tpu_torch.models.transformer import TransformerLM
    from bluefog_tpu_torch.ops import collectives as C
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix
    from bluefog_tpu_torch.optim import DistributedNeighborAllreduceOptimizer
    from bluefog_tpu_torch.parallel import tensor as pt
    from bluefog_tpu_torch.parallel.axes import Axis
    from bluefog_tpu_torch.topology import ExponentialTwoGraph

    t0 = time.perf_counter()
    base = slice_config()
    out = {}
    # path 1 in one process: phase 26's state and step against the placed
    # state and the sharded gossip, on the same gradients
    model, full = _tp_template(base)
    mesh = S.GossipMesh(TP_BF, {"tp": TP_SIZE}).mesh(ranks=range(N_RANKS))
    ref_model = pt.TPTransformerLM(base, mesh).to(device)
    a = dict(ref_model.named_parameters())
    for v in a.values():
        v.grad = torch.zeros_like(v)
    opt_a = DistributedNeighborAllreduceOptimizer(
        torch.optim.AdamW(list(a.values()), lr=3e-4, weight_decay=0.01),
        topology=ExponentialTwoGraph(TP_BF))
    b, opt_b = _tp_place(full, mesh, device)
    check(all(torch.equal(a[k], b[k]) for k in a),
          "path 1: the placed parameters differ from phase 26's")
    data = _tp_data(device)
    axis = Axis("tp", TP_SIZE, 0)
    vg = pt.tp_value_and_grad(lambda p, i: _tp_losses(model, p, i, axis),
                              model, axis)
    equal, launches = [], 0
    for _ in range(1 + MESH_STEPS):
        for r in range(TP_BF):
            _, g = vg({k: v[r] for k, v in a.items()}, data[r])
            with torch.no_grad():
                for k in a:
                    a[k].grad[r].copy_(g[k])
                    b[k].grad[r].copy_(g[k])
            del g
        opt_a.step()
        before = gossip_mix.launches
        opt_b.step()
        launches = gossip_mix.launches - before
        equal.append(all(torch.equal(a[k], b[k]) for k in a))
    shard_b, saved_b = C.sharded_neighbor_allreduce.last_wire
    print(f"[mesh path 1] one process, bf {TP_BF} x tp {TP_SIZE}: parameters "
          f"placed by make_shard_and_gather_fns from tp_param_rules, AdamW "
          f"state by shard_optimizer_state, the gossip through "
          f"sharded_neighbor_allreduce ({launches} K1 launch(es) a step; "
          f"{shard_b / 1e6:.1f} MB a shard coordinate a step on the wire, "
          f"{saved_b / 1e6:.1f} MB fewer than gather-then-gossip): "
          f"bit-equal to phase 26's step after each of {len(equal)} steps "
          f"(required): {equal}")
    check(all(equal) and launches > 0,
          f"path 1 differs from phase 26's step: {equal}, {launches}")
    with open(os.path.join(refdir, "path1_digests.json"), "w") as f:
        json.dump(_rows_digest(b, mesh.owned()), f)
    del a, opt_a, ref_model
    gc.collect()
    torch.cuda.empty_cache()
    out["path1"] = {"bit_equal": equal, "k1_launches": launches,
                    "shard_bytes": shard_b, "saved_bytes": saved_b,
                    "k1_parity": k1_step_parity(opt_b, "mesh path 1"),
                    "winput": mesh_winput(b, "mesh path 1")}
    del b, opt_b
    gc.collect()
    torch.cuda.empty_cache()
    # path 1's f32 tp group (the P = 8 reference): bf rank 0's tokens
    _set_compute_dtype(model, torch.float32)
    p = {k: v.detach().to(device).requires_grad_()
         for k, v in model.named_parameters()}
    ids = _tp_data(device, PARITY_BATCH)[0]
    losses, grads = pt.tp_value_and_grad(
        lambda p, i: _tp_losses(model, p, i, axis), model, axis)(p, ids)
    with torch.no_grad():
        logits = functional_call(model, p, (ids,), {"axis": axis})
    torch.save({"losses": losses.cpu(), "logits": logits[0].cpu()},
               os.path.join(refdir, "path1_f32.pt"))
    for t in range(TP_SIZE):
        torch.save({k: g[t].cpu() for k, g in grads.items()},
                   os.path.join(refdir, f"path1_f32_grads{t}.pt"))
    del model, full, p, grads, logits
    gc.collect()
    torch.cuda.empty_cache()

    # path 2: the virtual-rank f32 runs
    for i, (kind, n) in enumerate(MESH_SEQ.items()):
        cfg = dataclasses.replace(base, dtype=torch.float32)
        lm = TransformerLM(cfg, torch.Generator().manual_seed(0)).to(device)
        toks, tgts, pos = shard_sequence(_seq_ids(device, i, n), n,
                                         kind == "ring-zigzag")
        logits = lm(toks, attn_fn=_seq_attn(kind, Axis("sp", n)),
                    positions=pos)
        loss = F.cross_entropy(logits.flatten(0, -2), tgts.flatten())
        names, leaves = zip(*lm.named_parameters())
        g = torch.autograd.grad(loss, leaves)
        torch.save({"logits": logits.detach().cpu(),
                    "grads": {k: v.cpu() for k, v in zip(names, g)}},
                   os.path.join(refdir, f"seq_{kind}.pt"))
        del lm, logits, g, loss, leaves
        gc.collect()
        torch.cuda.empty_cache()

    # path 3: MoE dp 2 x ep 4, top-1, dp rank 0's f32 forward at ample
    # capacity (see mesh_moe)
    cfg = pmm.MoEConfig(gpt=dataclasses.replace(base, dtype=torch.float32),
                        num_experts=MOE_EXPERTS, ep_size=MOE_EP,
                        capacity_factor=MOE_EXPERTS, router="top1")
    moe = pmm.MoETransformerLM(cfg).to(device)
    p0 = dict(moe.named_parameters())
    ids = _moe_data(device, MESH_MOE_BATCH)[0]
    logits = functional_call(moe, p0, (ids,))
    loss = pmm.moe_lm_loss(moe, logits, torch.roll(ids, -1, dims=-1), cfg)
    g = torch.autograd.grad(loss, list(p0.values()))
    torch.save({"logits": logits.detach().cpu(), "loss": loss.item(),
                "grads": {k: v.cpu() for k, v in zip(p0, g)}},
               os.path.join(refdir, "moe.pt"))
    del moe, p0, logits, g, loss
    gc.collect()
    torch.cuda.empty_cache()

    # path 4: the hybrid's f32 1F1B step of dp rank 0
    hmesh = pt.make_hybrid_mesh({"bf": HYB_DP, "tp": HYB_TP},
                                ranks=range(HYB_DP * HYB_TP))
    hmodel = pt.TPTransformerLM(dataclasses.replace(
        base, dtype=torch.float32), hmesh)
    params = {k: v.detach()[0].to(device)
              for k, v in hmodel.named_parameters()}
    loss, grads = hybrid_runner(hmodel, Axis("pp", HYB_PP, 0), device)(
        "1f1b", params, _hybrid_data(device)[0])
    torch.save({"loss": loss, "grads": {k: v.cpu() for k, v in
                                        grads.items()}},
               os.path.join(refdir, "hybrid.pt"))
    del hmodel, params, grads
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mesh] the one-process references: "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def hybrid_runner(model, stage_axis, device):
    """``run(schedule, params, ids)``: one dp rank's pipelined step on the
    stages of ``stage_axis`` held here (all of them in one process), with
    ``params`` the dp rank's slice of ``model``'s stacked parameters (at
    least every key of a held stage, and of the rim a held stage touches)
    and ``ids`` its tokens.  Returns the loss (the last stage's; 0 where it
    is not held) and the corrected gradients of the held stages' blocks, of
    the embeddings where stage 0 is held and of the head where the last
    is."""
    import torch.nn.functional as F
    from torch.func import functional_call
    from bluefog_tpu_torch.parallel import pipeline as pp
    from bluefog_tpu_torch.parallel import tensor as pt
    from bluefog_tpu_torch.parallel.axes import Axis

    n_l = model.cfg.num_layers // HYB_PP
    held = list(stage_axis.local_ranks())
    suffixes = [k[len("block_0."):] for k, _ in model.named_parameters()
                if k.startswith("block_0.")]
    block = model.block_0
    tp_in_stage, tp_axis = Axis("tp", HYB_TP, 1), Axis("tp", HYB_TP, 0)
    n_tok = HYB_MICRO * HYB_MB * TP_SEQ

    def head_loss(head, y, tgt):
        # y (tp, mb, T, C): each tp rank's copy of the last stage's output;
        # the sum over the ranks of each one's loss on the dp rank's tokens
        z = F.layer_norm(y.float(), y.shape[-1:], eps=1e-6)
        z = z * head["scale"][:, None, None] + head["bias"][:, None, None]
        logits = torch.matmul(z.flatten(1, 2), head["kernel"])
        ce = F.cross_entropy(logits.flatten(0, 1),
                             tgt.flatten().repeat(HYB_TP), reduction="sum")
        return ce / n_tok

    def stage_fn(sp, x):
        for i in range(n_l):
            x = functional_call(
                block, {s: v[:, :, i] for s, v in sp.items()},
                (x, _causal_auto), {"axis": tp_in_stage})
        return x

    def run(schedule, p, ids):
        sp = {s: torch.stack([torch.stack(
            [p[f"block_{st * n_l + i}.{s}"] for i in range(n_l)], dim=1)
            for st in held]) for s in suffixes}
        tok = p["tok.embedding"].detach().requires_grad_()
        pos = p["pos.embedding"].detach().requires_grad_()
        rows = torch.arange(HYB_TP, device=device)[:, None, None]
        x = (tok[rows, ids] + pos[:, :TP_SEQ][:, None]).to(model.cfg.dtype)
        xs = x.unflatten(1, (HYB_MICRO, HYB_MB)).transpose(0, 1)
        tgt = torch.roll(ids, -1, dims=-1).unflatten(0, (HYB_MICRO, HYB_MB))
        head = {"scale": p["ln_f.scale"], "bias": p["ln_f.bias"],
                "kernel": p["lm_head.kernel"]}
        fn = (pp.pipeline_train_step_1f1b if schedule == "1f1b"
              else pp.pipeline_train_step_gpipe)
        loss, sg, hg, dxs = fn(stage_fn, sp, xs.detach(), tgt, head_loss,
                               axis=stage_axis, head_params=head,
                               collect_input_grads=True)
        raw = {}
        if 0 in held:
            torch.autograd.backward(xs, dxs)
            raw.update({"tok.embedding": tok.grad, "pos.embedding": pos.grad})
        if HYB_PP - 1 in held:
            raw.update({"ln_f.scale": hg["scale"], "ln_f.bias": hg["bias"],
                        "lm_head.kernel": hg["kernel"]})
        for j, st in enumerate(held):
            for i in range(n_l):
                for s in suffixes:
                    raw[f"block_{st * n_l + i}.{s}"] = sg[s][j, :, i]
        # the loss summed the tp ranks' copies
        return (float(loss) / HYB_TP,
                pt.tp_correct_grads(raw, model, tp_axis))
    return run


def _mesh_wall(tr, step, device):
    """One untimed step, then MESH_STEPS timed ones between two barriers of
    the group (its processes time-slice the card): ms a step, this
    process's launches a step, its peak GB, its collectives' stats a step,
    its handshakes' host ms a step, and the last step's result."""
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix_peer
    from bluefog_tpu_torch.parallel import axes as ax

    step()
    torch.cuda.synchronize(device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    _zero_launches()
    peer = gossip_mix_peer.launches
    ax.reset_collective_stats()
    hs = tr.handshake_us
    tr.barrier()
    t0 = time.perf_counter()
    for _ in range(MESH_STEPS):
        out = step()
    torch.cuda.synchronize(device)
    tr.barrier()
    ms = (time.perf_counter() - t0) / MESH_STEPS * 1e3
    stats = {op: {k: v / MESH_STEPS for k, v in st.items()}
             for op, st in ax.COLLECTIVE_STATS.items()}
    return {"ms": ms, "launches": _launches(MESH_STEPS),
            "k1_peer_launches": (gossip_mix_peer.launches - peer)
            / MESH_STEPS,
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "collectives": stats,
            "handshake_ms": (tr.handshake_us - hs) / MESH_STEPS / 1e3,
            "result": out}


def _mesh_collective(tr, fn, x, what):
    """A collective alone at a path's shape: all processes' calls between
    two barriers, MESH_REPS of them, against the bytes it must move on the
    card (each process stages its payload once, and reads and writes each
    row it gathers), over every process."""
    from bluefog_tpu_torch.parallel import axes as ax

    ax.reset_collective_stats()
    y = fn(x)
    st = ax.COLLECTIVE_STATS
    rows = sum(s["remote_bytes"] + s["local_bytes"] for s in st.values())
    nbytes = (2 * x.numel() * x.element_size() + 2 * rows) * tr.processes
    del y
    ms = _wall_ms(tr, lambda: fn(x), MESH_REPS)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"what": what, "ms": ms, "bytes": nbytes, "bound_ms": bound,
            "of_bound": bound / ms}


def _rel_to(got, ref):
    """max |got - ref| / max |ref|, ``ref`` from the host."""
    ref = ref.to(got.device, torch.float32)
    return float((got.detach().float() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


def _mesh_grads_rel(got, ref):
    worst, where = 0.0, ""
    for k, g in got.items():
        rel = _rel_to(g, ref[k])
        if not rel <= worst:
            worst, where = rel, k
    return worst, where


def mesh_path1(ctx, refdir, device):
    """Path 1 over processes: GPT-small TP, bf 4 x tp 2, placed from the
    full leaves by make_shard_and_gather_fns; at P = 8 (tp across the
    processes) first the f32 tp group's logits and corrected gradients
    against the one-process run; AdamW steps gossiping through
    sharded_neighbor_allreduce on K1's peer form; the state's digests; K1
    against its plain fold; the WinPut variant; the tp psum alone."""
    from torch.func import functional_call
    from bluefog_tpu_torch import sharding as S
    from bluefog_tpu_torch.parallel import axes as ax
    from bluefog_tpu_torch.parallel import tensor as pt

    base = slice_config()
    with _one_process():
        model, full = _tp_template(base)
    mesh = S.GossipMesh(TP_BF, {"tp": TP_SIZE}).mesh()
    box = mesh.owned()
    axis = mesh.axis("tp", dim=0)
    tr = ctx.transport
    out = {"box": [[s.start, s.stop] for s in box],
           "tp_crosses": axis.spans_processes}
    if axis.spans_processes:
        _set_compute_dtype(model, torch.float32)
        p32, _ = _tp_place(full, mesh, device, optimizer=False)
        p_r = {k: v[0] for k, v in p32.items()}
        ids = _tp_data(device, PARITY_BATCH)[0]
        losses, grads = pt.tp_value_and_grad(
            lambda p, i: _tp_losses(model, p, i, axis), model, axis)(p_r, ids)
        with torch.no_grad():
            logits = functional_call(model, p_r, (ids,), {"axis": axis})
        ref = torch.load(os.path.join(refdir, "path1_f32.pt"))
        refg = torch.load(os.path.join(
            refdir, f"path1_f32_grads{axis.start}.pt"))
        out["f32"] = {
            "logits": _rel_to(logits[0], ref["logits"]),
            "loss": abs(float(losses[0]) - float(ref["losses"][axis.start]))
            / abs(float(ref["losses"][axis.start])),
            "grads": _mesh_grads_rel({k: g[0] for k, g in grads.items()},
                                     refg)}
        x = torch.randn(1, TP_BATCH, TP_SEQ, base.hidden_size,
                        device=device).to(base.dtype)
        out["psum_alone"] = _mesh_collective(
            tr, lambda t: ax.psum(t, axis), x,
            f"psum of {tuple(x.shape)} bf16 over the tp pair")
        del p32, p_r, grads, logits, ref, refg
        _set_compute_dtype(model, base.dtype)
        gc.collect()
        torch.cuda.empty_cache()
    params, opt = _tp_place(full, mesh, device)
    del full
    # with tp across the card's 8 processes each holds one rank's whole
    # batch at once (phase 26 runs the bf ranks one after another), and
    # batch 8's f32 logits and their gradients alone take 5 GB a process:
    # its batch in MESH_P8_CHUNKS slices, the gradients averaged
    chunks = MESH_P8_CHUNKS if axis.spans_processes else 1
    out["chunks"] = chunks
    step = _tp_step_fn(model, params, opt, _tp_data(device), axis,
                       range(box[0].start, box[0].stop), chunks)
    out.update(_mesh_wall(tr, step, device))
    out["digests"] = _rows_digest(params, box)
    out["k1_parity"] = k1_step_parity(opt, f"mesh path 1 P={tr.processes}")
    if not axis.spans_processes:
        out["winput"] = mesh_winput(params, f"mesh path 1 P={tr.processes}")
    del params, opt
    return out


def mesh_seq(refdir, device):
    """Path 2 over processes: for each attention, the f32 logits and the
    gradients (the replicated model's, summed over the processes by
    reduce_partials) against the one-process run, then bf16 AdamW steps;
    the KV rotation or the all-to-all alone."""
    import torch.nn.functional as F
    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.examples.longcontext_lm import shard_sequence
    from bluefog_tpu_torch.models.transformer import TransformerLM
    from bluefog_tpu_torch.parallel import axes as ax

    base = slice_config()
    res = {}
    for i, (kind, n) in enumerate(MESH_SEQ.items()):
        ctx = bf.init(size=n)
        tr = ctx.transport
        axis = ax.make_hybrid_mesh({"sp": n}).axis("sp")
        own = slice(axis.start, axis.start + axis.local)
        attn = _seq_attn(kind, axis)
        lm = TransformerLM(dataclasses.replace(base, dtype=torch.float32),
                           torch.Generator().manual_seed(0)).to(device)
        toks, tgts, pos = (t[own] for t in shard_sequence(
            _seq_ids(device, i, n), n, kind == "ring-zigzag"))
        share = 1.0 / (n * SP_T_LOCAL)

        def loss_of(logits):
            return F.cross_entropy(logits.flatten(0, -2), tgts.flatten(),
                                   reduction="sum") * share

        logits = lm(toks, attn_fn=attn, positions=pos)
        names, leaves = zip(*lm.named_parameters())
        g = ax.reduce_partials(torch.autograd.grad(loss_of(logits), leaves),
                               axis)
        ref = torch.load(os.path.join(refdir, f"seq_{kind}.pt"), mmap=True)
        out = {"ranks": n, "held": [axis.start, axis.start + axis.local],
               "f32": {"logits": _rel_to(logits, ref["logits"][own]),
                       "grads": _mesh_grads_rel(dict(zip(names, g)),
                                                ref["grads"])}}
        del logits, g, ref
        _set_compute_dtype(lm, base.dtype)
        opt = torch.optim.AdamW(lm.parameters(), lr=3e-4, weight_decay=0.01)
        params = list(lm.parameters())

        def step():
            logits = lm(toks, attn_fn=attn, positions=pos)
            loss = loss_of(logits)
            grads = torch.autograd.grad(loss, params)
            for p_, g_ in zip(params, ax.reduce_partials(grads, axis)):
                p_.grad = g_
            opt.step()
            return float(loss.detach())

        out.update(_mesh_wall(tr, step, device))
        q = torch.randn(axis.local, 1, SP_T_LOCAL, base.num_heads,
                        base.hidden_size // base.num_heads,
                        device=device).to(base.dtype)
        out["alone"] = (_mesh_collective(
            tr, lambda t: ax.all_to_all(t, axis, -2, -3, tiled=True), q,
            f"all_to_all of q {tuple(q.shape)} bf16")
            if kind == "ulysses" else _mesh_collective(
                tr, lambda t: ax.shift(t, axis), q,
                f"the ring's KV shift of {tuple(q.shape)} bf16"))
        res[kind] = out
        del lm, opt, params, toks, tgts, pos, q
        gc.collect()
        torch.cuda.empty_cache()
    return res


def mesh_longcontext():
    """``examples.longcontext_lm`` under the launcher, each ``--attn``, at
    MESH_LC_STEPS steps (phase 29 runs its default 60 in one process): its 8
    sp ranks spread over the group's processes."""
    from bluefog_tpu_torch.examples import longcontext_lm as lc

    res = {}
    for kind in lc.ATTNS:
        t0 = time.perf_counter()
        out = lc.main(["--attn", kind, "--steps", str(MESH_LC_STEPS)])
        res[kind] = {"ok": out["ok"], "s": time.perf_counter() - t0,
                     "tokens_s": out["tokens_s"],
                     "first": out["losses"][0], "last": out["losses"][-1]}
    return res


def mesh_moe(ctx, refdir, device):
    """Path 3 over processes: MoE top-1, dp 2 x ep 4, each process two
    ep ranks of one dp rank: the f32 logits and gradients (experts its
    own, the replicated trunk's summed over its ep group's processes)
    against the one-process run, then bf16 AdamW steps gossiping each
    process's parameters with the same ep ranks of the other dp rank on
    K1's peer form, K1 against its plain fold; the all-to-all alone."""
    import numpy as np
    from torch.func import functional_call
    from bluefog_tpu_torch.models import moe as pmm
    from bluefog_tpu_torch.optim import DistributedNeighborAllreduceOptimizer
    from bluefog_tpu_torch.parallel import axes as ax
    from bluefog_tpu_torch.topology import ExponentialTwoGraph, Topology

    base = slice_config()
    tr = ctx.transport
    mesh = ax.make_hybrid_mesh({"dp": MOE_DP, "ep": MOE_EP})
    box = mesh.owned()
    d, eps = box[0].start, box[1]
    axis = mesh.axis("ep", dim=0)
    # the f32 check at ample capacity: at the path's, where the router
    # drops most tokens at init, rounding that differs between the batch
    # folds of one process and of two (cuBLAS picks by shape) moves a token
    # past the capacity and the drops cascade (4.6e-2 measured); no token
    # drops at capacity = the tokens of a rank
    cfg = pmm.MoEConfig(gpt=dataclasses.replace(base, dtype=torch.float32),
                        num_experts=MOE_EXPERTS, ep_size=MOE_EP,
                        capacity_factor=MOE_EXPERTS, router="top1")
    with _one_process():
        moe = pmm.MoETransformerLM(cfg)
    pmm.set_ep_axis(moe, axis)
    expert = lambda k: k.endswith(("mlp.wi", "mlp.wo"))  # noqa: E731
    host = {k: v.detach() for k, v in moe.named_parameters()}
    p = {k: (v[eps] if expert(k) else v).to(device, copy=True)
         .requires_grad_() for k, v in host.items()}
    share = axis.local / MOE_EP

    def loss_of(model, logits, ids):
        return pmm.moe_lm_loss(model, logits, torch.roll(ids, -1, dims=-1),
                               cfg) * share

    def grads_of(loss, p_r):
        g = dict(zip(p_r, torch.autograd.grad(loss, list(p_r.values()))))
        trunk = [k for k in g if not expert(k)]
        for k, v in zip(trunk, ax.reduce_partials([g[k] for k in trunk],
                                                  axis)):
            g[k] = v
        return g

    ids = _moe_data(device, MESH_MOE_BATCH)[0][eps]
    logits = functional_call(moe, p, (ids,))
    g = grads_of(loss_of(moe, logits, ids), p)
    ref = torch.load(os.path.join(refdir, "moe.pt"), mmap=True)
    out = {"held": [eps.start, eps.stop], "dp": d,
           "f32": {"logits": _rel_to(logits, ref["logits"][eps]),
                   "grads": _mesh_grads_rel(
                       g, {k: (v[eps] if expert(k) else v)
                           for k, v in ref["grads"].items()})}}
    del logits, g, ref, p
    gc.collect()
    torch.cuda.empty_cache()
    # bf16 steps: each process one row of the (dp, ep block) gossip, each
    # block under remat: four processes' activations without it, ~19 GiB a
    # process with the peer memory, do not fit the card together (probe)
    _set_compute_dtype(moe, base.dtype)
    moe.cfg = dataclasses.replace(moe.cfg, remat=True)
    cfg = dataclasses.replace(cfg, capacity_factor=1.25)   # phase 29's
    for m in moe.modules():
        if isinstance(m, pmm.MoEMLP):
            m.cfg = dataclasses.replace(m.cfg, capacity_factor=1.25)
    params = {k: (v[eps] if expert(k) else v)[None].to(device, copy=True)
              .requires_grad_() for k, v in host.items()}
    del host
    blocks = MOE_EP // axis.local
    topo = Topology(np.kron(ExponentialTwoGraph(MOE_DP).weights,
                            np.eye(blocks)), name="exp2(dp) x ep blocks")
    # one parameter at a time: the foreach step's temporaries would cost
    # another copy of the parameters in each of the card's four processes
    opt = DistributedNeighborAllreduceOptimizer(
        torch.optim.AdamW(list(params.values()), lr=3e-4, weight_decay=0.01,
                          foreach=False), topology=topo)
    data = _moe_data(device, MOE_BATCH)[d][eps]

    def step():
        p_r = {k: v[0] for k, v in params.items()}
        logits = functional_call(moe, p_r, (data,))
        loss = loss_of(moe, logits, data)
        g = grads_of(loss, p_r)
        del logits
        for k, v in params.items():     # the gradients as they are
            v.grad = g.pop(k)[None]
        opt.step()
        return float(loss.detach()) / share

    out.update(_mesh_wall(tr, step, device))
    out["k1_parity"] = k1_step_parity(opt, f"mesh moe P={tr.processes}")
    x = torch.randn(axis.local, MOE_EP, MOE_EXPERTS // MOE_EP,
                    cfg.capacity(MOE_BATCH * MOE_SEQ), base.hidden_size,
                    device=device).to(base.dtype)
    out["alone"] = _mesh_collective(
        tr, lambda t: ax.all_to_all(t, axis, -4, -4), x,
        f"the dispatch all-to-all of {tuple(x.shape)} bf16")
    del params, opt, moe, x
    return out


def mesh_hybrid(ctx, refdir, device):
    """Path 4 over processes: dp 2 x pp 2 x tp 2, each process one stage
    of one dp rank (tp whole): the f32 1F1B and GPipe gradients of its
    stage (with the embeddings on stage 0, the head on the last) against
    the one-process run, the bf16 schedules' times, then an SGD step
    gossiped over dp on K1's peer form against the plain fold; the stage
    hop alone."""
    import numpy as np
    from bluefog_tpu_torch.ops.collectives import fuse_apply, neighbor_allreduce
    from bluefog_tpu_torch.parallel import axes as ax
    from bluefog_tpu_torch.parallel import tensor as pt
    from bluefog_tpu_torch.topology import (ExponentialTwoGraph, Topology,
                                            build_schedule)

    base = slice_config()
    tr = ctx.transport
    mesh = ax.make_hybrid_mesh({"dp": HYB_DP, "pp": HYB_PP, "tp": HYB_TP})
    box = mesh.owned()
    d = box[0].start
    stage_axis = mesh.axis("pp", dim=0)
    held = list(stage_axis.local_ranks())
    with _one_process():
        model = pt.TPTransformerLM(dataclasses.replace(
            base, dtype=torch.float32), pt.make_hybrid_mesh(
                {"bf": HYB_DP, "tp": HYB_TP}, ranks=range(HYB_DP * HYB_TP)))
    host = {k: v.detach() for k, v in model.named_parameters()}
    run = hybrid_runner(model, stage_axis, device)
    ids = _hybrid_data(device)
    ref = torch.load(os.path.join(refdir, "hybrid.pt"), mmap=True)
    p = {k: v[0].to(device) for k, v in host.items()}
    out = {"stages": held, "dp": d, "f32": {}}
    for schedule in ("1f1b", "gpipe"):
        loss, g = run(schedule, p, ids[0])
        out["f32"][schedule] = {"grads": _mesh_grads_rel(g, ref["grads"]),
                                "keys": len(g)}
        if HYB_PP - 1 in held:
            out["f32"][schedule]["loss"] = abs(loss - ref["loss"]) / abs(
                ref["loss"])
        del g
    del p, ref
    gc.collect()
    torch.cuda.empty_cache()
    _set_compute_dtype(model, base.dtype)
    p = {k: v[d].to(device) for k, v in host.items()}
    for schedule in ("1f1b", "gpipe"):
        out[schedule] = _mesh_wall(tr, lambda: run(schedule, p, ids[d])[0],
                                   device)
    # the dp step: every process's row of its dp rank's parameters
    _, g = run("gpipe", p, ids[d])
    with torch.no_grad():
        new = {k: (v - 0.1 * g[k] if k in g else v)[None]
               for k, v in p.items()}
    sched = build_schedule(Topology(np.kron(
        ExponentialTwoGraph(HYB_DP).weights, np.eye(HYB_PP)),
        name="exp2(dp) x stages"))
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix_peer

    before = gossip_mix_peer.launches
    with torch.no_grad():
        mixed = fuse_apply(lambda t: neighbor_allreduce(
            t, sched, backend="kernel"), new)
        torch.cuda.synchronize(device)
        launched = gossip_mix_peer.launches - before
        plain = fuse_apply(lambda t: neighbor_allreduce(
            t, sched, backend="plain"), new)
    out["dp_step"] = {"k1_peer_launches": launched, "bit_equal": all(
        torch.equal(mixed[k], plain[k]) for k in plain)}
    x = torch.randn(1, HYB_TP, HYB_MB, TP_SEQ, base.hidden_size,
                    device=device).to(base.dtype)
    out["alone"] = _mesh_collective(
        tr, lambda t: ax.ppermute(t, stage_axis, [(0, 1)]), x,
        f"the stage hop of {tuple(x.shape)} bf16")
    del p, new, mixed, plain, model, host
    return out


def mesh_worker(argv):
    """One process of phase 30, started by the launcher: ``--mesh-worker
    OUTDIR REFDIR LENGTHS``; runs its group's paths (:data:`MESH_GROUPS`;
    at P = 8 first phase 1b's K1 check, :func:`mp_k1`, at the main path's
    comma-separated LENGTHS) and writes ``OUTDIR/p<process>.json``."""
    outdir, refdir = argv[0], argv[1]
    lengths = [int(v) for v in argv[2].split(",")]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from bluefog_tpu_torch.runtime.launch import initialize_cluster

    initialize_cluster()
    import bluefog_tpu_torch as bf

    t0 = time.perf_counter()
    ctx = bf.init(size=N_RANKS)
    device = ctx.device
    out = {"process": ctx.process_rank, "processes": ctx.process_count,
           "device": str(device)}
    seconds = {"init": time.perf_counter() - t0}
    if ctx.process_count == N_RANKS:
        t1 = time.perf_counter()
        out["k1"] = mp_k1(ctx, lengths)
        seconds["k1"] = time.perf_counter() - t1
    seen = set()
    for i, what in enumerate(MESH_GROUPS[ctx.process_count]):
        t1 = time.perf_counter()
        if i:
            ctx = bf.init(size=N_RANKS)   # the last path's memory freed
        with k3_calls(seen):
            if what == "path1":
                out[what] = mesh_path1(ctx, refdir, device)
            elif what == "seq":
                out[what] = mesh_seq(refdir, device)
            elif what == "moe":
                out[what] = mesh_moe(ctx, refdir, device)
            elif what == "longcontext":
                out[what] = mesh_longcontext()
            else:
                out[what] = mesh_hybrid(ctx, refdir, device)
        gc.collect()
        torch.cuda.empty_cache()
        seconds[what] = time.perf_counter() - t1
    out["seconds"] = seconds
    out["k3_shapes"] = [[list(shape), str(dt), causal]
                        for shape, dt, causal in sorted(seen, key=str)]
    bf.shutdown()
    with open(os.path.join(outdir, f"p{out['process']}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _mesh_group(procs, outdir, refdir, lengths):
    """Start ``procs`` processes of this script's phase-30 worker through
    the launcher; their results in process order (a failed or late group
    fails the phase)."""
    cmd = [sys.executable, "-m", "bluefog_tpu_torch.runtime.launch",
           "--no-build", "-np", str(procs), os.path.abspath(__file__),
           "--mesh-worker", outdir, refdir, ",".join(map(str, lengths))]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    # P processes share the card's memory: let each one's cached blocks grow
    # in place (the transport's peer memory is its own cudaMalloc)
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=MESH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        print(log[-6000:])
        check(False, f"phase 30: {procs} processes did not finish in "
              f"{MESH_TIMEOUT_S} s")
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        # every process's error line, then the end of the group's output
        errors = dict.fromkeys(line for line in log.splitlines()
                               if re.search(r"Error|error:", line))
        print("\n".join(list(errors)[:40]))
        print(log[-6000:])
    check(proc.returncode == 0,
          f"phase 30: {procs} processes: the launcher exited "
          f"{proc.returncode}")
    res = []
    for q in range(procs):
        with open(os.path.join(outdir, f"p{q}.json")) as f:
            res.append(json.load(f))
    return res, secs


def _collectives_line(rows):
    """The processes' collectives a step (each row one process's), summed
    over the processes."""
    total = {}
    for r in rows:
        for op, st in r["collectives"].items():
            agg = total.setdefault(op, {"calls": 0, "remote_bytes": 0,
                                        "local_bytes": 0, "host_s": 0.0})
            for k in agg:
                agg[k] += st[k]
    return total


def _alone_line(rows):
    """A collective timed alone: the slowest process's ms."""
    ms = max(r["alone"]["ms"] for r in rows)
    return {**{k: rows[0]["alone"][k] for k in ("what", "bytes",
                                                "bound_ms")},
            "ms": ms, "of_bound": rows[0]["alone"]["bound_ms"] / ms}


def phase_mesh_processes(device, single, lengths):
    """Phase 30 (see the module docstring): the one-process references
    (:func:`mesh_references`), then the groups of :data:`MESH_GROUPS`.
    ``single`` holds this run's one-process tokens/s of phases 25, 26, 28
    and 29; ``lengths`` the main path's for phase 1b's K1 check at P = 8,
    which the P = 8 group runs (its entry ``k1``)."""
    t_phase = time.perf_counter()
    refdir = tempfile.mkdtemp(prefix="bf-mesh-")
    out, shapes = {}, set()
    try:
        out["one_process"] = mesh_references(device, refdir)
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(device)
        print(f"[mesh] this process holds {torch.cuda.memory_allocated() / 2**30:.2f}"
              f" GiB ({torch.cuda.memory_reserved() / 2**30:.2f} reserved); "
              f"the card {free / 2**30:.2f} of {total / 2**30:.2f} GiB free")
        with open(os.path.join(refdir, "path1_digests.json")) as f:
            digests = json.load(f)
        for procs in MESH_GROUPS:
            outdir = os.path.join(refdir, f"P{procs}")
            os.makedirs(outdir)
            res, secs = _mesh_group(procs, outdir, refdir, lengths)
            tag = f"[mesh P={procs}]"
            print(f"{tag} {secs:.1f} s for the group; the slowest process's "
                  "seconds after start-up: "
                  + str({k: round(max(r["seconds"][k] for r in res), 1)
                         for k in res[0]["seconds"]}))
            entry = {"seconds": secs}
            if "k1" in res[0]:
                entry["k1"] = report_k1(f"[processes P={procs}]", res,
                                        lengths)
            shapes.update((tuple(sh), getattr(torch, dt[len("torch."):]),
                           causal) for r in res
                          for sh, dt, causal in r["k3_shapes"])
            if "path1" in res[0]:
                entry["path1"] = _report_mesh_path1(tag, procs, res, digests,
                                                    single)
            if "seq" in res[0]:
                entry["seq"] = _report_mesh_seq(tag, res, single)
            if "longcontext" in res[0]:
                entry["longcontext"] = res[0]["longcontext"]
                print(f"{tag} examples.longcontext_lm under the launcher: "
                      + ", ".join(f"{k} OK {v['ok']} ({v['first']:.3f} -> "
                                  f"{v['last']:.4f}, {v['s']:.1f} s)"
                                  for k, v in res[0]["longcontext"].items()))
                check(all(v["ok"] for r in res
                          for v in r["longcontext"].values()),
                      f"{tag} longcontext_lm over processes did not reach OK")
            if "moe" in res[0]:
                entry["moe"] = _report_mesh_moe(tag, res, single)
            if "hybrid" in res[0]:
                entry["hybrid"] = _report_mesh_hybrid(tag, res, single)
            out[procs] = entry
    finally:
        shutil.rmtree(refdir, ignore_errors=True)
    # K3 at every shape the processes handed it, held against the twins here
    out["k3_calls"] = check_k3_calls(shapes, device, "mesh processes")
    print(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _report_mesh_path1(tag, procs, res, digests, single):
    rows = [r["path1"] for r in res]
    crosses = rows[0]["tp_crosses"]
    same = all(v == digests[k] for r in rows for k, v in r["digests"].items())
    n_tok = TP_BF * TP_BATCH * TP_SEQ
    ms = max(r["ms"] for r in rows)
    entry = {"tp_crosses": crosses,
             "bit_equal_to_one_process": None if crosses else same,
             "ms": ms, "tokens_s": n_tok / ms * 1e3,
             "one_process_tokens_s": single["tp"],
             "peak_gb": max(r["peak_gb"] for r in rows),
             "launches": rows[0]["launches"],
             "k1_peer_launches": rows[0]["k1_peer_launches"],
             "handshake_ms": max(r["handshake_ms"] for r in rows),
             "collectives": _collectives_line(rows),
             "k1_parity": all(r["k1_parity"]["bit_equal"] for r in rows)}
    print(f"{tag} path 1 (bf {TP_BF} x tp {TP_SIZE}, processes hold "
          f"{[r['box'] for r in rows]}; tp across processes: {crosses}): "
          f"{entry['tokens_s']:.1f} tokens/s over the processes (one process"
          f" {single['tp']:.1f}), {ms:.2f} ms a step, peak "
          f"{entry['peak_gb']:.2f} GB a process, launches a step a process "
          f"{rows[0]['launches']}, handshakes {entry['handshake_ms']:.2f} ms;"
          + (f" batch in {rows[0]['chunks']} slices;" if crosses else
             f" the state after {1 + MESH_STEPS} steps bit-equal to one "
             f"process's: {same};")
          + f" K1 peer vs plain fold bit-equal "
          f"{entry['k1_parity']}; collectives a step "
          f"{entry['collectives']}; K1 peer launches a step a process "
          f"{rows[0]['k1_peer_launches']:g}")
    check(entry["k1_parity"], f"{tag} path 1: K1 differs from its plain fold")
    held_bf = rows[0]["box"][0][1] - rows[0]["box"][0][0]
    # tp folds into K3's batch: a launch a layer a held bf rank a slice
    want_k3 = base_layers() * held_bf * rows[0]["chunks"]
    check(all(r["launches"]["flash_forward"] == want_k3
              and r["launches"]["flash_backward_dq"] == want_k3
              for r in rows),
          f"{tag} path 1: K3 launches {rows[0]['launches']}, expected "
          f"{want_k3} a process a step")
    check(all(r["k1_peer_launches"] > 0 for r in rows),
          f"{tag} path 1: no K1 peer launch a step")
    if crosses:
        f32 = {"logits": max(r["f32"]["logits"] for r in rows),
               "loss": max(r["f32"]["loss"] for r in rows),
               "grads": max((r["f32"]["grads"] for r in rows),
                            key=lambda v: v[0])}
        entry["f32"] = f32
        entry["psum_alone"] = _alone_line(
            [{"alone": r["psum_alone"]} for r in rows])
        print(f"{tag} path 1 f32, the tp psum across processes: logits "
              f"{f32['logits']:.3e}, loss {f32['loss']:.3e}, corrected "
              f"gradients {f32['grads'][0]:.3e} ({f32['grads'][1]}) of the "
              f"one-process run's (tol {SLICE_TOL:.1e}); "
              f"{entry['psum_alone']['what']} alone "
              f"{entry['psum_alone']['ms']:.3f} ms for all processes, "
              f"bound {entry['psum_alone']['bound_ms']:.4f} ms")
        check(max(f32["logits"], f32["loss"], f32["grads"][0]) <= SLICE_TOL,
              f"{tag} path 1 f32 disagrees with one process: {f32}")
    else:
        check(same, f"{tag} path 1: the state differs from one process's")
        entry["winput"] = [r["winput"] for r in rows]
    return entry


def base_layers():
    return slice_config().num_layers


def _report_mesh_seq(tag, res, single):
    out = {}
    for kind, n in MESH_SEQ.items():
        rows = [r["seq"][kind] for r in res]
        ms = max(r["ms"] for r in rows)
        f32 = {"logits": max(r["f32"]["logits"] for r in rows),
               "grads": max((r["f32"]["grads"] for r in rows),
                            key=lambda v: v[0])}
        e = {"f32": f32, "ms": ms, "tokens_s": n * SP_T_LOCAL / ms * 1e3,
             "one_process_tokens_s": single["seq"][kind],
             "peak_gb": max(r["peak_gb"] for r in rows),
             "launches": rows[0]["launches"],
             "collectives": _collectives_line(rows),
             "handshake_ms": max(r["handshake_ms"] for r in rows),
             "alone": _alone_line(rows)}
        print(f"{tag} {kind} over {n} sp ranks ({n * SP_T_LOCAL} tokens, "
              f"held {[r['held'] for r in rows]}): f32 logits "
              f"{f32['logits']:.3e}, gradients {f32['grads'][0]:.3e} of the "
              f"one-process run's (tol {SLICE_TOL:.1e}); bf16 "
              f"{e['tokens_s']:.1f} tokens/s over the processes (one process "
              f"{e['one_process_tokens_s']:.1f}), peak {e['peak_gb']:.2f} GB "
              f"a process, K3 a step a process {e['launches']}; collectives "
              f"a step {e['collectives']}, handshakes {e['handshake_ms']:.2f}"
              f" ms; {e['alone']['what']} alone {e['alone']['ms']:.3f} ms, "
              f"bound {e['alone']['bound_ms']:.4f} ms")
        check(max(f32["logits"], f32["grads"][0]) <= SLICE_TOL,
              f"{tag} {kind} disagrees with one process: {f32}")
        want = base_layers() if kind == "ulysses" else 0
        check(all(r["launches"]["flash_forward"] == want for r in rows),
              f"{tag} {kind}: K3 launches {rows[0]['launches']}, expected "
              f"{want} a process a step")
        out[kind] = e
    return out


def _report_mesh_moe(tag, res, single):
    rows = [r["moe"] for r in res]
    ms = max(r["ms"] for r in rows)
    f32 = {"logits": max(r["f32"]["logits"] for r in rows),
           "grads": max((r["f32"]["grads"] for r in rows),
                        key=lambda v: v[0])}
    e = {"f32": f32, "ms": ms,
         "tokens_s": MOE_DP * MOE_EP * MOE_BATCH * MOE_SEQ / ms * 1e3,
         "one_process_tokens_s": single["moe"],
         "peak_gb": max(r["peak_gb"] for r in rows),
         "launches": rows[0]["launches"],
         "k1_peer_launches": rows[0]["k1_peer_launches"],
         "k1_parity": all(r["k1_parity"]["bit_equal"] for r in rows),
         "collectives": _collectives_line(rows),
         "handshake_ms": max(r["handshake_ms"] for r in rows),
         "alone": _alone_line(rows)}
    print(f"{tag} MoE top-1, dp {MOE_DP} x ep {MOE_EP} (processes hold ep "
          f"{[r['held'] for r in rows]}): f32 logits {f32['logits']:.3e}, "
          f"gradients {f32['grads'][0]:.3e} ({f32['grads'][1]}) of the "
          f"one-process run's (tol {SLICE_TOL:.1e}); bf16 "
          f"{e['tokens_s']:.1f} tokens/s (one process "
          f"{e['one_process_tokens_s']:.1f}), peak {e['peak_gb']:.2f} GB a "
          f"process, launches a step a process {e['launches']}, K1 peer vs "
          f"plain fold bit-equal {e['k1_parity']}; collectives a step "
          f"{e['collectives']}; {e['alone']['what']} alone "
          f"{e['alone']['ms']:.3f} ms, bound {e['alone']['bound_ms']:.4f} ms")
    check(max(f32["logits"], f32["grads"][0]) <= SLICE_TOL,
          f"{tag} MoE disagrees with one process: {f32}")
    check(e["k1_parity"], f"{tag} MoE: K1 differs from its plain fold")
    # remat: each layer's forward twice a step, its backward once
    check(all(r["launches"]["flash_forward"] == 2 * base_layers()
              and r["launches"]["flash_backward_dkv"] == base_layers()
              for r in rows), f"{tag} MoE: K3 launches {e['launches']}")
    return e


def _report_mesh_hybrid(tag, res, single):
    rows = [r["hybrid"] for r in res]
    n_tok = HYB_MICRO * HYB_MB * TP_SEQ
    e = {"f32": {}, "alone": _alone_line(rows)}
    for s in ("1f1b", "gpipe"):
        worst = max((r["f32"][s]["grads"] for r in rows), key=lambda v: v[0])
        loss = max(r["f32"][s].get("loss", 0.0) for r in rows)
        e["f32"][s] = {"grads": worst, "loss": loss}
        ms = max(r[s]["ms"] for r in rows)
        e[s] = {"ms": ms, "tokens_s": HYB_DP * n_tok / ms * 1e3,
                "one_process_tokens_s": single["hybrid"][s],
                "peak_gb": max(r[s]["peak_gb"] for r in rows),
                "launches": [r[s]["launches"] for r in rows],
                "collectives": _collectives_line([r[s] for r in rows])}
        check(max(worst[0], loss) <= SLICE_TOL,
              f"{tag} hybrid {s} disagrees with one process: {worst}, {loss}")
        check(all(la["flash_forward"] > 0 for la in e[s]["launches"]),
              f"{tag} hybrid {s}: a process launched no K3")
    dp = {"k1_peer_launches": [r["dp_step"]["k1_peer_launches"]
                               for r in rows],
          "bit_equal": all(r["dp_step"]["bit_equal"] for r in rows)}
    e["dp_step"] = dp
    print(f"{tag} hybrid dp {HYB_DP} x pp {HYB_PP} x tp {HYB_TP} (processes "
          f"hold dp/stage {[(r['dp'], r['stages']) for r in rows]}): f32 "
          + ", ".join(f"{s} gradients {e['f32'][s]['grads'][0]:.3e}, loss "
                      f"{e['f32'][s]['loss']:.3e}" for s in ("1f1b", "gpipe"))
          + f" of the one-process 1F1B's (tol {SLICE_TOL:.1e}); bf16 "
          + ", ".join(f"{s} {e[s]['tokens_s']:.1f} tokens/s over both dp "
                      f"ranks (one process {e[s]['one_process_tokens_s']:.1f}"
                      f" a dp rank), peak {e[s]['peak_gb']:.2f} GB, K3 "
                      f"{[la['flash_forward'] for la in e[s]['launches']]}"
                      for s in ("1f1b", "gpipe"))
          + f"; the dp step on K1's peer form ({dp['k1_peer_launches']} "
          f"launches) bit-equal to the plain fold: {dp['bit_equal']}; "
          f"{e['alone']['what']} alone {e['alone']['ms']:.3f} ms, bound "
          f"{e['alone']['bound_ms']:.4f} ms")
    check(dp["bit_equal"] and all(v > 0 for v in dp["k1_peer_launches"]),
          f"{tag} hybrid dp step: {dp}")
    return e


def main():
    # cuBLAS's deterministic workspace for the deterministic BERT phases,
    # set before any handle exists (the processes of phase 1b inherit it)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if len(sys.argv) > 1 and sys.argv[1] == "--mp-worker":
        return mp_worker(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-worker":
        return mesh_worker(sys.argv[2:])
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
    # phase 1c's processes' parameters wait here for phase 18's run
    bert_dir = tempfile.TemporaryDirectory()
    bert_procs = phase_bert_processes(bert_dir.name)
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
    # phase 24 here, beside phase 7: later in the script torch.profiler's
    # traces of these calls came back empty (an H100 run, after phase 22)
    k3_shapes = phase_k3_shapes(device)
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

    bert = phase_bert(device, bert_dir.name, bert_procs)
    bert_dir.cleanup()
    bert_ft = phase_bert_finetune()
    gates = phase_gates()
    ckpt = phase_checkpoint()
    vit = phase_vit(device)

    # every shape these paths hand K3 is held against the twins after them
    k3_paths = {}
    for tag, phase in (("seq", phase_sequence), ("tp", phase_tensor),
                       ("hybrid", phase_hybrid), ("moe", phase_moe),
                       ("longcontext", lambda _: phase_longcontext())):
        seen = set()
        with k3_calls(seen):
            k3_paths[tag] = phase(device)
        k3_paths[tag + "_k3_calls"] = check_k3_calls(seen, device, tag)
    seq, tensor, hybrid, moe, longctx = (
        k3_paths[t] for t in ("seq", "tp", "hybrid", "moe", "longcontext"))
    seen = set()
    with k3_calls(seen):
        mesh = phase_mesh_processes(device, {
            "tp": tensor["tokens_s"], "moe": moe["top1"]["tokens_s"],
            "seq": {k: v["remat=False"]["tokens_s"] for k, v in seq.items()},
            "hybrid": {s: hybrid[s]["tokens_s"] for s in ("1f1b", "gpipe")}},
            mp_lengths)
    k3_paths["mesh_k3_calls"] = check_k3_calls(seen, device, "mesh")
    procs[N_RANKS] = {"k1": mesh[N_RANKS]["k1"],
                      "seconds": mesh[N_RANKS]["seconds"]}

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
            **{tag: v["launches"] for tag, v in tracking.items()},
            "bert": bert["launches"],
            "bert_finetune": bert_ft["one_level"]["launches"],
            **{f"gate_{k}": v["launches"] for k, v in gates.items()},
            "elastic_resume": ckpt["elastic"]["launches"],
            "vit": vit["launches"],
            "tp": tensor["launches"]["gossip_mix"],
            "hybrid_dp_step": hybrid["dp_step_launches"]["gossip_mix"],
            **{f"moe_{r}": moe[r]["launches"]["gossip_mix"]
               for r in ("top1", "top2")}},
        "plain_fold_bit_equal_on_slice_paths": {
            "tp": tensor["k1_parity"]["bit_equal"],
            "hybrid_dp_step": hybrid["k1_parity"]["bit_equal"],
            **{f"moe_{r}": moe[r]["k1_parity"]["bit_equal"]
               for r in ("top1", "top2")}},
        "non_circulant": routing,
        "bert_machine_rows": bert["k1"],
        "gossip_of_meshes": {
            "launches_a_step": mesh["one_process"]["path1"]["k1_launches"],
            "bit_equal_to_phase_26": all(
                mesh["one_process"]["path1"]["bit_equal"]),
            "plain_fold_bit_equal": mesh["one_process"]["path1"][
                "k1_parity"]["bit_equal"]},
    }, {
        "name": "window_deliver",
        "route": "cuda",
        "source": "bluefog_tpu_torch/csrc/window_deliver.cu",
        "replaces": "bluefog_tpu/ops/pallas_gossip.py:460",
        "launches": k2_launches,
        **k2,
        "partitioned_window_put": mesh["one_process"]["path1"]["winput"],
    }, {
        "name": "gossip_mix_peer",
        "route": "cuda",
        "source": "bluefog_tpu_torch/csrc/gossip_mix.cu",
        "replaces": "bluefog_tpu/ops/pallas_gossip.py:388",
        "launches": procs[4]["main"]["launches"],
        "max_abs_err": max([v["k1"]["max_abs_err"] for v in procs.values()]
                           + [sl["gpt_k1"]["max_abs_err"],
                              bert_procs["k1"]["max_abs_err"]]),
        **{k: procs[4]["k1"][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "rows_a_rank")},
        "library_ms": k1["library_ms"],
        "processes": 4,
        "by_processes": {str(p): v["k1"] for p, v in procs.items()},
        "launches_on_slice_paths": {
            k: sl[k]["launches"] for k in ("gt", "ed", "gpt", "aperiodic")},
        "launches_on_bert": bert_procs["launches"],
        "bert_machine_rows": bert_procs["k1"],
        "gpt_payload": sl["gpt_k1"],
        "launches_on_mesh_paths": {
            "path1_P2": mesh[2]["path1"]["k1_peer_launches"],
            "path1_P8": mesh[8]["path1"]["k1_peer_launches"],
            "moe_P4": mesh[4]["moe"]["k1_peer_launches"],
            "hybrid_dp_step_P4": mesh[4]["hybrid"]["dp_step"][
                "k1_peer_launches"]},
        "plain_fold_bit_equal_on_mesh_paths": {
            "path1_P2": mesh[2]["path1"]["k1_parity"],
            "path1_P8": mesh[8]["path1"]["k1_parity"],
            "moe_P4": mesh[4]["moe"]["k1_parity"],
            "hybrid_dp_step_P4": mesh[4]["hybrid"]["dp_step"]["bit_equal"]},
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
        "partitioned_window_put_P2": mesh[2]["path1"]["winput"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"bluefog_tpu_torch/csrc/{src}",
        "replaces": f"{fa}:{line} {via}",
        "launches": k3_launches[name],
        **k3[part],
        "launches_over_processes": sl["gpt"]["k3"][i],
        "launches_on_slice_paths": {
            "tp": tensor["launches"][name],
            **{f"ulysses_remat={r}": seq["ulysses"][f"remat={r}"][
                "k3_launches"][name] for r in (False, True)},
            **{f"hybrid_{s}": hybrid[s]["launches"][name]
               for s in ("1f1b", "gpipe")},
            **{f"moe_{r}": moe[r]["launches"][name]
               for r in ("top1", "top2")}},
        "new_shapes": {shape: v[part] for shape, v in k3_shapes.items()},
        "twin_checked": {key: max(rels[o] for o in outs)
                         for key, rels in K3_TWIN_CHECKED.items()},
        "twin_checked_on_paths": {
            tag: k3_paths[tag + "_k3_calls"]
            for tag in ("seq", "tp", "hybrid", "moe", "longcontext",
                        "mesh")},
        "twin_checked_over_processes": mesh["k3_calls"],
        "launches_a_process_on_mesh_paths": {
            "path1_P2": mesh[2]["path1"]["launches"][name],
            "path1_P8": mesh[8]["path1"]["launches"][name],
            "ulysses_P2": mesh[2]["seq"]["ulysses"]["launches"][name],
            "moe_P4": mesh[4]["moe"]["launches"][name]},
    } for i, (name, part, src, line, outs) in enumerate((
        ("flash_forward", "fwd", "flash_attention.cu", 589, ("o", "l", "m")),
        ("flash_backward_dkv", "dkv", "flash_attention_bwd.cu", 941,
         ("dk", "dv")),
        ("flash_backward_dq", "dq", "flash_attention_bwd.cu", 1287,
         ("dq", "di"))))]
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
    print(f"this slice's paths: BERT-large hierarchical {bert['seq_s']:.1f} "
          f"seq/s, {bert['tokens_s']:.1f} tokens/s, {bert['step_ms']:.2f} ms "
          f"a step, peak {bert['peak_gb']:.2f} GB, idle {bert['idle']:.1%}, "
          f"K1 {bert['launches_a_step']} launches a step on machine rows "
          f"({bert['k1']['ms']:.4f} ms against {bert['k1']['bound_ms']:.4f} "
          f"ms), K1 step vs plain bit-equal {bert['parity']['bit_equal']}; "
          f"over {BERT_PROCESSES} processes {bert_procs['seq_s']:.1f} seq/s, "
          f"bit-equal to one process {bert['processes']['bit_equal']}, K1 peer "
          f"{bert_procs['k1']['ms']:.4f} ms against "
          f"{bert_procs['k1']['bound_ms']:.4f} ms; fine-tune "
          f"final acc {bert_ft['one_level']['final_acc']:.3f}, two-level "
          f"bit-equal {bert_ft['two_vs_one']['bit_equal']}; gates "
          + ", ".join(f"{k} {v['decentralized']['acc']:.4f} vs allreduce "
                      f"{v['allreduce']['acc']:.4f} ({v['wall_s']:.1f} s)"
                      for k, v in gates.items())
          + f"; resume bit-equal {ckpt['resume']['params_bit_equal']}, "
          f"{ckpt['resume']['bytes']:,} bytes a checkpoint, load "
          f"{ckpt['resume']['load_ms']:.1f} ms; elastic gap "
          f"{ckpt['elastic']['gap']:.4f}; ViT-base {vit['img_s']:.1f} img/s, "
          f"K3 launches {vit['k3_launches']}")
    print("sequence, tensor, pipeline and expert parallelism: "
          + "; ".join(
              f"{kind} over {v['ranks']} ranks {v['remat=False']['tokens_s']:.1f}"
              f" tokens/s ({v['remat=True']['tokens_s']:.1f} with remat), "
              f"peak {v['remat=False']['peak_gb']:.2f} / "
              f"{v['remat=True']['peak_gb']:.2f} GB, f32 logits "
              f"{v['float32']['logits']:.2e} and gradients "
              f"{v['float32']['grads']:.2e} of the whole sequence's, remat "
              f"bit-equal {v['bfloat16']['remat_bit_equal']}"
              for kind, v in seq.items())
          + f"; TP bf {TP_BF} x tp {TP_SIZE} {tensor['tokens_s']:.1f} tokens/s"
          f" (f32 replay {tensor['parity']['logits']:.2e}, gradients "
          f"{tensor['parity']['grads'][0]:.2e}); hybrid 1F1B "
          f"{hybrid['1f1b']['peak_gb']:.2f} GB / GPipe "
          f"{hybrid['gpipe']['peak_gb']:.2f} GB, "
          f"{hybrid['1f1b']['tokens_s']:.1f} / "
          f"{hybrid['gpipe']['tokens_s']:.1f} tokens/s; MoE "
          + ", ".join(f"{r} {moe[r]['tokens_s']:.1f} tokens/s, dropped "
                      f"{moe[r]['dropped']:.4f} (embeddings alone "
                      f"{moe[r]['routing']['embeddings']['dropped']:.4f}), "
                      f"FFN at capacity "
                      f"{moe[r]['routing']['ffn_at_capacity']['rel_err']:.2e}"
                      for r in ("top1", "top2"))
          + f"; K1 vs the plain fold bit-equal: TP "
          f"{tensor['k1_parity']['bit_equal']}, hybrid "
          f"{hybrid['k1_parity']['bit_equal']}, MoE "
          + "/".join(str(moe[r]["k1_parity"]["bit_equal"])
                     for r in ("top1", "top2"))
          + f"; K3 held against its twins at {len(K3_TWIN_CHECKED)} shapes"
          + "; longcontext_lm "
          + ", ".join(f"{k} OK in {v['s']:.1f} s" for k, v in longctx.items()))
    print("gossip of meshes and the axes over processes (phase 30): "
          + "; ".join(
              f"{name} P={p} {v['tokens_s']:.1f} tokens/s (one process "
              f"{v['one_process_tokens_s']:.1f})"
              for p, entry in ((p, mesh[p]) for p in MESH_GROUPS)
              for name, v in (
                  [("path 1", entry["path1"])] if "path1" in entry else [])
              + [(k, v) for k, v in entry.get("seq", {}).items()]
              + ([("MoE", entry["moe"])] if "moe" in entry else []))
          + f"; hybrid 1F1B {mesh[4]['hybrid']['1f1b']['tokens_s']:.1f} "
          f"tokens/s over 4 processes; path 1 at P = 2 bit-equal to one "
          f"process {mesh[2]['path1']['bit_equal_to_one_process']}, at P = 8"
          f" f32 within {max(mesh[8]['path1']['f32']['logits'], mesh[8]['path1']['f32']['grads'][0]):.2e}")
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

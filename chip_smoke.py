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
   1 + 1 steps (cut from 1 + 2 for the time limit) under deterministic
   cuDNN, as the
   reference; then the same
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
   and write); runs the main path for 1 + 1 steps under deterministic cuDNN
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
   Ring(8) over ResNet-50, 1 + 1 steps each under deterministic cuDNN
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
   rank, 1 + 1 steps (96 launches of each K3 kernel a step over the
   processes, 1 K1 peer launch a step a process, parameters within 2^-7 of
   one process's), and K1's peer form on GPT's one staged payload, bit-equal
   to its plain twin on the same rows (folded in column slices) and timed
   against its bytes bound.
   P = 8, one rank a process (PyTorch's one process a GPU layout, m = 1),
   K1's check and times only, runs in phase 30's P = 8 group.  A process
   that fails, or a group that outlives its time limit, fails the phase.
   The P = 2 and 4 groups and phase 1c's start together (for the script's
   time limit: on an H100 host whose phase 3 ran at 520 img/s the script
   took 1,266 s before this): every process starts beside this process's references
   (its interpreter, imports and gloo group), then waits for its group's
   release before it touches the card; a group is released after the one
   before it has finished, and its seconds count from its release.  The
   references' host times are taken beside the groups' start-up.
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
   each) and ``choco_sgd`` at its defaults, each to its OK, with its
   seconds (``convergence_comparison`` runs in phase 20).
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
   24-29 and then phase 30 came) and ``--n-per-rank 32`` (its 128, cut
   when phase 31 came), under deterministic algorithms,
   then with ``--two-level-mesh``: loss, accuracy and seq/s per epoch, the
   parameter spread, K1's launches, and the two forms' parameters, which
   must be bit-equal.
20. The gates: ``examples.mnist_epoch_gate`` at its defaults and
   ``examples.cifar_resnet_gate --filters 64`` at 2 epochs (its 6, cut
   when phase 31 came), each
   asserting its target and its parity with the allreduce arm; both arms'
   accuracy, img/s and seconds, and K1's launches.  The mnist gate and
   phase 17's ``examples.convergence_comparison`` (at its defaults, to its
   OK, two gossip flavors, one K1 launch a step each) each run in a fresh
   process beside the cifar gate, which runs here (for the script's time
   limit: the three share the host, and so their rates).
21. Checkpoints: ``examples.imagenet_resnet`` (ResNet-50, 8 x 32 at 64x64,
   synthetic data) for 3 epochs with a checkpoint each epoch, and a fresh
   process resuming from a copy of its epoch-2 checkpoint to epoch 3, each
   under deterministic cuDNN: the epoch-3 parameters and momentum
   bit-equal, the saved BatchNorm statistics the rank mean; bytes, save and
   load ms.  Both processes run in a thread beside phase 20 (for the
   script's time limit), whose gates' rates they share the host with.
   Then ``examples.elastic_resume``, 8 ranks to 4, on K1 (210 launches).
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
   K3's launches a step (Ulysses: one a layer, two forwards with remat).
   Phases 25-30 run GPT-small's widths at 2 of its 12 layers
   (``SLICE_LAYERS``), cut for the script's time limit (6 until phase 32
   came).
26. Tensor parallelism, ``TPTransformerLM`` at GPT-small's widths: in f32 on
   one tp 2 group at batch 2 x 1024, the gathered parameters replayed at tp
   = 1 through the dense ``TransformerLM`` give its logits and the
   corrected gradients (through the rule table) its gradients, within
   2^-7; then bf 4 x tp 2 in bf16, batch 8 x 1024 a bf rank, AdamW 3e-4
   (decay 0.01) gossiping over Exponential-2(4): 4 launches of each K3
   kernel a layer a step (48 at 12 layers) and K1's per the fuse plan,
   tokens/s; then the AdamW step
   through K1 against the same step through the plain fold from the same
   state, bit for bit.
27. Hybrid dp 2 x pp 2 x tp 2: GPT-small's TPBlocks (6 of its 12, as in
   phases 25-30), half a stage, bf16,
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
   reckoned first, the dropped fraction, tokens/s, 2 launches of each K3
   kernel a layer a step and K1's per the fuse plan; the AdamW step through K1
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
   against its twins at every shape the processes handed it.  The three
   groups start together (cut for the script's time limit when phase 33
   came): every process starts beside this process's references (its
   interpreter, imports and gloo group), then waits for its group's
   release before it touches the card; a group is released after the one
   before it has finished.  The references' host times and the P = 2
   group's rates are taken beside the other groups' start-up.
31. The asynchronous host runtime on one host, no TPU kernel on its path
   (K1-K3's counters are read around it and reported): the port's host
   library built from ``bluefog_tpu_torch/csrc/*.cc``; 31a ``TreePacker``
   round trips, bit-exact, of ResNet-50's parameters (f32) and a 2-layer
   GPT-small (bf16) from CUDA tensors to the f64 window vector, the fused
   and the per-leaf paths, pack and unpack ms against a pinned D2H and H2D
   of the same f32 bytes; 31b ``examples.async_pushsum`` and 31c
   ``examples.async_dsgd`` (LeNet-5 on the card, 8 rank threads) at their
   defaults, with their checks; 31d ResNet-50 (batch 32 a rank, 224x224,
   bf16) trained through ``DistributedWinPutOptimizer(async_=True)`` by 8
   rank threads on Exponential-2, each on its own CUDA stream, 10 s with
   ``overlap=False`` and with ``True`` at least 10 s, and long enough for
   two steps of its slowest rank at 2.5x the serial run's pace (a slower
   host left a rank one step in 10 s): steps a rank, img/s against
   phase 3's, the mass audit (exact), the consensus gap, a rank step's host
   ms (consume, unpack, ``loss_and_grad``, pack, deposit, and the
   harvester's hidden seconds), peak device GB and host RSS; 31e
   ``examples.async_dsgd_mp --ranks 2`` over shared memory, its workers on
   the card, beside 31f (for the script's time limit); 31f
   ``run_sharded_gossip`` on GPT-small's widths at 2 layers,
   4 ranks on Ring(4), ``{tp: 2}`` of ``tp_param_rules``, parameters drawn
   on the card, 2 rounds (3 until phase 32 came, cut for the script's
   time limit) with rank 2 healed out before the last: bit-equal to the
   ``axes={}`` run, each coordinate's mass audit exact.
32. The host runtime across hosts, no TPU kernel on its path (K1-K3's
   counters are read around it and reported).  32a, the wire on loopback:
   a ``WindowServer`` in a child process holds ResNet-50's f64 window
   vector (25,557,032 elements, 204 MB a slot, 2 slots, in shared memory)
   and the same vector cut into 8 windows; this process packs ResNet-50's
   parameters from the card (``TreePacker``) and deposits them, a put,
   through ``RemoteWindow`` (sync), ``PipelinedRemoteWindow``,
   ``StripedDepositStream`` at 2 and 4 stripes (the 8 windows) and the
   same-host shm route, each with codec none, f32 and top-k 0.1 (the sync
   wire has no codec; the shm route carries the dense values whatever the
   codec): ms a deposit and GB/s against a pinned D2H of the same bytes;
   read back over the wire bit-exact (none, and the shm route), equal to
   the f32 cast (f32), equal to ``wire_codec.decode(encode(...))`` (top-k),
   and ``shm_deposits()`` counting every deposit of the shm route and none
   of the others.  32b: ``examples.async_dsgd_mp --transport tcp --ranks
   2``, the same with ``--resilient`` (workers on the card), and
   ``examples.elastic_membership``, each with its own checks, the three
   at once.  32c:
   ResNet-50 on Exponential-2 at P = 2 processes time-slicing the card,
   batch 32 a rank, 224x224, bf16 compute, through ``run_async_dsgd_rank``
   with ``TreePacker`` on the card: ``TCP_SECONDS`` over shm, then over
   tcp, in the same worker processes (``--tcp-worker``): img/s of each and
   their ratio, rank 0's step host ms split as in 31d, bytes on the wire a
   step, the mass audits exact; then phase 35's traced run.  32d, on the
   card, drills at once (its
   death drill runs in 33b, under a chaos spec):
   ``win_mutex`` across 2 processes under ``bfrun`` (``_MUTEX_DRILL``: a
   child of rank 0 holds the lock and is SIGKILLed; rank 1 gets it only
   after the 2 s lease), and ``bfrun --supervise 2`` restarting a script
   on the card (``_SUPERVISED``) that kills itself at step 3 and resumes
   from its checkpoint to exit 0; then ``--ranks 4 --elastic`` alone
   (rank 3 joins from ``initial_members`` 0-2, rank 1 drains, the audit
   exact).
33. The communication control plane and chaos, no TPU kernel on the path
   (K1-K3's counters are read around it).  33a, the control plane at full
   width: configs[1]'s ResNet-50 at batch 32 a rank, 224x224, bf16
   compute, ``TreePacker`` on the card, plain SGD at ``ASYNC_LR`` on the
   de-biased iterate, as 32c; ``CTL_N`` = 4 processes time-slicing the
   card (``--ctl-worker``, started beside 32d and released together) on
   Exponential-2(4) over tcp with ``resilience=`` and
   ``stream_options=dict(max_in_flight=2, max_queue_items=8)``; rank 3's
   server behind the JAX package's control bench's lossy, slow link
   (``CTL_SPEC``: 120 ms on 95% of its frames, 1% of them cut).  Two runs
   in the same processes, each to ``CTL_STEPS`` = 10 steps a rank:
   ``control=None``, then ``control=ControlConfig(evidence_every=2,
   cooldown_rounds=4, min_lag_s=0.02)``.  The delay is the bench's: a
   larger one delays the streams' heartbeats past their silence limits.
   10 steps (cut from 30 for the script's time limit) give a static run
   of about 8 s at the 0.81 s a step a probe measured (30 steps in
   24.25 s) and five evidence windows under control.  Printed for each
   run: the wall time to the target and img/s, the streams' reconnects,
   replayed, retired and deduped batches over every rank, each sender's
   ack EWMA toward rank 3 and toward the others, the audit; under
   control the final plan (slow set, densify, gossip_every, codec level),
   the plan changes and the rounds of the first and the last, each
   rank's last plan, and the plan every process decides from the run's
   final evidence records.  Checked: both audits exact to 1e-9 n, no
   death, every rank at its target, every process's plan from the final
   records byte-identical (sha1), and ``3 in plan.slow or plan_changes
   >= 1``; the control / static time ratio is reported, not gated.
   33b, three drills (for the script's time limit the first two run
   beside 32d; the third runs alone right after phase 31, before 33a's
   workers start; all reported here)
   through ``python -m bluefog_tpu_torch.chaos
   --spec ...``: 32d's death (``async_dsgd_mp --ranks 3 --transport tcp
   --resilient --duration 8`` under ``rank2:sigkill:at_step=12``), a lossy
   link
   (``--ranks 2`` under ``ack:drop:after_frames=3;client:truncate:
   after_frames=5;server:drop:rate=0.05:seed=3``: at least one reconnect,
   at least one replayed, retired or deduped batch, the audit exact) and
   ``examples.async_dsgd``'s 8 rank threads on the card for 8 s (each
   rank's first step warmed in a thread before the budget) under
   ``rank2:die:at_step=8;rank1:stall:at_step=6:s=1.5`` (total plus died
   mass equal to n).  33c, inside 32a beside its server: a
   ``StripedDepositStream`` over the 8 windows resized by ``apply_plan``
   1 -> 4 -> 1 stripes, ms a deposit at each and the read-back bit-exact;
   four accumulating deposits with resizes between them and one flush at
   the end, every window bit-exact with four deposits (none stranded);
   the ``TransportPlan`` ``decide_transport_plan`` gives on the live ack
   EWMA.
34. Serve while training, no TPU kernel on the path (the JAX package's
   serving tier is host code; K1-K3's counters are read around it).  34a,
   the replica on the card: 32c's ResNet-50 (configs[1], batch 32 a
   rank, 224x224, bf16 compute) trained by ``run_async_dsgd_rank`` over
   tcp at ``SERVE_N`` = 2 processes on Exponential-2(2) (``--serve-
   worker``, started before 34b, which runs beside their start-up, and
   released by a go file),
   plain SGD at ``ASYNC_LR``, ``snapshot_every=1``,
   ``stop_after_steps=SERVE_STEPS`` = 12.  This process runs a
   ``ServingReplica`` on rank 0's group (template: ResNet-50's
   parameters on the card), an auditing ``Subscriber`` holding each
   frame's in-band ``round`` leaf to its round, a ``RelayNode`` (tier 1,
   the default ``DeltaConfig``) and a second replica behind it with
   ``delta=True``; it answers a request (a bf16 forward of a seeded
   batch of 32 images, timed to a synchronize) whenever the replica's
   round changes, after ``params()`` (the narrow cast and the copy to
   the card), and samples the staleness against a ``SnapshotClient``
   read of the live round, for both replicas.  Checked: the stamp audit
   with no mismatch over at least 3 frames, at least 3 staleness samples
   of each replica, strictly increasing rounds at both replicas and the
   relay, delta frames behind the relay, the delta replica reaching the
   relay's last round within ``SERVE_DRAIN_S`` after the trainers
   return, the mass audit exact,
   every served leaf on the card, a last round's served parameters
   bit-equal to ``TreePacker.unpack`` of ``x / p`` from a pinned
   ``SnapshotClient`` read of it, and the last request's logits
   bit-equal to the model's own forward with those parameters copied in
   (deterministic cuDNN).  Printed: the step rate against 32c's tcp rate,
   publish ms a step, a full push's ms and the pinned reads' ms of the
   204.5 MB vector, ``params()`` and request ms, the staleness of both
   replicas, the relay's full and delta pushes (bytes, each push's
   encode and send ms, by wrapping its senders), and the encode's parts
   at the vector's length (``time_delta_encode``: a trainer's dense
   step, and the top-k selection on it and on a delta-decoded round).
   34b, the sharded replica:
   GPT-small's widths at ``SHARD_LAYERS`` layers, seeded on the card,
   sharded by ``tp_param_rules`` over ``{tp: 2}``, one group a
   coordinate packed by a spec-aware ``TreePacker``, published at round
   5, then one coordinate alone at 6, then the other; the
   ``ShardedServingReplica`` serves 5 while 6 is incomplete, then 6,
   each reassembled on the card bit-equal to its round's whole tree.
35. (Run inside 32c's workers, analyzed right after phase 32.) Causal
   tracing and the sampling profiler, no TPU kernel on the path: 32c's
   workers make a third run, ``TCP_SECONDS`` over tcp, with
   ``tracing.configure(dir, rank=r)`` and ``profile=dir``; K1-K3's
   counters read 0 in each worker around it and in this process around
   the analysis.  This process reads the files with the port's analyzer
   and profile report.  Checked: both ranks' spans load, with their
   round spans; each round has a critical path and there is a gating
   edge; every owner-side span (recv, queue_wait, apply, ack) parents to
   a wire span of the other process; each rank's stream to the other has
   a ``{net, queue, apply}`` EWMA (``stream_stats["phase_s"]``); the mass
   audit is exact; the profile holds both ranks, compute and gossip
   samples, and its top 6 frames each carry a phase label.  Printed: each
   edge's split of a 204.5 MB deposit (wire, recv, queue_wait, apply,
   ack, net, and the stream's EWMA), the critical path's edges and
   gating seconds, the overlap fraction, the profile's top 6 frames, and
   the traced run's img/s against 32c's untraced tcp run (not checked).
36. Metrics and the flight recorder (no new kernel; K1 and K2 run with
   their counters armed).  36a, right after phase 3 on its trainer
   (ResNet-50 x 8 ranks, K1): after one untimed step, blocks of
   ``OBS_STEPS`` steps, each from one snapshot of the trainer's state,
   under deterministic algorithms, the arms in turns (``OBS_ORDER``: off,
   metrics, jit, jit, metrics, off): metrics off; ``metrics_start()`` (a
   JSONL file, one ``metrics.step`` line a step); metrics and
   ``BLUEFOG_TPU_BLACKBOX=jit``.
   Checked: every block's state bit-equal to the first's; K1 launches
   the same count a step in each block; ``bf_comm_bytes_total`` equals steps x slots x the
   fused buffers' bytes, and the rounds, messages and chunk counters
   their closed forms (one round a rank a step, as the JAX package's
   callback counts once per device); ``collective_census`` of one step
   equals K1's launch delta; the JSONL reads back through ``python -m
   bluefog_tpu_torch.metrics.dash``; a ``blackbox.dump`` after a
   synchronize holds one begin/end pair per gossip call and no open
   round, and the merge finds no hang.  Printed: each arm's host step ms,
   and the host microseconds of one step's hooks alone in each arm.
   36b, in 32c's workers after phase 35's run: one ``OBS_SECONDS`` run
   over tcp with metrics on and the recorder in its default host mode
   (32c's three runs have it off, ``BLUEFOG_TPU_BLACKBOX=0``).  Checked:
   each rank's sent deposits (the stream's items) equal its rounds, their
   dense bytes the items x the vector's bytes, and the other rank's
   server counted the same deposits and bytes; each worker dumped, and
   ``python -m bluefog_tpu_torch.blackbox`` on the incident diagnoses no
   hang.  Printed: the run's img/s, and the recorder's host cost a
   deposit (its events a deposit x a record's measured microseconds).
23. Report: a ``kernels:`` line, a line for K1 on this slice's paths and a
   line for the allreduce (not a TPU kernel), the kernels' JSON line (K1,
   K2 and K3's three kernels; K1's entry also carries its one-slot times,
   its launches on the new paths and its times on the grid and the star),
   a ``[phases] seconds:`` line (each phase's seconds and the total),
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
import threading
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
# the script's start, for the seconds of each phase (``lap``) and the total
T0 = time.perf_counter()
PHASE_S = {}
_LAST_LAP = [T0]


def lap(tag):
    """Charge the seconds since the last lap to phase ``tag``."""
    now = time.perf_counter()
    PHASE_S[tag] = PHASE_S.get(tag, 0.0) + now - _LAST_LAP[0]
    _LAST_LAP[0] = now


def phase_seconds_line():
    return ("[phases] seconds: "
            + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_S.items())
            + f"; total {time.perf_counter() - T0:.1f} s")


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


def _plan_leaves():
    """The main path's rank-stacked parameter leaves as meta tensors, in
    the trainer's order (``synthetic_benchmark.build`` stacks the model's
    ``named_parameters``): what the fuse plan reads, from a ResNet-50 made
    on the host, with no trainer built on the card."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import MODELS

    spec = MODELS["resnet50"]
    net = spec.make(torch.bfloat16, torch.Generator().manual_seed(0), 1000,
                    64, **({"image_size": 224} if spec.sized else {}))
    return [torch.empty((N_RANKS, *p.shape), dtype=p.dtype, device="meta")
            for p in net.parameters()]


def phase_build():
    """nvcc builds the kernels; beside it, g++ builds phase 31's native
    host runtime (``runtime/native.py``), which phase 31 then only loads."""
    from bluefog_tpu_torch.ops import _build
    from bluefog_tpu_torch.runtime import native

    t0 = time.perf_counter()
    host = {}

    def build_host():
        try:
            host["path"] = native.build()
        except BaseException as e:  # noqa: BLE001 (raised below)
            host["error"] = e
        host["s"] = time.perf_counter() - t0

    beside = threading.Thread(target=build_host, name="host-runtime-build")
    beside.start()
    try:
        _build.load()
    finally:
        beside.join()
    secs = time.perf_counter() - t0
    if "error" in host:
        raise host["error"]
    print(f"[build] {', '.join(p.name for p in _build._sources())} -> "
          f"sm_90a in {secs:.2f} s; beside it the native host runtime "
          f"{host['path'].name} in {host['s']:.2f} s")
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


OBS_STEPS = 2         # phase 36a: steps a block, two blocks an arm
OBS_ORDER = ("off", "metrics", "jit", "jit", "metrics", "off")
OBS_SECONDS = 2.0     # phase 36b: the observed run over tcp


def _cli_json(module, *args):
    """``python -m module args... --json`` in a fresh interpreter; its
    parsed output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run([sys.executable, "-m", module, *args, "--json"],
                          capture_output=True, text=True, timeout=120,
                          env=env)
    check(proc.returncode == 0,
          f"{module} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout)


@contextlib.contextmanager
def _metrics_held_off():
    """Metrics off inside (the hooks see no registry), the live registry
    back after, its counts kept: 36a's off blocks sit between its on
    blocks."""
    from bluefog_tpu_torch.metrics import registry as mreg

    held = mreg._REGISTRY, mreg._STOPPED
    mreg._REGISTRY, mreg._STOPPED = None, True
    try:
        yield
    finally:
        mreg._REGISTRY, mreg._STOPPED = held


def _hook_us(trainer, n_bufs, reps=2000):
    """Host microseconds of one main-path step's hooks alone, with metrics
    off, on, and on with the per-call recorder: the gossip call's begin,
    round record and end, and the optimizer's step record, on a tree of
    the step's ``n_bufs`` fused buffers.  The hooks read shapes only, so
    small buffers on the trainer's device cost what the step's do."""
    from bluefog_tpu_torch import blackbox, metrics
    from bluefog_tpu_torch.ops import collectives as C

    opt = trainer.opt
    sched = opt.schedule
    x = {"fused": {str(i): torch.empty(N_RANKS, 4, device=trainer.device)
                   for i in range(n_bufs)}}

    def step_hooks():
        token = C._round_begin("neighbor_allreduce", x,
                               stage="bf.neighbor_allreduce",
                               schedule=sched.name)
        C._record_round(x, op="neighbor_allreduce", slots=sched.num_slots,
                        route="kernel", schedule=sched.name, chunked=True)
        C._round_end(x, token)
        opt._record_step(True)

    prev_mode = os.environ.pop("BLUEFOG_TPU_BLACKBOX", None)
    out = {}
    try:
        for arm in ("off", "metrics", "jit"):
            if arm == "metrics":
                metrics.metrics_start()
            if arm == "jit":
                os.environ["BLUEFOG_TPU_BLACKBOX"] = "jit"
                blackbox.reset()
                blackbox.configure(rank=0)
            step_hooks()
            t0 = time.perf_counter()
            for _ in range(reps):
                step_hooks()
            out[arm] = (time.perf_counter() - t0) / reps * 1e6
    finally:
        metrics.metrics_stop()
        os.environ.pop("BLUEFOG_TPU_BLACKBOX", None)
        if prev_mode is not None:
            os.environ["BLUEFOG_TPU_BLACKBOX"] = prev_mode
        blackbox.reset()
    print(f"[36a] one step's hooks alone ({reps} reps, {n_bufs} fused "
          "buffers): " + ", ".join(f"{k} {v:.1f} us" for k, v in out.items()))
    return out


def phase_observed_main(trainer, main_lengths):
    """36a: the main path's steps with metrics off, on, and on with the
    flight recorder's per-call events, each block of ``OBS_STEPS`` from one
    snapshot, the arms interleaved (``OBS_ORDER``); see the module
    docstring.  Returns each arm's host step ms and the counters."""
    from bluefog_tpu_torch import blackbox, metrics
    from bluefog_tpu_torch.blackbox import merge
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix
    from bluefog_tpu_torch.utils.inspect import collective_census

    opt = trainer.opt
    sched = opt.schedule
    state, snap = _snapshot(trainer)
    counters = _counters(opt)
    n_bufs = len(main_lengths)
    fused_bytes = sum(p.numel() * p.element_size()
                      for p in trainer.params.values())
    out = tempfile.TemporaryDirectory()
    jsonl = os.path.join(out.name, "metrics.jsonl")
    prev_mode = os.environ.get("BLUEFOG_TPU_BLACKBOX")
    arms = {arm: {"ms": [], "launches": 0} for arm in OBS_ORDER}
    ref, steps_recorded = None, 0
    try:
        with deterministic():
            # one untimed step first: the first steps under deterministic
            # algorithms pick their kernels; and the arms take turns (run
            # in one order on an H100's host, each later arm read 6-15%
            # faster than the one before it)
            trainer.step()
            reg = metrics.metrics_start(jsonl)
            blackbox.reset()
            blackbox.configure(rank=0)
            for arm in OBS_ORDER:
                for k, v in state.items():
                    v.copy_(snap[k])
                _restore(opt, counters)
                if arm == "jit":
                    os.environ["BLUEFOG_TPU_BLACKBOX"] = "jit"
                else:
                    os.environ.pop("BLUEFOG_TPU_BLACKBOX", None)
                gossip_mix.launches = 0
                with (_metrics_held_off() if arm == "off"
                      else contextlib.nullcontext()):
                    for _ in range(OBS_STEPS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        trainer.step()
                        torch.cuda.synchronize()
                        arms[arm]["ms"].append(
                            (time.perf_counter() - t0) * 1e3)
                        if arm != "off":
                            metrics.step(steps_recorded)
                            steps_recorded += 1
                arms[arm]["launches"] += gossip_mix.launches
                if ref is None:
                    ref = {k: v.clone() for k, v in state.items()}
                else:
                    same = [k for k, v in state.items()
                            if not torch.equal(v, ref[k])]
                    check(not same, f"36a: a {arm} block's state differs "
                          f"from the first off block's in {same[:4]}")
                check(gossip_mix.launches == n_bufs * OBS_STEPS,
                      f"36a {arm}: K1 launched {gossip_mix.launches} times "
                      f"in {OBS_STEPS} steps, expected {n_bufs} a step")
            os.environ["BLUEFOG_TPU_BLACKBOX"] = "jit"
            pending = blackbox.get().settle()
            torch.cuda.synchronize()
            dump = blackbox.dump("phase36a", directory=out.name)
            # the census, on the metrics-and-recorder state, of one more
            # step; the arms were compared above
            before = gossip_mix.launches
            census = collective_census(trainer.step)
            delta = gossip_mix.launches - before
            snapm = reg.snapshot()
            metrics.metrics_stop()
    finally:
        if prev_mode is None:
            os.environ.pop("BLUEFOG_TPU_BLACKBOX", None)
        else:
            os.environ["BLUEFOG_TPU_BLACKBOX"] = prev_mode
        blackbox.reset()
        for k, v in state.items():
            v.copy_(snap[k])
        _restore(opt, counters)
    # the counters over the on blocks and the census step
    on_steps = OBS_STEPS * sum(arm != "off" for arm in OBS_ORDER)
    jit_calls = OBS_STEPS * OBS_ORDER.count("jit")
    steps = on_steps + 1
    lbl = (f'{{backend="pallas",op="neighbor_allreduce",'
           f'schedule="{sched.name}"}}')
    want = {
        "bf_comm_rounds_total": steps * N_RANKS,
        "bf_comm_bytes_total": steps * sched.num_slots * fused_bytes,
        "bf_comm_messages_total": steps * N_RANKS * n_bufs * sched.num_slots,
        "bf_comm_pallas_chunks_total": steps * N_RANKS * n_bufs,
    }
    for name, v in want.items():
        got = snapm.get(name + lbl)
        print(f"[36a] {name}{lbl} {got} = {v} (closed form)")
        check(got == v, f"36a: {name} {got}, closed form {v}")
    check(census["calls"] == {"neighbor_allreduce": 1}
          and census["kernels"]["gossip_mix"]["launches"] == delta == n_bufs,
          f"36a: census {census} against K1's launch delta {delta}")
    rows = {r["series"]: r for r in _cli_json(
        "bluefog_tpu_torch.metrics.dash", jsonl)}
    brow = rows["bf_comm_bytes_total" + lbl]
    check(brow["total"] == want["bf_comm_bytes_total"]
          and brow["points"] == on_steps,
          f"36a: the dash read {brow} from the JSONL")
    lines = [json.loads(l) for l in open(dump) if l.strip()]
    evs = [l["event"] for l in lines if "event" in l]
    begins = [e for e in evs if e["kind"] == "collective_begin"]
    ends = [e for e in evs if e["kind"] == "collective_end"]
    (spans,) = [l["open_spans"] for l in lines if "open_spans" in l]
    check(len(begins) == len(ends) == jit_calls
          and all(e["op"] == "neighbor_allreduce" for e in begins)
          and not spans,
          f"36a: the dump holds {len(begins)} begins, {len(ends)} ends, "
          f"{len(spans)} open spans for {jit_calls} gossip calls")
    report = merge.diagnose(merge.load_incident(out.name))
    check(not report["stuck_rounds"] and not report["suspect_ranks"],
          f"36a: the merge found a hang: {report}")
    out.cleanup()
    hooks_us = _hook_us(trainer, n_bufs)
    mean = {k: sum(v["ms"]) / len(v["ms"]) for k, v in arms.items()}
    print(f"[36a] ResNet-50 x {N_RANKS} ranks, blocks of {OBS_STEPS} steps "
          f"in the order {OBS_ORDER}, bit-equal states, K1 {n_bufs} launches"
          f" a step in each block; host step ms: " + "; ".join(
              f"{k} {[round(t, 2) for t in v['ms']]} (mean {mean[k]:.2f})"
              for k, v in arms.items())
          + f"; metrics / off {mean['metrics'] / mean['off']:.4f}, jit / off"
          f" {mean['jit'] / mean['off']:.4f}; {pending} end(s) pending at "
          f"the dump's settle before the synchronize; census {census}")
    return {"ms": {k: v["ms"] for k, v in arms.items()},
            "mean_ms": mean, "hooks_us": hooks_us,
            "launches": {k: v["launches"] for k, v in arms.items()},
            "census": census, "counters": {k + lbl: snapm[k + lbl]
                                           for k in want}}


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
    K1 launch a step on each) and ``examples.choco_sgd``, each to its own
    OK, with its seconds."""
    from bluefog_tpu_torch.examples import average_consensus, choco_sgd
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
    return out


# ---------------------------------------------------------------------------
# Phase 1b: the ranks spread over processes that share the card
# ---------------------------------------------------------------------------

# P = 8, one rank a process, K1's check only, runs in phase 30's P = 8 group
# (one group start fewer)
MP_PROCESSES = (2, 4)
# steps of phase 1b's runs over processes and of their one-process
# references (2 + 3 until PR 12; cut to make room for phase 30)
MP_WARMUP, MP_TIMED = 1, 1   # 1 + 2 cut to 1 + 1 for the time limit
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
    """The ResNet-50 main path over this process's ranks, 1 + 1 steps under
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
           "losses": [loss.tolist() for loss in res["losses"]],
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
    """The one-process runs the P = 2 group is held against: 1 + 1 steps
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
    this process's ranks, 1 + 1 steps (deterministic cuDNN for ResNet-50):
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

    # started beside this script's references (interpreters, imports, the
    # gloo group): touch the card only once released
    _await_go(outdir, MP_TIMEOUT_S)
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


def _await_go(outdir, timeout_s):
    """Wait for the parent's release of this process's group (the ``go``
    file in ``outdir``); a parent that never releases it (it failed) ends
    the wait with an error after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(os.path.join(outdir, "go")):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{outdir}: never released")
        time.sleep(0.05)


def _start_processes(procs, what, lengths, win_len, outdir, env_extra=None):
    """Start ``procs`` processes of this script's phase-1b worker through
    the launcher (with ``env_extra`` added to their environment).  Each
    waits, once initialized, for :func:`_run_processes` to release it, so
    that the group's start-up runs beside other work and only its paths
    run alone."""
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
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    return proc, time.perf_counter()


def _kill_started(started):
    """Stop groups started by :func:`_start_processes` that were never
    collected (a phase failed before their release)."""
    for proc, _ in started:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()


def _run_processes(procs, outdir, started):
    """Release a group started by :func:`_start_processes`, wait for it
    (stopping the whole group at the time limit, counted from its start),
    and return its results in process order and its seconds from the
    release; a failed or late process fails the phase."""
    proc, t_start = started
    t0 = time.perf_counter()
    open(os.path.join(outdir, "go"), "w").close()
    try:
        log, _ = proc.communicate(
            timeout=max(1.0, MP_TIMEOUT_S - (t0 - t_start)))
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


def phase_processes(device, lengths, win_len, bert_outdir):
    """Phase 1b (see the module docstring): the one-process reference run,
    then P = 2 and 4 processes (all checks), each group started by the
    launcher (P = 8's K1 check runs in phase 30's P = 8 group).  Phase
    1c's group starts here too, beside the references; it is returned
    unreleased, for :func:`phase_bert_processes`."""
    from bluefog_tpu_torch.examples.synthetic_benchmark import build, run

    t_phase = time.perf_counter()
    out = {}
    started = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            # every group starts now, beside this process's references,
            # and touches the card only when released, after the group
            # before it has finished
            for procs in MP_PROCESSES:
                outdir = os.path.join(tmp, f"P{procs}")
                os.makedirs(outdir)
                what = "slice" if procs == SLICE_PROCESSES else "all"
                started[procs] = _start_processes(procs, what, lengths,
                                                  win_len, outdir)
            started["bert"] = _start_processes(
                BERT_PROCESSES, "bert", [0], 0, bert_outdir,
                {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
            with deterministic_cudnn():
                trainer = build("resnet50", "neighbor", "exp2",
                                size=N_RANKS, batch_size=BATCH,
                                image_size=224, device=device)
                ref_losses = [loss.tolist() for loss in run(
                    trainer, MP_WARMUP, MP_TIMED)["losses"]]
            ref = {k: v.detach().cpu() for k, v in trainer.params.items()}
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            refs = slice_references(device)
            for procs in MP_PROCESSES:
                outdir = os.path.join(tmp, f"P{procs}")
                what = "slice" if procs == SLICE_PROCESSES else "all"
                res, secs = _run_processes(procs, outdir,
                                           started.pop(procs))
                out[procs] = _report_group(procs, what, res, secs,
                                           (ref, ref_losses), refs, lengths,
                                           outdir)
        except BaseException:
            _kill_started(started.values())
            raise
    print(f"[processes] phase {time.perf_counter() - t_phase:.1f} s")
    return out, started["bert"]


def _report_group(procs, what, res, secs, ref, refs, lengths, outdir):
    """Phase 1b's report of one group (its seconds from its release):
    printed, checked, returned.  ``ref`` is the one-process run's
    parameters and its losses a step."""
    tag = f"[processes P={procs}]"
    parts = {k: round(max(r["seconds"][k] for r in res), 1)
             for k in res[0]["seconds"]}
    print(f"{tag} {secs:.1f} s for the group from its release ({what}; the "
          f"slowest process's seconds after start-up: {parts}); ranks "
          f"{[r['ranks'] for r in res]} on {res[0]['device']}")
    entry = {"k1": report_k1(tag, res, lengths), "seconds": secs}
    entry.update(_report_processes(tag, procs, res, ref, outdir,
                                   len(lengths)))
    if what == "slice":
        entry["slice"] = _report_slice(tag, procs, res, refs, outdir)
    return entry


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
    ref, ref_losses = ref
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
    worst, where, unequal = 0.0, "", []
    for q in range(procs):
        got = torch.load(os.path.join(outdir, f"params_{q}.pt"))
        rows = res[q]["ranks"]
        for k, v in got.items():
            d = _diff_rel(v, ref[k][rows[0]:rows[-1] + 1])
            if d:
                unequal.append(f"{q}:{k}")
            if d > worst:
                worst, where = d, f" at process {q}'s {k}"
    # which step first parted from the one-process run, if one did
    same_loss = [[r["main"]["losses"][s] == ref_losses[s][
        r["ranks"][0]:r["ranks"][-1] + 1] for s in range(len(ref_losses))]
        for r in res]
    print(f"{tag} parameters after {MP_WARMUP + MP_TIMED} steps against the "
          f"one-process run: max |diff| / max |value| {worst:.3e}{where} (tol "
          f"{STEP_TOL:.3e}); {len(unequal)} tensor(s) not bit-equal"
          + (f": {unequal[:12]}" if unequal else "")
          + f"; losses equal to its, by process and step: {same_loss}")
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


def _diff_rel(got, want):
    """max |got - want| / max |want| in f64 (host tensors): 0.0 at once
    when the two are equal, since the f64 copies of a model's state are
    what costs."""
    if torch.equal(got, want):
        return 0.0
    d = float((got.double() - want.double()).abs().max())
    return d / max(float(want.double().abs().max()), 1e-12)


def _held(got_file, ref, rows):
    """max |diff| / max |value| of the saved state against the reference's
    rows, over every tensor, and whether every tensor is bit-equal."""
    got = torch.load(got_file)
    worst, equal = 0.0, True
    for k, v in got.items():
        want = ref[k][rows[0]:rows[-1] + 1]
        equal = equal and torch.equal(v, want)
        worst = max(worst, _diff_rel(v, want))
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
BERT_FT_N_PER_RANK = 32   # the example's 128 cut (4 steps, not 16)
CIFAR_GATE_EPOCHS = 2     # the example's 6 cut: its loss was 0.0094
#                           after the second epoch at the default
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
    from the same state, under deterministic settings.  The copies stay on
    the card: the state's (BERT-large's parameters and momentum over 8
    ranks, 21 GB) beside the K1 step's 47 GB peak, then the K1 step's
    parameters (10.7 GB) beside the plain step's; the parameters after
    the steps and the losses are compared."""
    opt = trainer.opt
    state = {k: v.detach() for k, v in trainer.state().items()}
    snap = {k: v.clone() for k, v in state.items()}
    counters = _counters(opt)
    try:
        with deterministic():
            opt.backend = "kernel"
            loss_k = trainer.step()
            after_k = {k: v.clone() for k, v in state.items()
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
    for k, want in after_k.items():
        got = state[k]
        equal = equal and torch.equal(got, want)
        d = float((got.double() - want.double()).abs().max())
        worst = max(worst, d / max(float(want.double().abs().max()), 1e-12))
    n_params = len(after_k)
    del after_k
    loss_d = float((loss_k - loss_p).abs().max())
    print(f"[{tag}] K1 step vs plain-fold step over {n_params} "
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
                            str(BERT_FT_EPOCHS), "--n-per-rank",
                            str(BERT_FT_N_PER_RANK)] + extra)
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
                worst = max(worst, _diff_rel(v, first[k]))
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


def phase_bert_processes(outdir, started):
    """Phase 1c, BERT-large over processes: phase 18's path with the 8
    ranks over 2 processes (each 2 machines of local size 2), 2 + 3 steps
    under deterministic settings, K1's peer launches a step a process, and
    K1's peer form on the machine rows; each process's parameters are saved
    in ``outdir``, for phase 18 to hold against its one-process run.  The
    group was started beside phase 1b (``started``; its two processes of 4
    BERT-large ranks each hold 29-35 GB at the mix, so they run with
    expandable segments, which keep the backward's cached blocks from
    fragmenting what is left of the card)."""
    tag = f"[bert P={BERT_PROCESSES}]"
    res, secs = _run_processes(BERT_PROCESSES, outdir, started)
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


# an example's main(argv) in a fresh process, TF32 off as in this one: its
# result, K1's launches in that process and its seconds, as one JSON line
_EXAMPLE_RUN = (
    "import importlib, json, sys, time, torch\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix\n"
    "mod = importlib.import_module(sys.argv[1])\n"
    "t0 = time.perf_counter()\n"
    "res = mod.main(sys.argv[2:])\n"
    "print('EXAMPLE_RESULT ' + json.dumps({'res': res, 'launches': "
    "gossip_mix.launches, 's': time.perf_counter() - t0}, default=float))\n")


def _start_example(module, argv):
    """``module``'s ``main(argv)`` in a fresh process, started now;
    :func:`_example_result` waits for it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return subprocess.Popen([sys.executable, "-c", _EXAMPLE_RUN, module]
                            + argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _example_result(proc, what):
    """``{"res", "launches", "s"}`` of a :func:`_start_example` process; a
    failed or late process fails the phase."""
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        print(stdout[-4000:], stderr[-4000:])
    check(proc.returncode == 0, f"{what} exited {proc.returncode}")
    line = [ln for ln in stdout.splitlines()
            if ln.startswith("EXAMPLE_RESULT ")][-1]
    return json.loads(line[len("EXAMPLE_RESULT "):])


def phase_gates():
    """``examples.mnist_epoch_gate`` at its defaults and
    ``examples.cifar_resnet_gate --filters 64`` at its defaults but
    ``CIFAR_GATE_EPOCHS``: each gate
    asserts its target and its parity with the allreduce arm; both arms'
    accuracy, steps, img/s and wall-clock, and K1's launches (the gossip
    arm's fuse plan a step; none in the allreduce arm).  The mnist gate
    and ``examples.convergence_comparison`` (phase 17's; two gossip
    flavors, one K1 launch a step each, to its OK) run in fresh processes
    beside the cifar gate here.  Returns the gates and
    convergence_comparison's seconds."""
    from bluefog_tpu_torch.examples import cifar_resnet_gate
    from bluefog_tpu_torch.models import LeNet5
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix

    procs = {"mnist": _start_example(
                 "bluefog_tpu_torch.examples.mnist_epoch_gate", []),
             "convergence_comparison": _start_example(
                 "bluefog_tpu_torch.examples.convergence_comparison", [])}
    runs = {}
    try:
        gc.collect()
        t0 = time.perf_counter()
        gossip_mix.launches = 0
        res = cifar_resnet_gate.main(["--filters", "64", "--epochs",
                                      str(CIFAR_GATE_EPOCHS)])
        runs["cifar"] = {"res": res, "launches": gossip_mix.launches,
                         "s": time.perf_counter() - t0}
        for name, proc in procs.items():
            runs[name] = _example_result(proc, name)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    conv = runs.pop("convergence_comparison")
    steps = 2 * conv["res"]["steps"]
    print(f"[examples] convergence_comparison (beside the gates): accuracies "
          f"{conv['res']['acc']}, K1 launches {conv['launches']} ({steps} "
          f"expected: exp2 and ring gossip, one fused LeNet buffer a step); "
          f"{conv['s']:.2f} s")
    check(conv["launches"] == steps,
          f"convergence_comparison launched K1 {conv['launches']} times")
    out = {}
    for name, model in (("mnist", LeNet5()),
                        ("cifar", cifar_resnet_gate.make_model(64))):
        per_step, _ = _launches_a_step(p[None] for p in model.parameters())
        res, launches, secs = (runs[name][k] for k in ("res", "launches",
                                                       "s"))
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
    return out, conv["s"]


RESUME_ARGS = ["--size", str(N_RANKS), "--batch-size", str(BATCH),
               "--image-size", "64", "--steps-per-epoch", "2", "--epochs",
               "3", "--warmup-epochs", "1", "--eval-every", "0"]


def _imagenet_process(argv, procs):
    """``examples.imagenet_resnet`` in a fresh process under deterministic
    cuDNN (TF32 off, as here), appended to ``procs`` while it runs; its
    checkpoint numbers."""
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
    proc = subprocess.Popen([sys.executable, "-c", code] + argv, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    procs.append(proc)
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        print(stdout[-4000:], stderr[-4000:])
    check(proc.returncode == 0, f"imagenet_resnet {argv} exited "
          f"{proc.returncode}")
    line = [ln for ln in stdout.splitlines()
            if ln.startswith("CHECKPOINT ")][-1]
    return json.loads(line[len("CHECKPOINT "):])


def start_checkpoint():
    """Phase 21's two processes, in a thread beside phase 20 (for the
    script's time limit): ``examples.imagenet_resnet`` for 3 epochs with a
    checkpoint each, then a fresh process resuming from a copy of its
    epoch-2 checkpoint.  :func:`phase_checkpoint` waits for them;
    :func:`stop_checkpoint` stops them."""
    tmp = tempfile.TemporaryDirectory()
    job = {"tmp": tmp, "procs": [], "t0": time.perf_counter()}

    def body():
        try:
            cut = os.path.join(tmp.name, "cut")
            straight = os.path.join(tmp.name, "all")
            job["whole"] = _imagenet_process(
                RESUME_ARGS + ["--checkpoint-dir", straight], job["procs"])
            # the resume reads the latest step
            shutil.copytree(os.path.join(straight, "step_2"),
                            os.path.join(cut, "step_2"))
            job["resumed"] = _imagenet_process(
                RESUME_ARGS + ["--checkpoint-dir", cut, "--resume"],
                job["procs"])
        except BaseException as e:
            job["error"] = e
        job["s"] = time.perf_counter() - job["t0"]

    job["thread"] = threading.Thread(target=body, daemon=True)
    job["thread"].start()
    return job


def stop_checkpoint(job):
    """Stop :func:`start_checkpoint`'s processes (a phase beside them
    failed)."""
    for proc in job["procs"]:
        if proc.poll() is None:
            proc.kill()
    job["thread"].join(timeout=30)
    job["tmp"].cleanup()


def phase_checkpoint(job):
    """``examples.imagenet_resnet`` (ResNet-50, 8 ranks x 32 at 64x64) for
    3 epochs with a checkpoint each epoch, then a fresh process resumes
    from a copy of its epoch-2 checkpoint (what an interruption after epoch
    2 leaves) to epoch 3, each process under deterministic cuDNN (both run
    by :func:`start_checkpoint`'s ``job``): the two epoch-3 checkpoints'
    parameters and momentum bit-equal, the epoch-2 checkpoint's BatchNorm
    statistics the rank mean; save and load ms and bytes a checkpoint.
    Then ``examples.elastic_resume`` from 8 ranks to 4 on K1."""
    from bluefog_tpu_torch.examples import elastic_resume
    from bluefog_tpu_torch.ops.gossip_kernel import gossip_mix
    from bluefog_tpu_torch.utils.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    out = {}
    job["thread"].join()
    with job["tmp"] as tmp:
        if "error" in job:
            raise job["error"]
        print(f"[checkpoint] the two imagenet processes took {job['s']:.1f} "
              f"s, beside phase 20; waited {time.perf_counter() - t0:.1f} s "
              "for them after it")
        cut, straight = os.path.join(tmp, "cut"), os.path.join(tmp, "all")
        whole, resumed = job["whole"], job["resumed"]
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


SLICE_LAYERS = 2   # GPT-small's 12 cut for the script's time limit


def slice_config():
    """GPT-small's published widths at ``SLICE_LAYERS`` layers, the
    configuration of phases 25-30."""
    from bluefog_tpu_torch.models.transformer import GPTConfig

    return dataclasses.replace(GPTConfig.small(), num_layers=SLICE_LAYERS)


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
    """dp 2 x pp 2 x tp 2 on GPT-small's TPBlocks, half a stage: each dp
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

    # started beside the groups before this one (interpreters, imports,
    # the gloo group): touch the card only once released
    while not os.path.exists(os.path.join(outdir, "go")):
        time.sleep(0.05)
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


def _mesh_start(procs, outdir, refdir, lengths):
    """Start ``procs`` processes of this script's phase-30 worker through
    the launcher.  Each waits, once initialized, for the ``go`` file in
    ``outdir`` (:func:`_mesh_group` writes it), so that a group's start-up
    runs beside the group before it and only its paths run alone."""
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
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    return proc, time.perf_counter()


def _mesh_group(procs, outdir, started):
    """Release a group started by :func:`_mesh_start` and collect its
    results in process order (a failed or late group fails the phase).
    Its seconds count from the release."""
    proc, t_start = started
    t0 = time.perf_counter()
    open(os.path.join(outdir, "go"), "w").close()
    try:
        log, _ = proc.communicate(
            timeout=max(1.0, MESH_TIMEOUT_S - (t0 - t_start)))
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
    started = {}
    try:
        # every group starts now (interpreters, imports, gloo groups) beside
        # this process's references; each touches the card only when
        # released, after the group before it has finished
        for procs in MESH_GROUPS:
            outdir = os.path.join(refdir, f"P{procs}")
            os.makedirs(outdir)
            started[procs] = _mesh_start(procs, outdir, refdir, lengths)
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
            res, secs = _mesh_group(procs, outdir, started.pop(procs))
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
        for proc, _ in started.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
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


# ---------------------------------------------------------------------------
# Phase 31: the asynchronous host runtime (native window table, TreePacker
# on the card, rank threads and processes)
# ---------------------------------------------------------------------------

ASYNC_RANKS = 8
ASYNC_BATCH = 32                 # a rank, at 224x224 (configs[1])
ASYNC_SECONDS = 10.0             # each of 31d's two runs, at least
ASYNC_MIN_STEPS = 2              # each rank's steps in each run
ASYNC_LR = 0.01                  # phase 3's SGD rate (no momentum here)
SHARD_LAYERS = 2                 # GPT-small's 12 cut for 31f's host vectors
SHARD_RANKS = 4
SHARD_ROUNDS = 2                 # 3 until phase 32 came
PACK_REPS = 5


def _host_rss_gb():
    """(resident, peak resident) GB of this process: /proc's VmRSS and
    getrusage's maximum."""
    import resource

    rss = float("nan")
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) * 1024 / 1e9
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    return rss, peak


def _host_wall_ms(fn, reps, warm=1):
    """Mean wall milliseconds of ``fn`` (which returns with the card done)
    over ``reps`` calls, after ``warm``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _copy_ms(n_f32, device):
    """Device milliseconds of one pinned D2H and one H2D copy of ``n_f32``
    f32: the transfer bound of a pack and of an unpack."""
    dev = torch.empty(n_f32, dtype=torch.float32, device=device)
    host = torch.empty(n_f32, dtype=torch.float32, pin_memory=True)
    d2h = time_ms(lambda: host.copy_(dev, non_blocking=True), PACK_REPS)
    h2d = time_ms(lambda: dev.copy_(host, non_blocking=True), PACK_REPS)
    return d2h, h2d


def host_packer(device):
    """31a: TreePacker on the card.  ResNet-50's parameters (f32) and a
    2-layer GPT-small (bf16) packed from CUDA tensors into the f64 window
    vector and unpacked, bit-exact, through the fused path and the per-leaf
    path; pack and unpack ms against the measured pinned copies of the
    same f32 bytes."""
    import numpy as np

    from bluefog_tpu_torch.models.resnet import ResNet50
    from bluefog_tpu_torch.models.transformer import TransformerLM
    from bluefog_tpu_torch.runtime.async_windows import TreePacker

    out = {}
    gpt_cfg = dataclasses.replace(slice_config(), num_layers=SHARD_LAYERS)
    for tag, make in (
            ("resnet50_f32", lambda: ResNet50(num_classes=1000)),
            ("gpt_small_2l_bf16", lambda: TransformerLM(gpt_cfg).to(
                torch.bfloat16))):
        net = make().to(device)
        tree = {k: v.detach() for k, v in net.named_parameters()}
        del net
        n = sum(v.numel() for v in tree.values())
        fused, leafwise = TreePacker(tree), TreePacker(tree, fused=False)
        check(fused.fused and not leafwise.fused,
              f"31a {tag}: the packer took the wrong path")
        vec = fused.pack(tree)
        ref = leafwise.pack(tree)
        check(vec.tobytes() == ref.tobytes(),
              f"31a {tag}: the fused pack differs from the per-leaf pack")
        for how, packer in (("fused", fused), ("per-leaf", leafwise)):
            back = packer.unpack(vec)
            torch.cuda.synchronize()
            bad = [k for k in tree if back[k].dtype != tree[k].dtype
                   or not torch.equal(back[k], tree[k])]
            check(not bad, f"31a {tag}: {how} round trip not bit-exact at "
                  f"{bad[:3]}")
        del back
        buf = np.empty(n, np.float64)
        row = {"n": n, "leaves": len(tree),
               "dtype": str(next(iter(tree.values())).dtype)[6:]}
        for how, packer in (("fused", fused), ("per_leaf", leafwise)):
            row[f"{how}_pack_ms"] = _host_wall_ms(
                lambda: packer.pack(tree, out=buf), PACK_REPS)
            row[f"{how}_unpack_ms"] = _host_wall_ms(
                lambda: packer.unpack(vec), PACK_REPS)
        d2h, h2d = _copy_ms(n, device)
        row.update(copy_d2h_ms=d2h, copy_h2d_ms=h2d,
                   copy_gb_s=(4 * n / 1e9) / (d2h / 1e3))
        print(f"[31a] TreePacker {tag}: {n:,} elements in {len(tree)} "
              f"leaves, round trip bit-exact (fused and per-leaf); pack "
              f"{row['fused_pack_ms']:.2f} ms fused / "
              f"{row['per_leaf_pack_ms']:.2f} ms per-leaf against a pinned "
              f"D2H of its f32 bytes {d2h:.2f} ms ({row['copy_gb_s']:.1f} "
              f"GB/s); unpack {row['fused_unpack_ms']:.2f} ms fused / "
              f"{row['per_leaf_unpack_ms']:.2f} ms per-leaf against an H2D "
              f"{h2d:.2f} ms")
        out[tag] = row
        del tree, vec, ref, fused, leafwise
        torch.cuda.empty_cache()
    return out


def host_pushsum():
    """31b: examples.async_pushsum at its defaults, with its checks."""
    from bluefog_tpu_torch.examples import async_pushsum

    t0 = time.perf_counter()
    res = async_pushsum.main(["--name", f"smoke_ps_{os.getpid()}"])
    res["s"] = time.perf_counter() - t0
    check(res["ok"], f"31b async_pushsum failed: {res['failures']}")
    print(f"[31b] async_pushsum: steps {res['steps_per_rank']}, max error "
          f"{res['max_abs_err']:.2e}, mass {res['total_mass']!r}, "
          f"{res['s']:.2f} s")
    return res


def host_async_dsgd(device):
    """31c: examples.async_dsgd on the card at its defaults (LeNet-5, 8 rank
    threads, Exp-2, the skew), with its four checks."""
    from bluefog_tpu_torch.examples import async_dsgd

    t0 = time.perf_counter()
    res = async_dsgd.main(["--name", f"smoke_dsgd_{os.getpid()}",
                           "--device", device.type])
    res["s"] = time.perf_counter() - t0
    check(res["ok"], f"31c async_dsgd failed: {res['failures']}")
    print(f"[31c] async_dsgd (LeNet-5, cuda): steps {res['steps_per_rank']},"
          f" loss drop {[round(d, 3) for d in res['loss_drop']]}, sum(p) - n"
          f" {res['total_mass'] - ASYNC_RANKS:.3e}, consensus gap "
          f"{res['consensus_gap']:.4f} (scale {res['param_scale']:.3f}), "
          f"{res['s']:.2f} s")
    return res


def host_resnet_async(device, sync_img_s):
    """31d: ResNet-50 trained asynchronously through
    DistributedWinPutOptimizer(async_=True): 8 rank threads on Exp-2, each
    on its own CUDA stream, batch ASYNC_BATCH a rank at 224x224, bf16
    compute, plain SGD at ASYNC_LR on the de-biased iterate, no extra skew;
    once with overlap=False and once with overlap=True."""
    import copy

    import numpy as np

    from bluefog_tpu_torch.examples.synthetic_benchmark import build
    from bluefog_tpu_torch.optim import DistributedWinPutOptimizer
    from bluefog_tpu_torch.topology import ExponentialTwoGraph

    trainer = build("resnet50", "none", "exp2", size=ASYNC_RANKS,
                    batch_size=ASYNC_BATCH, image_size=224, device=device)
    params0 = {k: v[0].detach().clone() for k, v in trainer.params.items()}
    for v in trainer.params.values():
        v.grad = None
    # functional_call swaps a module's parameters for its duration: one
    # module a rank thread
    models = [copy.deepcopy(trainer.model) for _ in range(ASYNC_RANKS)]
    batch = trainer.batch
    losses_seen = []

    def loss_and_grad(r, step, params):
        b_r = {k: v[r] for k, v in trainer.buffers.items()}
        params = {k: v.requires_grad_() for k, v in params.items()}
        loss = trainer.loss_fn(models[r], (params, b_r),
                               tuple(t[r] for t in batch))
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), dict(zip(params, grads))

    # warm cuDNN's plans (the process's cache, which every rank thread's
    # handle then finds) before the clock runs
    loss_and_grad(0, 0, {k: v.clone() for k, v in params0.items()})
    torch.cuda.synchronize()
    out = {"batch": ASYNC_BATCH, "sync_img_s": sync_img_s}
    duration = ASYNC_SECONDS
    for overlap in (False, True):
        opt = DistributedWinPutOptimizer(
            None, topology=ExponentialTwoGraph(ASYNC_RANKS), async_=True,
            lr=ASYNC_LR)
        opt.name = f"smoke_resnet_async_{overlap}_{os.getpid()}"
        torch.cuda.reset_peak_memory_stats()
        rep = opt.run(params0, loss_and_grad, duration_s=duration,
                      skew=[0.0] * ASYNC_RANKS, overlap=overlap)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rss, hwm = _host_rss_gb()
        steps = rep.steps_per_rank
        img_s = sum(steps) * ASYNC_BATCH / rep.wall_time_s
        per_step = {k: sum(p[k] for p in rep.phase_s) * 1e3 / sum(steps)
                    for k in rep.phase_s[0]
                    if overlap or k != "harvest"}
        mass_err = abs(rep.total_mass - ASYNC_RANKS)
        first = [ls[0] for ls in rep.losses]
        last = [ls[-1] for ls in rep.losses]
        losses_seen += first + last
        row = {"steps_per_rank": steps, "img_s": img_s,
               "wall_s": rep.wall_time_s, "mass_err": mass_err,
               "consensus_gap": rep.consensus_gap, "host_ms": per_step,
               "peak_gb": peak_gb, "rss_gb": rss, "rss_peak_gb": hwm,
               "loss_first": first, "loss_last": last}
        tag = f"overlap={overlap}"
        out[tag] = row
        print(f"[31d] ResNet-50 async {tag}: steps/rank {steps} in "
              f"{rep.wall_time_s:.1f} s, {img_s:.1f} img/s over all ranks "
              f"(synchronous phase 3: {sync_img_s:.1f}); |sum(p) - n| "
              f"{mass_err:.3e}; consensus gap {rep.consensus_gap:.4e}; "
              f"host ms a rank step "
              + ", ".join(f"{k} {v:.1f}" for k, v in per_step.items())
              + f"; peak device {peak_gb:.2f} GB, host RSS {rss:.2f} GB "
              f"(peak {hwm:.2f}); loss first {np.mean(first):.4f} last "
              f"{np.mean(last):.4f}")
        check(mass_err <= 1e-9, f"31d {tag}: mass audit {rep.total_mass!r}")
        check(min(steps) >= ASYNC_MIN_STEPS,
              f"31d {tag}: a rank starved: {steps}")
        check(math.isfinite(rep.consensus_gap),
              f"31d {tag}: consensus gap {rep.consensus_gap}")
        if not overlap:
            # the overlapped run stepped 1.0-2.3x slower than the serial
            # one on the H100's host: give its slowest rank time for
            # ASYNC_MIN_STEPS steps on a slow host too
            duration = max(ASYNC_SECONDS, ASYNC_MIN_STEPS * 2.5
                           * rep.wall_time_s / max(min(steps), 1))
        del rep
    check(all(math.isfinite(v) for v in losses_seen),
          "31d: a non-finite loss")
    del trainer, models, params0, batch
    torch.cuda.empty_cache()
    return out


ASYNC_MP_JOB = "31e async_dsgd_mp"


def async_mp_job(device):
    """31e as a ``_run_together`` job: examples.async_dsgd_mp --ranks 2
    over shared memory, its two worker processes on the card, with its
    checks (run in rank 0).  It runs beside 31f (for the script's time
    limit)."""
    return {ASYNC_MP_JOB: (["-m", "bluefog_tpu_torch.examples.async_dsgd_mp",
                            "--ranks", "2", "--device", device.type], 300)}


def host_async_mp(stdout, secs):
    """31e's report, from :func:`async_mp_job`'s run."""
    line = _report_line(stdout, "ASYNC_MP_REPORT")
    check(line, f"31e async_dsgd_mp: no report:\n{stdout[-3000:]}")
    print(f"[31e] async_dsgd_mp --ranks 2 (shm, workers on the card, beside "
          f"31f): {line}; {secs:.2f} s")
    return {"report": line, "s": secs}


def host_sharded_gossip(device):
    """31f: run_sharded_gossip on GPT-small's widths at SHARD_LAYERS layers,
    SHARD_RANKS ranks on Ring(4), inner axes {tp: 2} of tp_param_rules
    (the tensor-parallel rule table), each rank's parameters drawn on the
    card, SHARD_ROUNDS rounds, rank 2 healed out before the last: against
    the axes={} run bit
    for bit, and each coordinate's mass audit exact through the heal."""
    from bluefog_tpu_torch.parallel import tensor as pt
    from bluefog_tpu_torch.sharding.gossip import run_sharded_gossip
    from bluefog_tpu_torch.topology import RingGraph

    base = dataclasses.replace(slice_config(), num_layers=SHARD_LAYERS)
    _, full = _tp_template(base)
    table = pt.tp_param_rules()
    specs = {k: table.resolve(k.replace(".", "/"), v.shape)
             for k, v in full.items()}
    sharded = sum(1 for s in specs.values() if any(e is not None for e in s))
    params0 = []
    for r in range(SHARD_RANKS):
        g = torch.Generator(device=device).manual_seed(100 + r)
        params0.append({k: v.to(device) + 0.02 * torch.randn(
            v.shape, generator=g, device=device) for k, v in full.items()})
    n = sum(v.numel() for v in full.values())
    del full
    topo = RingGraph(SHARD_RANKS)
    runs = {}
    # both runs heal rank 2 out before their last round, so the heal's
    # audit and the bit-equality hold through it; they run at once, on two
    # host threads (each is one thread of model-sized numpy passes; two
    # runs, not three, and together: the script's time)
    from concurrent.futures import ThreadPoolExecutor

    def one(tag, axes):
        t0 = time.perf_counter()
        rep = run_sharded_gossip(topo, params0, specs, axes,
                                 rounds=SHARD_ROUNDS,
                                 heal_after=SHARD_ROUNDS - 1, dead_ranks=[2],
                                 name=f"smoke_sg_{tag}_{os.getpid()}")
        return rep, time.perf_counter() - t0

    t_both = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futs = {tag: pool.submit(one, tag, axes)
                for tag, axes in (("gathered", {}), ("tp2", {"tp": 2}))}
        done = {tag: f.result() for tag, f in futs.items()}
    both_s = time.perf_counter() - t_both
    for tag, (rep, secs) in done.items():
        worst = max(abs(m - SHARD_RANKS) for m in rep.total_mass.values())
        check(worst <= 1e-9, f"31f {tag}: mass audit off by {worst}")
        runs[tag] = {"rep": rep, "s": secs, "mass_err": worst,
                     "coords": len(rep.total_mass)}
        print(f"[31f] run_sharded_gossip {tag}: {len(rep.total_mass)} "
              f"coordinate(s), per-coordinate |mass - {SHARD_RANKS}| <= "
              f"{worst:.3e}, {rep.deposits} deposits of "
              f"{rep.shard_bytes_per_deposit:,} bytes (saved "
              f"{rep.saved_bytes_per_deposit:,}), {secs:.2f} s (both runs "
              f"together {both_s:.2f} s)")
    a, b = runs["gathered"]["rep"], runs["tp2"]["rep"]
    check(a.params[2] is None and b.params[2] is None
          and a.dead_ranks == b.dead_ranks == [2],
          "31f: the heal did not take rank 2 out")
    bad = [(r, k) for r in range(SHARD_RANKS) if r != 2 for k in a.params[r]
           if not torch.equal(a.params[r][k], b.params[r][k])]
    check(not bad, f"31f: the tp 2 run differs from the gathered run at "
          f"{bad[:3]}")
    print(f"[31f] {n:,} parameters ({sharded} leaves sharded over tp), the "
          f"{{tp: 2}} run bit-equal to the gathered run on every surviving "
          f"rank, through the heal")
    out = {k: {kk: vv for kk, vv in v.items() if kk != "rep"}
           for k, v in runs.items()}
    out["n"], out["bit_equal"] = n, True
    del params0, runs, a, b
    torch.cuda.empty_cache()
    return out


def phase_host_runtime(device, sync_img_s):
    """Phase 31: the native host runtime built from the checkout, then
    31a-31f (31e beside 31f).  No TPU kernel lies on this path; K1-K3's
    counters are read around it and reported."""
    from bluefog_tpu_torch.ops.deliver_kernel import window_deliver
    from bluefog_tpu_torch.runtime import native

    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    print(f"[31] native host runtime {native.library_path().name} loaded "
          f"(built from bluefog_tpu_torch/csrc/*.cc if missing) in "
          f"{build_s:.2f} s")
    counters = [window_deliver, *_slice_kernels()]
    for k in counters:
        k.launches = 0
    out = {"build_s": build_s}
    out["packer"] = host_packer(device)
    out["pushsum"] = host_pushsum()
    out["async_dsgd"] = host_async_dsgd(device)
    out["resnet"] = host_resnet_async(device, sync_img_s)
    bg = _start_together(async_mp_job(device))
    try:
        out["sharded"] = host_sharded_gossip(device)
    except BaseException:
        for p, _ in bg[0].values():
            p.kill()
        raise
    out["mp"] = host_async_mp(*_finish_together(bg)[ASYNC_MP_JOB])
    out["launches"] = {k.__name__: k.launches for k in counters}
    out["s"] = time.perf_counter() - t0
    print(f"[31] kernel launches during phase 31 (none of its path's work is "
          f"a TPU kernel): {out['launches']}; the phase took {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 32: the host runtime across hosts (the TCP window server, wire v2,
# deposit streams, peer faults, elastic membership, win_mutex, supervisor)
# ---------------------------------------------------------------------------

WIRE_N = 25_557_032              # ResNet-50's f64 window vector, 204 MB
WIRE_CHUNKS = 8                  # the striped streams' per-coordinate windows
WIRE_REPS = 2                    # deposits a way and codec, the last timed
WIRE_TOPK = 0.1
TCP_SECONDS = 4.0                # each of 32c's runs (and phase 35's)
TCP_BATCH = 32                   # a rank, at 224x224 (configs[1])

_WIRE_OWNER = r'''
import sys
import numpy as np
from bluefog_tpu_torch.runtime.async_windows import (AsyncWindow,
                                                     shm_unlink_window)
from bluefog_tpu_torch.runtime.window_server import WindowServer

prefix, n, chunks = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
names = [prefix + ":full"] + [f"{prefix}:c{i}" for i in range(chunks)]
sizes = [n] + [len(c) for c in np.array_split(np.empty(n, np.int8), chunks)]
wins = []
for nm, sz in zip(names, sizes):
    shm_unlink_window(nm)
    wins.append(AsyncWindow(nm, 2, sz, np.float64, shm=True))
srv = WindowServer()
_, port = srv.start("127.0.0.1")
print(f"WIRE_OWNER {port}", flush=True)
sys.stdin.readline()
srv.stop()
for w in wins:
    w.free()
'''


def _wire_payload(device):
    """ResNet-50's parameters, made on the card and packed by TreePacker
    into the f64 window vector (25,557,032 elements)."""
    from bluefog_tpu_torch.models.resnet import ResNet50
    from bluefog_tpu_torch.runtime.async_windows import TreePacker

    net = ResNet50(num_classes=1000).to(device)
    tree = {k: v.detach() for k, v in net.named_parameters()}
    vec = TreePacker(tree).pack(tree)
    del net, tree
    torch.cuda.empty_cache()
    check(vec.size == WIRE_N, f"32a: the packed vector has {vec.size:,} "
          f"elements, not {WIRE_N:,}")
    return vec


def host_wire(device):
    """32a: the wire on loopback.  A WindowServer in a child process holds
    ResNet-50's f64 window vector (2 slots of 25,557,032) and, for the
    striped streams, the same vector cut into 8 windows; this process
    deposits it (a put into slot 0) through RemoteWindow (sync),
    PipelinedRemoteWindow, StripedDepositStream at 2 and 4 stripes and the
    same-host shm route, with codec none, f32 and top-k 0.1 (the sync wire
    has no codec; the shm route carries the dense values whatever the
    stream's codec), and reads each back over the wire."""
    import numpy as np

    from bluefog_tpu_torch.runtime import wire_codec as wc
    from bluefog_tpu_torch.runtime.window_server import (
        DepositStream, PipelinedRemoteWindow, RemoteWindow,
        StripedDepositStream)

    vec = _wire_payload(device)
    chunks = np.array_split(vec, WIRE_CHUNKS)
    prefix = f"smoke_wire_{os.getpid()}"
    repo = os.path.dirname(os.path.abspath(__file__))
    owner = subprocess.Popen(
        [sys.executable, "-c", _WIRE_OWNER, prefix, str(WIRE_N),
         str(WIRE_CHUNKS)], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=repo + os.pathsep
                            + os.environ.get("PYTHONPATH", "")), cwd=repo)
    out = {"n": WIRE_N, "bytes": vec.nbytes}
    try:
        line = owner.stdout.readline()
        check(line.startswith("WIRE_OWNER"), f"32a: the owner said {line!r}")
        addr = ("127.0.0.1", int(line.split()[1]))
        full = prefix + ":full"
        reader = RemoteWindow(addr, full, timeout_s=120)
        chunk_readers = [RemoteWindow(addr, f"{prefix}:c{i}", timeout_s=120)
                         for i in range(WIRE_CHUNKS)]

        def read_back(striped):
            if not striped:
                return reader.read(0, WIRE_N, np.float64, consume=True)[0]
            return np.concatenate([
                r.read(0, len(c), np.float64, consume=True)[0]
                for r, c in zip(chunk_readers, chunks)])

        f32 = vec.astype(np.float32).astype(np.float64)
        views, _ = wc.encode(vec, wc.CODEC_TOPK, topk_ratio=WIRE_TOPK)
        topk = wc.decode(wc.CODEC_TOPK,
                         memoryview(b"".join(bytes(v) for v in views)),
                         WIRE_N, np.float64)
        ctopk = [wc.decode(wc.CODEC_TOPK, memoryview(b"".join(
            bytes(v) for v in wc.encode(c, wc.CODEC_TOPK,
                                        topk_ratio=WIRE_TOPK)[0])),
                           len(c), np.float64) for c in chunks]
        want = {"none": vec, "f32": f32, "topk": topk}
        want_striped = {"none": vec, "f32": f32,
                        "topk": np.concatenate(ctopk)}
        rows = {}
        for way in ("sync", "pipelined", "striped2", "striped4", "shm"):
            for codec in (("none",) if way == "sync"
                          else ("none", "f32", "topk")):
                striped = way.startswith("striped")
                kw = {} if codec == "none" else {"codec": codec,
                                                 "topk_ratio": WIRE_TOPK}
                if way == "sync":
                    h = RemoteWindow(addr, full, timeout_s=120)

                    def go():
                        h.deposit(0, vec, accumulate=False)
                elif way == "pipelined":
                    h = PipelinedRemoteWindow(addr, full, timeout_s=120, **kw)

                    def go():
                        h.deposit_async(0, vec, accumulate=False)
                        h.flush(120)
                elif striped:
                    h = StripedDepositStream(addr, 120,
                                             n_stripes=int(way[-1]), **kw)

                    def go():
                        for i, c in enumerate(chunks):
                            h.deposit_async(f"{prefix}:c{i}".encode(), 0, c,
                                            accumulate=False)
                        h.flush(120)
                else:
                    h = DepositStream(addr, 120, shm=True, **kw)

                    def go():
                        h.deposit_async(full.encode(), 0, vec,
                                        accumulate=False)
                        h.flush(120)
                for _ in range(WIRE_REPS - 1):
                    go()
                t0 = time.perf_counter()
                go()
                ms = (time.perf_counter() - t0) * 1e3
                stream = getattr(h, "stream", h)
                got = read_back(striped)
                expect = ("none" if way == "shm" else codec)
                ref = (want_striped if striped else want)[expect]
                exact = got.tobytes() == ref.tobytes()
                shm_n = getattr(stream, "shm_deposits", 0)
                wire = getattr(stream, "wire_bytes", None)
                row = {"ms": ms, "gb_s": vec.nbytes / 1e9 / (ms / 1e3),
                       "exact": exact, "shm_deposits": shm_n,
                       "wire_bytes_a_deposit": (wire / WIRE_REPS
                                                if wire is not None
                                                else vec.nbytes)}
                rows[f"{way}/{codec}"] = row
                h.close()
                print(f"[32a] {way:9s} codec {codec:4s}: {ms:8.2f} ms a "
                      f"deposit of {vec.nbytes / 1e6:.1f} MB "
                      f"({row['gb_s']:.2f} GB/s), "
                      f"{row['wire_bytes_a_deposit'] / 1e6:.1f} MB on the "
                      f"wire, read back "
                      f"{'bit-exact' if expect == 'none' else 'codec-exact'}"
                      f" {exact}, shm deposits {shm_n}")
                check(exact, f"32a {way}/{codec}: the read-back differs from "
                      f"the {expect} reference")
                if way == "shm":
                    check(shm_n == WIRE_REPS,
                          f"32a shm/{codec}: {shm_n} deposits took the shm "
                          "route")
                else:
                    check(shm_n == 0, f"32a {way}: an shm deposit")
        out["retune"] = stripe_retune(addr, prefix, chunks, chunk_readers)
        for r in [reader] + chunk_readers:
            r.close()
        d2h, _ = _copy_ms(2 * WIRE_N, device)  # the same bytes, as f32
        out.update(rows=rows, copy_d2h_ms=d2h,
                   copy_gb_s=vec.nbytes / 1e9 / (d2h / 1e3))
        print(f"[32a] yardstick: a pinned D2H of the same {vec.nbytes / 1e6:.1f}"
              f" MB {d2h:.2f} ms ({out['copy_gb_s']:.1f} GB/s)")
    finally:
        try:
            owner.stdin.write("quit\n")
            owner.stdin.flush()
            owner.wait(timeout=30)
        except Exception:
            owner.kill()
            owner.wait()
    return out


def stripe_retune(addr, prefix, chunks, chunk_readers):
    """33c, beside 32a's server: one StripedDepositStream over the 8
    windows, its pool resized by apply_plan 1 -> 4 -> 1 stripes.  First
    the timed pass: at each stripe count WIRE_REPS puts into slot 0, the
    last timed, each read back bit-exact.  Then the strand check: four
    accumulating deposits into slot 1 with resizes 1 -> 4 -> 1 -> 4
    between them and no flush until the end (shrinking fences the closing
    stripes): slot 1 must hold ``((c + c) + c) + c`` bit for bit, four
    deposits each.  Last, the
    TransportPlan that decide_transport_plan gives on the live ack
    EWMA."""
    import numpy as np

    from bluefog_tpu_torch.control import (TransportPlan,
                                           decide_transport_plan)
    from bluefog_tpu_torch.runtime.window_server import StripedDepositStream

    names = [f"{prefix}:c{i}".encode() for i in range(len(chunks))]
    st = StripedDepositStream(addr, 120, n_stripes=1)
    out = {"ms": {}}
    try:
        for version, stripes in enumerate((1, 4, 1)):
            if version:
                st.apply_plan(TransportPlan(version=version, round=version,
                                            stripes=stripes))
            check(st.n_stripes == stripes, f"33c: {st.n_stripes} stripes")
            for _ in range(WIRE_REPS):
                t0 = time.perf_counter()
                for nm, c in zip(names, chunks):
                    st.deposit_async(nm, 0, c, accumulate=False)
                st.flush(120)
                ms = (time.perf_counter() - t0) * 1e3
            exact = all(
                r.read(0, len(c), np.float64, consume=True)[0].tobytes()
                == c.tobytes() for r, c in zip(chunk_readers, chunks))
            out["ms"][f"{version}:{stripes}"] = ms
            print(f"[33c] {stripes} stripe(s) (plan version {version}): "
                  f"{ms:.2f} ms a deposit of "
                  f"{sum(c.nbytes for c in chunks) / 1e6:.1f} MB, read "
                  f"back bit-exact {exact}")
            check(exact, f"33c: the read-back at {stripes} stripes differs")
        for version, stripes in enumerate((4, 1, 4), start=3):
            for nm, c in zip(names, chunks):
                st.deposit_async(nm, 1, c, accumulate=True)
            st.apply_plan(TransportPlan(version=version, round=version,
                                        stripes=stripes))
        for nm, c in zip(names, chunks):
            st.deposit_async(nm, 1, c, accumulate=True)
        st.flush(120)
        stranded = []
        for i, (r, c) in enumerate(zip(chunk_readers, chunks)):
            got, fresh = r.read(1, len(c), np.float64, consume=True)
            want = ((c + c) + c) + c
            if fresh != 4 or got.tobytes() != want.tobytes():
                stranded.append((i, fresh))
        out["stranded"] = stranded
        ack = st.ack_ewma()
        plan = decide_transport_plan(TransportPlan(), 16, ack_ewma_s=ack,
                                     phase_s=st.phase_ewma())
        out["plan"] = json.loads(plan.to_bytes())
        out["ack_ewma_s"] = ack
        print(f"[33c] 4 accumulating deposits with resizes 1 -> 4 -> 1 -> 4 "
              f"between them, no flush until the end: every window bit-exact "
              f"with 4 deposits: {not stranded} {stranded}; the live ack "
              f"EWMA {ack * 1e3 if ack else float('nan'):.2f} ms -> "
              f"decide_transport_plan {out['plan']}")
        check(not stranded, f"33c: stranded or wrong windows {stranded}")
    finally:
        st.close()
    return out


def _run_together(jobs):
    """Run ``{tag: (argv after the interpreter, timeout s)}`` as concurrent
    processes (each ``python -m ...`` or a script), fail on any non-zero
    exit, and return ``{tag: (stdout, seconds)}``."""
    return _finish_together(_start_together(jobs))


def _start_together(jobs):
    """The first half of :func:`_run_together`: start the jobs."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = {tag: (subprocess.Popen([sys.executable, *argv],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True,
                                    env=env, cwd=repo), timeout)
             for tag, (argv, timeout) in jobs.items()}
    return procs, t0


def _finish_together(started):
    """The second half of :func:`_run_together`: wait for the jobs."""
    procs, t0 = started
    out = {}
    try:
        for tag, (p, timeout) in procs.items():
            left = max(1.0, timeout - (time.perf_counter() - t0))
            text = p.communicate(timeout=left)[0]
            out[tag] = (text, time.perf_counter() - t0)
            check(p.returncode == 0,
                  f"{tag} failed ({p.returncode}):\n{text[-3000:]}")
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _report_line(stdout, key):
    return next((ln[len(key) + 1:] for ln in stdout.splitlines()
                 if ln.startswith(key)), "")


def host_tcp_examples(device):
    """32b: examples.async_dsgd_mp --transport tcp --ranks 2, the same with
    --resilient (workers on the card), and examples.elastic_membership on
    the card, each at its defaults and with its own checks; the three run
    at once."""
    mp = ["-m", "bluefog_tpu_torch.examples.async_dsgd_mp", "--transport",
          "tcp", "--ranks", "2", "--device", device.type]
    res = _run_together({
        "32b async_dsgd_mp tcp": (mp, 300),
        "32b async_dsgd_mp tcp --resilient": (mp + ["--resilient"], 300),
        "32b elastic_membership": (
            ["-m", "bluefog_tpu_torch.examples.elastic_membership",
             "--device", device.type], 300)})
    out = {}
    for tag, (stdout, secs) in res.items():
        key = "ELASTIC_REPORT" if "elastic" in tag else "ASYNC_MP_REPORT"
        rep = _report_line(stdout, key)
        check(rep, f"{tag}: no report")
        if "elastic" in tag:
            check("elastic_membership: OK" in stdout, f"{tag}: no OK")
        out[tag[4:]] = {"report": rep, "s": secs}
        print(f"[32b] {tag[4:]} (on the card): {rep}; {secs:.2f} s")
    return out


def _resnet_rank_job(rank, n, dev, bdir):
    """One rank process's ResNet-50 at batch TCP_BATCH, 224x224, bf16
    compute (32c and 33a): its parameters and ``loss_and_grad``, warmed
    up; then it marks itself ready and waits for the parent's go."""
    import copy

    from bluefog_tpu_torch.examples.synthetic_benchmark import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(dev)
    trainer = build("resnet50", "none", "exp2", size=n,
                    batch_size=TCP_BATCH, image_size=224, device=device)
    params0 = {k: v[rank].detach().clone() for k, v in trainer.params.items()}
    model = copy.deepcopy(trainer.model)
    b_r = {k: v[rank] for k, v in trainer.buffers.items()}
    batch = tuple(t[rank] for t in trainer.batch)
    for v in trainer.params.values():
        v.grad = None

    def loss_and_grad(r, step, params):
        params = {k: v.requires_grad_() for k, v in params.items()}
        loss = trainer.loss_fn(model, (params, b_r), batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), dict(zip(params, grads))

    loss_and_grad(rank, 0, {k: v.clone() for k, v in params0.items()})
    if device.type == "cuda":
        torch.cuda.synchronize()
    # warmed up: wait for the parent's go, so that nothing the parent runs
    # meanwhile (32b's examples, 32d's drills) shares the host with the
    # timed runs
    open(os.path.join(bdir, f"ready.{rank}"), "w").close()
    while not os.path.exists(os.path.join(bdir, "go")):
        time.sleep(0.01)
    return params0, loss_and_grad


def _record_us(reps=20000):
    """A flight-recorder record's host microseconds on this host (a
    throwaway recorder, the event a deposit's size)."""
    from bluefog_tpu_torch.blackbox import recorder

    rec = recorder.FlightRecorder(capacity=4096)
    t0 = time.perf_counter()
    for i in range(reps):
        rec.record("tcp_deposit", slot=0, bytes=204456264, window="w",
                   peer="127.0.0.1")
    return (time.perf_counter() - t0) / reps * 1e6


def observed_run(rank, n, bdir, params0, loss_and_grad):
    """36b in one 32c worker: an ``OBS_SECONDS`` run over tcp with metrics
    on and the recorder in its default host mode; then this rank's dump
    into ``bdir/incident`` and its counters into ``observed.<rank>``."""
    from bluefog_tpu_torch import blackbox, metrics
    from bluefog_tpu_torch.runtime.async_windows import (FileBarrier,
                                                         run_async_dsgd_rank)
    from bluefog_tpu_torch.topology import ExponentialTwoGraph

    os.environ["BLUEFOG_TPU_BLACKBOX"] = "1"
    blackbox.reset()
    reg = metrics.metrics_start()
    rep = run_async_dsgd_rank(
        ExponentialTwoGraph(n), rank, params0, loss_and_grad,
        barrier=FileBarrier(os.path.join(bdir, "observed"), n, rank),
        lr=ASYNC_LR, duration_s=OBS_SECONDS,
        name=f"smoke_tcp_observed_{os.path.basename(bdir)}",
        transport="tcp", tcp_bind="127.0.0.1")
    snap = reg.snapshot()
    events = len(blackbox.get().events())
    path = blackbox.dump("phase36b", directory=os.path.join(bdir,
                                                            "incident"))
    metrics.metrics_stop()
    vec_bytes = (sum(v.numel() for v in params0.values()) + 1) * 8
    out = {"snap": snap, "events": events, "dump": path,
           "record_us": _record_us(), "vec_bytes": vec_bytes}
    if rep is not None:
        out.update(steps=rep.steps_per_rank, wall_s=rep.wall_time_s,
                   mass=rep.total_mass)
    with open(os.path.join(bdir, f"observed.{rank}"), "w") as f:
        json.dump(out, f)


def tcp_worker(argv):
    """One rank process of 32c: ResNet-50 over run_async_dsgd_rank, first
    over shm, then over tcp, its gradient on the card; then phase 35's run
    over tcp with tracing and the sampling profiler on, its trace and
    profile files under ``bdir``, K1-K3's launch counters read around
    it; then 36b's run (:func:`observed_run`).  The flight recorder is off
    in the first three runs."""
    rank, n, bdir, dev = int(argv[0]), int(argv[1]), argv[2], argv[3]
    os.environ["BLUEFOG_TPU_BLACKBOX"] = "0"
    from bluefog_tpu_torch import tracing
    from bluefog_tpu_torch.ops.deliver_kernel import window_deliver
    from bluefog_tpu_torch.runtime.async_windows import (FileBarrier,
                                                         run_async_dsgd_rank)
    from bluefog_tpu_torch.topology import ExponentialTwoGraph

    params0, loss_and_grad = _resnet_rank_job(rank, n, dev, bdir)
    counters = [window_deliver, *_slice_kernels()]
    res = {}
    for run in ("shm", "tcp", "traced"):
        kw = {}
        if run == "traced":
            for k in counters:
                k.launches = 0
            tracing.configure(os.path.join(bdir, "trace"), rank=rank,
                              job=f"smoke_traced_{os.path.basename(bdir)}")
            kw["profile"] = os.path.join(bdir, "profile")
        rep = run_async_dsgd_rank(
            ExponentialTwoGraph(n), rank, params0, loss_and_grad,
            barrier=FileBarrier(os.path.join(bdir, run), n, rank),
            lr=ASYNC_LR, duration_s=TCP_SECONDS,
            name=f"smoke_tcp_{run}_{os.path.basename(bdir)}",
            transport="shm" if run == "shm" else "tcp",
            tcp_bind="127.0.0.1", **kw)
        if run == "traced":
            tracing.reset()  # flushes this rank's spans
            launches = {k.__name__: k.launches for k in counters}
        if rank == 0:
            res[run] = {
                "steps": rep.steps_per_rank, "wall_s": rep.wall_time_s,
                "mass": rep.total_mass, "gap": rep.consensus_gap,
                "phase_s": rep.phase_s[0], "wire_bytes": rep.wire_bytes,
                "loss": [rep.losses[0][0], rep.losses[0][-1]],
                "streams": rep.stream_stats}
    with open(os.path.join(bdir, f"launches.{rank}"), "w") as f:
        json.dump(launches, f)
    observed_run(rank, n, bdir, params0, loss_and_grad)
    if rank == 0:
        with open(os.path.join(bdir, "report.json"), "w") as f:
            json.dump(res, f)
    print(f"TCP_WORKER_OK {rank}", flush=True)
    return 0


def start_tcp_resnet(device):
    """32c's two worker processes, started so that their start-up (imports,
    the model, cuDNN's warm-up) overlaps 32b; they wait for
    :func:`host_tcp_resnet`'s go before their timed runs."""
    n = 2
    repo = os.path.abspath(__file__)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(repo) + os.pathsep + env.get(
        "PYTHONPATH", "")
    bdir = tempfile.TemporaryDirectory()
    procs = [subprocess.Popen(
        [sys.executable, repo, "--tcp-worker", str(r), str(n), bdir.name,
         device.type],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(n)]
    return {"n": n, "procs": procs, "bdir": bdir, "t0": time.perf_counter()}


def host_tcp_resnet(started):
    """32c: ResNet-50 on configs[1]'s Exponential-2 at P = 2 processes
    time-slicing the card, batch 32 a rank, 224x224, bf16 compute, through
    run_async_dsgd_rank with TreePacker on the card: TCP_SECONDS over shm,
    then over tcp, in the same worker processes (started by
    :func:`start_tcp_resnet`); then phase 35's traced run over tcp, whose
    files stay in ``out["traced"]["dir"]`` for :func:`phase_traced_tcp`."""
    n, procs, bdir, t0 = (started[k] for k in ("n", "procs", "bdir", "t0"))
    outs = []
    kept = False
    try:
        deadline = time.perf_counter() + 300
        while not all(os.path.exists(os.path.join(bdir.name, f"ready.{r}"))
                      for r in range(n)):
            check(all(p.poll() is None for p in procs),
                  "32c: a worker exited before its runs")
            check(time.perf_counter() < deadline,
                  "32c: the workers were not ready within 300 s")
            time.sleep(0.05)
        t_go = time.perf_counter()
        open(os.path.join(bdir.name, "go"), "w").close()
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
        for r, (p, o) in enumerate(zip(procs, outs)):
            check(p.returncode == 0 and f"TCP_WORKER_OK {r}" in o,
                  f"32c worker {r} failed ({p.returncode}):\n{o[-4000:]}")
        with open(os.path.join(bdir.name, "report.json")) as f:
            res = json.load(f)
        launches = []
        for r in range(n):
            with open(os.path.join(bdir.name, f"launches.{r}")) as f:
                launches.append(json.load(f))
        kept = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if not kept:
            bdir.cleanup()
    out = {"s": time.perf_counter() - t0,
           "runs_s": time.perf_counter() - t_go,
           "traced": {"dir": bdir, "report": res.pop("traced"),
                      "launches": launches}}
    for transport in ("shm", "tcp"):
        v = res[transport]
        steps = v["steps"]
        img_s = sum(steps) * TCP_BATCH / v["wall_s"]
        host_ms = {k: s * 1e3 / steps[0] for k, s in v["phase_s"].items()
                   if k != "harvest"}
        row = {"steps": steps, "img_s": img_s, "mass_err": abs(v["mass"] - n),
               "gap": v["gap"], "host_ms": host_ms,
               "wire_bytes_a_step": v["wire_bytes"] / steps[0],
               "loss": v["loss"]}
        out[transport] = row
        print(f"[32c] ResNet-50 over {transport}, P = {n} processes: steps "
              f"{steps} in {v['wall_s']:.2f} s, {img_s:.1f} img/s; "
              f"|sum(p) - n| {row['mass_err']:.3e}; rank 0's step host ms "
              + ", ".join(f"{k} {x:.1f}" for k, x in host_ms.items())
              + f"; {row['wire_bytes_a_step'] / 1e6:.1f} MB on the wire a "
              f"step; loss {v['loss'][0]:.4f} -> {v['loss'][1]:.4f}")
        check(row["mass_err"] <= 1e-9 * n,
              f"32c {transport}: mass audit {v['mass']!r}")
        check(min(steps) >= 2, f"32c {transport}: a rank starved: {steps}")
        check(math.isfinite(v["loss"][1]), f"32c {transport}: a NaN loss")
    out["tcp_over_shm"] = out["tcp"]["img_s"] / out["shm"]["img_s"]
    print(f"[32c] tcp / shm img/s: {out['tcp_over_shm']:.3f}; the runs "
          f"{out['runs_s']:.1f} s, {out['s']:.1f} s with the workers' start "
          "(beside 32b)")
    return out


def _dominant_phase(report, frame):
    """The phase that holds most of ``frame``'s self samples."""
    by = {}
    for ph, folded, cnt in report["stacks"]:
        if folded.rsplit(";", 1)[-1] == frame:
            by[ph] = by.get(ph, 0) + int(cnt)
    return max(by, key=by.get) if by else "other"


def _sum_series(snap, name, skip=None):
    """The sum of a family's series in a snapshot (those whose labels hold
    ``skip`` left out)."""
    return sum(v for k, v in snap.items()
               if k.split("{", 1)[0] == name
               and (skip is None or skip not in k))


def phase_observed_tcp(resnet):
    """36b's analysis: the two workers' counters and dumps from their
    observed run over tcp (see the module docstring)."""
    t0 = time.perf_counter()
    bdir = resnet["traced"]["dir"].name
    n = 2
    obs = []
    for r in range(n):
        with open(os.path.join(bdir, f"observed.{r}")) as f:
            obs.append(json.load(f))
    rows = []
    for r, o in enumerate(obs):
        snap, peer = o["snap"], obs[1 - r]["snap"]
        vec = o["vec_bytes"]
        rounds = snap[f'bf_round_seconds_count{{rank="{r}"}}']
        items = _sum_series(snap, "bf_tcp_pipelined_items_total")
        dense = _sum_series(snap, "bf_tcp_dense_bytes_total")
        shm = _sum_series(snap, "bf_shm_deposits_total")
        # the other rank's server: this rank's deposits into its data
        # window (rank 0's meta window takes small ones of its own)
        landed = _sum_series(peer, "bf_tcp_deposit_bytes_total",
                             skip=":meta")
        per_dep = o["events"] / max(items, 1)
        rows.append({"rounds": rounds, "items": items, "dense": dense,
                     "landed": landed, "shm": shm, "events": o["events"],
                     "record_us": o["record_us"],
                     "recorder_us_a_deposit": per_dep * o["record_us"]})
        print(f"[36b] rank {r}: {rounds:.0f} rounds, {items:.0f} deposits "
              f"sent over tcp ({shm:.0f} over shm), {dense:,.0f} dense bytes"
              f" = {items:.0f} x {vec:,} expected; the other rank's server "
              f"took {landed:,.0f} bytes into its data window; {o['events']}"
              f" recorder events ({per_dep:.1f} a deposit) at "
              f"{o['record_us']:.2f} us a record")
        check(shm == 0 and items == rounds,
              f"36b rank {r}: {items} deposits for {rounds} rounds")
        check(dense == items * vec and landed == items * vec,
              f"36b rank {r}: bytes {dense} sent / {landed} landed for "
              f"{items} deposits of {vec}")
        check(o["dump"] and os.path.exists(o["dump"]),
              f"36b rank {r} wrote no dump")
    report = _cli_json("bluefog_tpu_torch.blackbox",
                       os.path.join(bdir, "incident"), "--expect-ranks",
                       str(n))
    check(not report["stuck_rounds"] and not report["missing_ranks"]
          and not report["suspect_ranks"],
          f"36b: the merge diagnosed a hang: {report}")
    o0 = obs[0]
    check(abs(o0["mass"] - n) <= 1e-9 * n, f"36b: mass audit {o0['mass']}")
    img_s = sum(o0["steps"]) * TCP_BATCH / o0["wall_s"]
    out = {"img_s": img_s, "tcp_img_s": resnet["tcp"]["img_s"],
           "steps": o0["steps"], "ranks": rows,
           "s": time.perf_counter() - t0}
    print(f"[36b] observed run over tcp, P = {n}: steps {o0['steps']} in "
          f"{o0['wall_s']:.2f} s, {img_s:.1f} img/s against 32c's tcp run's "
          f"{resnet['tcp']['img_s']:.1f} (metrics and recorder off; not "
          f"checked: a {OBS_SECONDS:.0f} s run); the merge: no hang, ranks "
          f"{report['present_ranks']}; recorder host cost a deposit "
          + ", ".join(f"rank {r} {x['recorder_us_a_deposit']:.1f} us"
                      for r, x in enumerate(rows)))
    return out


def phase_traced_tcp(resnet):
    """Phase 35: 32c's third run (ResNet-50 over tcp at P = 2 for
    TCP_SECONDS, with ``tracing.configure`` and ``profile=`` in both
    worker processes), read by the port's trace analyzer and profile
    report here.  Checks: every rank's spans load, each round has a
    critical path, every owner-side span's parent is a sender's wire span
    in the other process, every stream has a phase EWMA, the mass audit is
    exact, the profile's top frames carry phase labels, and K1-K3's
    launch counters read 0 in the workers around the run and here around
    the analysis.  Prints the {net, queue, apply} split of a deposit, the
    critical path's edges, the overlap fraction, the profile's top 6
    frames, and the traced run's img/s against 32c's untraced tcp run
    (printed, not checked: a 4 s run is too noisy for tracing's budget)."""
    from bluefog_tpu_torch.ops.deliver_kernel import window_deliver
    from bluefog_tpu_torch.profiling import PHASES
    from bluefog_tpu_torch.profiling import report as prof_report
    from bluefog_tpu_torch.tracing import analyze as an

    t0 = time.perf_counter()
    counters = [window_deliver, *_slice_kernels()]
    for k in counters:
        k.launches = 0
    tr = resnet.pop("traced")
    n = 2
    try:
        v = tr["report"]
        steps = v["steps"]
        img_s = sum(steps) * TCP_BATCH / v["wall_s"]
        out = {"steps": steps, "img_s": img_s, "wall_s": v["wall_s"],
               "traced_over_untraced": img_s / resnet["tcp"]["img_s"],
               "mass_err": abs(v["mass"] - n)}
        check(out["mass_err"] <= 1e-9 * n,
              f"35: mass audit {v['mass']!r}")
        check(min(steps) >= 2, f"35: a rank starved: {steps}")
        check(math.isfinite(v["loss"][1]), "35: a NaN loss")
        for r, lc in enumerate(tr["launches"]):
            check(not any(lc.values()),
                  f"35: rank {r} launched a kernel: {lc}")
        # every stream's {net, queue, apply} EWMA, from the extended acks
        phase_s = {}
        for r in range(n):
            ph = v["streams"].get(str(r), {}).get("phase_s", {})
            check(sorted(ph) == [str(1 - r)]
                  and sorted(ph[str(1 - r)]) == ["apply", "net", "queue"],
                  f"35: rank {r}'s stream has no phase EWMA: {ph}")
            phase_s[f"{r}->{1 - r}"] = ph[str(1 - r)]
        out["phase_ewma_s"] = phase_s

        tdir = os.path.join(tr["dir"].name, "trace")
        spans = an.load_traces(tdir)
        ranks = sorted({sp.get("rank") for sp in spans})
        check(ranks == [0, 1], f"35: spans of ranks {ranks}")
        for r in range(n):
            check(any(sp["name"] == "round" and sp["rank"] == r
                      for sp in spans), f"35: rank {r} has no round span")
        by_sid = {sp["sid"]: sp for sp in spans}
        owner = [sp for sp in spans if sp.get("cat") == "tcp_srv"]
        check(owner, "35: no owner-side span")
        for sp in owner:
            par = by_sid.get(sp.get("par"))
            check(par is not None and par["name"] == "wire"
                  and par["rank"] != sp["rank"],
                  f"35: owner-side span {sp['name']} of rank {sp['rank']} "
                  f"parents to {par and (par['name'], par['rank'])}")
        rep = an.analyze(tdir, spans=spans)
        cp = rep["critical_path"]
        rounds = rep["rounds"]["rounds_observed"]
        check(rounds >= 2 and cp["chains_walked"] == rounds,
              f"35: {cp['chains_walked']} critical chains over {rounds} "
              "rounds")
        check(cp.get("gating_edge") is not None,
              f"35: no gating edge: {cp}")
        wires = [sp for sp in spans if sp["name"] == "wire"
                 and not sp.get("open")]
        out.update(spans=len(spans), open_spans=rep["open_spans"],
                   rounds=rounds, critical_path=cp, edges=rep["edges"],
                   overlap=rep["overlap_fraction"],
                   deposit_mb=sum(sp.get("bytes", 0) for sp in wires)
                   / max(1, len(wires)) / 1e6)
        for name, er in sorted(rep["edges"].items()):
            print(f"[35] edge {name}: {er['batches']} batches, a deposit of "
                  f"{out['deposit_mb']:.1f} MB: wire "
                  f"{er['wire_mean_s'] * 1e3:.1f} ms = "
                  + ", ".join(f"{p} {x * 1e3:.1f}"
                              for p, x in er["phase_mean_s"].items())
                  + " ms; the stream's EWMA "
                  + ", ".join(f"{p} {x * 1e3:.1f}"
                              for p, x in phase_s[name].items()) + " ms")
        print(f"[35] critical path over {rounds} rounds: gating edge "
              f"{cp['gating_edge'][0]} -> {cp['gating_edge'][1]} "
              f"({cp['gating_rounds']} hops, dominant phase "
              f"{cp.get('dominant_phase')} "
              f"{cp.get('dominant_frac', float('nan')):.0%}); hops "
              f"{cp['gate_counts']}, gating seconds "
              + ", ".join(f"{k} {x:.2f}" for k, x in cp["gate_time_s"].items())
              + "; overlap fraction "
              + ", ".join(f"rank {r} {x:.1%}"
                          for r, x in sorted(out["overlap"].items())))

        prof = prof_report.merge(os.path.join(tr["dir"].name, "profile"))
        check(prof["samples"] > 0 and prof["ranks"] == [0, 1],
              f"35: profile samples {prof['samples']} of ranks "
              f"{prof['ranks']}")
        check(prof["phases"].get("compute", 0) > 0
              and prof["phases"].get("gossip", 0) > 0,
              f"35: no compute or gossip samples: {prof['phases']}")
        top = [(fr, c, frac, _dominant_phase(prof, fr))
               for fr, c, frac in prof_report.top_table(prof, 6)]
        check(len(top) == 6 and all(ph in (*PHASES, "other")
                                    for *_, ph in top),
              f"35: top frames {top}")
        out["profile"] = {"samples": prof["samples"],
                          "phase_frac": prof["phase_frac"],
                          "attributed_frac": prof["attributed_frac"],
                          "top": top,
                          "compute_top": prof_report.phase_frames(
                              prof, "compute", 3)}
        print(f"[35] profile: {prof['samples']} samples, phases "
              f"{prof['phase_frac']}, attributed "
              f"{prof['attributed_frac']:.1%}; top 6 frames by self: "
              + "; ".join(f"{fr} {frac:.1%} ({ph})"
                          for fr, _, frac, ph in top)
              + "; compute's top frames "
              + ", ".join(f"{fr} {c}" for fr, c in out["profile"][
                  "compute_top"]))
    finally:
        tr["dir"].cleanup()
    out["launches"] = {k.__name__: k.launches for k in counters}
    check(not any(out["launches"].values()),
          f"35: kernels launched around the analysis: {out['launches']}")
    out["s"] = time.perf_counter() - t0
    print(f"[35] traced tcp run: steps {steps} in {v['wall_s']:.2f} s, "
          f"{img_s:.1f} img/s, {out['traced_over_untraced']:.3f}x 32c's "
          f"untraced tcp run in the same workers (not checked); "
          f"|sum(p) - n| {out['mass_err']:.3e}; {len(spans)} spans; "
          f"launches {out['launches']} here, "
          f"{tr['launches']} in the workers; the analysis {out['s']:.1f} s")
    return out



_MUTEX_LEASE_S = 2.0
SUPERVISE_STEPS = 6

# 32d's lock drill under bfrun -np 2: a child of rank 0 takes
# win_mutex("smoke") with a 2 s lease and is SIGKILLed holding it (a child,
# so its death does not stop the launcher's group); rank 1 waits for the
# lock and prints how long after the holder took it it got it
_MUTEX_DRILL = r"""
import os, signal, subprocess, sys, time

mode, d, lease = sys.argv[1], sys.argv[2], float(sys.argv[3])
held = os.path.join(d, "held")
if mode == "holder":
    from bluefog_tpu_torch.parallel import api

    held_lock = api.win_mutex("smoke", lease_s=lease)  # kept: a collected
    held_lock.__enter__()  # context manager would release the lock
    with open(held + ".tmp", "w") as f:
        f.write(repr(time.time()))
    os.replace(held + ".tmp", held)
    os.kill(os.getpid(), signal.SIGKILL)
if os.environ["RANK"] == "0":
    rc = subprocess.call([sys.executable, __file__, "holder", d, str(lease)])
    sys.exit(0 if rc == -signal.SIGKILL else 1)
from bluefog_tpu_torch.parallel import api

while not os.path.exists(held):
    time.sleep(0.01)
with open(held) as f:
    t_held = float(f.read())
with api.win_mutex("smoke", timeout_s=60.0):
    t_got = time.time()
print(f"MUTEX_WAITED {t_got - t_held!r}", flush=True)
"""

# 32d's supervised script, on the card: a linear regression that
# checkpoints every step through CheckpointManager, SIGKILLs itself at step
# 3 of its first life, and resumes from its checkpoint after the restart
_SUPERVISED = r"""
import os, signal, sys
import torch
from bluefog_tpu_torch.utils.checkpoint import CheckpointManager

d, device, steps = sys.argv[1], torch.device(sys.argv[2]), int(sys.argv[3])
mgr = CheckpointManager(os.path.join(d, "ckpt"), async_save=False)
gen = torch.Generator(device=device).manual_seed(5)
X = torch.randn(256, 16, generator=gen, device=device)
y = X @ torch.randn(16, generator=gen, device=device)
state = {"w": torch.zeros(1, 16, device=device)}
last = mgr.latest_step()
start = 0
if last is not None:
    state = mgr.restore(last, template=state)
    start = last + 1
for step in range(start, steps):
    w = state["w"][0]
    grad = 2 * X.T @ (X @ w - y) / X.shape[0]
    state = {"w": (w - 0.1 * grad)[None]}
    mgr.save(step, state)
    marker = os.path.join(d, "killed")
    if step == 3 and not os.path.exists(marker):
        open(marker, "w").close()
        os.kill(os.getpid(), signal.SIGKILL)
loss = float(torch.mean((X @ state["w"][0] - y) ** 2))
print(f"SUPERVISED_OK resumed_from={last} loss={loss!r}", flush=True)
"""


def host_tcp_faults(device, beside=None):
    """32d: faults and membership over TCP, on the card, the three drills
    at once: a join and a drain (capacity 4), the win_mutex lease steal
    under bfrun and bfrun --supervise 2 (the death drill runs in 33b, under
    a chaos spec).  ``beside`` holds more ``_run_together`` jobs to run at
    the same time (33b's); their ``(stdout, seconds)`` come back beside
    32d's results."""
    mp = ["-m", "bluefog_tpu_torch.examples.async_dsgd_mp", "--device",
          device.type]
    launch = ["-m", "bluefog_tpu_torch.runtime.launch", "--no-build"]
    out = {}
    with tempfile.TemporaryDirectory() as d:
        mutex, sup = os.path.join(d, "mutex.py"), os.path.join(d, "sup.py")
        with open(mutex, "w") as f:
            f.write(_MUTEX_DRILL)
        with open(sup, "w") as f:
            f.write(_SUPERVISED)
        os.makedirs(os.path.join(d, "m"))
        os.makedirs(os.path.join(d, "s"))
        res = _run_together({
            "32d win_mutex": (launch + ["-np", "2", mutex, "contend",
                                        os.path.join(d, "m"),
                                        str(_MUTEX_LEASE_S)], 120),
            "32d supervise": (launch + [
                "-np", "1", "--supervise", "2", "--restart-backoff", "0.5",
                sup, os.path.join(d, "s"), device.type,
                str(SUPERVISE_STEPS)], 180),
            "32d join and drain": (mp + ["--ranks", "4", "--elastic",
                                         "--duration", "6"], 300),
            **(beside or {})})
    stdout, secs = res["32d win_mutex"]
    waited = float(stdout.split("MUTEX_WAITED ")[1].split()[0])
    out["mutex"] = {"waited_s": waited, "lease_s": _MUTEX_LEASE_S, "s": secs}
    print(f"[32d] win_mutex under bfrun -np 2: the holder SIGKILLed, the "
          f"lock stolen {waited:.3f} s after it was taken (lease "
          f"{_MUTEX_LEASE_S} s); {secs:.2f} s")
    check(_MUTEX_LEASE_S <= waited < 30.0,
          f"32d win_mutex: stolen after {waited} s")
    stdout, secs = res["32d supervise"]
    line = _report_line(stdout, "SUPERVISED_OK")
    check("resumed_from=3" in line, f"32d supervise: {line!r}")
    out["supervise"] = {"report": line, "s": secs}
    print(f"[32d] bfrun --supervise 2: the script SIGKILLed itself at step "
          f"3, restarted and resumed: {line}; {secs:.2f} s")
    stdout, secs = res["32d join and drain"]
    rep = _report_line(stdout, "ASYNC_MP_REPORT")
    check("joined=[3] left=[1]" in rep, f"32d join and drain: {rep!r}")
    out["join_drain"] = {"report": rep, "s": secs}
    print(f"[32d] a join and a drain: capacity 4, members 0-2, rank 3 "
          f"joins, rank 1 drains: {rep}; {secs:.2f} s")
    return out, {tag: v for tag, v in res.items() if tag in (beside or {})}


def phase_host_runtime_tcp(device, start_next=None, beside=None):
    """Phase 32: 32a-32d.  No TPU kernel lies on this path; K1-K3's
    counters are read around it and reported.  ``start_next()`` runs
    before 32d (phase 33a's workers start beside it); its result is
    returned beside the phase's."""
    from bluefog_tpu_torch.ops.deliver_kernel import window_deliver

    t0 = time.perf_counter()
    counters = [window_deliver, *_slice_kernels()]
    for k in counters:
        k.launches = 0
    out = {"wire": host_wire(device)}
    torch.cuda.empty_cache()
    started = start_tcp_resnet(device)
    try:
        out["examples"] = host_tcp_examples(device)
    except BaseException:
        for p in started["procs"]:
            p.kill()
        raise
    out["resnet"] = host_tcp_resnet(started)
    nxt = start_next() if start_next is not None else None
    try:
        out["faults"], out["beside_32d"] = host_tcp_faults(
            device, beside=beside)
    except BaseException:
        for p in (nxt or {}).get("procs", []):
            p.kill()
        raise
    out["launches"] = {k.__name__: k.launches for k in counters}
    out["s"] = time.perf_counter() - t0
    print(f"[32] kernel launches during phase 32 (none of its path's work is "
          f"a TPU kernel): {out['launches']}; the phase took {out['s']:.1f} s")
    return out, nxt


# ---------------------------------------------------------------------------
# Phase 33: the communication control plane and chaos on the card
# ---------------------------------------------------------------------------

CTL_N = 4                        # rank processes of 33a, on configs[1]'s graph
CTL_STEPS = 10                   # each rank's target (stop_after_steps)
CTL_SLOW = 3                     # the rank whose server sits behind the link
# the reference bench's lossy, slow link (benchmarks/control_bench.py)
CTL_SPEC = ("server:delay:ms=120:rate=0.95:seed=1;"
            "server:drop:rate=0.01:seed=2")
CTL_CONFIG = dict(evidence_every=2, cooldown_rounds=4, min_lag_s=0.02)
CTL_STREAM = dict(max_in_flight=2, max_queue_items=8)
CTL_CAP_S = 150.0                # each run's duration cap
CHAOS_DEATH = "rank2:sigkill:at_step=12"
CHAOS_LOSSY = ("ack:drop:after_frames=3;client:truncate:after_frames=5;"
               "server:drop:rate=0.05:seed=3")
CHAOS_THREADS = "rank2:die:at_step=8;rank1:stall:at_step=6:s=1.5"
CHAOS_THREADS_JOB = "33b threads"


def ctl_worker(argv):
    """One rank process of 33a: ResNet-50 over run_async_dsgd_rank on tcp
    with resilience=, first with control=None, then with control=, each to
    CTL_STEPS steps; rank CTL_SLOW's server behind CTL_SPEC.  Every rank
    writes its plan changes, its last plan and the plan decided from the
    run's final evidence records; rank 0 the report."""
    import hashlib

    rank, n, bdir, dev = int(argv[0]), int(argv[1]), argv[2], argv[3]
    from bluefog_tpu_torch import chaos
    from bluefog_tpu_torch.control import (CommPlan, ControlConfig,
                                           controller, decide_plan,
                                           read_evidence)
    from bluefog_tpu_torch.runtime.async_windows import (FileBarrier,
                                                         run_async_dsgd_rank)
    from bluefog_tpu_torch.runtime.resilience import ResilienceConfig
    from bluefog_tpu_torch.topology import ExponentialTwoGraph

    params0, loss_and_grad = _resnet_rank_job(rank, n, dev, bdir)
    # every decision this process's controller takes, with its round
    changes = []
    decide = controller.CommController.decide

    def recording_decide(self, round_, evidences):
        before = self.plan.version
        plan = decide(self, round_, evidences)
        if plan.version != before:
            changes.append([round_, plan.to_bytes().decode()])
        return plan

    controller.CommController.decide = recording_decide
    cfg = ControlConfig(**CTL_CONFIG)
    for mode in ("static", "control"):
        changes.clear()
        # each run meets the same fault sequence for the same traffic
        chaos.configure(CTL_SPEC if rank == CTL_SLOW else None)
        rdir = os.path.join(bdir, mode)
        rep = run_async_dsgd_rank(
            ExponentialTwoGraph(n), rank, params0, loss_and_grad,
            barrier=FileBarrier(rdir, n, rank), lr=ASYNC_LR,
            duration_s=CTL_CAP_S, name=f"smoke_ctl_{mode}_"
            f"{os.path.basename(bdir)}", transport="tcp",
            tcp_bind="127.0.0.1",
            # death detection is not under test here: a 204 MB deposit
            # behind the slow link must not read as a dead peer
            resilience=ResilienceConfig(suspect_after_s=2.0,
                                        dead_after_s=20.0,
                                        barrier_timeout_s=120.0,
                                        reconnect_budget=8, seed=rank),
            control=cfg if mode == "control" else None,
            stop_after_steps=CTL_STEPS, stream_options=dict(CTL_STREAM))
        mine = {"changes": list(changes)}
        if mode == "control":
            # the run is over on every rank (the audit barrier): the
            # disseminated records are final, and the plan decided from
            # them is what every rank converges on
            evs = read_evidence(rdir, n)
            settled = decide_plan(CommPlan(), 10 ** 6, evs, cfg)
            mine["settled"] = hashlib.sha1(settled.to_bytes()).hexdigest()
            mine["settled_plan"] = settled.to_bytes().decode()
            mine["records"] = [e.to_json() for e in evs]
        with open(os.path.join(bdir, f"{mode}.{rank}.json"), "w") as f:
            json.dump(mine, f)
        if rank == 0:
            with open(os.path.join(bdir, f"{mode}.report.json"), "w") as f:
                json.dump({
                    "steps": rep.steps_per_rank, "wall_s": rep.wall_time_s,
                    "mass": rep.total_mass, "dead": rep.dead_ranks,
                    "gap": rep.consensus_gap, "streams": rep.stream_stats,
                    "plan": (rep.control_plan.to_bytes().decode()
                             if rep.control_plan is not None else None),
                    "plan_changes": rep.plan_changes,
                    "loss": [rep.losses[0][0], rep.losses[0][-1]]}, f)
    chaos.reset()
    print(f"CTL_WORKER_OK {rank}", flush=True)
    return 0


def start_control(device):
    """33a's four worker processes, started beside 32d; they wait for
    :func:`host_control`'s go before their runs."""
    repo = os.path.abspath(__file__)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(repo) + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.pop("BLUEFOG_TPU_CHAOS", None)
    bdir = tempfile.TemporaryDirectory()
    procs = [subprocess.Popen(
        [sys.executable, repo, "--ctl-worker", str(r), str(CTL_N),
         bdir.name, device.type],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(CTL_N)]
    return {"procs": procs, "bdir": bdir, "t0": time.perf_counter()}


def host_control(started):
    """33a: the control plane at full width (see the module docstring)."""
    import hashlib

    from bluefog_tpu_torch.control import CommPlan, Evidence

    n, procs, bdir = CTL_N, started["procs"], started["bdir"]
    outs = []
    try:
        deadline = time.perf_counter() + 300
        while not all(os.path.exists(os.path.join(bdir.name, f"ready.{r}"))
                      for r in range(n)):
            check(all(p.poll() is None for p in procs),
                  "33a: a worker exited before its runs")
            check(time.perf_counter() < deadline,
                  "33a: the workers were not ready within 300 s")
            time.sleep(0.05)
        t_go = time.perf_counter()
        open(os.path.join(bdir.name, "go"), "w").close()
        for p in procs:
            outs.append(p.communicate(timeout=2 * CTL_CAP_S + 120)[0])
        for r, (p, o) in enumerate(zip(procs, outs)):
            check(p.returncode == 0 and f"CTL_WORKER_OK {r}" in o,
                  f"33a worker {r} failed ({p.returncode}):\n{o[-4000:]}")

        def load(name):
            with open(os.path.join(bdir.name, name)) as f:
                return json.load(f)

        res = {m: {"report": load(f"{m}.report.json"),
                   "ranks": [load(f"{m}.{r}.json") for r in range(n)]}
               for m in ("static", "control")}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        bdir.cleanup()
    out = {"start_s": t_go - started["t0"],
           "runs_s": time.perf_counter() - t_go}
    for mode in ("static", "control"):
        rep, ranks = res[mode]["report"], res[mode]["ranks"]
        steps = rep["steps"]
        img_s = sum(steps) * TCP_BATCH / rep["wall_s"]
        streams = rep["streams"]
        tot = {k: sum(v[k] for v in streams.values())
               for k in ("reconnects", "replayed", "retired", "deduped")}
        toward = {r: v["ack_ewma_s"].get(str(CTL_SLOW))
                  for r, v in streams.items()
                  if str(CTL_SLOW) in v["ack_ewma_s"]}
        others = {r: {j: e for j, e in v["ack_ewma_s"].items()
                      if j != str(CTL_SLOW)} for r, v in streams.items()}
        row = {"steps": steps, "wall_s": rep["wall_s"], "img_s": img_s,
               "mass_err": abs(rep["mass"] - n), "dead": rep["dead"],
               "gap": rep["gap"], "loss": rep["loss"], "streams": tot,
               "ack_ewma_toward_slow_s": toward,
               "ack_ewma_other_s": others}
        if mode == "control":
            plan = CommPlan.from_bytes(rep["plan"].encode())
            firsts = [c["changes"][0][0] for c in ranks if c["changes"]]
            lasts = [c["changes"][-1][0] for c in ranks if c["changes"]]
            live = [(c["changes"][-1][1] if c["changes"] else None)
                    for c in ranks]
            content = {json.dumps({k: v for k, v in json.loads(b).items()
                                   if k not in ("round", "version")},
                                  sort_keys=True) if b else None
                       for b in live}
            settled = {c["settled"] for c in ranks}
            lag = {}
            for rec in ranks[0]["records"]:
                ev = Evidence.from_json(rec)
                if CTL_SLOW in ev.lag_s:
                    lag[ev.rank] = ev.lag_s[CTL_SLOW]
            row.update(
                plan={"slow": list(plan.slow), "densify": plan.densify,
                      "gossip_every": plan.gossip_every,
                      "codec_level": plan.codec_level,
                      "version": plan.version, "round": plan.round},
                plan_changes=rep["plan_changes"],
                first_change_round=min(firsts) if firsts else None,
                last_change_round=max(lasts) if lasts else None,
                changes_a_rank=[len(c["changes"]) for c in ranks],
                live_final_sha1=[hashlib.sha1(b.encode()).hexdigest()[:12]
                                 if b else None for b in live],
                live_final_same_bytes=len(set(live)) == 1,
                live_final_same_content=len(content) == 1,
                settled_sha1=sorted(settled),
                settled_plan=ranks[0]["settled_plan"],
                evidence_lag_toward_slow_s=lag)
        out[mode] = row
        print(f"[33a] ResNet-50, {n} processes over tcp, {mode}: steps "
              f"{steps} in {rep['wall_s']:.2f} s to the target of "
              f"{CTL_STEPS}, {img_s:.1f} img/s; |sum(p) - n| "
              f"{row['mass_err']:.3e}; dead {rep['dead']}; streams (all "
              f"ranks) {tot}; ack EWMA toward rank {CTL_SLOW} (by sender) "
              + ", ".join(f"{r}: {v * 1e3:.1f} ms" for r, v in
                          toward.items())
              + "; to the others "
              + ", ".join(f"{r}->{j}: {e * 1e3:.1f} ms"
                          for r, d in others.items() for j, e in d.items())
              + f"; loss {rep['loss'][0]:.4f} -> {rep['loss'][1]:.4f}")
        if mode == "control":
            print(f"[33a] control: final plan {row['plan']}, plan changes "
                  f"{row['plan_changes']} (a rank {row['changes_a_rank']}), "
                  f"first change at round {row['first_change_round']}, "
                  f"last at {row['last_change_round']}; the ranks' last "
                  f"plans {row['live_final_sha1']} (same bytes "
                  f"{row['live_final_same_bytes']}, same content "
                  f"{row['live_final_same_content']}); decided from the "
                  f"final records by every process: {row['settled_sha1']} "
                  f"= {row['settled_plan']}; the records' lag toward rank "
                  f"{CTL_SLOW}: "
                  + ", ".join(f"{r}: {v * 1e3:.1f} ms"
                              for r, v in sorted(lag.items())))
        check(row["mass_err"] <= 1e-9 * n,
              f"33a {mode}: mass audit {rep['mass']!r}")
        check(rep["dead"] == [], f"33a {mode}: dead ranks {rep['dead']}")
        check(min(steps) >= CTL_STEPS,
              f"33a {mode}: a rank missed its target: {steps}")
        check(math.isfinite(rep["loss"][1]), f"33a {mode}: a NaN loss")
    c = out["control"]
    check(len(c["settled_sha1"]) == 1,
          f"33a: the processes decided different plans from the same "
          f"records: {c['settled_sha1']}")
    check(CTL_SLOW in c["plan"]["slow"] or c["plan_changes"] >= 1,
          f"33a: the controller neither penalized rank {CTL_SLOW} nor "
          f"changed the plan: {c['plan']}")
    out["control_over_static"] = c["wall_s"] / out["static"]["wall_s"]
    print(f"[33a] time to the target, control / static: "
          f"{out['control_over_static']:.3f} ({c['wall_s']:.2f} / "
          f"{out['static']['wall_s']:.2f} s); the workers' start "
          f"{out['start_s']:.1f} s (beside 32d), the runs "
          f"{out['runs_s']:.1f} s")
    return out


def chaos_drill_jobs(device):
    """33b's three drills under chaos specs (the chaos CLI exports each to
    its command), as ``_run_together`` jobs: the death of 32d, a lossy link
    over 2 processes, and the thread runner's death and stall.  The first
    two run beside 32d, the third alone right after phase 31;
    :func:`host_chaos_drills` checks and reports them."""
    chaos_cli = ["-m", "bluefog_tpu_torch.chaos", "--spec"]
    mp = [sys.executable, "-m", "bluefog_tpu_torch.examples.async_dsgd_mp",
          "--transport", "tcp", "--resilient", "--device", device.type]
    return {
        # 8 s, not the example's 3: on a slow or loaded host the victim's
        # twelfth step (its first ones pay the process's CUDA set-up) and
        # the 1 s detection must land before the survivors' last step, or
        # the death is caught only at the final flush, where no exact
        # baseline can be rebuilt
        "33b death": (chaos_cli + [CHAOS_DEATH, "--"] + mp
                      + ["--ranks", "3", "--duration", "8"], 300),
        "33b lossy link": (chaos_cli + [CHAOS_LOSSY, "--"] + mp
                           + ["--ranks", "2"], 300),
        CHAOS_THREADS_JOB: (chaos_cli + [CHAOS_THREADS, "--", sys.executable,
                                     "-m",
                                     "bluefog_tpu_torch.examples.async_dsgd",
                                     "--device", device.type,
                                     "--duration", "8",
                                     "--name", f"smoke_chaos_{os.getpid()}"],
                        300)}


def host_chaos_drills(res):
    """33b: the checks and the report of :func:`chaos_drill_jobs`' runs
    (``{tag: (stdout, seconds)}``)."""
    import ast

    out = {}
    stdout, secs = res["33b death"]
    rep = _report_line(stdout, "ASYNC_MP_REPORT")
    check("dead=[2]" in rep, f"33b death: {rep!r}")
    out["death"] = {"report": rep, "s": secs}
    print(f"[33b] a death under {CHAOS_DEATH!r}: 3 processes: {rep}; "
          f"{secs:.2f} s")
    stdout, secs = res["33b lossy link"]
    rep = _report_line(stdout, "ASYNC_MP_REPORT")
    streams = ast.literal_eval(rep.split("streams=")[1].split(" device=")[0])
    tot = {k: sum(v[k] for v in streams.values())
           for k in ("reconnects", "replayed", "retired", "deduped")}
    mass = float(rep.split("mass=")[1].split()[0])
    out["lossy"] = {"report": rep, "streams": tot, "s": secs}
    print(f"[33b] a lossy link under {CHAOS_LOSSY!r}: 2 processes: "
          f"streams {tot}; mass {mass!r}; {secs:.2f} s")
    check(tot["reconnects"] >= 1, f"33b lossy link: no reconnect: {tot}")
    check(tot["replayed"] + tot["retired"] + tot["deduped"] >= 1,
          f"33b lossy link: nothing replayed or deduped: {tot}")
    check(abs(mass - 2.0) <= 1e-9 * 2, f"33b lossy link: mass {mass!r}")
    stdout, secs = res[CHAOS_THREADS_JOB]
    line = next((ln for ln in stdout.splitlines()
                 if ln.startswith("dead ranks")), "")
    check(line.startswith("dead ranks [2]"), f"33b threads: {line!r}")
    total = float(line.rsplit("total + died = ", 1)[1])
    check(abs(total - 8.0) <= 1e-9 * 8, f"33b threads: total + died = "
          f"{total!r}")
    check("OK" in stdout, f"33b threads: the example's checks failed")
    steps = next((ln for ln in stdout.splitlines()
                  if ln.startswith("steps/rank")), "")
    warm = stdout.split("warm-up ", 1)[1].split(" s ", 1)[0]
    out["threads"] = {"line": line, "s": secs, "warm_s": float(warm)}
    print(f"[33b] 8 rank threads under {CHAOS_THREADS!r}: {line}; {steps}; "
          f"warm-up {warm} s before the budget; {secs:.2f} s")
    return out


def phase_control_chaos(device, ctl_started, drills, threads):
    """Phase 33: 33a, then 33b's report: its drills over processes
    (``drills``) ran beside 32d, its rank-thread drill (``threads``, its
    ``_run_together`` result) alone right after phase 31, before 33a's
    workers started (beside those four processes, each holding ResNet-50
    on the card, its ranks made 2-4x fewer steps and missed the example's
    loss drop in two of three runs); 33c ran inside 32a, beside its
    server.  No
    TPU kernel lies on this path; K1-K3's counters are read around it."""
    from bluefog_tpu_torch.ops.deliver_kernel import window_deliver

    t0 = time.perf_counter()
    counters = [window_deliver, *_slice_kernels()]
    for k in counters:
        k.launches = 0
    drills = {**drills, **threads}
    out = {"control": host_control(ctl_started)}
    torch.cuda.empty_cache()
    out["drills"] = host_chaos_drills(drills)
    out["launches"] = {k.__name__: k.launches for k in counters}
    out["s"] = time.perf_counter() - t0
    print(f"[33] kernel launches during phase 33 (none of its path's work is "
          f"a TPU kernel): {out['launches']}; the phase took {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 34: serve while training, on the card
# ---------------------------------------------------------------------------

SERVE_N = 2                      # rank processes of 34a (32c's shape)
SERVE_STEPS = 12                 # each rank's stop_after_steps
SERVE_CAP_S = 150.0              # the run's duration cap
SERVE_PIN_LAST = 3               # the last rounds read back pinned (parity)
SERVE_IDLE_S = 30.0              # the delta subscriptions' silence limit
SERVE_DRAIN_S = 30.0             # the delta replica's catch-up limit


def serve_worker(argv):
    """One rank process of 34a: 32c's ResNet-50 over run_async_dsgd_rank on
    tcp with ``snapshot_every=1`` to SERVE_STEPS steps; its own
    WindowServer serves the snapshots.  Rank 0 writes the report."""
    rank, n, bdir, dev = int(argv[0]), int(argv[1]), argv[2], argv[3]
    from bluefog_tpu_torch.runtime.async_windows import (FileBarrier,
                                                         run_async_dsgd_rank)
    from bluefog_tpu_torch.topology import ExponentialTwoGraph

    params0, loss_and_grad = _resnet_rank_job(rank, n, dev, bdir)
    rep = run_async_dsgd_rank(
        ExponentialTwoGraph(n), rank, params0, loss_and_grad,
        barrier=FileBarrier(os.path.join(bdir, "run"), n, rank),
        lr=ASYNC_LR, duration_s=SERVE_CAP_S, name=_serve_name(bdir),
        transport="tcp", tcp_bind="127.0.0.1", snapshot_every=1,
        stop_after_steps=SERVE_STEPS)
    if rank == 0:
        with open(os.path.join(bdir, "report.json"), "w") as f:
            json.dump({"steps": rep.steps_per_rank, "wall_s": rep.wall_time_s,
                       "mass": rep.total_mass, "dead": rep.dead_ranks,
                       "phase_s": rep.phase_s[0],
                       "loss": [rep.losses[0][0], rep.losses[0][-1]]}, f)
    print(f"SERVE_WORKER_OK {rank}", flush=True)
    return 0


def _serve_name(bdir):
    return f"smoke_serve_{os.path.basename(bdir)}"


def start_serving(device):
    """34a's two worker processes, started beside 34b; they wait, warmed
    up, for :func:`host_serving`'s go."""
    repo = os.path.abspath(__file__)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(repo) + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.pop("BLUEFOG_TPU_CHAOS", None)
    bdir = tempfile.TemporaryDirectory()
    procs = [subprocess.Popen(
        [sys.executable, repo, "--serve-worker", str(r), str(SERVE_N),
         bdir.name, device.type],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(SERVE_N)]
    return {"procs": procs, "bdir": bdir, "t0": time.perf_counter()}


def _await_file(path, procs, what, timeout_s=300):
    deadline = time.perf_counter() + timeout_s
    while not os.path.exists(path):
        check(all(p.poll() is None for p in procs),
              f"{what}: a worker exited early:\n"
              + "".join((p.stdout.read() or "")[-3000:] for p in procs
                        if p.poll() is not None))
        check(time.perf_counter() < deadline,
              f"{what}: {os.path.basename(path)} not there within "
              f"{timeout_s} s")
        time.sleep(0.02)


def _recording(sub_or_fn, rounds):
    """Wrap a subscription's callback (or a table's publish) to record the
    rounds it sees, in order."""
    if callable(sub_or_fn):
        fn = sub_or_fn

        def publish(group, rnd, leaves, **kw):
            rounds.append(rnd)
            return fn(group, rnd, leaves, **kw)
        return publish
    cb = sub_or_fn._on_snapshot

    def on_snapshot(snap):
        rounds.append(snap.round)
        return cb(snap) if cb is not None else None
    sub_or_fn._on_snapshot = on_snapshot
    return sub_or_fn


def _pushes_of(server):
    """Record the pushes that ``server``'s subscription senders build and
    send in this process, one dict a push: its kind (``full`` or
    ``delta``), round, bytes on the wire, the seconds its body took to
    build (a delta frame's encode, a full frame's anchor copy) and the
    seconds its send took.  Wraps the sender class; returns the list and
    the function that restores the class."""
    from bluefog_tpu_torch.runtime import window_server as ws

    pushes, pending = [], {}
    body_of, send_of = ws._SubSender._payload_views, ws._SubSender._send

    def payload_views(sender, rnd, leaves):
        t = time.perf_counter()
        body = body_of(sender, rnd, leaves)
        if sender._handler.server is server._server:
            delta = (sender._delta_on and
                     ws._DELTA_HDR.unpack(body[0])[0] == ws._OP_DELTA)
            pending[sender] = {"kind": "delta" if delta else "full",
                               "round": rnd,
                               "encode_s": time.perf_counter() - t}
        return body

    def send(sender, views):
        # a push's send follows its body's build; keepalives find nothing
        push = pending.pop(sender, None)
        t = time.perf_counter()
        ok = send_of(sender, views)
        if push is not None:
            push["send_s"] = time.perf_counter() - t
            push["bytes"] = sum(memoryview(v).nbytes for v in views)
            push["sent"] = ok
            pushes.append(push)
        return ok

    def restore():
        ws._SubSender._payload_views = body_of
        ws._SubSender._send = send_of

    ws._SubSender._payload_views = payload_views
    ws._SubSender._send = send
    return pushes, restore


def time_delta_encode(n, seed=34):
    """The delta encode's parts on this host at 34a's vector length (``n``
    f64 entries, seeded), under the default ``DeltaConfig``:
    ``DeltaEncoder.step`` on a trainer's dense round-over-round step, and
    ``np.argpartition`` of the difference's magnitudes alone (the top-k
    selection ``wire_codec.encode`` makes) on that step and on the same
    round as a delta frame decodes it (what a relay re-encodes for its
    children: the difference is zero off the upstream frame's kept
    entries).  The relay's own encodes are timed live (``_pushes_of``)."""
    import numpy as np
    from bluefog_tpu_torch.runtime import wire_codec
    from bluefog_tpu_torch.runtime.delta import (DeltaApplier, DeltaConfig,
                                                 DeltaEncoder)

    cfg = DeltaConfig()
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(n)
    x1 = x0 + 0.01 * rng.standard_normal(n)

    def leaves(x, rnd):
        return [("x", x), ("p", np.ones(1)), ("round", np.full(1, rnd, float))]

    enc = DeltaEncoder()
    enc.step(0, leaves(x0, 0), cfg)               # the anchor
    t = time.perf_counter()
    kind, base, items = enc.step(1, leaves(x1, 1), cfg)
    out = {"n": n, "dense_ms": (time.perf_counter() - t) * 1e3}
    check(kind == 10, "34a: the timed encode made no delta frame")
    del enc
    app = DeltaApplier("timed")
    app.anchor(0, dict(leaves(x0, 0)))
    rec = app.apply(1, base, [
        (name, dt, codec, n_el, memoryview(b"".join(bytes(v) for v in vs)))
        for name, dt, codec, n_el, vs, _ in items])
    del items
    k = wire_codec.kept(n, cfg.topk_ratio)
    for tag, x in (("dense", x1), ("decoded", rec["x"])):
        mag = np.abs(x - x0)
        out[f"{tag}_zero_share"] = float(np.mean(mag == 0.0))
        t = time.perf_counter()
        np.argpartition(mag, n - k)
        out[f"{tag}_select_ms"] = (time.perf_counter() - t) * 1e3
    return out


def host_serving(device, started, tcp_img_s):
    """34a (see the module docstring): the replica on the card, following
    rank 0 of a ResNet-50 that trains while it serves."""
    import numpy as np
    from torch.func import functional_call

    from bluefog_tpu_torch.examples.synthetic_benchmark import build
    from bluefog_tpu_torch.relay import RelayNode
    from bluefog_tpu_torch.runtime.async_windows import TreePacker
    from bluefog_tpu_torch.serving import (RoundRolled, ServingReplica,
                                           SnapshotClient,
                                           SnapshotUnavailable, Subscriber)

    procs, bdir, t0 = (started[k] for k in ("procs", "bdir", "t0"))
    n = SERVE_N
    # the prediction server's model: configs[1]'s ResNet-50, the workers'
    # seed and layout (build's parameter order is the packer's), one rank
    trainer = build("resnet50", "none", "exp2", size=1, batch_size=TCP_BATCH,
                    image_size=224, device=device)
    model = trainer.model
    template = {k: v[0].detach() for k, v in trainer.params.items()}
    buffers = {k: v[0] for k, v in trainer.buffers.items()}
    images = trainer.batch[0][0]          # a seeded request of 32 images
    del trainer
    with torch.no_grad():                 # cuDNN's first-call set-up
        functional_call(model, (template, buffers), (images,),
                        {"train": False})
    torch.cuda.synchronize()
    group = f"{_serve_name(bdir.name)}:0"
    outs, closers = [], []
    restore = None
    try:
        for r in range(n):
            _await_file(os.path.join(bdir.name, f"ready.{r}"), procs, "34a")
        t_go = time.perf_counter()
        open(os.path.join(bdir.name, "go"), "w").close()
        _await_file(os.path.join(bdir.name, "run", "winaddr.0"), procs,
                    "34a", 120)
        with open(os.path.join(bdir.name, "run", "winaddr.0")) as f:
            host, port = f.read().strip().rsplit(":", 1)
        addr = (host, int(port))
        audit = {"frames": 0, "mismatches": 0}

        def stamp(snap):
            audit["frames"] += 1
            if int(snap.leaves["round"][0]) != snap.round:
                audit["mismatches"] += 1

        rounds = {"replica": [], "delta_replica": [], "relay": []}
        auditor = Subscriber(addr, group, every=1, on_snapshot=stamp,
                             queue_max=1)
        closers.append(auditor)
        replica = ServingReplica(addr, group, template, every=1)
        closers.append(replica)
        _recording(replica.subscriber, rounds["replica"])
        # a sender is silent while it encodes a delta of the 204.5 MB
        # vector (seconds on a loaded host): the delta subscriptions'
        # silence limit is set above that, or every encode would read as a
        # dead link and every reconnect would start on a full frame
        relay = RelayNode(addr, [group], tier=1, idle_timeout_s=SERVE_IDLE_S)
        closers.append(relay)
        relay.table.publish = _recording(relay.table.publish, rounds["relay"])
        pushes, restore = _pushes_of(relay.server)
        replica2 = ServingReplica(relay.address, group, template, delta=True,
                                  idle_timeout_s=SERVE_IDLE_S)
        closers.append(replica2)
        _recording(replica2.subscriber, rounds["delta_replica"])
        client = SnapshotClient(addr, group, retry=dict(budget=8, cap_s=0.4))
        closers.append(client)

        # the prediction server: a request on every new served round
        params_ms, req_ms, stale, off_card, pull_ms = [], [], [], 0, []
        stale_delta = []
        last, pinned, served, errors = -1, None, None, None
        report = os.path.join(bdir.name, "report.json")
        deadline = time.perf_counter() + SERVE_CAP_S + 60
        # serve until rank 0 has reported (its run over, its group gone)
        while (not os.path.exists(report) and procs[0].poll() is None
               and time.perf_counter() < deadline):
            if replica.round <= last:
                time.sleep(0.005)
                continue
            ta = time.perf_counter()
            rnd, params = replica.params(with_round=True)
            torch.cuda.synchronize()
            tb = time.perf_counter()
            with torch.no_grad():
                functional_call(model, (params, buffers), (images,),
                                {"train": False})
            torch.cuda.synchronize()
            tc = time.perf_counter()
            params_ms.append((tb - ta) * 1e3)
            req_ms.append((tc - tb) * 1e3)
            off_card += sum(1 for v in params.values() if not v.is_cuda)
            last, served = rnd, (rnd, params)
            if errors is None and rnd >= SERVE_STEPS - 1:
                # the readers' state while the trainer still serves (after
                # it returns, their reconnects to it fail by design)
                errors = {k: c.error for k, c in (
                    ("replica", replica), ("delta_replica", replica2),
                    ("relay", relay), ("auditor", auditor))}
            try:
                live = client.snapshot(names=["round"]).round
                stale.append(replica.staleness_rounds(live)
                             if live >= rnd else 0)
                stale_delta.append(replica2.staleness_rounds(live))
            except (SnapshotUnavailable, RuntimeError, OSError):
                pass  # the rank is tearing down its group (counted below)
            if rnd >= SERVE_STEPS - SERVE_PIN_LAST:
                # the served round read back whole, pinned: the parity's
                # reference (the group goes when the rank returns)
                td = time.perf_counter()
                try:
                    snap = client.snapshot(pin_round=rnd)
                    pull_ms.append((time.perf_counter() - td) * 1e3)
                    pinned = (rnd, params, snap)
                except (RoundRolled, SnapshotUnavailable, RuntimeError,
                        OSError):
                    pass
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
        for r, (p, o) in enumerate(zip(procs, outs)):
            check(p.returncode == 0 and f"SERVE_WORKER_OK {r}" in o,
                  f"34a worker {r} failed ({p.returncode}):\n{o[-4000:]}")
        with open(report) as f:
            rep = json.load(f)
        # the trainers are gone and the relay keeps its last round: the
        # delta replica must reach it (its sender encodes the latest due
        # round after the one in hand).  The encode's parts are timed
        # meanwhile, beside that sender's encode.
        t_end = time.perf_counter()
        encode = {}

        def timed():
            try:
                encode.update(time_delta_encode(
                    sum(v.numel() for v in template.values())))
            except BaseException as e:
                encode["error"] = e
        timer = threading.Thread(target=timed, name="34a-encode")
        timer.start()
        while (replica2.round < rounds["relay"][-1]
               and time.perf_counter() - t_end < SERVE_DRAIN_S):
            time.sleep(0.02)
        drain = {"round": replica2.round, "relay": rounds["relay"][-1],
                 "s": time.perf_counter() - t_end}
        timer.join()
        if "error" in encode:
            raise encode["error"]
        delta_frames = replica2.subscriber.delta_frames
        adopted = (replica.adopted, replica2.adopted)
        resumes = {"replica": replica.subscriber.resumes,
                   "delta_replica": replica2.subscriber.resumes,
                   "relay_upstream": relay.subscription(group).resumes,
                   "auditor": auditor.resumes}
    finally:
        if restore is not None:
            restore()
        for c in reversed(closers):
            c.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        bdir.cleanup()
    runs_s = time.perf_counter() - t_go

    check(served is not None, "34a: the replica served nothing")
    check(pinned is not None, "34a: no pinned read of the last rounds")
    # the final served parameters against the port's unpack of x / p from
    # the pinned read of the same round
    p_rnd, p_params, snap = pinned
    want = TreePacker(template, np.float64).unpack(
        snap["x"] / float(snap["p"][0]))
    unequal = [k for k in template if not torch.equal(p_params[k], want[k])]
    check(not unequal, f"34a: round {p_rnd}'s served parameters differ from "
          f"the unpack of the pinned read at {unequal[:3]}")
    # a request's logits against the same forward from the parameters
    # copied into the model's own state
    f_rnd, f_params = served
    with torch.no_grad(), deterministic_cudnn():
        got = functional_call(model, (f_params, buffers), (images,),
                              {"train": False})
        for k, v in model.named_parameters():
            v.copy_(f_params[k])
        for k, v in model.named_buffers():
            v.copy_(buffers[k])
        ref = model(images, train=False)
    check(torch.equal(got, ref), "34a: the request's logits differ from the "
          "model's own forward with the served parameters")
    check(got.shape == (TCP_BATCH, 1000) and torch.isfinite(got).all(),
          f"34a: logits {tuple(got.shape)} not finite")
    steps = rep["steps"]
    mass_err = abs(rep["mass"] - n)
    img_s = sum(steps) * TCP_BATCH / rep["wall_s"]
    publish_ms = rep["phase_s"]["publish"] * 1e3 / steps[0]

    def by_kind(kind):
        rows = [p for p in pushes if p["kind"] == kind and p["sent"]]
        return {"frames": len(rows), "rounds": [p["round"] for p in rows],
                "mb": (float(np.mean([p["bytes"] for p in rows])) / 1e6
                       if rows else float("nan")),
                "encode_ms": [p["encode_s"] * 1e3 for p in rows],
                "send_ms": [p["send_s"] * 1e3 for p in rows]}

    full, dlt = by_kind("full"), by_kind("delta")
    push_ms = (float(np.mean(full["send_ms"])) if full["frames"]
               else float("nan"))
    out = {"steps": steps, "wall_s": rep["wall_s"], "img_s": img_s,
           "tcp_img_s": tcp_img_s, "ratio_to_32c": img_s / tcp_img_s,
           "publish_ms": publish_ms, "mass_err": mass_err,
           "push_ms": push_ms, "pull_ms": pull_ms,
           "params_ms": params_ms, "request_ms": req_ms,
           "request_p50_ms": float(np.median(req_ms)),
           "request_max_ms": max(req_ms),
           "params_p50_ms": float(np.median(params_ms)),
           "stale_worst": max(stale) if stale else float("nan"),
           "stale_mean": float(np.mean(stale)) if stale else float("nan"),
           "stale_samples": len(stale), "audit": audit, "rounds": rounds,
           "delta_stale": stale_delta,
           "delta_stale_worst": (max(stale_delta) if stale_delta
                                 else float("nan")),
           "delta_stale_mean": (float(np.mean(stale_delta)) if stale_delta
                                else float("nan")),
           "drain": drain, "encode": encode,
           "delta_frames": delta_frames, "adopted": adopted,
           "push": {"full": full, "delta": dlt},
           "resumes": resumes,
           "pinned_round": p_rnd, "final_round": f_rnd,
           "runs_s": runs_s, "s": time.perf_counter() - t0,
           "loss": rep["loss"]}
    print(f"[34a] ResNet-50, {n} processes over tcp, snapshot_every=1: steps "
          f"{steps} in {rep['wall_s']:.2f} s, {img_s:.1f} img/s against "
          f"32c's tcp {tcp_img_s:.1f} ({out['ratio_to_32c']:.3f}x); rank 0's "
          f"publish {publish_ms:.1f} ms a step; |sum(p) - n| {mass_err:.3e}; "
          f"loss {rep['loss'][0]:.4f} -> {rep['loss'][1]:.4f}")
    print(f"[34a] the replica on the card: {len(req_ms)} requests, params() "
          f"p50 {out['params_p50_ms']:.1f} ms (max {max(params_ms):.1f}), "
          f"request (bf16 forward of {TCP_BATCH} images) p50 "
          f"{out['request_p50_ms']:.2f} ms, max {out['request_max_ms']:.2f} "
          f"ms; staleness worst {out['stale_worst']} mean "
          f"{out['stale_mean']:.2f} rounds over {len(stale)} samples; "
          f"adopted {adopted[0]} (relay's delta replica {adopted[1]}, "
          f"{delta_frames} delta frames); pinned reads of 204.5 MB "
          + ", ".join(f"{x:.1f}" for x in pull_ms) + " ms")
    def ms(xs):
        return "[" + ", ".join(f"{x:.1f}" for x in xs) + "]"

    print(f"[34a] behind the relay: full pushes {full['frames']} x "
          f"{full['mb']:.1f} MB (built in {ms(full['encode_ms'])} ms, sent "
          f"in {ms(full['send_ms'])} ms), delta pushes {dlt['frames']} x "
          f"{dlt['mb']:.2f} MB of rounds {dlt['rounds']} (encoded in "
          f"{ms(dlt['encode_ms'])} ms, sent in {ms(dlt['send_ms'])} ms); "
          f"the delta replica's staleness worst {out['delta_stale_worst']} "
          f"mean {out['delta_stale_mean']:.2f} rounds over "
          f"{len(stale_delta)} samples, round {drain['round']} of the "
          f"relay's {drain['relay']} {drain['s']:.2f} s after the trainers "
          f"returned")
    print(f"[34a] the delta encode on this host, {encode['n']:,} f64 "
          f"entries, default DeltaConfig (beside the relay's last encode): "
          f"a trainer's dense step {encode['dense_ms']:.1f} ms, its top-k "
          f"selection alone {encode['dense_select_ms']:.1f} ms "
          f"({encode['dense_zero_share']:.3f} of the difference zero); the "
          f"selection on the same round decoded from a delta frame, as a "
          f"relay re-encodes it, {encode['decoded_select_ms']:.1f} ms "
          f"({encode['decoded_zero_share']:.3f} zero)")
    print(f"[34a] rounds replica {rounds['replica']}, relay "
          f"{rounds['relay']}, delta replica {rounds['delta_replica']}; "
          f"stamp audit {audit}; resumes {resumes}; round {p_rnd} "
          f"bit-equal to the pinned "
          f"read's unpack, round {f_rnd}'s logits bit-equal; "
          f"{runs_s:.1f} s from the go, {out['s']:.1f} s with the start")
    check(f_rnd == SERVE_STEPS - 1 and errors is not None
          and not any(errors.values()),
          f"34a: served up to round {f_rnd}; reader errors {errors}")
    check(audit["frames"] >= 3 and audit["mismatches"] == 0,
          f"34a: round-stamp audit {audit}")
    check(len(stale) >= 3 and len(stale_delta) >= 3,
          f"34a: {len(stale)} staleness samples of the replica and "
          f"{len(stale_delta)} of the delta replica against the live round")
    check(drain["round"] >= drain["relay"],
          f"34a: the delta replica stopped at round {drain['round']}, the "
          f"relay holds {drain['relay']}, {SERVE_DRAIN_S} s after the "
          f"trainers returned; delta encodes {ms(dlt['encode_ms'])} ms")
    for k, rr in rounds.items():
        check(len(rr) >= 2 and rr == sorted(set(rr)),
              f"34a: {k}'s rounds not strictly increasing: {rr}")
    check(delta_frames > 0, "34a: the delta replica saw no delta frame")
    check(mass_err <= 1e-9 * n, f"34a: mass audit {rep['mass']!r}")
    check(rep["dead"] == [], f"34a: dead ranks {rep['dead']}")
    check(min(steps) >= SERVE_STEPS - 1, f"34a: a rank starved: {steps}")
    check(off_card == 0 and all(v.is_cuda for v in f_params.values()),
          f"34a: {off_card} served leaves off the card")
    check(math.isfinite(rep["loss"][1]), "34a: a NaN loss")
    return out


def host_sharded_replica(device):
    """34b: GPT-small's widths at SHARD_LAYERS layers, seeded parameters on
    the card, sharded by tp_param_rules over {tp: 2}: each coordinate's
    shard packed by a spec-aware TreePacker and published as its own group
    at round 5, then one coordinate alone at round 6, then the other.  A
    ShardedServingReplica serves round 5 while round 6 is incomplete, then
    round 6, reassembled on the card bit-equal to that round's whole
    tree."""
    import numpy as np
    from bluefog_tpu_torch.parallel import tensor as pt
    from bluefog_tpu_torch.runtime.async_windows import TreePacker
    from bluefog_tpu_torch.runtime.window_server import WindowServer
    from bluefog_tpu_torch.serving import ShardedServingReplica, SnapshotTable
    from bluefog_tpu_torch.sharding import ShardView, inner_coords

    t0 = time.perf_counter()
    base = dataclasses.replace(slice_config(), num_layers=SHARD_LAYERS)
    _, full = _tp_template(base)
    table = pt.tp_param_rules()
    specs = {k: table.resolve(k.replace(".", "/"), v.shape)
             for k, v in full.items()}
    axes = {"tp": 2}
    gen = torch.Generator(device=device).manual_seed(34)
    tree = {k: v.to(device) for k, v in full.items()}
    noise = {k: 0.02 * torch.randn(v.shape, generator=gen, device=device)
             for k, v in tree.items()}
    del full

    def at(rnd):
        return {k: v + rnd * noise[k] for k, v in tree.items()}

    packers = [TreePacker(tree, np.float64, sharding=ShardView(
        specs=specs, axes=axes, coord=c)) for c in inner_coords(axes)]
    tbl = SnapshotTable()
    srv = WindowServer(snapshots=tbl)
    addr = srv.start("127.0.0.1")
    group = f"smoke_shard_{os.getpid()}"

    def publish(rnd, cis):
        t = at(rnd)
        for ci in cis:
            tbl.publish(f"{group}:{ci}", rnd,
                        {"x": packers[ci].pack(t), "p": np.array([1.0]),
                         "round": np.array([float(rnd)])})

    rep = None
    out = {"n": sum(v.numel() for v in tree.values()),
           "sharded_leaves": sum(1 for s in specs.values()
                                 if any(e is not None for e in s)),
           "coords": len(packers)}
    try:
        publish(5, range(len(packers)))
        rep = ShardedServingReplica(addr, group, tree, specs, axes)
        check(rep.wait_ready(60.0) == 5, "34b: round 5 not served first")
        publish(6, [0])
        deadline = time.perf_counter() + 60
        while (rep.subscribers[0].cursor < 6
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        check(rep.subscribers[0].cursor == 6,
              "34b: coordinate 0's round 6 never arrived")
        check(rep.round == 5, f"34b: served round {rep.round} while round 6 "
              "is incomplete")
        got5 = rep.params()
        want5 = at(5)
        check(all(torch.equal(got5[k], want5[k]) for k in want5),
              "34b: round 5 reassembled differs from its whole tree")
        del got5, want5
        publish(6, [1])
        deadline = time.perf_counter() + 60
        while rep.round < 6 and time.perf_counter() < deadline:
            time.sleep(0.01)
        check(rep.round == 6, "34b: round 6 never completed")
        ta = time.perf_counter()
        got6 = rep.params()
        torch.cuda.synchronize()
        out["params_ms"] = (time.perf_counter() - ta) * 1e3
        want6 = at(6)
        bad = [k for k in want6 if not torch.equal(got6[k], want6[k])]
        check(not bad, f"34b: round 6 reassembled differs at {bad[:3]}")
        check(all(v.is_cuda for v in got6.values()),
              "34b: reassembled leaves off the card")
        check(rep.error is None, f"34b: {rep.error}")
    finally:
        if rep is not None:
            rep.close()
        srv.stop()
    out["s"] = time.perf_counter() - t0
    print(f"[34b] ShardedServingReplica on GPT-small's widths at "
          f"{SHARD_LAYERS} layers ({out['n']:,} parameters, "
          f"{out['sharded_leaves']} leaves sharded over tp, {out['coords']} "
          f"coordinate groups): served round 5 while round 6 was incomplete, "
          f"then round 6, reassembled on the card bit-equal to its whole "
          f"tree; params() {out['params_ms']:.1f} ms; {out['s']:.1f} s")
    return out


def phase_serving(device, tcp_img_s):
    """Phase 34: 34a's workers start, 34b runs beside their start-up, then
    34a.  No TPU kernel lies on this path (the reference's serving tier is
    host code); K1-K3's counters are read around it and reported."""
    from bluefog_tpu_torch.ops.deliver_kernel import window_deliver

    t0 = time.perf_counter()
    counters = [window_deliver, *_slice_kernels()]
    for k in counters:
        k.launches = 0
    started = start_serving(device)
    try:
        sharded = host_sharded_replica(device)
    except BaseException:
        for p in started["procs"]:
            p.kill()
        raise
    torch.cuda.empty_cache()
    out = {"replica": host_serving(device, started, tcp_img_s),
           "sharded": sharded}
    torch.cuda.empty_cache()
    out["launches"] = {k.__name__: k.launches for k in counters}
    out["s"] = time.perf_counter() - t0
    print(f"[34] kernel launches during phase 34 (none of its path's work is "
          f"a TPU kernel): {out['launches']}; the phase took {out['s']:.1f} s")
    return out


def main():
    # cuBLAS's deterministic workspace for the deterministic BERT phases,
    # set before any handle exists (the processes of phase 1b inherit it)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if len(sys.argv) > 1 and sys.argv[1] == "--mp-worker":
        return mp_worker(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-worker":
        return mesh_worker(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--tcp-worker":
        return tcp_worker(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--ctl-worker":
        return ctl_worker(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--serve-worker":
        return serve_worker(sys.argv[2:])
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
    lap("1")
    # the plan needs only the parameters' shapes: no trainer on the card
    leaves = _plan_leaves()
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
    plan_leaves = [(v.shape, v.dtype) for v in leaves]
    del leaves
    # phase 1c's processes' parameters wait here for phase 18's run
    bert_dir = tempfile.TemporaryDirectory()
    procs, bert_started = phase_processes(device, mp_lengths, win_len,
                                          bert_dir.name)
    lap("1b")
    try:
        bert_procs = phase_bert_processes(bert_dir.name, bert_started)
    except BaseException:
        _kill_started([bert_started])
        raise
    lap("1c")
    trainer = build("resnet50", "neighbor", "exp2", size=N_RANKS,
                    batch_size=BATCH, image_size=224, device=device)
    leaves = list(trainer.params.values())
    check([(v.shape, v.dtype) for v in leaves] == plan_leaves,
          "the fuse plan's leaves are not the trainer's")
    k1 = phase_k1(device, main_lengths)
    lap("2")
    main_launches, main_res = phase_main_path(
        trainer, {gossip_mix: len(main_lengths)}, "main",
        f"ResNet-50 x {N_RANKS} virtual ranks, exp2, batch {BATCH}/rank, "
        "bf16")
    k1_launches = main_launches["gossip_mix"]
    phase_step_parity(trainer, "parity")
    phase_host_breakdown(trainer, "main")
    lap("3")
    observed = phase_observed_main(trainer, main_lengths)
    del trainer, leaves
    torch.cuda.empty_cache()
    lap("36")

    k2, k2_acc, k2_push = phase_k2(device, win_len)
    lap("4")
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
    lap("5")
    push_launches = phase_pushsum(device, win_len)
    lap("6")

    k3 = phase_k3(device)
    lap("7")
    # phase 24 here, beside phase 7: later in the script torch.profiler's
    # traces of these calls came back empty (an H100 run, after phase 22)
    k3_shapes = phase_k3_shapes(device)
    torch.cuda.empty_cache()
    lap("24")
    k3_launches = phase_gpt(device)
    lap("8")

    allreduce = phase_allreduce(device, main_lengths)
    lap("9")
    hier = phase_hierarchical(device, main_lengths)
    lap("10")
    phase_imagenet(main_lengths)
    lap("11")
    phase_mnist()
    lap("12")

    routing = phase_routing(device, main_lengths)
    lap("13")
    dynamic = phase_dynamic(device, main_lengths)
    lap("14")
    tracking = phase_tracking(device, main_lengths)
    lap("15")
    choco = phase_choco(device, win_len)
    lap("16")
    examples = phase_examples()
    lap("17")

    bert = phase_bert(device, bert_dir.name, bert_procs)
    bert_dir.cleanup()
    lap("18")
    bert_ft = phase_bert_finetune()
    lap("19")
    # phase 21's processes run beside phase 20
    ckpt_job = start_checkpoint()
    try:
        gates, examples["convergence_comparison"] = phase_gates()
    except BaseException:
        stop_checkpoint(ckpt_job)
        raise
    ckpt = phase_checkpoint(ckpt_job)
    lap("20-21")
    vit = phase_vit(device)
    lap("22")

    # every shape these paths hand K3 is held against the twins after them
    k3_paths = {}
    for tag, phase in (("seq", phase_sequence), ("tp", phase_tensor),
                       ("hybrid", phase_hybrid), ("moe", phase_moe),
                       ("longcontext", lambda _: phase_longcontext())):
        seen = set()
        with k3_calls(seen):
            k3_paths[tag] = phase(device)
        k3_paths[tag + "_k3_calls"] = check_k3_calls(seen, device, tag)
    lap("25-29")
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
    torch.cuda.empty_cache()
    lap("30")
    host = phase_host_runtime(device, main_res["samples_per_s"])
    torch.cuda.empty_cache()
    lap("31")
    # 33b's rank-thread drill alone now, before 33a's workers start beside
    # 32d; its drills over processes run beside 32d
    drills = chaos_drill_jobs(device)
    threads = _run_together({CHAOS_THREADS_JOB:
                             drills.pop(CHAOS_THREADS_JOB)})
    lap("33")
    tcp, ctl_started = phase_host_runtime_tcp(
        device, start_next=lambda: start_control(device), beside=drills)
    lap("32")
    observed_tcp = phase_observed_tcp(tcp["resnet"])
    lap("36")
    traced = phase_traced_tcp(tcp["resnet"])
    lap("35")
    ctl = phase_control_chaos(device, ctl_started, tcp.pop("beside_32d"),
                              threads)
    lap("33")
    serve = phase_serving(device, tcp["resnet"]["tcp"]["img_s"])
    lap("34")

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
    pk, rn = host["packer"], host["resnet"]
    print("the asynchronous host runtime (phase 31): TreePacker "
          + "; ".join(f"{tag} pack {v['fused_pack_ms']:.2f} / unpack "
                      f"{v['fused_unpack_ms']:.2f} ms fused (per-leaf "
                      f"{v['per_leaf_pack_ms']:.2f} / "
                      f"{v['per_leaf_unpack_ms']:.2f}) against copies "
                      f"{v['copy_d2h_ms']:.2f} / {v['copy_h2d_ms']:.2f} ms"
                      for tag, v in pk.items())
          + f"; async_dsgd LeNet-5 steps {host['async_dsgd']['steps_per_rank']}"
          f", gap {host['async_dsgd']['consensus_gap']:.4f}; ResNet-50 async "
          + ", ".join(f"{k} {v['img_s']:.1f} img/s (mass error "
                      f"{v['mass_err']:.1e}, gap {v['consensus_gap']:.3e})"
                      for k, v in rn.items() if k.startswith("overlap"))
          + f" against {rn['sync_img_s']:.1f} img/s synchronous; sharded "
          f"gossip {host['sharded']['n']:,} params bit-equal "
          f"{host['sharded']['bit_equal']}; phase {host['s']:.1f} s")
    wr, tr_ = tcp["wire"]["rows"], tcp["resnet"]
    print("the host runtime across hosts (phase 32): the wire on loopback, "
          "ResNet-50's f64 vector "
          + ", ".join(f"{k} {v['ms']:.1f} ms ({v['gb_s']:.2f} GB/s)"
                      for k, v in wr.items())
          + f" against a pinned D2H {tcp['wire']['copy_d2h_ms']:.2f} ms; "
          f"ResNet-50 at P = 2 over shm {tr_['shm']['img_s']:.1f} / tcp "
          f"{tr_['tcp']['img_s']:.1f} img/s ({tr_['tcp_over_shm']:.3f}x), "
          f"audits exact; join "
          f"and drain: {tcp['faults']['join_drain']['report']}; win_mutex "
          f"stolen after {tcp['faults']['mutex']['waited_s']:.3f} s (lease "
          f"{tcp['faults']['mutex']['lease_s']} s); supervise: "
          f"{tcp['faults']['supervise']['report']}; launches "
          f"{tcp['launches']}; phase {tcp['s']:.1f} s")
    cc, dr, rt = ctl["control"], ctl["drills"], tcp["wire"]["retune"]
    print("the control plane and chaos (phase 33): ResNet-50 over "
          f"{CTL_N} processes to {CTL_STEPS} steps, rank {CTL_SLOW} behind "
          f"{CTL_SPEC!r}: static {cc['static']['wall_s']:.2f} s "
          f"({cc['static']['img_s']:.1f} img/s), control "
          f"{cc['control']['wall_s']:.2f} s ({cc['control']['img_s']:.1f} "
          f"img/s), ratio {cc['control_over_static']:.3f}; final plan "
          f"{cc['control']['plan']}, {cc['control']['plan_changes']} "
          f"change(s), the first at round "
          f"{cc['control']['first_change_round']}; audits exact; death "
          f"{dr['death']['report']}; lossy link streams "
          f"{dr['lossy']['streams']}; threads {dr['threads']['line']}; "
          f"stripes " + ", ".join(f"{k} {v:.2f} ms"
                                  for k, v in rt["ms"].items())
          + f", none stranded; launches {ctl['launches']}; phase "
          f"{ctl['s']:.1f} s")
    sv, sh = serve["replica"], serve["sharded"]
    print("serve while training (phase 34): ResNet-50 at P = 2 over tcp with "
          f"snapshot_every=1 {sv['img_s']:.1f} img/s against 32c's "
          f"{sv['tcp_img_s']:.1f} ({sv['ratio_to_32c']:.3f}x), publish "
          f"{sv['publish_ms']:.1f} ms a step, a full push of the 204.5 MB "
          f"vector {sv['push_ms']:.1f} ms; the replica on the card: params() "
          f"p50 {sv['params_p50_ms']:.1f} ms, request p50 "
          f"{sv['request_p50_ms']:.2f} / max {sv['request_max_ms']:.2f} ms, "
          f"staleness worst {sv['stale_worst']} mean {sv['stale_mean']:.2f} "
          f"rounds, stamp audit {sv['audit']}; behind the relay "
          f"{sv['delta_frames']} delta frames, encoded in "
          f"{max(sv['push']['delta']['encode_ms'], default=float('nan')):.1f} "
          f"ms at most, the delta replica's staleness worst "
          f"{sv['delta_stale_worst']}; sharded replica bit-equal, params() "
          f"{sh['params_ms']:.1f} ms; launches {serve['launches']}; phase "
          f"{serve['s']:.1f} s")
    cp = traced["critical_path"]
    print("causal tracing and the profiler (phase 35): 32c's ResNet-50 over "
          f"tcp traced and profiled, {traced['img_s']:.1f} img/s "
          f"({traced['traced_over_untraced']:.3f}x untraced), a "
          f"{traced['deposit_mb']:.1f} MB deposit's split "
          + "; ".join(f"{k} " + ", ".join(f"{p} {x * 1e3:.1f}"
                                            for p, x in v.items()) + " ms"
                      for k, v in traced["phase_ewma_s"].items())
          + f"; gating edge {cp['gating_edge']} "
          f"({cp.get('dominant_phase')}), overlap "
          + ", ".join(f"{x:.1%}" for _, x in sorted(traced["overlap"].items()))
          + "; top frames "
          + ", ".join(f"{fr} ({ph})" for fr, _, _, ph in
                      traced["profile"]["top"][:3])
          + f"; launches {traced['launches']}; analysis {traced['s']:.1f} s")
    om, ot = observed["mean_ms"], observed_tcp
    print("metrics and the flight recorder (phase 36): ResNet-50 x "
          f"{N_RANKS} ranks host step ms off {om['off']:.2f}, metrics "
          f"{om['metrics']:.2f} ({om['metrics'] / om['off']:.4f}x), metrics "
          f"+ per-call recorder {om['jit']:.2f} ({om['jit'] / om['off']:.4f}"
          f"x), states bit-equal, K1 {observed['launches']} launches; "
          "one step's hooks alone "
          + ", ".join(f"{k} {v:.1f} us" for k, v in
                      observed["hooks_us"].items())
          + "; "
          f"counters at their closed forms; over tcp at P = 2 "
          f"{ot['img_s']:.1f} img/s observed against {ot['tcp_img_s']:.1f} "
          f"unobserved, the recorder "
          + ", ".join(f"{x['recorder_us_a_deposit']:.1f}"
                      for x in ot["ranks"])
          + " us a deposit; no hang in either incident")
    print(phase_seconds_line())
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

"""bluefog_tpu_torch: the PyTorch/CUDA port of ``bluefog_tpu``.

A second package beside the JAX one, with its module layout and public
names, so a reader finds each counterpart:

==============================================  ===============================
``bluefog_tpu``                                 here
==============================================  ===============================
topology.graphs / topology.schedule             topology.graphs / .schedule
topology.dynamic                                topology.dynamic
parallel.context (init/size/set_topology/...)   parallel.context
parallel.api (rank_stack, collectives, sync)   parallel.api
parallel.api (win_create ... win_update_...)    parallel.api
ops.pallas_gossip.neighbor_allreduce_pallas     ops.gossip_kernel (K1, CUDA)
ops.pallas_gossip.deliver_pallas                ops.deliver_kernel (K2, CUDA)
ops.ring_attention.local_attention              ops.ring_attention
library flash_attention (Pallas TPU)            ops.flash_kernel (K3, CUDA)
ops.collectives (fuse_apply, allreduce, ...,    ops.collectives
  neighbor_..., hierarchical_...)
ops.collectives (..._dynamic, ..._aperiodic)    ops.collectives
ops.compression (compressors, CHOCO-Gossip)     ops.compression
ops.windows (WindowState, win_put, ...)         ops.windows
optim.optimizers (incl. WinPut sync, CHOCO,     optim.optimizers
  gradient tracking, exact diffusion)
models.resnet                                   models.resnet
models.transformer (GPTConfig, TransformerLM)   models.transformer
models.lenet                                    models.lenet
models.bert (BertConfig, BertEncoder)           models.bert
models.vit (ViTConfig, ViT)                     models.vit
utils.checkpoint (CheckpointManager, ...)       utils.checkpoint
utils.failure (HangError, Heartbeat)            utils.failure
data.loader, data.tfrecord (csrc/tfrecord.cc)   data.loader, data.tfrecord
examples/synthetic_benchmark.py                 examples.synthetic_benchmark
examples/decentralized_optimization.py          examples.decentralized_...
examples/mnist_decentralized.py                 examples.mnist_decentralized
examples/imagenet_resnet.py                     examples.imagenet_resnet
examples/average_consensus.py                   examples.average_consensus
examples/choco_sgd.py                           examples.choco_sgd
examples/convergence_comparison.py              examples.convergence_...
examples/bert_finetune_hierarchical.py          examples.bert_finetune_...
examples/mnist_epoch_gate.py                    examples.mnist_epoch_gate
examples/cifar_resnet_gate.py                   examples.cifar_resnet_gate
examples/elastic_resume.py                      examples.elastic_resume
runtime.launch (initialize_cluster, bfrun-tpu)  runtime.launch (bfrun)
ops.ring_attention (ring, Ulysses, zigzag)      ops.ring_attention
ops.moe, models.moe (Switch / GShard MoE)       ops.moe, models.moe
parallel.tensor, .pipeline, .rng                parallel.tensor, .pipeline,
                                                  .rng (.axes: mesh axes)
sharding.rules (the rule table)                 sharding.rules
examples/longcontext_lm.py                      examples.longcontext_lm
the exchange of pallas_gossip (remote DMA)      ops.transport
csrc/*.cc, runtime.native (engine, windows)     csrc/*.cc, runtime.native
utils.timeline, utils.logging                   utils.timeline, utils.logging
runtime.async_windows (AsyncWindow,             runtime.async_windows
  TreePacker, async push-sum and DSGD)
sharding.gossip (run_sharded_gossip)            sharding.gossip
examples/async_pushsum.py, async_dsgd.py,       examples.async_pushsum, ...
  async_dsgd_mp.py (shm)
chaos (spec, injector, bfchaos-tpu)             chaos (python -m ...chaos)
control (plan, evidence, controller,            control
  transport, tree)
metrics (registry, comm, export, health, dash)  metrics
blackbox (recorder, dump, merge)                blackbox
utils.lockcheck, tracing, profiling             utils.lockcheck, tracing, ...
utils.inspect (collective census, flops)        utils.inspect
==============================================  ===============================

Ranks are virtual: ``n`` gossip ranks live on one device as the leading axis
of rank-stacked tensors, as in the JAX package's stacked-array API.  Under
``python -m bluefog_tpu_torch.runtime.launch -np P`` they are spread over
``P`` processes, each holding a contiguous block of them, with the rows
moving between processes through gloo on the CPU and through peer memory
on the card.  Entry
points default to ``device="cuda"`` and raise when no GPU is present; the CPU
is used only when a caller asks for it.  The package imports ``torch`` and
numpy, never JAX.
"""

from importlib import import_module as _import_module
from importlib import util as _util

__version__ = "0.1.0"

# The public names and the modules that hold them.  They load at first
# access (PEP 562), so ``python -m bluefog_tpu_torch.runtime.launch`` and a
# child process that only joins the cluster do not import torch and the
# whole package through this file.
_EXPORTS = {
    "bluefog_tpu_torch.parallel.context": (
        "get_context", "in_neighbor_machine_ranks", "in_neighbor_ranks",
        "init", "initialized", "load_machine_topology", "load_topology",
        "local_rank", "local_size", "machine_rank", "machine_size",
        "out_neighbor_machine_ranks", "out_neighbor_ranks", "owned_ranks",
        "process_count", "process_rank", "rank", "set_machine_topology",
        "set_topology", "shutdown", "size",
    ),
    "bluefog_tpu_torch.parallel.api": (
        "allgather", "allreduce", "allreduce_parameters", "barrier",
        "broadcast", "broadcast_optimizer_state", "broadcast_parameters",
        "hierarchical_neighbor_allreduce", "neighbor_allgather",
        "neighbor_allreduce", "neighbor_allreduce_aperiodic", "rank_shard",
        "rank_stack", "win_accumulate", "win_create", "win_free", "win_get",
        "win_put", "win_update", "win_update_then_collect", "enqueue_host_op",
        "poll", "synchronize", "wait_all_host_ops", "win_mutex",
        "win_mutex_break", "win_mutex_sweep",
    ),
    "bluefog_tpu_torch.utils.timeline": (
        "timeline_context", "timeline_end_activity", "timeline_start",
        "timeline_start_activity", "timeline_stop",
    ),
    "bluefog_tpu_torch.optim": (
        "CommunicationType", "DistributedChocoSGDOptimizer",
        "DistributedExactDiffusionOptimizer",
        "DistributedGradientAllreduceOptimizer",
        "DistributedGradientTrackingOptimizer",
        "DistributedHierarchicalNeighborAllreduceOptimizer",
        "DistributedNeighborAllreduceOptimizer", "DistributedWinPutOptimizer",
        "decentralized_optimizer",
    ),
    "bluefog_tpu_torch.utils.checkpoint": (
        "CheckpointManager", "resize_rank_state", "run_with_restart",
    ),
    "bluefog_tpu_torch.utils.failure": (
        "HangError", "Heartbeat", "run_supervised",
    ),
    "bluefog_tpu_torch.metrics": (
        "metrics_active", "metrics_start", "metrics_stop",
    ),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = ["blackbox", "metrics", "topology", *_WHERE]


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is not None:
        value = getattr(_import_module(mod), name)
    elif _util.find_spec(f"{__name__}.{name}") is not None:
        value = _import_module(f"{__name__}.{name}")
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))

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

from bluefog_tpu_torch import topology
from bluefog_tpu_torch.parallel.context import (
    get_context,
    in_neighbor_machine_ranks,
    in_neighbor_ranks,
    init,
    initialized,
    load_machine_topology,
    load_topology,
    local_rank,
    local_size,
    machine_rank,
    machine_size,
    out_neighbor_machine_ranks,
    out_neighbor_ranks,
    owned_ranks,
    process_count,
    process_rank,
    rank,
    set_machine_topology,
    set_topology,
    shutdown,
    size,
)
from bluefog_tpu_torch.parallel.api import (
    allgather,
    allreduce,
    allreduce_parameters,
    barrier,
    broadcast,
    broadcast_optimizer_state,
    broadcast_parameters,
    hierarchical_neighbor_allreduce,
    neighbor_allgather,
    neighbor_allreduce,
    neighbor_allreduce_aperiodic,
    rank_shard,
    rank_stack,
    win_accumulate,
    win_create,
    win_free,
    win_get,
    win_put,
    win_update,
    win_update_then_collect,
)
from bluefog_tpu_torch.optim import (
    CommunicationType,
    DistributedChocoSGDOptimizer,
    DistributedExactDiffusionOptimizer,
    DistributedGradientAllreduceOptimizer,
    DistributedGradientTrackingOptimizer,
    DistributedHierarchicalNeighborAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer,
    DistributedWinPutOptimizer,
    decentralized_optimizer,
)

from bluefog_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    resize_rank_state,
    run_with_restart,
)
from bluefog_tpu_torch.utils.failure import HangError, Heartbeat

__version__ = "0.1.0"

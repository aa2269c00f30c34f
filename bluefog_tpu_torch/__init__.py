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
data.loader, data.tfrecord (csrc/tfrecord.cc)   data.loader, data.tfrecord
examples/synthetic_benchmark.py                 examples.synthetic_benchmark
examples/decentralized_optimization.py          examples.decentralized_...
examples/mnist_decentralized.py                 examples.mnist_decentralized
examples/imagenet_resnet.py                     examples.imagenet_resnet
examples/average_consensus.py                   examples.average_consensus
examples/choco_sgd.py                           examples.choco_sgd
examples/convergence_comparison.py              examples.convergence_...
runtime.launch (initialize_cluster, bfrun-tpu)  runtime.launch (bfrun)
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

__version__ = "0.1.0"

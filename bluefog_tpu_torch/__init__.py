"""bluefog_tpu_torch: the PyTorch/CUDA port of ``bluefog_tpu``.

A second package beside the JAX one, with its module layout and public
names, so a reader finds each counterpart:

==============================================  ===============================
``bluefog_tpu``                                 here
==============================================  ===============================
topology.graphs / topology.schedule             topology.graphs / .schedule
parallel.context (init/size/set_topology/...)   parallel.context
parallel.api (rank_stack, neighbor_allreduce)   parallel.api
parallel.api (win_create ... win_update_...)    parallel.api
ops.pallas_gossip.neighbor_allreduce_pallas     ops.gossip_kernel (K1, CUDA)
ops.pallas_gossip.deliver_pallas                ops.deliver_kernel (K2, CUDA)
ops.collectives (fuse_apply, neighbor_...)      ops.collectives
ops.windows (WindowState, win_put, ...)         ops.windows
optim.optimizers (incl. WinPut, sync mode)      optim.optimizers
models.resnet                                   models.resnet
examples/synthetic_benchmark.py                 examples.synthetic_benchmark
examples/decentralized_optimization.py          examples.decentralized_...
==============================================  ===============================

Ranks are virtual: ``n`` gossip ranks live on one device as the leading axis
of rank-stacked tensors, as in the JAX package's stacked-array API.  Entry
points default to ``device="cuda"`` and raise when no GPU is present; the CPU
is used only when a caller asks for it.  The package imports ``torch`` and
numpy, never JAX.
"""

from bluefog_tpu_torch import topology
from bluefog_tpu_torch.parallel.context import (
    get_context,
    in_neighbor_ranks,
    init,
    initialized,
    load_topology,
    out_neighbor_ranks,
    rank,
    set_topology,
    shutdown,
    size,
)
from bluefog_tpu_torch.parallel.api import (
    neighbor_allreduce,
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
    DistributedNeighborAllreduceOptimizer,
    DistributedWinPutOptimizer,
    decentralized_optimizer,
)

__version__ = "0.1.0"

"""Decentralized optimizers: ``torch.optim`` plus gossip."""

from bluefog_tpu_torch.optim.optimizers import (  # noqa: F401
    ChocoSGDOptimizer,
    CommunicationType,
    DecentralizedOptimizer,
    DistributedChocoSGDOptimizer,
    DistributedExactDiffusionOptimizer,
    DistributedGradientAllreduceOptimizer,
    DistributedGradientTrackingOptimizer,
    DistributedHierarchicalNeighborAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer,
    DistributedWinPutOptimizer,
    ExactDiffusionOptimizer,
    GradientTrackingOptimizer,
    decentralized_optimizer,
    get_comm_every,
    set_comm_every,
)

"""Decentralized optimizers: ``torch.optim`` plus gossip."""

from bluefog_tpu_torch.optim.optimizers import (  # noqa: F401
    CommunicationType,
    DecentralizedOptimizer,
    DistributedGradientAllreduceOptimizer,
    DistributedHierarchicalNeighborAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer,
    DistributedWinPutOptimizer,
    decentralized_optimizer,
)

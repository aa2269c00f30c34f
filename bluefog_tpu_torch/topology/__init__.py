"""Virtual topologies and their gossip schedules (numpy only)."""

from bluefog_tpu_torch.topology.graphs import (  # noqa: F401
    ExponentialGraph,
    ExponentialTwoGraph,
    FullyConnectedGraph,
    GetRecvWeights,
    GetSendWeights,
    IsRegularGraph,
    IsTopologyEquivalent,
    MeshGrid2DGraph,
    RingGraph,
    StarGraph,
    SymmetricExponentialGraph,
    Topology,
)
from bluefog_tpu_torch.topology.schedule import (  # noqa: F401
    GossipSchedule,
    build_schedule,
)

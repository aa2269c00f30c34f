"""Virtual topologies, dynamic topology generators and their gossip
schedules (numpy; the aperiodic matrix builder returns a torch tensor)."""

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
    heal,
    replan,
    replan_penalized,
)
from bluefog_tpu_torch.topology.mapping import (  # noqa: F401
    ici_ring_order,
    remap_topology,
)
from bluefog_tpu_torch.topology.dynamic import (  # noqa: F401
    GetDynamicOnePeerSendRecvRanks,
    GetExp2DynamicSendRecvMachineRanks,
    GetInnerOuterExpo2DynamicSendRecvRanks,
    GetInnerOuterRingDynamicSendRecvRanks,
    dynamic_topologies_from_generator,
    one_peer_exp2_mixing_matrix,
    one_peer_exponential_two_schedules,
    one_peer_ring_schedules,
)
from bluefog_tpu_torch.topology.schedule import (  # noqa: F401
    GossipSchedule,
    build_schedule,
)

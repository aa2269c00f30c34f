"""Collectives and windows over rank-stacked tensors, and the kernels K1
(gossip) and K2 (window deliver)."""

from bluefog_tpu_torch.ops.collectives import (  # noqa: F401
    fuse_apply,
    fuse_plan,
    neighbor_allreduce,
)
from bluefog_tpu_torch.ops.gossip_kernel import (  # noqa: F401
    gossip_mix,
    gossip_mix_plain,
)
from bluefog_tpu_torch.ops.deliver_kernel import (  # noqa: F401
    window_deliver,
    window_deliver_plain,
)

"""Collectives over rank-stacked tensors and the gossip kernel K1."""

from bluefog_tpu_torch.ops.collectives import (  # noqa: F401
    fuse_apply,
    fuse_plan,
    neighbor_allreduce,
)
from bluefog_tpu_torch.ops.gossip_kernel import (  # noqa: F401
    gossip_mix,
    gossip_mix_plain,
)

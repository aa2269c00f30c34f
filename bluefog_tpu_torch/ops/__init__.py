"""Collectives and windows over rank-stacked tensors, local attention, and
the kernels K1 (gossip), K2 (window deliver) and K3 (flash attention)."""

from bluefog_tpu_torch.ops.collectives import (  # noqa: F401
    allgather,
    allreduce,
    barrier,
    broadcast,
    fuse_apply,
    fuse_plan,
    hierarchical_neighbor_allreduce,
    hierarchical_neighbor_allreduce_2d,
    neighbor_allgather,
    neighbor_allreduce,
    neighbor_allreduce_aperiodic,
    neighbor_allreduce_dynamic,
    pair_gossip,
)
from bluefog_tpu_torch.ops.gossip_kernel import (  # noqa: F401
    gossip_mix,
    gossip_mix_plain,
)
from bluefog_tpu_torch.ops.deliver_kernel import (  # noqa: F401
    window_deliver,
    window_deliver_plain,
)
from bluefog_tpu_torch.ops.flash_kernel import (  # noqa: F401
    flash_attention,
    flash_backward_dkv,
    flash_backward_dkv_plain,
    flash_backward_dq,
    flash_backward_dq_plain,
    flash_forward,
    flash_forward_plain,
)
from bluefog_tpu_torch.ops.ring_attention import local_attention  # noqa: F401

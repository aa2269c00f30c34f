"""Collectives and windows over rank-stacked tensors, local and
sequence-parallel attention, mixture-of-experts routing, and the kernels K1
(gossip), K2 (window deliver) and K3 (flash attention)."""

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
from bluefog_tpu_torch.ops.moe import (  # noqa: F401
    expert_parallel_ffn,
    moe_ffn_reference,
    switch_router,
    top2_router,
)
# ring_attention stays a module here (its function is
# ops.ring_attention.ring_attention): an export of that name would hide it
from bluefog_tpu_torch.ops.ring_attention import (  # noqa: F401
    all_to_all_attention,
    local_attention,
    zigzag_shard,
    zigzag_unshard,
)

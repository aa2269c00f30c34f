"""Array-level op API over rank-stacked tensors: the ``bf.*`` surface.

Counterpart of ``bluefog_tpu/parallel/api.py`` for :func:`rank_stack` and the
stacked-array :func:`neighbor_allreduce`.  As there, all ranks' values live in
one tensor with a leading ``size``-long rank axis: ``x[r]`` is rank ``r``'s
value.  The ranks are virtual, on the context's one device.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import _pytree as pytree

from bluefog_tpu_torch.ops import collectives as _C
from bluefog_tpu_torch.parallel.context import get_context
from bluefog_tpu_torch.topology.graphs import Topology
from bluefog_tpu_torch.topology.schedule import GossipSchedule, build_schedule

__all__ = ["rank_stack", "neighbor_allreduce"]


@functools.lru_cache(maxsize=256)
def _schedule_for(topology: Topology) -> GossipSchedule:
    # topologies hash by identity: repeated calls with one Topology object
    # reuse one schedule, and with it the schedule's cached device tables
    return build_schedule(topology)


def rank_stack(x, size: Optional[int] = None, device=None):
    """Replicate a value into the stacked per-rank representation: ``out[r]
    = x`` for every rank (pytree-polymorphic).  Each result is a fresh
    contiguous tensor, detached from ``x``, on ``device`` (default: the
    context's), so ranks can be updated in place independently."""
    if size is None or device is None:
        ctx = get_context()
        size = ctx.size if size is None else size
        device = ctx.device if device is None else device

    def one(leaf):
        leaf = torch.as_tensor(leaf).detach().to(device)
        return leaf.unsqueeze(0).expand(size, *leaf.shape).clone()

    return pytree.tree_map(one, x)


def neighbor_allreduce(x, *, topology=None, self_weight=None,
                       recv_weights=None, send_weights=None,
                       backend: str = "auto"):
    """Stacked-array ``bf.neighbor_allreduce``: ``out[i] = W[i,i] x[i] +
    sum_j W[i,j] x[j]`` with ``W`` from ``topology`` (default: the
    context's).  ``send_weights`` is the reference's per-call
    ``dst_weights``; see :func:`bluefog_tpu_torch.ops.collectives.
    neighbor_allreduce` for the weight shapes and backends."""
    if topology is None:
        sched = get_context().schedule
    elif isinstance(topology, Topology):
        sched = _schedule_for(topology)
    else:
        sched = topology
    return _C.neighbor_allreduce(x, sched, self_weight=self_weight,
                                 recv_weights=recv_weights,
                                 send_weights=send_weights, backend=backend)

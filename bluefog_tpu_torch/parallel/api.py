"""Array-level op API over rank-stacked tensors: the ``bf.*`` surface.

Counterpart of ``bluefog_tpu/parallel/api.py`` for :func:`rank_stack`, the
stacked-array :func:`neighbor_allreduce` and the name-keyed window registry
(``win_create`` ... ``win_update_then_collect``).  As there, all ranks'
values live in one tensor with a leading ``size``-long rank axis: ``x[r]`` is
rank ``r``'s value.  The ranks are virtual, on the context's one device.
``win_mutex`` is not ported yet (it comes with the host runtime).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import _pytree as pytree

from bluefog_tpu_torch.ops import collectives as _C
from bluefog_tpu_torch.ops import windows as _W
from bluefog_tpu_torch.parallel.context import get_context
from bluefog_tpu_torch.topology.graphs import Topology
from bluefog_tpu_torch.topology.schedule import GossipSchedule, build_schedule

__all__ = ["rank_stack", "neighbor_allreduce", "win_create", "win_free",
           "win_put", "win_accumulate", "win_get", "win_update",
           "win_update_then_collect"]


@functools.lru_cache(maxsize=256)
def _schedule_for(topology: Topology) -> GossipSchedule:
    # topologies hash by identity: repeated calls with one Topology object
    # reuse one schedule, and with it the schedule's cached device tables
    return build_schedule(topology)


def _sched(topology) -> GossipSchedule:
    if topology is None:
        return get_context().schedule
    if isinstance(topology, Topology):
        return _schedule_for(topology)
    return topology


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
    return _C.neighbor_allreduce(x, _sched(topology), self_weight=self_weight,
                                 recv_weights=recv_weights,
                                 send_weights=send_weights, backend=backend)


# ---------------------------------------------------------------------------
# Window registry (one-sided ops), keyed by name on the context
# ---------------------------------------------------------------------------


def _on_device(x):
    dev = get_context().device
    return pytree.tree_map(lambda t: torch.as_tensor(t).to(dev), x)


def win_create(x, name: str, *, topology=None, zero_init: bool = False
               ) -> bool:
    """Register window ``name`` over the stacked tensor(-tree) ``x``, on the
    context's device (reference ``bf.win_create``)."""
    x = _on_device(x)
    if zero_init:
        x = pytree.tree_map(torch.zeros_like, x)
    get_context().windows[name] = _W.win_create(x, _sched(topology),
                                                name=name)
    return True


def win_free(name: Optional[str] = None) -> bool:
    """Drop one window, or all of them when ``name`` is None (reference
    ``bf.win_free()``)."""
    ctx = get_context()
    if name is None:
        ctx.windows.clear()
    else:
        ctx.windows.pop(name, None)
    return True


def _get_win(name: str) -> _W.WindowState:
    ctx = get_context()
    if name not in ctx.windows:
        raise KeyError(f"no window named {name!r}; call win_create first")
    return ctx.windows[name]


def win_put(x, name: str, *, dst_weight=1.0) -> bool:
    """Put ``dst_weight * x`` into the out-neighbours' slots of ``name``
    (``x=None``: the window's self buffer)."""
    state = _get_win(name)
    _W.win_put(state, None if x is None else _on_device(x),
               dst_weight=dst_weight)
    return True


def win_accumulate(x, name: str, *, dst_weight=1.0) -> bool:
    """Add ``dst_weight * x`` into the out-neighbours' slots of ``name``."""
    state = _get_win(name)
    _W.win_accumulate(state, None if x is None else _on_device(x),
                      dst_weight=dst_weight)
    return True


def win_get(name: str) -> bool:
    """Pull the in-neighbours' published values into the slots of ``name``."""
    _W.win_get(_get_win(name))
    return True


def win_update(name: str, *, self_weight=None, recv_weights=None):
    """The stacked weighted average of ``name``'s self and landing buffers,
    which also becomes its self buffer (reference ``bf.win_update``)."""
    out, _ = _W.win_update(_get_win(name), self_weight=self_weight,
                           recv_weights=recv_weights)
    return out


def win_update_then_collect(name: str):
    """Sum of ``name``'s self and landing buffers; the slots are zeroed."""
    out, _ = _W.win_update_then_collect(_get_win(name))
    return out

"""Array-level op API over rank-stacked tensors: the ``bf.*`` surface.

Counterpart of ``bluefog_tpu/parallel/api.py`` for :func:`rank_stack`, the
stacked-array collectives (:func:`neighbor_allreduce`,
:func:`neighbor_allreduce_aperiodic`, :func:`neighbor_allgather`,
:func:`allreduce`, :func:`allgather`, :func:`broadcast`, :func:`barrier`,
:func:`hierarchical_neighbor_allreduce`),
the parameter-sync helpers of the reference's ``utility.py``
(:func:`broadcast_parameters`, :func:`allreduce_parameters`,
:func:`broadcast_optimizer_state`) and the name-keyed window registry
(``win_create`` ... ``win_update_then_collect``), and the nonblocking
host-op surface on the native engine (:func:`enqueue_host_op`,
:func:`poll`, :func:`synchronize`, :func:`wait_all_host_ops`).  As there, all ranks'
values live in one tensor with a leading ``size``-long rank axis: ``x[r]`` is
rank ``r``'s value.  The ranks are virtual, on the context's one device.
``win_mutex`` is not ported yet (it comes with the window server).

In a context that spans processes every stacked tensor is this process's
owned block of ``m`` ranks (``rank_stack`` makes one), and the collectives
(the aperiodic gossip and ``neighbor_allgather`` too), the parameter-sync
helpers and the windows act on it across the processes (see
:mod:`bluefog_tpu_torch.ops.transport`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils import _pytree as pytree

from bluefog_tpu_torch.ops import collectives as _C
from bluefog_tpu_torch.ops import transport as _T
from bluefog_tpu_torch.ops import windows as _W
from bluefog_tpu_torch.parallel.context import get_context
from bluefog_tpu_torch.topology.schedule import GossipSchedule

__all__ = ["rank_stack", "rank_shard", "neighbor_allreduce", "neighbor_allreduce_aperiodic",
           "neighbor_allgather",
           "allreduce", "allgather", "broadcast", "barrier",
           "hierarchical_neighbor_allreduce", "broadcast_parameters",
           "allreduce_parameters", "broadcast_optimizer_state", "win_create",
           "win_free", "win_put", "win_accumulate", "win_get", "win_update",
           "win_update_then_collect", "enqueue_host_op", "poll",
           "synchronize", "wait_all_host_ops"]


def _sched(topology) -> GossipSchedule:
    if topology is None:
        return get_context().schedule
    # a Topology is lowered once per object, keeping its device tables
    return _C._as_schedule(topology)


def rank_stack(x, size: Optional[int] = None, device=None):
    """Replicate a value into the stacked per-rank representation: ``out[r]
    = x`` for every rank (pytree-polymorphic) this process holds: all of
    them in one process, its owned block over several.  Each result is a
    fresh contiguous tensor, detached from ``x``, on ``device`` (default:
    the context's), so ranks can be updated in place independently."""
    if size is None or device is None:
        ctx = get_context()
        size = _T.owned_rows(ctx.size) if size is None else size
        device = ctx.device if device is None else device

    def one(leaf):
        leaf = torch.as_tensor(leaf).detach().to(device)
        return leaf.unsqueeze(0).expand(size, *leaf.shape).clone()

    return pytree.tree_map(one, x)


def rank_shard(x):
    """Place a stacked tree so its rank axis lies on the context (reference
    ``api.py::rank_shard``): every leaf on the context's device; over
    processes, a leaf that carries all ``size`` ranks keeps the rows this
    process owns (a leaf already cut to them stays as it is)."""
    ctx = get_context()
    start, rows = _T.owned_start(ctx.size), _T.owned_rows(ctx.size)

    def one(leaf):
        leaf = torch.as_tensor(leaf).to(ctx.device)
        if leaf.dim() == 0 or leaf.shape[0] not in (ctx.size, rows):
            raise ValueError(f"a stacked leaf has {ctx.size} (or, over "
                             f"processes, {rows}) ranks first; got shape "
                             f"{tuple(leaf.shape)}")
        if leaf.shape[0] == ctx.size and rows != ctx.size:
            leaf = leaf[start:start + rows].contiguous()
        return leaf

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


def neighbor_allreduce_aperiodic(x, mixing_matrix, *,
                                 max_rotations: Optional[int] = None):
    """Stacked-array gossip with an arbitrary per-call topology: ``out = W @
    x`` over the rank axis for any row-stochastic ``(size, size)`` ``W``
    held on the host; edge set and weights may change every call.
    ``max_rotations`` caps the active rotations (more poison the output with
    NaN); see :func:`bluefog_tpu_torch.ops.collectives.
    neighbor_allreduce_aperiodic`.  Over several processes ``x`` is the
    owned block and every process passes the same whole matrix."""
    return _C.neighbor_allreduce_aperiodic(x, mixing_matrix,
                                           max_rotations=max_rotations)


def neighbor_allgather(x: torch.Tensor, *, topology=None):
    """Stacked ``bf.neighbor_allgather``: ``(slots, mask)``; see
    :func:`bluefog_tpu_torch.ops.collectives.neighbor_allgather` for the
    padding to ``K`` slots."""
    return _C.neighbor_allgather(x, _sched(topology))


def allreduce(x, *, average: bool = True):
    """Stacked ``bf.allreduce``: every rank gets the mean (or sum) of all
    ranks' values."""
    return _C.allreduce(x, average=average)


def allgather(x):
    """Stacked ``bf.allgather``: every rank's row becomes the full stack,
    ``(size, size, ...)`` for leaves of shape ``(size, ...)``."""
    return _C.allgather(x)


def broadcast(x, root_rank: int = 0):
    """Stacked ``bf.broadcast``: every rank gets ``root_rank``'s value."""
    return _C.broadcast(x, root_rank)


def barrier() -> bool:
    """Wait for the work queued on the context's device, and over several
    processes for every process."""
    return _C.barrier(get_context().device)


def hierarchical_neighbor_allreduce(x, *, machine_topology=None,
                                    self_weight=None, recv_weights=None,
                                    two_level_mesh: bool = False,
                                    backend: str = "auto"):
    """Stacked ``bf.hierarchical_neighbor_allreduce``: the exact average
    within each machine of ``init(local_size=...)``, then gossip between
    machines along ``machine_topology`` (default: the context's).
    ``two_level_mesh`` selects the reference's ``(machine, local)`` mesh
    form, whose local average does not round bf16/f16 sums to the leaf's
    dtype; see :mod:`bluefog_tpu_torch.ops.collectives`."""
    ctx = get_context()
    msched = machine_topology
    if msched is None:
        if ctx.machine_schedule is None:
            raise RuntimeError(
                "no machine topology: init(local_size=...) first")
        msched = ctx.machine_schedule
    fn = (_C.hierarchical_neighbor_allreduce_2d if two_level_mesh
          else _C.hierarchical_neighbor_allreduce)
    return fn(x, _sched(msched), local_size=ctx.local_size,
              self_weight=self_weight, recv_weights=recv_weights,
              backend=backend)


# ---------------------------------------------------------------------------
# Parameter-sync helpers (reference bluefog/torch/utility.py)
# ---------------------------------------------------------------------------


def broadcast_parameters(params, root_rank: int = 0):
    """Every rank's parameters become ``root_rank``'s (reference
    ``bf.broadcast_parameters``)."""
    return broadcast(params, root_rank)


def allreduce_parameters(params):
    """Every rank's parameters become the ranks' average (reference
    ``bf.allreduce_parameters``); integer leaves keep their dtype."""
    return allreduce(params, average=True)


def broadcast_optimizer_state(state, root_rank: int = 0):
    """Broadcast every rank-stacked tensor of an optimizer state, such as a
    ``torch.optim`` state dict (reference ``bf.broadcast_optimizer_state``).
    Tensors without the context's leading rank axis (a step count) and
    non-tensor entries (hyper-parameters) pass through unchanged."""
    n = _T.owned_rows(get_context().size)

    def one(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.dim() > 0
                and leaf.shape[0] == n):
            return _C.broadcast(leaf, root_rank)
        return leaf

    return pytree.tree_map(one, state)


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
    ``bf.win_free()``), and free its memory: over several processes on the
    card its peer memory now, in every process (collective, see
    :func:`bluefog_tpu_torch.ops.windows.win_free`)."""
    ctx = get_context()
    names = list(ctx.windows) if name is None else [name]
    for key in names:
        state = ctx.windows.pop(key, None)
        if state is not None:
            _W.win_free(state)
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


# -- the nonblocking host-op surface (reference bluefog/torch/mpi_ops.py
# poll / synchronize over its handle manager).  The card's work is
# asynchronous on its streams by construction, so the handles here track
# host ops (checkpoint IO, metric flushes) on the engine thread of
# runtime/native.py.


def enqueue_host_op(fn, *, op: str = "host_op", name: str = "") -> int:
    """Run ``fn()`` on the background engine thread; returns a handle."""
    from bluefog_tpu_torch.runtime.native import engine

    return engine().enqueue(fn, op=op, name=name)


def poll(handle: int) -> bool:
    """True once the host op behind ``handle`` has completed."""
    from bluefog_tpu_torch.runtime.native import engine

    return engine().poll(handle)


def synchronize(handle: int, timeout_s=None):
    """Block until the host op completes and clear its handle (reference
    ``bf.synchronize`` = WaitAndClear).  Raises the op's exception again."""
    from bluefog_tpu_torch.runtime.native import engine

    return engine().synchronize(handle, timeout_s=timeout_s)


def wait_all_host_ops(timeout_s=None):
    """Drain every pending host op (before shutdown or a checkpoint)."""
    from bluefog_tpu_torch.runtime.native import engine

    return engine().wait_all(timeout_s=timeout_s)

"""Mesh axes over ranks, and the collectives along one of them.

The JAX package runs its sequence-, tensor-, pipeline- and expert-parallel
code inside ``shard_map`` over a multi-axis mesh (``parallel/tensor.py::
make_hybrid_mesh``): each device holds its local block, and a collective
(``psum``, ``ppermute``, ``all_to_all``, ``all_gather``) moves blocks along
one named axis.  Here a tensor carries the group's ranks on its leading
dimensions, one per mesh axis, outermost first (``(*mesh.shape, *local)``),
so that ``x[i, j]`` is the block of the rank at mesh position ``(i, j)``.

**One process.**  Every rank of the mesh is a row of this process's
tensors, and a collective along an axis is a tensor operation on that
axis's dimension:

================  ===========================================================
``lax.psum``      a sum over the dimension, broadcast back (:func:`psum`)
``lax.ppermute``  an index of the dimension (:func:`ppermute`, :func:`shift`)
``all_to_all``    a reshape and a transpose (:func:`all_to_all`)
``all_gather``    a concatenation, broadcast back (:func:`all_gather`)
================  ===========================================================

**Over processes.**  In a context that spans ``P`` processes (``bfrun``),
each process owns a contiguous block of ranks, and its tensors carry only
the mesh positions of its ranks: for a row-major mesh, some outer axes at
one index, one axis in part (a contiguous range of its indices) and the
inner axes whole.  :meth:`Mesh.axis` then says which part of the axis the
leading dimension holds (:attr:`Axis.start`, :attr:`Axis.count`) and which
processes hold the rest of each group (:attr:`Axis.groups`).  An axis held
whole runs as in one process.  Along an axis held in part, each collective
moves rows through :mod:`bluefog_tpu_torch.ops.transport` (peer memory on
the card, gloo on the CPU): every process stages its rows, and each reads
from its group's processes the rows it needs (:func:`_gather_rows`).  As in
``shard_map``, every process calls every collective, in the same order.

Autograd through them computes what JAX computes under ``shard_map`` with
``check_vma=False``: the gradient of the sum over ranks of each rank's
output.  In one process that is autograd through the tensor operations;
over processes each collective is an ``autograd.Function`` whose backward is
the transposed collective: ``psum``'s a ``psum``, ``ppermute``'s the inverse
permutation, ``all_to_all``'s the inverse ``all_to_all`` and
``all_gather``'s a reduce-scatter.  A ``psum`` over processes sums the
group's blocks in rank order, so a group of two gives the bits of the
one-process form.

An :class:`Axis` names one axis, its size and the tensor dimension that
carries it; dimensions of a rank's own block are given from the end
(negative), so they hold whatever number of mesh dimensions lead.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Axis", "Mesh", "ici_ring_order", "make_hybrid_mesh", "psum",
           "pmean", "ppermute", "shift", "all_to_all", "all_gather",
           "blocks", "reduce_partials", "COLLECTIVE_STATS",
           "reset_collective_stats"]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis: its ``name``, its ``size`` and the tensor dimension
    ``dim`` that carries its ranks (a leading dimension).

    Over processes (see the module docstring) ``count`` is the number of the
    axis's indices this process holds, from ``start``, and ``groups[q]``
    lists, in axis order, the processes that hold process ``q``'s group
    along the axis (each ``count`` indices).  ``count`` None: the whole
    axis is here."""

    name: str
    size: int
    dim: int = 0
    start: int = 0
    count: Optional[int] = None
    groups: Optional[Tuple[Tuple[int, ...], ...]] = None

    @property
    def local(self) -> int:
        """How many of the axis's ranks the tensor dimension holds."""
        return self.size if self.count is None else self.count

    @property
    def spans_processes(self) -> bool:
        return self.count is not None and self.count < self.size

    def local_ranks(self) -> range:
        """The axis indices of the tensor dimension's rows."""
        return range(self.start, self.start + self.local)

    def at(self, dim: int) -> "Axis":
        """The same axis carried on tensor dimension ``dim``."""
        return dataclasses.replace(self, dim=dim)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, outermost first, over the ranks ``ranks`` (a
    numpy array of rank ids of shape :attr:`shape`): the port's counterpart
    of the ``jax.sharding.Mesh`` that ``make_hybrid_mesh`` returns."""

    axis_names: Tuple[str, ...]
    ranks: np.ndarray

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.ranks.shape)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def owned(self) -> Tuple[slice, ...]:
        """The index block of the mesh whose ranks this process holds: the
        whole mesh in one process (see the module docstring)."""
        procs = _process_layout()
        if procs is None:
            return tuple(slice(0, s) for s in self.shape)
        return _owned_block(self.ranks, procs[0], procs[2])

    def axis(self, name: str, dim: Optional[int] = None) -> Axis:
        """The :class:`Axis` of ``name`` on tensors whose leading dimensions
        are this mesh's (or on dimension ``dim``, for a tensor that keeps
        only some of them), with its part over processes."""
        i = self.axis_names.index(name)
        ax = Axis(name, self.shape[i], i if dim is None else dim)
        procs = _process_layout()
        if procs is None:
            return ax
        me, count, per = procs
        blocks = [_owned_block(self.ranks, q, per) for q in range(count)]
        mine = blocks[me][i]
        c = mine.stop - mine.start
        if c == self.shape[i]:
            return ax
        groups = []
        for q, blk in enumerate(blocks):
            pos = [s.start for s in blk]
            grp = []
            for j in range(0, self.shape[i], c):
                pos[i] = j
                grp.append(int(self.ranks[tuple(pos)]) // per)
            if grp[blk[i].start // c] != q:
                raise ValueError(f"axis {name!r}: process {q}'s block does "
                                 "not tile the mesh")
            groups.append(tuple(grp))
        return dataclasses.replace(ax, start=mine.start, count=c,
                                   groups=tuple(groups))


def _process_layout() -> Optional[Tuple[int, int, int]]:
    """``(this process, processes, ranks a process)`` in a context that
    spans processes; None in one process."""
    from bluefog_tpu_torch.ops import transport as _T

    tr = _T.active()
    if tr is None:
        return None
    from bluefog_tpu_torch.parallel.context import get_context

    return tr.process, tr.processes, get_context().size // tr.processes


def _owned_block(ranks: np.ndarray, q: int, per: int) -> Tuple[slice, ...]:
    """The box of mesh positions whose ranks process ``q`` owns (ranks
    ``[q per, (q+1) per)``); raises unless they form one box that holds
    every position of those ranks on the mesh."""
    mask = (ranks // per) == q
    if not mask.any():
        raise ValueError(f"process {q} owns no rank of the mesh: a mesh over "
                         "processes must cover every process")
    idx = np.nonzero(mask)
    box = tuple(slice(int(a.min()), int(a.max()) + 1) for a in idx)
    if int(mask[box].sum()) != int(mask.sum()) or not mask[box].all():
        raise ValueError(f"process {q}'s ranks are not one box of the mesh "
                         f"{ranks.tolist()}")
    return box


def ici_ring_order(ranks: Sequence[int]) -> list:
    """The JAX package's ``topology/mapping.py::ici_ring_order`` on one
    card, where every rank is a row of the same memory: the identity."""
    return list(ranks)


def make_hybrid_mesh(axes: Mapping[str, int], *,
                     ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A :class:`Mesh` from ``{name: size}`` pairs, outermost first, over
    ``ranks`` (default: the context's ``0 .. size-1``) in
    :func:`ici_ring_order`; raises when the axes need more ranks than there
    are (reference ``parallel/tensor.py::make_hybrid_mesh``)."""
    if ranks is None:
        from bluefog_tpu_torch.parallel.context import get_context

        ranks = range(get_context().size)
    ranks = ici_ring_order(ranks)
    names = tuple(axes.keys())
    sizes = tuple(int(axes[n]) for n in names)
    need = int(np.prod(sizes, dtype=np.int64))
    if need > len(ranks):
        raise ValueError(f"mesh {dict(axes)} needs {need} ranks, have "
                         f"{len(ranks)}")
    return Mesh(names, np.asarray(ranks[:need]).reshape(sizes))


# ---------------------------------------------------------------------------
# Rows between the processes of an axis group
# ---------------------------------------------------------------------------

# per collective: calls, bytes read from other processes' rows, bytes read
# from this process's own rows, and host seconds inside the transport
COLLECTIVE_STATS: Dict[str, Dict[str, float]] = {}


def reset_collective_stats() -> None:
    COLLECTIVE_STATS.clear()


_SCHEDULES: Dict[tuple, object] = {}


def _schedule(axis: Axis, rows: int, slots: int,
              table: Callable[[int, int], Sequence[Optional[Tuple[int,
                                                                   int]]]],
              key) -> object:
    """A :class:`~bluefog_tpu_torch.topology.schedule.GossipSchedule` over
    the global row space (process ``q``'s ``rows`` rows at ``q * rows``),
    in which row ``i`` of the process at group position ``g`` reads, in slot
    ``k``, row ``i'`` of the process at position ``g'`` for ``table(g, i)[k]
    = (g', i')`` (None: nothing).  Cached by ``key``."""
    from bluefog_tpu_torch.topology.schedule import GossipSchedule

    full = (axis.name, axis.size, axis.count, axis.groups, rows, slots, key)
    sched = _SCHEDULES.get(full)
    if sched is None:
        procs = len(axis.groups)
        src = np.full((procs * rows, slots), -1, np.int32)
        for q, grp in enumerate(axis.groups):
            g = grp.index(q)
            for i in range(rows):
                for k, s in enumerate(table(g, i)):
                    if s is not None:
                        src[q * rows + i, k] = grp[s[0]] * rows + s[1]
        sched = GossipSchedule(
            size=procs * rows, perms=tuple(() for _ in range(slots)),
            self_weights=np.zeros(procs * rows, np.float32),
            recv_weights=np.zeros((procs * rows, slots), np.float32),
            recv_src=src, is_circulant=False, name=f"axis:{axis.name}")
        _SCHEDULES[full] = sched
    return sched


def _gather_rows(op: str, axis: Axis, flat: torch.Tensor, slots: int,
                 table, key) -> torch.Tensor:
    """``(R, L)`` rows of this process -> ``(R, slots, L)``: what each row
    reads from the axis group (see :func:`_schedule`), zeros where it reads
    nothing.  Collective over every process."""
    from bluefog_tpu_torch.ops import transport as _T

    tr = _T.active()
    if tr is None:
        raise RuntimeError(f"axis {axis.name!r} spans processes, but no "
                           "transport is active")
    flat = flat.contiguous()
    rows = flat.shape[0]
    sched = _schedule(axis, rows, slots, table, key)
    t0 = time.perf_counter()
    with tr.exchange(sched, [flat]) as (peer,):
        zero, views = None, []
        for row in peer.views:
            for v in row:
                if v is None:
                    if zero is None:
                        zero = flat.new_zeros(flat.shape[1])
                    v = zero
                views.append(v)
        out = torch.stack(views).view(rows, slots, flat.shape[1])
    start = tr.start(sched.size)
    src = sched.recv_src[start:start + rows]
    remote = int(((src >= 0) & ((src < start) | (src >= start + rows))).sum())
    local = int(((src >= start) & (src < start + rows)).sum())
    row_bytes = flat.shape[1] * flat.element_size()
    st = COLLECTIVE_STATS.setdefault(op, {"calls": 0, "remote_bytes": 0,
                                          "local_bytes": 0, "host_s": 0.0})
    st["calls"] += 1
    st["remote_bytes"] += remote * row_bytes
    st["local_bytes"] += local * row_bytes
    st["host_s"] += time.perf_counter() - t0
    return out


def _rows_of(x: torch.Tensor, axis: Axis) -> Tuple[torch.Tensor, tuple]:
    """``x`` with the axis first, as ``(count, L)`` rows, and the shape to
    restore."""
    if x.shape[axis.dim] != axis.local:
        raise ValueError(f"axis {axis.name!r} holds {axis.local} of its "
                         f"{axis.size} ranks here, the tensor "
                         f"{x.shape[axis.dim]} on dimension {axis.dim}")
    xs = x.movedim(axis.dim, 0)
    return xs.reshape(axis.local, -1), tuple(xs.shape)


def _all_blocks(x: torch.Tensor, axis: Axis, op: str) -> torch.Tensor:
    """Every block of the group along the axis, ``(size, *rest)``, with the
    axis's dimension moved first (read once a process)."""
    flat, shape = _rows_of(x, axis)
    per = axis.size // axis.local
    # a process's rows as one: the group's processes in order are the axis
    got = _gather_rows(op, axis, flat.reshape(1, -1), per,
                       lambda g, i: [(j, 0) for j in range(per)], "all")
    return got[0].view(axis.size, *shape[1:])


def _psum_x(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    whole = _all_blocks(x, axis, "psum").sum(0)
    return whole.unsqueeze(0).expand(axis.local, *whole.shape).movedim(
        0, axis.dim)


def _ppermute_x(x: torch.Tensor, axis: Axis,
                perm: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    src = [-1] * axis.size
    for s, d in perm:
        src[d] = s
    c = axis.local
    flat, shape = _rows_of(x, axis)

    def table(g, i):
        s = src[g * c + i]
        return [None if s < 0 else (s // c, s % c)]

    got = _gather_rows("ppermute", axis, flat, 1, table, ("perm", perm))
    return got.view(shape).movedim(0, axis.dim)


def _exchange_chunks(x: torch.Tensor, axis: Axis, split: int, tiled: bool,
                     op: str) -> Tuple[torch.Tensor, int]:
    """The all-to-all's move: each rank's block cut along block dimension
    ``split`` (``n`` chunks, or ``n`` indices untiled), chunk ``j`` to rank
    ``j``.  Returns ``(y, s)``: ``y`` with the destination rank first and
    the source rank at dimension ``s`` (the split's position, the chunk's
    remaining width after it when tiled)."""
    n, c = axis.size, axis.local
    xs = x.movedim(axis.dim, 0)
    if xs.shape[0] != c:
        raise ValueError(f"axis {axis.name!r} holds {c} ranks here, the "
                         f"tensor {xs.shape[0]}")
    s = xs.dim() + split
    if tiled:
        if xs.shape[s] % n:
            raise ValueError(f"dimension {split} of size {xs.shape[s]} does "
                             f"not split over {n} ranks")
        xs = xs.unflatten(s, (n, xs.shape[s] // n))
    elif xs.shape[s] != n:
        raise ValueError(f"untiled all_to_all splits a dimension of the "
                         f"axis size {n}, got {xs.shape[s]}")
    chunks = xs.movedim(s, 1).contiguous()          # (c, chunk j, ...)
    flat = chunks.view(c * n, -1)

    def table(g, i):
        a, j = divmod(i, n)                         # rank g c + a, from j
        return [(j // c, (j % c) * n + g * c + a)]

    got = _gather_rows(op, axis, flat, 1, table, "a2a")
    y = got.view(chunks.shape)                      # (c, source j, ...)
    return y.movedim(1, s), s


def _all_to_all_x(x, axis: Axis, split: int, concat: int,
                  tiled: bool) -> torch.Tensor:
    y, s = _exchange_chunks(x, axis, split, tiled, "all_to_all")
    nd = x.dim()
    if not tiled:
        y = y if split == concat else y.movedim(s, nd + concat)
    else:
        cc = nd + concat
        y = y.movedim(s, cc).flatten(cc, cc + 1)
    return y.movedim(0, axis.dim)


def _all_gather_x(x, axis: Axis, dim: int) -> torch.Tensor:
    blocks_ = _all_blocks(x, axis, "all_gather")
    full = torch.cat(blocks_.unbind(0), dim=dim)
    return full.unsqueeze(0).expand(axis.local, *full.shape).movedim(
        0, axis.dim)


def _reduce_scatter_x(g, axis: Axis, dim: int) -> torch.Tensor:
    """The transpose of :func:`all_gather` along block dimension ``dim``:
    rank ``i`` gets the sum over the ranks of their chunk ``i``, in rank
    order."""
    y, s = _exchange_chunks(g, axis, dim, True, "reduce_scatter")
    return y.sum(s).movedim(0, axis.dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _psum_x(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _psum_x(g, ctx.axis), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _ppermute_x(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _ppermute_x(g, ctx.axis, inverse), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split, concat, tiled):
        ctx.args = (axis, split, concat, tiled)
        return _all_to_all_x(x, axis, split, concat, tiled)

    @staticmethod
    def backward(ctx, g):
        axis, split, concat, tiled = ctx.args
        return (_all_to_all_x(g, axis, concat, split, tiled), None, None,
                None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather_x(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_x(g, ctx.axis, ctx.dim), None, None


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.psum``: every rank of the axis gets the sum of their blocks."""
    if axis.spans_processes:
        return _PSum.apply(x, axis)
    return x.sum(axis.dim, keepdim=True).expand_as(x)


def pmean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.pmean``."""
    if axis.spans_processes:
        return _PSum.apply(x, axis) / axis.size
    return x.mean(axis.dim, keepdim=True).expand_as(x)


def ppermute(x: torch.Tensor, axis: Axis,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: rank ``dst`` gets the block of rank ``src`` for
    each ``(src, dst)`` in ``perm``; a rank no pair reaches gets zeros."""
    if axis.spans_processes:
        return _PPermute.apply(x, axis, tuple((int(s), int(d))
                                              for s, d in perm))
    src = [-1] * axis.size
    for s, d in perm:
        src[d] = s
    if all(s >= 0 for s in src):
        return x.index_select(axis.dim, torch.tensor(src, device=x.device))
    idx = torch.tensor([max(s, 0) for s in src], device=x.device)
    keep = torch.tensor([s >= 0 for s in src], device=x.device)
    shape = [1] * x.dim()
    shape[axis.dim] = axis.size
    return torch.where(keep.view(shape), x.index_select(axis.dim, idx), 0)


def shift(x: torch.Tensor, axis: Axis, k: int = 1) -> torch.Tensor:
    """The ring ``ppermute`` ``[(i, (i + k) % n)]``: rank ``r`` gets the
    block of rank ``r - k``."""
    if axis.spans_processes:
        n = axis.size
        return ppermute(x, axis, [(i, (i + k) % n) for i in range(n)])
    return torch.roll(x, k, dims=axis.dim)


def all_to_all(x: torch.Tensor, axis: Axis, split: int, concat: int, *,
               tiled: bool = False) -> torch.Tensor:
    """``lax.all_to_all``: a rank's block is cut along its dimension
    ``split`` into one chunk per rank, chunk ``j`` goes to rank ``j``, and
    each rank joins what it received along ``concat``, in source order.
    ``split`` and ``concat`` are dimensions of the block, counted from the
    end (negative).  Untiled, ``split`` has the axis's size and the received
    chunks stack along ``concat`` (which then has that size); tiled, the
    chunks are ``1/n`` of ``split`` and concatenate along ``concat``."""
    if split >= 0 or concat >= 0:
        raise ValueError("all_to_all takes block dimensions counted from the "
                         f"end, got split={split}, concat={concat}")
    if axis.spans_processes:
        return _AllToAll.apply(x, axis, split, concat, tiled)
    n, nd = axis.size, x.dim()
    if not tiled:
        if x.shape[split] != n:
            raise ValueError(f"untiled all_to_all splits a dimension of the "
                             f"axis size {n}, got {x.shape[split]}")
        # chunk j of rank r moves to rank j, where it sits at index r
        y = x.transpose(axis.dim, nd + split)
        return y if split == concat else y.movedim(nd + split, nd + concat)
    if x.shape[split] % n:
        raise ValueError(f"dimension {split} of size {x.shape[split]} does "
                         f"not split over {n} ranks")
    s, c = nd + split, nd + concat
    y = x.unflatten(s, (n, x.shape[s] // n))            # chunk index at s
    y = y.transpose(axis.dim, s)                        # dst leads, src at s
    # src moves to concat's index, which puts it just before concat whether
    # concat came before or after the new dimension
    return y.movedim(s, c).flatten(c, c + 1)


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: every rank gets the blocks of
    all ranks concatenated along its block dimension ``dim`` (from the
    end)."""
    if dim >= 0:
        raise ValueError(f"all_gather takes a block dimension counted from "
                         f"the end, got {dim}")
    if axis.spans_processes:
        return _AllGather.apply(x, axis, dim)
    full = torch.cat(x.unbind(axis.dim), dim=dim)
    return full.unsqueeze(axis.dim).expand(
        *full.shape[:axis.dim], axis.size, *full.shape[axis.dim:])


def blocks(x: torch.Tensor, axis: Axis) -> List[torch.Tensor]:
    """The group's ``size`` blocks along the axis, in axis order, each
    without the axis's dimension (no gradient): the shards a gather
    reassembles."""
    with torch.no_grad():
        if axis.spans_processes:
            got = _all_blocks(x, axis, "blocks")
            return [b for b in got.unbind(0)]
        return list(x.unbind(axis.dim))


def reduce_partials(parts: Sequence[torch.Tensor],
                    axis: Axis) -> List[torch.Tensor]:
    """Each of ``parts`` summed over the processes of the axis group, in
    process order: for a value every process computes as a partial over its
    own ranks, such as a replicated parameter's gradient through the
    ranks it holds.  In one process (the axis whole here) they are already
    whole.  No gradient; the parts travel as one payload per dtype."""
    parts = list(parts)
    if not axis.spans_processes or not parts:
        return parts
    per = axis.size // axis.local
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, p in enumerate(parts):
        by_dtype.setdefault(p.dtype, []).append(i)
    with torch.no_grad():
        for idx in by_dtype.values():
            flat = torch.cat([parts[i].reshape(1, -1) for i in idx], dim=1)
            got = _gather_rows("reduce_partials", axis, flat, per,
                               lambda g, i: [(j, 0) for j in range(per)],
                               "partials")
            total = got[0].sum(0)
            off = 0
            for i in idx:
                n = parts[i].numel()
                out[i] = total[off:off + n].view(parts[i].shape)
                off += n
    return out

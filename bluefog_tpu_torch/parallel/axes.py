"""Mesh axes over virtual ranks, and the collectives along one of them.

The JAX package runs its sequence-, tensor-, pipeline- and expert-parallel
code inside ``shard_map`` over a multi-axis mesh (``parallel/tensor.py::
make_hybrid_mesh``): each device holds its local block, and a collective
(``psum``, ``ppermute``, ``all_to_all``, ``all_gather``) moves blocks along
one named axis.  Here the ranks of such a group are virtual, as everywhere
in the port: a tensor carries the group's ranks on its leading dimensions,
one per mesh axis, outermost first (``(*mesh.shape, *local)``), so that
``x[i, j]`` is the block of the rank at mesh position ``(i, j)``.  A
collective along an axis is then a tensor operation on that axis's
dimension:

================  ===========================================================
``lax.psum``      a sum over the dimension, broadcast back (:func:`psum`)
``lax.ppermute``  an index of the dimension (:func:`ppermute`, :func:`shift`)
``all_to_all``    a reshape and a transpose (:func:`all_to_all`)
``all_gather``    a concatenation, broadcast back (:func:`all_gather`)
================  ===========================================================

Autograd through them computes what JAX computes under ``shard_map`` with
``check_vma=False``: the gradient of the sum over ranks of each rank's
output, so a ``psum``'s backward is again a ``psum``.  Every collective of
this slice goes through this module, so that a later slice can route them
through :mod:`bluefog_tpu_torch.ops.transport` when the ranks of a group
live in several processes.

An :class:`Axis` names one axis, its size and the tensor dimension that
carries it; dimensions of a rank's own block are given from the end
(negative), so they hold whatever number of mesh dimensions lead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Axis", "Mesh", "ici_ring_order", "make_hybrid_mesh", "psum",
           "pmean", "ppermute", "shift", "all_to_all", "all_gather"]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis: its ``name``, its ``size`` and the tensor dimension
    ``dim`` that carries its ranks (a leading dimension)."""

    name: str
    size: int
    dim: int = 0


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

    def axis(self, name: str) -> Axis:
        """The :class:`Axis` of ``name`` on tensors whose leading dimensions
        are this mesh's."""
        i = self.axis_names.index(name)
        return Axis(name, self.shape[i], i)


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


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.psum``: every rank of the axis gets the sum of their blocks."""
    return x.sum(axis.dim, keepdim=True).expand_as(x)


def pmean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.pmean``."""
    return x.mean(axis.dim, keepdim=True).expand_as(x)


def ppermute(x: torch.Tensor, axis: Axis,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: rank ``dst`` gets the block of rank ``src`` for
    each ``(src, dst)`` in ``perm``; a rank no pair reaches gets zeros."""
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
    full = torch.cat(x.unbind(axis.dim), dim=dim)
    return full.unsqueeze(axis.dim).expand(
        *full.shape[:axis.dim], axis.size, *full.shape[axis.dim:])

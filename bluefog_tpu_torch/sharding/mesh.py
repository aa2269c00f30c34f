"""Gossip-of-meshes geometry: each gossip rank is a whole mesh.

Counterpart of ``bluefog_tpu/sharding/mesh.py``.  The hybrid mesh is
``('bf', <inner axes...>)``: the outer ``bf`` axis carries the decentralized
data-parallel gossip (``neighbor_allreduce`` and window deposits between
ranks), the inner axes (``fsdp``/``tp``/``pp``) shard each rank's model
within its mesh.  This module holds the geometry both sides share:

- the tensors (:class:`GossipMesh`): :meth:`GossipMesh.mesh` is the port's
  :class:`~bluefog_tpu_torch.parallel.axes.Mesh` with the gossip axis
  outermost, the layout ``(bf, *inner, *local)`` every stacked leaf takes
  (the reference's ``jax_mesh`` and ``abstract``);
- the slices (:func:`shard_shape`, :func:`shard_slices`,
  :class:`ShardView`): numpy arithmetic for a leaf's shard under a
  :class:`~bluefog_tpu_torch.sharding.rules.RuleTable` spec.  A deposit
  moves ``shard_bytes``, never ``full_bytes``, and the two differ by exactly
  ``prod(sizes of mentioned axes)``.

Coordinates are dicts ``{axis_name: index}``; a leaf dimension whose spec
entry names several axes (``('fsdp', 'tp')``) is split row-major in the
listed order, as XLA's ``NamedSharding`` splits it.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from torch.utils import _pytree as pytree

from bluefog_tpu_torch.sharding.rules import PartitionSpec, spec_entry_axes

__all__ = [
    "GossipMesh",
    "ShardView",
    "num_shards",
    "inner_coords",
    "shard_shape",
    "shard_slices",
    "shard_size_ratio",
    "spec_leaves",
]


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def spec_leaves(specs, template=None) -> List[PartitionSpec]:
    """The specs of a spec tree, flattened in the order of ``template``'s
    leaves (which must be as many when given)."""
    flat = pytree.tree_leaves(specs, is_leaf=_is_spec)
    if template is not None:
        n = len(pytree.tree_leaves(template))
        if len(flat) != n:
            raise ValueError(f"spec tree has {len(flat)} leaves, template {n}")
    return flat


def _spec_entries(spec, ndim: int) -> List[Tuple[str, ...]]:
    """Per-dimension axis tuples, padded with replicated entries to
    ``ndim``."""
    entries = [spec_entry_axes(e) for e in tuple(spec)]
    if len(entries) > ndim:
        raise ValueError(
            f"spec {spec} has {len(entries)} entries for a {ndim}-d leaf")
    entries += [()] * (ndim - len(entries))
    return entries


def num_shards(axes: Mapping[str, int]) -> int:
    """The inner mesh's size: how many shards one rank's mesh holds."""
    n = 1
    for s in axes.values():
        n *= int(s)
    return n


def inner_coords(axes: Mapping[str, int]) -> List[Dict[str, int]]:
    """Every inner-mesh coordinate, row-major in ``axes``'s key order: the
    order shard ids take everywhere."""
    names = list(axes.keys())
    return [dict(zip(names, idx))
            for idx in itertools.product(*(range(int(axes[n]))
                                           for n in names))]


def shard_shape(shape: Sequence[int], spec,
                axes: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape of one shard of a ``shape`` leaf under ``spec``.  Every
    mentioned axis must divide its dimension evenly: ragged shards are
    refused.  An axis the mesh does not have counts as one shard, so
    ``axes={}`` gives the gathered single-mesh shape of any spec."""
    shape = tuple(int(s) for s in shape)
    out = []
    for dim, entry in zip(shape, _spec_entries(spec, len(shape))):
        div = 1
        for ax in entry:
            div *= int(axes.get(ax, 1))
        if dim % div:
            raise ValueError(
                f"dim {dim} not divisible by axes {entry} (= {div}) "
                f"in spec {spec} for shape {shape}")
        out.append(dim // div)
    return tuple(out)


def shard_slices(shape: Sequence[int], spec, axes: Mapping[str, int],
                 coord: Mapping[str, int]) -> Tuple[slice, ...]:
    """The index slices that select coordinate ``coord``'s shard of a
    leaf."""
    shape = tuple(int(s) for s in shape)
    local = shard_shape(shape, spec, axes)
    out = []
    for dim, loc, entry in zip(shape, local, _spec_entries(spec, len(shape))):
        idx = 0
        for ax in entry:  # row-major over the listed axes
            if ax not in axes:
                continue  # an absent axis is one shard (see shard_shape)
            idx = idx * int(axes[ax]) + int(coord[ax])
        start = idx * loc
        out.append(slice(start, start + loc))
    return tuple(out)


def shard_size_ratio(spec, axes: Mapping[str, int]) -> int:
    """``full_size / shard_size`` for a leaf under ``spec``: what a
    shard-local gossip saves on the wire against gather-then-gossip."""
    r = 1
    for entry in (tuple(spec) or ()):
        for ax in spec_entry_axes(entry):
            r *= int(axes.get(ax, 1))
    return r


@dataclass(frozen=True)
class ShardView:
    """One inner-mesh coordinate's view of a spec tree.

    Attributes:
      specs: tree of :class:`PartitionSpec` matching the template (from
        :meth:`RuleTable.resolve_tree`).
      axes: ``{inner_axis: size}``.
      coord: ``{inner_axis: index}``: which shard this view is.
    """

    specs: Any
    axes: Mapping[str, int] = field(default_factory=dict)
    coord: Mapping[str, int] = field(default_factory=dict)

    def __post_init__(self):
        missing = set(self.axes) - set(self.coord)
        if missing:
            raise ValueError(f"coord missing axes {sorted(missing)}")
        for ax, i in self.coord.items():
            if not 0 <= int(i) < int(self.axes[ax]):
                raise ValueError(
                    f"coord {ax}={i} out of range [0, {self.axes[ax]})")

    def spec_leaves(self, template) -> List[PartitionSpec]:
        """The specs aligned with ``template``'s leaves."""
        return spec_leaves(self.specs, template)

    def leaf_shape(self, shape: Sequence[int], spec) -> Tuple[int, ...]:
        return shard_shape(shape, spec, self.axes)

    def leaf_slices(self, shape: Sequence[int], spec) -> Tuple[slice, ...]:
        return shard_slices(shape, spec, self.axes, self.coord)


class GossipMesh:
    """The hybrid ``(bf, inner...)`` mesh, as one object both sides use:
    ``bf`` ranks gossip over the outer axis, each rank's model sharded over
    the inner axes.  :meth:`mesh` gives the port's mesh (the gossip axis
    outermost); :meth:`views` the per-coordinate plans of a spec tree."""

    def __init__(self, bf: int, inner: Mapping[str, int], *,
                 bf_axis: str = "bf"):
        if bf < 1:
            raise ValueError(f"bf size must be >= 1, got {bf}")
        if bf_axis in inner:
            raise ValueError(f"inner axes shadow the gossip axis {bf_axis!r}")
        self.bf = int(bf)
        self.bf_axis = bf_axis
        self.inner: Dict[str, int] = {k: int(v) for k, v in inner.items()}

    @property
    def inner_size(self) -> int:
        return num_shards(self.inner)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {self.bf_axis: self.bf, **self.inner}

    def coords(self) -> List[Dict[str, int]]:
        return inner_coords(self.inner)

    def mesh(self, ranks: Optional[Sequence[int]] = None):
        """The port's :class:`~bluefog_tpu_torch.parallel.axes.Mesh` of
        ``make_hybrid_mesh({bf_axis: bf, **inner})`` over ``ranks``
        (default: the context's)."""
        from bluefog_tpu_torch.parallel.axes import make_hybrid_mesh

        return make_hybrid_mesh(self.axis_sizes, ranks=ranks)

    def views(self, specs) -> List[ShardView]:
        return [ShardView(specs=specs, axes=self.inner, coord=c)
                for c in self.coords()]

    def __repr__(self) -> str:
        return (f"GossipMesh({self.bf_axis}={self.bf}, "
                + ", ".join(f"{k}={v}" for k, v in self.inner.items()) + ")")

"""Apply resolved specs: shard and gather leaves on the mesh and on the host.

Counterpart of ``bluefog_tpu/sharding/apply.py``, in two halves of the
``make_shard_and_gather_fns`` pattern:

- **Mesh** (:func:`make_shard_and_gather_fns`): per-leaf callables that
  place a full leaf onto a :class:`~bluefog_tpu_torch.parallel.axes.Mesh`
  under its spec, as the port's stacked layout ``(*mesh.shape, *local)``
  (the layout ``parallel/tensor.py`` uses; over processes only the rows this
  process owns), and that pull it back whole.  Gathering is the cold path:
  checkpoint consolidation, evaluation; the gossip never calls it.
- **Host** (:func:`shard_tree` / :func:`gather_tree`): one coordinate's
  slice of every leaf, and its inverse, the full tree reassembled from every
  coordinate's shard tree.  Both take numpy arrays or torch tensors.

Plus the wire accounting of shard-local gossip (:func:`tree_wire_bytes`).
The reference's metric counters (``record_shard_savings``) come with the
port's metrics package.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from bluefog_tpu_torch.sharding.mesh import (ShardView, inner_coords,
                                             shard_shape, shard_slices,
                                             shard_size_ratio, spec_leaves)
from bluefog_tpu_torch.sharding.rules import PartitionSpec, spec_entry_axes

__all__ = [
    "make_shard_and_gather_fns",
    "shard_tree",
    "gather_tree",
    "reassemble_vectors",
    "tree_wire_bytes",
]


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(s) for s in np.shape(leaf)) if not isinstance(
        leaf, torch.Tensor) else tuple(leaf.shape)


def _itemsize(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.dtype(getattr(leaf, "dtype", None)
                    or np.asarray(leaf).dtype).itemsize


def _full_shape(local: Tuple[int, ...], spec, axes: Mapping[str, int]
                ) -> Tuple[int, ...]:
    """The leaf shape whose shard under ``spec`` is ``local``."""
    ents = [spec_entry_axes(e) for e in tuple(spec)]
    ents += [()] * (len(local) - len(ents))
    return tuple(n * int(np.prod([axes.get(a, 1) for a in e] or [1]))
                 for n, e in zip(local, ents))


# ---------------------------------------------------------------------------
# Mesh side
# ---------------------------------------------------------------------------


def make_shard_and_gather_fns(specs, mesh):
    """``(shard_fns, gather_fns)``: trees of per-leaf callables, like
    ``specs`` (a tree of :class:`PartitionSpec` resolved on the full
    leaves).

    ``shard_fns[leaf](x)`` places the full leaf ``x`` on ``mesh`` (the
    port's :class:`~bluefog_tpu_torch.parallel.axes.Mesh`, e.g.
    ``GossipMesh.mesh()``): a stacked ``(*mesh.shape, *shard)`` tensor whose
    row at each mesh position is that position's shard (the same value
    along every axis the spec does not mention), on ``x``'s device; over
    processes only the positions of the ranks this process owns
    (``mesh.owned()``).  ``gather_fns[leaf](x)`` is the inverse: the
    full leaf from a stacked one, each axis the spec does not mention read
    at its index 0; over processes it is collective (every process passes
    its owned rows and gets the whole leaf)."""
    names, sizes = mesh.axis_names, mesh.sizes

    def mk_shard(spec):
        def shard(x):
            x = torch.as_tensor(x)
            owned = mesh.owned()
            pieces = [x[shard_slices(x.shape, spec, sizes,
                                     dict(zip(names, pos)))]
                      for pos in itertools.product(
                          *(range(s.start, s.stop) for s in owned))]
            local = tuple(s.stop - s.start for s in owned)
            return torch.stack(pieces).view(*local, *pieces[0].shape)

        return shard

    def mk_gather(spec):
        def gather(x):
            x = torch.as_tensor(x)
            lead = len(names)
            stacked = _whole_mesh(x, mesh)
            shard = tuple(stacked.shape[lead:])
            full = stacked.new_empty(_full_shape(shard, spec, sizes))
            mentioned = {a for e in tuple(spec) for a in spec_entry_axes(e)}
            ranges = [range(sizes[n]) if n in mentioned else range(1)
                      for n in names]
            for pos in itertools.product(*ranges):
                full[shard_slices(full.shape, spec, sizes,
                                  dict(zip(names, pos)))] = stacked[pos]
            return full

        return gather

    shard_fns = pytree.tree_map(mk_shard, specs, is_leaf=_is_spec)
    gather_fns = pytree.tree_map(mk_gather, specs, is_leaf=_is_spec)
    return shard_fns, gather_fns


def _whole_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """A stacked leaf over the whole mesh: ``x`` itself in one process;
    over processes every process's owned rows gathered (collective)."""
    from bluefog_tpu_torch.ops import transport as _T
    from bluefog_tpu_torch.parallel.axes import _owned_block

    tr = _T.active()
    lead = len(mesh.axis_names)
    if tr is None:
        if tuple(x.shape[:lead]) != mesh.shape:
            raise ValueError(f"a stacked leaf of leading shape "
                             f"{tuple(x.shape[:lead])} on the mesh "
                             f"{mesh.shape}")
        return x
    from bluefog_tpu_torch.parallel.context import get_context

    per = get_context().size // tr.processes
    rows = tr.gather_all([x.reshape(1, -1).contiguous()])[0]
    whole = x.new_empty(*mesh.shape, *x.shape[lead:])
    for q in range(tr.processes):
        box = _owned_block(mesh.ranks, q, per)
        whole[box] = rows[q].view(x.shape)
    return whole


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------


def shard_tree(tree, view: ShardView):
    """``view``'s shard of every leaf: numpy copies of numpy leaves, torch
    copies of tensors."""
    specs = view.spec_leaves(tree)
    leaves, treedef = pytree.tree_flatten(tree)
    out = []
    for leaf, spec in zip(leaves, specs):
        if isinstance(leaf, torch.Tensor):
            out.append(leaf[view.leaf_slices(leaf.shape, spec)].clone())
        else:
            a = np.asarray(leaf)
            # np.array keeps a 0-d leaf 0-d for gather_tree's check
            out.append(np.array(a[view.leaf_slices(a.shape, spec)]))
    return pytree.tree_unflatten(out, treedef)


def gather_tree(template, specs, axes: Mapping[str, int],
                shard_trees: Mapping[Any, Any]):
    """Inverse of :func:`shard_tree` over all coordinates: the full tree
    reassembled from per-coordinate shard trees.

    ``shard_trees`` maps a coordinate key (the coordinate's items as a
    sorted tuple, or the positional tuple in ``axes`` key order) to that
    coordinate's shard tree.  Every coordinate must be present; the shards'
    shapes are checked against the template so that a mis-keyed shard cannot
    land at the wrong offset.  The full leaves are tensors where the shards
    are (on their device), else numpy arrays."""
    names = list(axes.keys())
    coords = inner_coords(axes)

    def key_of(coord: Dict[str, int]):
        pos = tuple(coord[n] for n in names)
        if pos in shard_trees:
            return pos
        srt = tuple(sorted(coord.items()))
        if srt in shard_trees:
            return srt
        raise KeyError(
            f"missing shard for coordinate {coord} (keys tried: {pos} "
            f"and {srt}; have {sorted(map(str, shard_trees.keys()))})")

    specs_flat = spec_leaves(specs, template)
    t_leaves, treedef = pytree.tree_flatten(template)
    shard_flat = {tuple(c[n] for n in names):
                  pytree.tree_leaves(shard_trees[key_of(c)]) for c in coords}
    for pos, leaves in shard_flat.items():
        if len(leaves) != len(t_leaves):
            raise ValueError(f"shard at {pos} has {len(leaves)} leaves, "
                             f"template {len(t_leaves)}")
    out = []
    for i, (tleaf, spec) in enumerate(zip(t_leaves, specs_flat)):
        shape = _shape(tleaf)
        loc = shard_shape(shape, spec, axes)
        first = shard_flat[tuple(coords[0][n] for n in names)][i]
        if isinstance(first, torch.Tensor):
            full = first.new_empty(shape)
        else:
            dtype = getattr(tleaf, "dtype", None) or np.asarray(tleaf).dtype
            full = np.empty(shape, dtype)
        for c in coords:
            pos = tuple(c[n] for n in names)
            piece = shard_flat[pos][i]
            if _shape(piece) != loc:
                raise ValueError(
                    f"shard {pos} leaf {i} has shape {_shape(piece)}, "
                    f"expected {loc} (spec {spec}, full {shape})")
            full[shard_slices(shape, spec, axes, c)] = (
                piece if isinstance(full, torch.Tensor) else np.asarray(piece))
        out.append(full)
    return pytree.tree_unflatten(out, treedef)


def reassemble_vectors(template, specs, axes: Mapping[str, int],
                       vectors: Mapping[Any, np.ndarray], *,
                       dtype=np.float64):
    """The full tree from per-coordinate packed flat vectors (the serving
    snapshot and warm-start read path): each coordinate's vector holds its
    shard of every leaf, in the template's leaf order, each raveled in C
    order, in ``dtype`` (the layout of the reference's spec-aware
    ``TreePacker``, whose port comes with the host runtime).  Keys as in
    :func:`gather_tree`."""
    names = list(axes.keys())
    t_leaves, treedef = pytree.tree_flatten(template)
    specs_flat = spec_leaves(specs, template)
    shard_trees = {}
    for coord in inner_coords(axes):
        pos = tuple(coord[n] for n in names)
        key = pos if pos in vectors else tuple(sorted(coord.items()))
        vec = np.asarray(vectors[key], dtype)
        leaves, off = [], 0
        for tleaf, spec in zip(t_leaves, specs_flat):
            shp = shard_shape(_shape(tleaf), spec, axes)
            n = int(np.prod(shp, dtype=np.int64))
            ldt = (getattr(tleaf, "dtype", None)
                   or np.asarray(tleaf).dtype)
            if isinstance(ldt, torch.dtype):
                ldt = torch.empty((), dtype=ldt).numpy().dtype
            leaves.append(vec[off:off + n].reshape(shp).astype(ldt))
            off += n
        if off != vec.size:
            raise ValueError(f"vector at {pos} has {vec.size} entries, the "
                             f"shards {off}")
        shard_trees[pos] = pytree.tree_unflatten(leaves, treedef)
    return gather_tree(template, specs, axes, shard_trees)


# ---------------------------------------------------------------------------
# Wire accounting
# ---------------------------------------------------------------------------


def tree_wire_bytes(tree, specs, axes: Mapping[str, int]
                    ) -> Tuple[int, int]:
    """``(shard_bytes, full_bytes)`` one deposit of ``tree`` (full leaves)
    moves, shard-local against gather-then-gossip."""
    specs_flat = spec_leaves(specs, tree)
    shard_b = full_b = 0
    for leaf, spec in zip(pytree.tree_leaves(tree), specs_flat):
        full = int(np.prod(_shape(leaf), dtype=np.int64)) * _itemsize(leaf)
        full_b += full
        shard_b += full // shard_size_ratio(spec, axes)
    return shard_b, full_b

"""The rule table: one ordered ``regex -> PartitionSpec`` mapping as the
single source of truth for how every leaf family is partitioned.

Counterpart of ``bluefog_tpu/sharding/rules.py`` (the table; the mesh and
apply and gossip modules of that package are not ported yet).  Leaves are
named by their ``'/'``-joined path, rules are searched first-match-wins,
scalars are never partitioned, and a non-scalar leaf no rule matches raises
:class:`UnmatchedLeafError`.  :class:`PartitionSpec` is the port's own
value with ``jax.sharding.PartitionSpec``'s meaning: one entry per
dimension, ``None`` (replicated), an axis name, or a tuple of names.

Paths come from :func:`named_leaves`: nested mappings and sequences join
their keys with ``'/'``, and a key holding PyTorch's ``'.'``-joined module
path (``block_0.up.kernel``) counts as that many components, so a model's
``named_parameters`` resolve under the same patterns as the JAX package's
flax trees.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
from torch.utils import _pytree as pytree

__all__ = [
    "PartitionSpec",
    "Rule",
    "RuleTable",
    "ShardingRuleError",
    "UnmatchedLeafError",
    "UnusedRuleError",
    "named_leaves",
    "named_tree_map",
    "norm_spec",
    "opt_state_specs",
    "spec_entry_axes",
    "spec_mentions",
]


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: per dimension ``None``, an axis name or
    a tuple of axis names (``jax.sharding.PartitionSpec``'s meaning)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class ShardingRuleError(ValueError):
    """Base class for rule-table resolution failures."""


class UnmatchedLeafError(ShardingRuleError):
    """A non-scalar leaf matched no rule: the silent-replication leak."""


class UnusedRuleError(ShardingRuleError):
    """A rule matched no leaf: a typo'd pattern shards nothing."""


def _keystr(k) -> str:
    for attr in ("key", "name", "idx"):
        v = getattr(k, attr, None)
        if v is not None:
            return str(v).replace(".", "/")
    return str(k)


def named_leaves(tree, *, sep: str = "/",
                 is_leaf: Optional[Callable] = None) -> List[Tuple[str, Any]]:
    """``[(path_name, leaf)]`` with ``'/'``-joined component names."""
    flat, _ = pytree.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(sep.join(_keystr(k) for k in path), leaf)
            for path, leaf in flat]


def named_tree_map(fn: Callable[[str, Any], Any], tree, *, sep: str = "/",
                   is_leaf: Optional[Callable] = None):
    """``tree_map`` where ``fn`` also receives the leaf's joined path."""
    flat, spec = pytree.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return pytree.tree_unflatten(
        [fn(sep.join(_keystr(k) for k in path), leaf) for path, leaf in flat],
        spec)


def _leaf_shape(leaf) -> Tuple[int, ...]:
    shape = getattr(leaf, "shape", None)
    if shape is None:
        shape = np.shape(leaf)
    return tuple(int(s) for s in shape)


def _is_scalar(shape: Tuple[int, ...]) -> bool:
    return len(shape) == 0 or int(np.prod(shape, dtype=np.int64)) == 1


@dataclass(frozen=True)
class Rule:
    """One table entry: ``re.search(pattern, leaf_path)`` -> ``spec``."""

    pattern: str
    spec: PartitionSpec

    def __post_init__(self):
        re.compile(self.pattern)  # fail at construction, not resolution
        if isinstance(self.spec, str):
            # a bare axis name shards dim 0 over it (splatting the string
            # would make one axis per character)
            object.__setattr__(self, "spec", PartitionSpec(self.spec))
        elif not isinstance(self.spec, PartitionSpec):
            object.__setattr__(self, "spec", PartitionSpec(*self.spec))

    def matches(self, name: str) -> bool:
        return re.search(self.pattern, name) is not None


class RuleTable:
    """Ordered first-match-wins ``regex -> PartitionSpec`` resolution;
    ``axes`` (``{name: size}``), when given, is checked against every
    rule's spec at construction."""

    def __init__(self, rules: Sequence, *,
                 axes: Optional[Mapping[str, int]] = None):
        self.rules: Tuple[Rule, ...] = tuple(
            r if isinstance(r, Rule) else Rule(r[0], r[1]) for r in rules)
        self.axes = dict(axes) if axes is not None else None
        if self.axes is not None:
            for r in self.rules:
                for entry in r.spec:
                    for a in spec_entry_axes(entry):
                        if a not in self.axes:
                            raise ShardingRuleError(
                                f"rule {r.pattern!r} mentions axis {a!r}, "
                                f"not one of {sorted(self.axes)}")

    def resolve(self, name: str, shape: Sequence[int] = ()) -> PartitionSpec:
        """Spec for one named leaf of the (per-rank) ``shape``."""
        shape = tuple(int(s) for s in shape)
        if _is_scalar(shape):
            return PartitionSpec()
        for r in self.rules:
            if r.matches(name):
                if len(r.spec) > len(shape):
                    raise ShardingRuleError(
                        f"rule {r.pattern!r} spec {r.spec} has more entries "
                        f"than leaf {name!r} has dims {shape}")
                return r.spec
        raise UnmatchedLeafError(
            f"no partition rule matches leaf {name!r} (shape {shape}): add "
            "a rule (or an explicit replicate rule, e.g. Rule('.*', "
            "PartitionSpec())) so replication is a decision, not a leak")

    def resolve_tree(self, tree, *, is_leaf: Optional[Callable] = None):
        """A tree of :class:`PartitionSpec` matching ``tree``."""
        return named_tree_map(
            lambda name, leaf: self.resolve(name, _leaf_shape(leaf)),
            tree, is_leaf=is_leaf)

    def coverage(self, tree, *, is_leaf: Optional[Callable] = None
                 ) -> Tuple[List[str], List[str]]:
        """``(unmatched_leaf_names, unused_rule_patterns)`` over ``tree``;
        scalars need no rule but can keep one alive."""
        unmatched: List[str] = []
        used = [False] * len(self.rules)
        for name, leaf in named_leaves(tree, is_leaf=is_leaf):
            hit = next((i for i, r in enumerate(self.rules)
                        if r.matches(name)), None)
            if hit is not None:
                used[hit] = True
            elif not _is_scalar(_leaf_shape(leaf)):
                unmatched.append(name)
        unused = [r.pattern for r, u in zip(self.rules, used) if not u]
        return unmatched, unused

    def check(self, tree, *, is_leaf: Optional[Callable] = None) -> None:
        """Raise unless the table and ``tree`` cover each other exactly."""
        unmatched, unused = self.coverage(tree, is_leaf=is_leaf)
        if unmatched:
            raise UnmatchedLeafError(f"leaves matched by no rule: {unmatched}")
        if unused:
            raise UnusedRuleError(f"rules matching no leaf: {unused}")

    def __len__(self) -> int:
        return len(self.rules)

    def __repr__(self) -> str:
        return (f"RuleTable({len(self.rules)} rules"
                + (f", axes={self.axes}" if self.axes is not None else "")
                + ")")

    def replaced(self, pattern: str, spec) -> "RuleTable":
        """A new table with the rule of ``pattern`` given ``spec``."""
        if pattern not in [r.pattern for r in self.rules]:
            raise KeyError(f"no rule with pattern {pattern!r}")
        return RuleTable(
            [Rule(r.pattern, spec if r.pattern == pattern else r.spec)
             for r in self.rules], axes=self.axes)


def spec_entry_axes(entry) -> Tuple[str, ...]:
    """Axis names of one spec entry (``None`` | str | tuple)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def norm_spec(spec) -> Tuple[Tuple[str, ...], ...]:
    """Comparable form: per-dimension axis tuples, trailing replicated
    entries trimmed."""
    out = [spec_entry_axes(e) for e in tuple(spec)]
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


def spec_mentions(spec, axis: str) -> bool:
    """Whether ``spec`` shards any dimension over ``axis``."""
    return any(axis in spec_entry_axes(e) for e in tuple(spec))


def opt_state_specs(table: RuleTable, params, opt_state, *,
                    is_leaf: Optional[Callable] = None):
    """Spec tree for ``opt_state`` from the table that shards ``params``: a
    scalar leaf is replicated; otherwise the longest parameter path that is
    a ``'/'``-component suffix of the leaf's path, with the same shape,
    gives its spec (moments inherit their parameter's placement); a leaf
    shadowing no parameter resolves through the table itself."""
    index = []
    for name, leaf in named_leaves(params, is_leaf=is_leaf):
        shape = _leaf_shape(leaf)
        index.append((tuple(name.split("/")), shape,
                      table.resolve(name, shape)))
    index.sort(key=lambda t: len(t[0]), reverse=True)

    def derive(name: str, leaf) -> PartitionSpec:
        shape = _leaf_shape(leaf)
        if _is_scalar(shape):
            return PartitionSpec()
        comps = tuple(name.split("/"))
        for ppath, pshape, pspec in index:
            if (len(comps) >= len(ppath) and comps[-len(ppath):] == ppath
                    and shape == pshape):
                return pspec
        return table.resolve(name, shape)

    return named_tree_map(derive, opt_state, is_leaf=is_leaf)

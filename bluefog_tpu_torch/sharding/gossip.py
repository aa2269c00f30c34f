"""Gossip of meshes over the window table: shard-local neighbour gossip.

Counterpart of ``bluefog_tpu/sharding/gossip.py``.  Each gossip rank is a
whole inner mesh (``fsdp``/``tp`` shards); the gossip graph connects meshes,
not devices.  The wire model:

- every inner-mesh coordinate owns its own window per rank
  (``{name}:{rank}:{shard}``), sized to the shard-local packed vector plus
  the push-sum mass scalar;
- coordinate ``c`` of rank ``r`` deposits only into coordinate ``c`` of its
  out-neighbours: no gather on the hot path (the full tree is reassembled
  only at the read boundary, :func:`~bluefog_tpu_torch.sharding.apply.
  gather_tree`);
- push-sum mass is carried per shard, so the exactly-once audit holds per
  coordinate, ``sum_r p[r, c] == n``, and stays exact through a
  :func:`~bluefog_tpu_torch.topology.heal`.

Gossip is element-wise, so the shard-local run does the same floating-point
operations in the same order per element as the gathered run:
``run_sharded_gossip`` with ``axes={}`` is that reference, and the two are
bit-equal.  The rounds are deterministic and synchronous (every rank
deposits, then every rank consumes), which makes that claim testable; the
asynchronous execution model is
:func:`bluefog_tpu_torch.runtime.async_windows.run_async_dsgd`.  The run's
deposits are accounted on the metrics registry
(:func:`~bluefog_tpu_torch.sharding.apply.record_shard_savings`), and the
report carries the same byte counts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.runtime.async_windows import AsyncWindow, TreePacker
from bluefog_tpu_torch.blackbox import recorder as _bb
from bluefog_tpu_torch.sharding.apply import (gather_tree,
                                              record_shard_savings,
                                              tree_wire_bytes)
from bluefog_tpu_torch.sharding.mesh import ShardView, inner_coords
from bluefog_tpu_torch.sharding.rules import RuleTable
from bluefog_tpu_torch.topology.graphs import Topology, heal as _heal

__all__ = ["ShardedGossipReport", "run_sharded_gossip"]


@dataclass
class ShardedGossipReport:
    """Outcome of a shard-local gossip run."""

    rounds: int
    # per-rank de-biased estimates reassembled to full trees (None for the
    # ranks healed out): the run's only gather, at the read boundary
    params: List[Any]
    # per-coordinate mass over every window and unconsumed slot (exact
    # audit: each entry == topology.size, deaths included)
    total_mass: Dict[Tuple[int, ...], float]
    # bytes per deposit: shard-local, and what a gather-then-gossip wire
    # would have added
    shard_bytes_per_deposit: int
    saved_bytes_per_deposit: int
    deposits: int = 0
    dead_ranks: List[int] = field(default_factory=list)


def run_sharded_gossip(
    topology: Topology,
    params0: Sequence[Any],
    rule_table,
    axes: Mapping[str, int],
    *,
    rounds: int = 10,
    name: str = "shard_gossip",
    heal_after: Optional[int] = None,
    dead_ranks: Sequence[int] = (),
    dtype=np.float64,
    native: Optional[bool] = None,
) -> ShardedGossipReport:
    """Run ``rounds`` of shard-local push-sum gossip over ``topology``.

    Args:
      topology: the gossip graph over ranks (each a whole inner mesh).
      params0: one tree per rank (``len == topology.size``), all with the
        structure and shapes of ``params0[0]``: numpy arrays or tensors (on
        the card, they pass through :class:`TreePacker`).
      rule_table: the :class:`~bluefog_tpu_torch.sharding.rules.RuleTable`
        resolving every leaf's spec, or an already resolved spec tree.
      axes: inner-mesh ``{axis: size}``; ``{}`` is one shard per rank, the
        gathered reference.
      heal_after / dead_ranks: after round ``heal_after`` the ranks in
        ``dead_ranks`` stop and the survivors re-plan through
        :func:`~bluefog_tpu_torch.topology.heal`; the per-coordinate audit
        stays exact through the change.
      native: ``False`` runs on the Python twin of the window table.
    """
    n = topology.size
    if len(params0) != n:
        raise ValueError(f"{len(params0)} param trees != topology size {n}")
    template = params0[0]
    if isinstance(rule_table, RuleTable):
        specs = rule_table.resolve_tree(template)
    else:
        specs = rule_table
    coords = inner_coords(axes)
    views = [ShardView(specs=specs, axes=axes, coord=c) for c in coords]
    packers = [TreePacker(template, dtype, sharding=v) for v in views]
    d = packers[0].size
    dead = set(int(r) for r in dead_ranks)
    if heal_after is None and dead:
        raise ValueError("dead_ranks without heal_after")

    in_nbrs = [list(topology.in_neighbors(r)) for r in range(n)]
    out_nbrs = [list(topology.out_neighbors(r)) for r in range(n)]
    slot_of = [{src: k for k, src in enumerate(in_nbrs[r])} for r in range(n)]

    # one window per (rank, coordinate): the shard-local landing zone
    wins: List[List[AsyncWindow]] = []
    try:
        for r in range(n):
            row = []
            wins.append(row)
            for ci in range(len(coords)):
                row.append(AsyncWindow(f"{name}:{r}:{ci}",
                                       max(len(in_nbrs[r]), 1), d + 1,
                                       np.float64, native=native))
    except BaseException:
        for row in wins:
            for w in row:
                w.free()
        raise

    try:
        x = [[packers[ci].pack(params0[r]).astype(np.float64)
              for ci in range(len(coords))] for r in range(n)]
        p = [[1.0] * len(coords) for _ in range(n)]
        live = list(range(n))
        my_out = [list(out_nbrs[r]) for r in range(n)]
        deposits = 0
        # one payload and one read buffer for the whole run: a deposit
        # lands before it returns, and model-sized temporaries would cost
        # fresh pages on every call
        payload = np.empty(d + 1, np.float64)
        rbuf = np.empty(d + 1, np.float64)

        for k in range(rounds):
            if heal_after is not None and k == heal_after and dead:
                healed = _heal(topology, frozenset(dead))
                _bb.record("sharded_gossip_heal", round=k,
                           dead=sorted(dead))
                live = [r for r in range(n) if r not in dead]
                my_out = [list(healed.out_neighbors(r)) for r in range(n)]
            # deposit phase: same shard to same shard, shard-sized wire
            for r in live:
                frac = 1.0 / (len(my_out[r]) + 1)
                for ci in range(len(coords)):
                    np.multiply(x[r][ci], frac, out=payload[:-1])
                    payload[-1] = p[r][ci] * frac
                    for j in my_out[r]:
                        wins[j][ci].deposit(slot_of[j][r], payload,
                                            accumulate=True)
                        deposits += 1
                    x[r][ci] *= frac
                    p[r][ci] *= frac
            # consume phase: fold whatever landed
            for r in live:
                for ci in range(len(coords)):
                    for s in range(len(in_nbrs[r])):
                        buf, fresh = wins[r][ci].read(s, consume=True,
                                                      out=rbuf)
                        if fresh > 0:
                            x[r][ci] += buf[:-1]
                            p[r][ci] += buf[-1]
                    # publish (x, p), a round-consistent pair for readers
                    payload[:-1] = x[r][ci]
                    payload[-1] = p[r][ci]
                    wins[r][ci].set_self(payload)

        # mass audit per coordinate: held by live and dead ranks, plus
        # what was never consumed (a dead rank's landing slots)
        total_mass: Dict[Tuple[int, ...], float] = {}
        names = list(axes.keys())
        for ci, c in enumerate(coords):
            tot = 0.0
            for r in range(n):
                tot += p[r][ci]
                for s in range(len(in_nbrs[r])):
                    if r in dead:
                        buf, fresh = wins[r][ci].read(s, consume=False,
                                                      out=rbuf)
                        if fresh > 0:
                            tot += float(buf[-1])
            total_mass[tuple(c[nm] for nm in names)] = tot

        # the read boundary (gather)
        params: List[Any] = [None] * n
        for r in range(n):
            if r in dead:
                continue
            shard_trees = {}
            for ci, c in enumerate(coords):
                z = x[r][ci] / p[r][ci]
                shard_trees[tuple(c[nm] for nm in names)] = (
                    packers[ci].unpack(z))
            params[r] = gather_tree(template, specs, axes, shard_trees)

        shard_b, full_b = tree_wire_bytes(template, specs, axes)
        if deposits:
            record_shard_savings(template, specs, axes, deposits=deposits)
        return ShardedGossipReport(
            rounds=rounds,
            params=params,
            total_mass=total_mass,
            shard_bytes_per_deposit=shard_b,
            saved_bytes_per_deposit=full_b - shard_b,
            deposits=deposits,
            dead_ranks=sorted(dead),
        )
    finally:
        for row in wins:
            for w in row:
                w.free()

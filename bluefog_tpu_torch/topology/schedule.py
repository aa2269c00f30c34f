"""Lower a virtual topology to a gossip schedule.

Counterpart of ``bluefog_tpu/topology/schedule.py`` (numpy only, copied).  The
digraph is decomposed into a sequence of *partial permutations* (slots); slot
``k`` of rank ``i`` receives from ``recv_src[i, k]`` with weight
``recv_weights[i, k]``.

1. **Circulant fast path**: every standard topology (ring, exp2,
   symmetric-exp, fully-connected, one-peer phases) is a union of complete
   shift classes ``{i -> i+s (mod n)}``; each shift is one slot.  These are the
   schedules the TPU kernels take; the port's K1 and K2 take any schedule.
2. **Greedy edge coloring** for other digraphs (star, grid, user graphs): no
   two edges in a slot share a source or a destination.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from bluefog_tpu_torch.topology.graphs import Topology

__all__ = ["GossipSchedule", "build_schedule"]

Perm = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True, eq=False)
class GossipSchedule:
    """A topology lowered to slots + per-rank weight tables.

    ``eq=False``: identity equality/hash, so a schedule can key the cache of
    its device-side tables.

    Attributes:
      size: number of ranks.
      perms: one partial permutation per slot, ``(src, dst)`` pairs with
        distinct sources and distinct destinations.
      self_weights: ``(n,)`` diagonal of the mixing matrix.
      recv_weights: ``(n, K)`` weight rank ``i`` applies to slot ``k``'s
        arrival (0 where no edge).
      recv_src: ``(n, K)`` int32 source rank feeding rank ``i``'s slot ``k``,
        or -1.
      is_circulant: every slot is a complete shift permutation.
    """

    size: int
    perms: Tuple[Perm, ...]
    self_weights: np.ndarray
    recv_weights: np.ndarray
    recv_src: np.ndarray
    is_circulant: bool
    name: str = "schedule"

    @property
    def num_slots(self) -> int:
        return len(self.perms)

    def validate(self) -> None:
        for k, perm in enumerate(self.perms):
            srcs = [s for s, _ in perm]
            dsts = [d for _, d in perm]
            if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
                raise ValueError(
                    f"slot {k} is not a partial permutation: {perm}")

    def mixing_matrix(self) -> np.ndarray:
        """Reconstruct the dense row-stochastic matrix."""
        w = np.diag(self.self_weights.copy())
        for k, perm in enumerate(self.perms):
            for (src, dst) in perm:
                w[dst, src] += self.recv_weights[dst, k]
        return w


def _try_circulant_slots(topo: Topology) -> Optional[List[Perm]]:
    """One full rotation per shift if the edge set is a union of complete
    shift classes, else None."""
    n = topo.size
    edges = set(topo.edges)
    shifts = sorted({(dst - src) % n for (src, dst) in edges})
    for s in shifts:
        if any((i, (i + s) % n) not in edges for i in range(n)):
            return None
    if len(shifts) * n != len(edges):
        return None
    return [tuple((i, (i + s) % n) for i in range(n)) for s in shifts]


def _greedy_color_slots(topo: Topology) -> List[Perm]:
    """Greedy proper edge coloring of the digraph into partial permutations,
    high-degree endpoints first, deterministic order."""
    slots: List[List[Tuple[int, int]]] = []
    slot_srcs: List[set] = []
    slot_dsts: List[set] = []

    def deg(e):
        return topo.out_degree(e[0]) + topo.in_degree(e[1])

    for (src, dst) in sorted(topo.edges, key=lambda e: (-deg(e), e)):
        for k in range(len(slots)):
            if src not in slot_srcs[k] and dst not in slot_dsts[k]:
                slots[k].append((src, dst))
                slot_srcs[k].add(src)
                slot_dsts[k].add(dst)
                break
        else:
            slots.append([(src, dst)])
            slot_srcs.append({src})
            slot_dsts.append({dst})
    return [tuple(sorted(s)) for s in slots]


def build_schedule(topo: Topology, name: Optional[str] = None) -> GossipSchedule:
    """Lower a :class:`Topology` to a :class:`GossipSchedule`."""
    n = topo.size
    circ = _try_circulant_slots(topo)
    perms = circ if circ is not None else _greedy_color_slots(topo)
    k_slots = len(perms)
    recv_w = np.zeros((n, max(k_slots, 1)))
    recv_src = np.full((n, max(k_slots, 1)), -1, dtype=np.int32)
    for k, perm in enumerate(perms):
        for (src, dst) in perm:
            recv_w[dst, k] = topo.weights[dst, src]
            recv_src[dst, k] = src
    sched = GossipSchedule(
        size=n,
        perms=tuple(perms),
        self_weights=np.array([topo.self_weight(r) for r in range(n)]),
        recv_weights=recv_w,
        recv_src=recv_src,
        is_circulant=circ is not None,
        name=name or topo.name,
    )
    sched.validate()
    if not np.allclose(sched.mixing_matrix(), topo.weights, atol=1e-9):
        raise AssertionError("schedule does not reproduce the mixing matrix")
    return sched

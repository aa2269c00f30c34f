"""Static virtual topologies with row-stochastic mixing weights.

Counterpart of ``bluefog_tpu/topology/graphs.py``; numpy only, copied here so
the port never imports the JAX package.  Conventions are the reference's:

``W[i, j]`` is the weight rank ``i`` applies to the tensor *received from*
rank ``j``; edge ``j -> i`` exists iff ``W[i, j] > 0`` (for ``i != j``).
``W[i, i]`` is the self weight.  One gossip step computes

    out_i = W[i, i] * x_i  +  sum_{j in InNbr(i)} W[i, j] * x_j

Uniform ``1/(in_degree+1)`` weights for the exponential/ring/star families and
Metropolis-Hastings weights for the 2-D grid.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Topology",
    "ExponentialTwoGraph",
    "ExponentialGraph",
    "SymmetricExponentialGraph",
    "RingGraph",
    "MeshGrid2DGraph",
    "StarGraph",
    "FullyConnectedGraph",
    "IsTopologyEquivalent",
    "IsRegularGraph",
    "GetRecvWeights",
    "GetSendWeights",
    "heal",
    "replan",
    "replan_penalized",
]


@dataclasses.dataclass(frozen=True, eq=False)
class Topology:
    """A directed, weighted virtual communication graph.

    ``eq=False``: identity-based equality/hash, so a topology can key caches;
    semantic comparison goes through :func:`IsTopologyEquivalent`.

    Attributes:
      weights: ``(n, n)`` float64 row-stochastic matrix, orientation per the
        module docstring.
      name: human-readable tag.
      inactive: ranks healed out of the graph (:func:`heal`): their rows
        are identity self-loops and no active row references them.  Rank
        numbers stay valid, and the derived ``name`` keeps one collapsed
        suffix.
    """

    weights: np.ndarray
    name: str = "custom"
    inactive: FrozenSet[int] = frozenset()

    def __post_init__(self):
        object.__setattr__(self, "inactive",
                           frozenset(int(r) for r in self.inactive))
        w = np.asarray(self.weights, dtype=np.float64)
        if w.ndim != 2 or w.shape[0] != w.shape[1]:
            raise ValueError(f"weights must be square, got shape {w.shape}")
        if (w < -1e-12).any():
            raise ValueError("weights must be non-negative")
        rows = w.sum(axis=1)
        if not np.allclose(rows, 1.0, atol=1e-8):
            raise ValueError(f"weights must be row-stochastic; row sums {rows}")
        object.__setattr__(self, "weights", w)

    @property
    def size(self) -> int:
        return self.weights.shape[0]

    def self_weight(self, rank: int) -> float:
        return float(self.weights[rank, rank])

    def in_neighbors(self, rank: int) -> List[int]:
        """Ranks whose tensors ``rank`` receives (sorted)."""
        row = self.weights[rank]
        return [j for j in range(self.size) if j != rank and row[j] > 0.0]

    def out_neighbors(self, rank: int) -> List[int]:
        """Ranks to which ``rank`` sends (sorted)."""
        col = self.weights[:, rank]
        return [i for i in range(self.size) if i != rank and col[i] > 0.0]

    def in_degree(self, rank: int) -> int:
        return len(self.in_neighbors(rank))

    def out_degree(self, rank: int) -> int:
        return len(self.out_neighbors(rank))

    @property
    def max_in_degree(self) -> int:
        return max(self.in_degree(r) for r in range(self.size))

    @property
    def edges(self) -> List[Tuple[int, int]]:
        """Directed edge list as ``(src, dst)`` pairs (dst receives from src)."""
        n = self.size
        return [(j, i) for i in range(n) for j in range(n)
                if i != j and self.weights[i, j] > 0.0]

    @staticmethod
    def from_edges(
        size: int,
        edges: Sequence[Tuple[int, int]],
        weights: Optional[Dict[Tuple[int, int], float]] = None,
        name: str = "custom",
    ) -> "Topology":
        """Build from a ``(src, dst)`` edge list; without ``weights`` each row
        gets uniform ``1/(in_degree+1)``."""
        w = np.zeros((size, size))
        if weights is None:
            indeg = [0] * size
            for (_, dst) in edges:
                indeg[dst] += 1
            for i in range(size):
                w[i, i] = 1.0 / (indeg[i] + 1)
            for (src, dst) in edges:
                w[dst, src] = 1.0 / (indeg[dst] + 1)
        else:
            for (src, dst) in edges:
                w[dst, src] = weights[(src, dst)]
            for i in range(size):
                w[i, i] = 1.0 - w[i].sum()
        return Topology(weights=w, name=name)


def _uniform_from_out_offsets(size: int, offsets: Sequence[int],
                              name: str) -> Topology:
    """Circulant-style digraph: rank ``i`` sends to ``i + o (mod n)``, with
    uniform ``1/(in_degree + 1)`` weights per receiving rank."""
    w = np.zeros((size, size))
    indeg = np.zeros(size, dtype=int)
    edge = np.zeros((size, size), dtype=bool)
    for i in range(size):
        for o in offsets:
            dst = (i + o) % size
            if dst != i and not edge[dst, i]:
                edge[dst, i] = True
                indeg[dst] += 1
    for i in range(size):
        w[i, i] = 1.0 / (indeg[i] + 1)
        w[i, edge[i]] = 1.0 / (indeg[i] + 1)
    return Topology(weights=w, name=name)


def ExponentialGraph(size: int, base: int = 2) -> Topology:
    """Static exponential graph: ``i -> (i + base**k) % size`` for all
    ``base**k < size``."""
    if size < 1:
        raise ValueError("size must be >= 1")
    offsets = []
    o = 1
    while o < size:
        offsets.append(o)
        o *= base
    return _uniform_from_out_offsets(size, offsets,
                                     f"ExponentialGraph(base={base})")


def ExponentialTwoGraph(size: int) -> Topology:
    """Exponential-2 graph: the reference's default topology and the core of
    its decentralized-SGD recipe."""
    return dataclasses.replace(ExponentialGraph(size, base=2),
                               name="ExponentialTwoGraph")


def SymmetricExponentialGraph(size: int, base: int = 4) -> Topology:
    """Bidirectional exponential graph: edges to ``i ± base**k``."""
    offsets = []
    o = 1
    while o < size:
        offsets += [o, -o]
        o *= base
    return _uniform_from_out_offsets(
        size, offsets, f"SymmetricExponentialGraph(base={base})")


def RingGraph(size: int, connect_style: int = 0) -> Topology:
    """Ring: 0 = bidirectional (±1), 1 = unidirectional right (``i -> i+1``),
    2 = unidirectional left."""
    if connect_style not in (0, 1, 2):
        raise ValueError("connect_style must be 0, 1 or 2")
    offs = {0: [1, -1], 1: [1], 2: [-1]}[connect_style]
    return _uniform_from_out_offsets(size, offs,
                                     f"RingGraph(style={connect_style})")


def MeshGrid2DGraph(size: int,
                    shape: Optional[Tuple[int, int]] = None) -> Topology:
    """2-D (non-wraparound) grid with Metropolis-Hastings weights
    ``W[i,j] = 1 / (max(deg_i, deg_j) + 1)``, the remainder on the diagonal.
    Ranks lie row-major on the most-square factorization of ``size`` unless
    ``shape`` is given."""
    if shape is None:
        a = int(math.floor(math.sqrt(size)))
        while size % a != 0:
            a -= 1
        shape = (a, size // a)
    nrows, ncols = shape
    if nrows * ncols != size:
        raise ValueError(f"shape {shape} does not match size {size}")

    def nbrs(r: int) -> List[int]:
        y, x = divmod(r, ncols)
        out = []
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            yy, xx = y + dy, x + dx
            if 0 <= yy < nrows and 0 <= xx < ncols:
                out.append(yy * ncols + xx)
        return out

    deg = [len(nbrs(r)) for r in range(size)]
    w = np.zeros((size, size))
    for i in range(size):
        for j in nbrs(i):
            w[i, j] = 1.0 / (max(deg[i], deg[j]) + 1.0)
        w[i, i] = 1.0 - w[i].sum()
    return Topology(weights=w, name=f"MeshGrid2DGraph{shape}")


def StarGraph(size: int, center_rank: int = 0) -> Topology:
    """Bidirectional edges between ``center_rank`` and every other rank,
    uniform ``1/(in_degree+1)`` weights."""
    edges = []
    for r in range(size):
        if r != center_rank:
            edges += [(center_rank, r), (r, center_rank)]
    return Topology.from_edges(size, edges,
                               name=f"StarGraph(center={center_rank})")


def FullyConnectedGraph(size: int) -> Topology:
    """Complete digraph with uniform ``1/size`` weights: one gossip step is an
    exact average."""
    return Topology(weights=np.full((size, size), 1.0 / size),
                    name="FullyConnectedGraph")


def IsRegularGraph(topo: Topology) -> bool:
    """True iff every rank's in-degree equals its out-degree."""
    return all(topo.in_degree(r) == topo.out_degree(r)
               for r in range(topo.size))


def IsTopologyEquivalent(a: Optional[Topology], b: Optional[Topology]) -> bool:
    """Structural and weight equivalence."""
    if a is None or b is None or a.size != b.size:
        return False
    return bool(np.allclose(a.weights, b.weights, atol=1e-9))


def GetRecvWeights(topo: Topology, rank: int) -> Tuple[float, Dict[int, float]]:
    """``(self_weight, {src_rank: weight})`` for the receiving side of one
    gossip step."""
    return topo.self_weight(rank), {j: float(topo.weights[rank, j])
                                    for j in topo.in_neighbors(rank)}


def GetSendWeights(topo: Topology, rank: int) -> Tuple[float, Dict[int, float]]:
    """``(self_weight, {dst_rank: weight})``: the weight each destination
    applies to this rank's tensor."""
    return topo.self_weight(rank), {i: float(topo.weights[i, rank])
                                    for i in topo.out_neighbors(rank)}


# a healed/replanned name carries exactly one provenance suffix: repeated
# membership change collapses it instead of growing a
# "+heal(...)+heal(...)" chain
_PROVENANCE_RE = re.compile(r"(\+(heal|replan|ctl)\([^)]*\))+$")


def _base_name(name: str) -> str:
    """``name`` without its ``+heal(...)``/``+replan(...)`` suffix chain."""
    return _PROVENANCE_RE.sub("", name)


def heal(topo: Topology, dead_ranks) -> Topology:
    """Renormalise the mixing weights over the ranks that survive
    ``dead_ranks`` (counterpart of ``bluefog_tpu.topology.heal``).

    Each surviving row drops its dead in-neighbours' columns and is
    rescaled by the surviving row mass (the weights keep their relative
    proportions), so it stays row-stochastic; a survivor whose every
    neighbour died becomes a pure self-loop.  Dead rows become identity
    self-loops: their indices stay valid, but no surviving row references
    them.  Push-sum's weight channel de-biases whatever row-stochastic
    matrix is in effect, so switching to the healed one mid-run keeps the
    surviving average unbiased.

    ``heal(topo, [])`` returns ``topo``; killing every rank raises
    ``ValueError``.  ``heal(heal(t, a), b)`` equals ``heal(t, a | b)``,
    and the name carries one ``+heal([union])`` suffix, the union on
    :attr:`Topology.inactive`."""
    dead = frozenset(int(r) for r in dead_ranks)
    if not dead:
        return topo
    n = topo.size
    bad = [r for r in dead if not (0 <= r < n)]
    if bad:
        raise ValueError(f"dead ranks {sorted(bad)} out of range for "
                         f"size-{n} topology")
    all_dead = dead | topo.inactive
    if len(all_dead) >= n:
        raise ValueError("cannot heal a topology with every rank dead")
    w = topo.weights.copy()
    for r in dead:
        w[r, :] = 0.0
        w[:, r] = 0.0
        w[r, r] = 1.0
    for i in range(n):
        if i in all_dead:
            continue
        s = w[i].sum()
        if s <= 0.0:
            w[i, i] = 1.0  # every neighbour died: an isolated self-loop
        else:
            w[i] /= s
    return Topology(weights=w,
                    name=f"{_base_name(topo.name)}+heal({sorted(all_dead)})",
                    inactive=all_dead)


# the replan constructor ladder: the best graph family per live-member
# count m, balancing spectral gap against degree caps as the fleet grows
# and shrinks — a tiny fleet affords the one-step exact averager, a large
# one caps out-degree at ~log2(m) with the exponential family
_REPLAN_FULL_MAX = 4


def _replan_graph(m: int) -> Topology:
    if m == 1:
        return Topology(weights=np.ones((1, 1)), name="self")
    if m <= _REPLAN_FULL_MAX:
        return FullyConnectedGraph(m)
    return ExponentialGraph(m, base=2)


def replan(topo: Topology, members, *, name: Optional[str] = None
           ) -> Topology:
    """Build a FRESH mixing plan over the *current* member set — the
    generalization of :func:`heal` for intentional membership change
    (ranks joining and leaving a running job, not just dying).

    Where ``heal`` renormalizes the existing edge structure over the
    survivors (inert self-loop padding for the dead — right for an
    unplanned death mid-round), ``replan`` re-optimizes: it constructs a
    new graph over the ``m = len(members)`` live ranks (one-step exact
    averaging for tiny fleets, the exponential-2 family — out-degree
    ``~log2(m)``, strong connectivity, healthy spectral gap — beyond),
    then embeds it into the full ``n x n`` index space so rank numbering
    stays stable: non-members become inert identity self-loops, exactly
    the shape the rejoin/admission path expects.

    Determinism is the coordination-free contract: the plan depends ONLY
    on ``(topo.size, sorted(members))``, so every rank computing
    ``replan`` from the same member list converges on the SAME matrix
    with no extra rendezvous.  ``replan(replan(t, m1), m2) ==
    replan(t, m2)`` — replanning is memoryless over member sets.

    ``members`` must be a non-empty subset of ``range(topo.size)``.  The
    result's :attr:`Topology.inactive` is the complement and the name is
    a single collapsed ``+replan(n=m)`` suffix."""
    n = topo.size
    mem = sorted({int(r) for r in members})
    if not mem:
        raise ValueError("cannot replan over an empty member set")
    bad = [r for r in mem if not (0 <= r < n)]
    if bad:
        raise ValueError(f"member ranks {bad} out of range for "
                         f"size-{n} topology")
    m = len(mem)
    small = _replan_graph(m)
    w = np.zeros((n, n))
    idx = np.array(mem)
    w[np.ix_(idx, idx)] = small.weights
    mem_set = frozenset(mem)
    for r in range(n):
        if r not in mem_set:
            w[r, r] = 1.0
    return Topology(
        weights=w,
        name=name or f"{_base_name(topo.name)}+replan(n={m})",
        inactive=frozenset(range(n)) - frozenset(mem))


# the densify ladder the communication controller climbs when measured
# mixing lags the spectral-gap prediction: each level trades more edges
# (wire volume, ack pressure) for a larger spectral gap.  Level 0 is the
# replan base family (out-degree ~log2 m), level 1 doubles the edge set
# with the symmetric exponential family, level 2 is the one-step exact
# averager.
MAX_DENSIFY = 2


def _densify_graph(m: int, level: int) -> Topology:
    if m == 1:
        return Topology(weights=np.ones((1, 1)), name="self")
    if level >= 2 or m <= _REPLAN_FULL_MAX:
        return FullyConnectedGraph(m)
    if level == 1:
        return SymmetricExponentialGraph(m, base=2)
    return _replan_graph(m)


def replan_penalized(topo: Topology, members, *, slow=(),
                     densify: int = 0, name: Optional[str] = None
                     ) -> Topology:
    """The penalized form of :func:`replan` (the communication
    controller's actuation, which comes with ROADMAP item 10):
    a fresh mixing plan over ``members`` with **per-peer penalties**
    applied — a peer in ``slow`` (a slow rank, a lossy link) keeps only
    its canonical RING edges over the sorted member list, so its degree
    drops from the family's ~log2(m) to exactly one in-edge and one
    out-edge.  Strong connectivity is preserved by construction (the
    ring spine covers every member), so the penalized graph still
    passes the B-connectivity verifier — consensus keeps flowing, just
    not at the worst link's pace.  ``densify`` raises the base family's
    edge budget (0 = replan base, 1 = symmetric exponential, 2 = fully
    connected) when measured mixing lags the spectral-gap prediction.

    Determinism is the coordination-free contract, exactly as for
    :func:`replan`: the result depends ONLY on ``(topo.size,
    sorted(members), sorted(slow & members), min(densify, MAX_DENSIFY))``
    — every rank deciding from the same disseminated evidence converges
    on the SAME matrix with no rendezvous.  Memoryless over member sets
    and penalty sets; slow ranks outside ``members`` are ignored.  With
    no penalties and ``densify=0`` this is exactly ``replan``.

    The derived ``name`` carries one collapsed ``+ctl(...)`` suffix
    (the heal/replan provenance convention)."""
    n = topo.size
    mem = sorted({int(r) for r in members})
    if not mem:
        raise ValueError("cannot replan over an empty member set")
    bad = [r for r in mem if not (0 <= r < n)]
    if bad:
        raise ValueError(f"member ranks {bad} out of range for "
                         f"size-{n} topology")
    level = max(0, min(int(densify), MAX_DENSIFY))
    pen = sorted({int(r) for r in slow} & set(mem))
    if not pen and level == 0:
        base = replan(topo, mem)
        return base if name is None else dataclasses.replace(
            base, name=name)
    m = len(mem)
    small = _densify_graph(m, level)
    w_small = small.weights.copy()
    if pen and m > 1:
        # drop every edge incident to a penalized member EXCEPT the
        # canonical ring spine i -> (i+1) mod m over the sorted member
        # list — degree reduction that can never disconnect the graph
        pen_idx = {mem.index(r) for r in pen}
        edge = w_small > 0.0
        np.fill_diagonal(edge, False)
        for i in range(m):
            for j in range(m):
                if not edge[i, j]:
                    continue
                if i in pen_idx or j in pen_idx:
                    if i != (j + 1) % m:  # keep ring edge j -> j+1
                        edge[i, j] = False
        # re-uniform rows over the surviving edges (1/(in_degree+1))
        w_small = np.zeros((m, m))
        for i in range(m):
            nbrs = [j for j in range(m) if edge[i, j]]
            k = len(nbrs) + 1
            w_small[i, i] = 1.0 / k
            for j in nbrs:
                w_small[i, j] = 1.0 / k
    w = np.zeros((n, n))
    idx = np.array(mem)
    w[np.ix_(idx, idx)] = w_small
    mem_set = frozenset(mem)
    for r in range(n):
        if r not in mem_set:
            w[r, r] = 1.0
    return Topology(
        weights=w,
        name=name or (f"{_base_name(topo.name)}"
                      f"+ctl(n={m},slow={pen},densify={level})"),
        inactive=frozenset(range(n)) - mem_set)

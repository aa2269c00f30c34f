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
from typing import Dict, List, Optional, Sequence, Tuple

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
    """

    weights: np.ndarray
    name: str = "custom"

    def __post_init__(self):
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

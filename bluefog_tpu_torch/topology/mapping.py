"""Virtual-graph relabelling (counterpart of the JAX package's
``topology/mapping.py``).

On the TPU the physical network is a torus with known device coordinates,
and the JAX package orders the devices along a snake over them so that the
hot virtual edges are single hops.  On one card every rank is a row of the
same memory, so :func:`ici_ring_order` (re-exported from
:mod:`bluefog_tpu_torch.parallel.axes`) is the identity; across processes
the order of the ranks is the launcher's.  :func:`remap_topology` relabels
a topology by such an order.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from bluefog_tpu_torch.parallel.axes import ici_ring_order
from bluefog_tpu_torch.topology.graphs import Topology

__all__ = ["ici_ring_order", "remap_topology"]


def remap_topology(topo: Topology, perm: Sequence[int]) -> Topology:
    """Relabel ranks: new rank ``i`` plays old rank ``perm[i]``'s role.

    ``W'[i, j] = W[perm[i], perm[j]]``.  Used to align a virtual topology
    with a physical ordering chosen by :func:`ici_ring_order`."""
    p = np.asarray(perm)
    if sorted(p.tolist()) != list(range(topo.size)):
        raise ValueError("perm must be a permutation of range(size)")
    w = topo.weights[np.ix_(p, p)]
    return Topology(weights=w, name=f"{topo.name}|remap")

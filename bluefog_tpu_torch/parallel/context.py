"""The framework context: n virtual gossip ranks on one device.

Counterpart of ``bluefog_tpu/parallel/context.py``.  The JAX package puts one
rank on each device of a mesh; here the ``n`` ranks are virtual, rows of
rank-stacked tensors on one device, as the JAX package's stacked-array API
represents them.  ``rank()`` therefore names no calling process: host code
passes an explicit rank to neighbor queries, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from bluefog_tpu_torch.topology.graphs import ExponentialTwoGraph, Topology
from bluefog_tpu_torch.topology.schedule import GossipSchedule, build_schedule

__all__ = [
    "BluefogContext",
    "resolve_device",
    "init",
    "shutdown",
    "initialized",
    "get_context",
    "size",
    "rank",
    "set_topology",
    "load_topology",
    "in_neighbor_ranks",
    "out_neighbor_ranks",
]


@dataclasses.dataclass
class BluefogContext:
    """Everything the framework holds between calls; ``windows`` maps each
    registered window's name to its ``ops.windows.WindowState``."""

    size: int
    device: torch.device
    topology: Topology
    schedule: GossipSchedule
    windows: Dict[str, Any] = dataclasses.field(default_factory=dict)


_CTX: Optional[BluefogContext] = None


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device when no GPU is present
    raises rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def init(*, topology: Optional[Topology] = None, size: Optional[int] = None,
         device="cuda") -> BluefogContext:
    """Initialize ``size`` virtual ranks on ``device`` (the reference's
    ``bf.init()``).  ``size`` defaults to the topology's; the topology
    defaults to ``ExponentialTwoGraph(size)``, as in the JAX package."""
    global _CTX
    dev = resolve_device(device)
    if size is None:
        if topology is None:
            raise ValueError("init needs size= or topology=")
        size = topology.size
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    topo = topology if topology is not None else ExponentialTwoGraph(size)
    if topo.size != size:
        raise ValueError(f"topology size {topo.size} != size {size}")
    _CTX = BluefogContext(size=size, device=dev, topology=topo,
                          schedule=build_schedule(topo))
    return _CTX


def shutdown() -> None:
    """Tear down the context and free its windows (reference
    ``bf.shutdown()``)."""
    global _CTX
    if _CTX is not None:
        _CTX.windows.clear()
    _CTX = None


def initialized() -> bool:
    return _CTX is not None


def get_context() -> BluefogContext:
    if _CTX is None:
        raise RuntimeError("bluefog_tpu_torch.init() has not been called")
    return _CTX


def size() -> int:
    return get_context().size


def rank(default: int = 0) -> int:
    """The rank host code speaks for when it names none: every virtual rank
    lives in this one process (see the module docstring)."""
    get_context()
    return default


def set_topology(topology: Optional[Topology] = None,
                 is_weighted: bool = True) -> bool:
    """Install a new virtual topology and rebuild the gossip schedule
    (reference ``bf.set_topology``).  ``is_weighted=False`` replaces the
    weights by uniform ``1/(in_degree+1)`` rows."""
    ctx = get_context()
    topo = topology if topology is not None else ExponentialTwoGraph(ctx.size)
    if topo.size != ctx.size:
        raise ValueError(f"topology size {topo.size} != size {ctx.size}")
    if not is_weighted:
        topo = Topology.from_edges(topo.size, topo.edges, name=topo.name)
    ctx.topology = topo
    ctx.schedule = build_schedule(topo)
    return True


def load_topology() -> Topology:
    """Reference ``bf.load_topology()``."""
    return get_context().topology


def in_neighbor_ranks(rank_: Optional[int] = None) -> List[int]:
    r = rank() if rank_ is None else rank_
    return get_context().topology.in_neighbors(r)


def out_neighbor_ranks(rank_: Optional[int] = None) -> List[int]:
    r = rank() if rank_ is None else rank_
    return get_context().topology.out_neighbors(r)

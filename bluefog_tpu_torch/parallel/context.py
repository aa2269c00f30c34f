"""The framework context: n virtual gossip ranks on one device.

Counterpart of ``bluefog_tpu/parallel/context.py``.  The JAX package puts one
rank on each device of a mesh; here the ``n`` ranks are virtual, rows of
rank-stacked tensors on one device, as the JAX package's stacked-array API
represents them.  ``rank()`` therefore names no calling process: host code
passes an explicit rank to neighbor queries, as in the JAX package.

For the hierarchical ops the ranks are grouped into machines of
``local_size`` consecutive ranks (rank ``r`` on machine ``r //
local_size``), and the context keeps a machine-level topology and its gossip
schedule beside the rank-level ones.
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
    "local_size",
    "local_rank",
    "machine_size",
    "machine_rank",
    "set_machine_topology",
    "load_machine_topology",
    "in_neighbor_machine_ranks",
    "out_neighbor_machine_ranks",
]


@dataclasses.dataclass
class BluefogContext:
    """Everything the framework holds between calls; ``windows`` maps each
    registered window's name to its ``ops.windows.WindowState``.  The
    machine topology is None when there is one machine."""

    size: int
    device: torch.device
    topology: Topology
    schedule: GossipSchedule
    local_size: int = 1
    machine_topology: Optional[Topology] = None
    machine_schedule: Optional[GossipSchedule] = None
    windows: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_machines(self) -> int:
        return self.size // self.local_size


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


def init(*, topology: Optional[Topology] = None,
         machine_topology: Optional[Topology] = None,
         size: Optional[int] = None, local_size: Optional[int] = None,
         device="cuda") -> BluefogContext:
    """Initialize ``size`` virtual ranks on ``device`` (the reference's
    ``bf.init()``).  ``size`` defaults to the topology's; the topology
    defaults to ``ExponentialTwoGraph(size)``, as in the JAX package.

    ``local_size`` (default 1) ranks make a machine; with more than one
    machine the machine topology defaults to ``ExponentialTwoGraph`` over
    the ``size / local_size`` machines, as in the JAX package."""
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
    local = 1 if local_size is None else int(local_size)
    if local < 1 or size % local:
        raise ValueError(f"size {size} not divisible by local_size {local}")
    mtopo = machine_topology
    if mtopo is None and size // local > 1:
        mtopo = ExponentialTwoGraph(size // local)
    if mtopo is not None and mtopo.size != size // local:
        raise ValueError(f"machine topology size {mtopo.size} != "
                         f"{size // local} machines")
    _CTX = BluefogContext(
        size=size, device=dev, topology=topo, schedule=build_schedule(topo),
        local_size=local, machine_topology=mtopo,
        machine_schedule=build_schedule(mtopo) if mtopo is not None else None)
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


def local_size() -> int:
    """Ranks per machine."""
    return get_context().local_size


def local_rank(rank_: Optional[int] = None) -> int:
    r = rank() if rank_ is None else rank_
    return r % get_context().local_size


def machine_size() -> int:
    """The number of machines."""
    return get_context().n_machines


def machine_rank(rank_: Optional[int] = None) -> int:
    r = rank() if rank_ is None else rank_
    return r // get_context().local_size


def set_machine_topology(topology: Topology, is_weighted: bool = True) -> bool:
    """Install the machine-level topology of the hierarchical ops (reference
    ``bf.set_machine_topology``)."""
    ctx = get_context()
    if topology.size != ctx.n_machines:
        raise ValueError(f"machine topology size {topology.size} != "
                         f"n_machines {ctx.n_machines}")
    if not is_weighted:
        topology = Topology.from_edges(topology.size, topology.edges,
                                       name=topology.name)
    ctx.machine_topology = topology
    ctx.machine_schedule = build_schedule(topology)
    return True


def load_machine_topology() -> Optional[Topology]:
    return get_context().machine_topology


def in_neighbor_machine_ranks(machine_rank_: Optional[int] = None
                              ) -> List[int]:
    ctx = get_context()
    if ctx.machine_topology is None:
        return []
    m = machine_rank() if machine_rank_ is None else machine_rank_
    return ctx.machine_topology.in_neighbors(m)


def out_neighbor_machine_ranks(machine_rank_: Optional[int] = None
                               ) -> List[int]:
    ctx = get_context()
    if ctx.machine_topology is None:
        return []
    m = machine_rank() if machine_rank_ is None else machine_rank_
    return ctx.machine_topology.out_neighbors(m)

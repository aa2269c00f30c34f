"""The framework context: n gossip ranks, in one process or spread over
several.

Counterpart of ``bluefog_tpu/parallel/context.py``.  The JAX package puts one
rank on each device of a mesh; here the ``n`` ranks are virtual, rows of
rank-stacked tensors on one device, as the JAX package's stacked-array API
represents them.  In one process ``rank()`` therefore names no calling
process: host code passes an explicit rank to neighbor queries, as in the
JAX package.

When ``init`` runs inside a process group of ``P`` processes
(:func:`bluefog_tpu_torch.runtime.launch.initialize_cluster`, e.g. under
``python -m bluefog_tpu_torch.runtime.launch -np P``), the ranks are spread
over the processes as the JAX package spreads its mesh over controllers:
process ``p`` owns the contiguous block ``[p m, (p+1) m)`` of ``m = n / P``
ranks, every rank-stacked tensor it passes to a collective is that ``(m,
...)`` block, ``rank()`` is its first rank ``p m`` (the mesh rank of the
controller's first device in the reference), and a machine defaults to a
process (``local_size = m``).  The context then carries the
:class:`~bluefog_tpu_torch.ops.transport.Transport` that moves rows between
the processes.

For the hierarchical ops the ranks are grouped into machines of
``local_size`` consecutive ranks (rank ``r`` on machine ``r //
local_size``), and the context keeps a machine-level topology and its gossip
schedule beside the rank-level ones.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import torch

from bluefog_tpu_torch.ops import transport as _transport
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
    "process_rank",
    "process_count",
    "owned_ranks",
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
    machine topology is None when there is one machine.  Over several
    processes, ``process_rank`` and ``process_count`` place this process and
    ``transport`` moves rows between them (None in one process)."""

    size: int
    device: torch.device
    topology: Topology
    schedule: GossipSchedule
    local_size: int = 1
    machine_topology: Optional[Topology] = None
    machine_schedule: Optional[GossipSchedule] = None
    windows: Dict[str, Any] = dataclasses.field(default_factory=dict)
    process_rank: int = 0
    process_count: int = 1
    transport: Optional[_transport.Transport] = None

    @property
    def n_machines(self) -> int:
        return self.size // self.local_size

    @property
    def owned_ranks(self) -> range:
        """The ranks whose rows this process holds."""
        m = self.size // self.process_count
        return range(self.process_rank * m, (self.process_rank + 1) * m)


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


def _process_group() -> tuple:
    """``(rank, world size)`` of torch.distributed's default group, or
    ``(0, 1)`` when there is none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _process_device(device, processes: int) -> torch.device:
    """A bare ``"cuda"`` over several processes is this process's card:
    ``LOCAL_RANK`` (as the launcher sets it) modulo the cards present, so
    that processes sharing one card all take it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and processes > 1:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


SIMULATE_ENV = "BLUEFOG_TPU_TORCH_SIMULATE"


def simulated_size() -> Optional[int]:
    """The virtual rank count ``bfrun --simulate N`` asked for (None when
    it did not): ``init()`` then defaults to N ranks on the CPU."""
    v = os.environ.get(SIMULATE_ENV, "").strip()
    return int(v) if v else None


def init(*, topology: Optional[Topology] = None,
         machine_topology: Optional[Topology] = None,
         size: Optional[int] = None, local_size: Optional[int] = None,
         device=None) -> BluefogContext:
    """Initialize ``size`` ranks on ``device`` (the reference's
    ``bf.init()``).  ``size`` defaults to the topology's; the topology
    defaults to ``ExponentialTwoGraph(size)``, as in the JAX package.
    ``device`` defaults to the card; under ``bfrun --simulate N``, where
    the caller asked for N virtual ranks on the CPU, ``size`` defaults to
    N and ``device`` to the CPU.

    ``local_size`` ranks make a machine (default 1 in one process, a
    process's ``size / P`` ranks over ``P`` processes); with more than one
    machine the machine topology defaults to ``ExponentialTwoGraph`` over
    the ``size / local_size`` machines, as in the JAX package.

    Inside a process group of ``P > 1`` processes this process owns ranks
    ``[p m, (p+1) m)``, ``m = size / P`` (``P`` must divide ``size``), and
    the context gets a transport; ``init`` is then collective."""
    global _CTX
    sim = simulated_size()
    if device is None:
        device = "cpu" if sim else "cuda"
    if size is None and topology is None and sim:
        size = sim
    proc, procs = _process_group()
    dev = _process_device(device, procs)
    if size is None:
        if topology is None:
            raise ValueError("init needs size= or topology=")
        size = topology.size
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    if size % procs:
        raise ValueError(f"size {size} cannot be split over {procs} "
                         "processes: the process count must divide it")
    topo = topology if topology is not None else ExponentialTwoGraph(size)
    if topo.size != size:
        raise ValueError(f"topology size {topo.size} != size {size}")
    default_local = size // procs if procs > 1 else 1
    local = default_local if local_size is None else int(local_size)
    if local < 1 or size % local:
        raise ValueError(f"size {size} not divisible by local_size {local}")
    mtopo = machine_topology
    if mtopo is None and size // local > 1:
        mtopo = ExponentialTwoGraph(size // local)
    if mtopo is not None and mtopo.size != size // local:
        raise ValueError(f"machine topology size {mtopo.size} != "
                         f"{size // local} machines")
    if _CTX is not None:
        shutdown()
    tr = None
    if procs > 1:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        tr = _transport.Transport(dev)
    _CTX = BluefogContext(
        size=size, device=dev, topology=topo, schedule=build_schedule(topo),
        local_size=local, machine_topology=mtopo,
        machine_schedule=build_schedule(mtopo) if mtopo is not None else None,
        process_rank=proc, process_count=procs, transport=tr)
    _transport.activate(tr)
    # arm the flight recorder's crash dumps (excepthooks, fatal signals,
    # faulthandler, atexit-after-exception) at bring-up: the watchdog
    # dumps on its own, but a rank dying of an uncaught exception must
    # leave its recorder behind too.  No-op when BLUEFOG_TPU_BLACKBOX=0;
    # idempotent.
    from bluefog_tpu_torch import blackbox

    blackbox.install()
    return _CTX


def shutdown() -> None:
    """Tear down the context and free its windows (reference
    ``bf.shutdown()``)."""
    global _CTX
    if _CTX is not None:
        _CTX.windows.clear()
        if _CTX.transport is not None:
            _transport.activate(None)
            _CTX.transport.close()
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
    """The rank host code speaks for when it names none: ``default`` in one
    process, where every rank lives; over several processes this process's
    first rank (see the module docstring)."""
    ctx = get_context()
    if ctx.process_count > 1:
        return ctx.owned_ranks.start
    return default


def process_rank() -> int:
    """This process's index in the process group (0 in one process)."""
    return get_context().process_rank


def process_count() -> int:
    """The number of processes the ranks are spread over."""
    return get_context().process_count


def owned_ranks() -> range:
    """The ranks whose rows this process holds: all of them in one
    process."""
    return get_context().owned_ranks


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

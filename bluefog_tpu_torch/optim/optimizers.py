"""Decentralized optimizers: a ``torch.optim`` optimizer plus gossip.

Counterpart of ``bluefog_tpu/optim/optimizers.py`` for
:class:`CommunicationType`, :func:`decentralized_optimizer` (the
``neighbor_allreduce``, ``hierarchical_neighbor_allreduce``, ``allreduce``
and ``empty`` types), :func:`DistributedNeighborAllreduceOptimizer`,
:func:`DistributedHierarchicalNeighborAllreduceOptimizer`,
:func:`DistributedGradientAllreduceOptimizer` and the synchronous
:func:`DistributedWinPutOptimizer`.

The wrapped optimizer holds rank-stacked parameters, ``p[r]`` being rank
``r``'s copy, with rank-stacked gradients in ``.grad``.  Every
``torch.optim`` update is element-wise, so one optimizer over stacked tensors
is ``n`` independent optimizers with the same hyper-parameters.  Modes:

- **ATC** (adapt-then-combine): ``p' = W (p + update)``: the local step,
  then gossip of the result.
- **AWC** (adapt-with-combine, the default): ``p' = W p + update``, as the
  JAX package computes it: the local step runs on the un-mixed parameters,
  so an update that reads them (weight decay) sees the pre-step values, and
  the gossip's change ``(W - I) p``, computed out of place before it, is
  then added.  For ``neighbor_allreduce`` the change is one gossip with
  every self weight less one; the hierarchical mix has a local mean in front
  of its gossip, so its change is the mix less the parameters.
- **Allreduce** (the centralized baseline): every parameter's ``.grad`` is
  replaced by its mean over the ranks, one fused buffer per dtype, then the
  base step runs; no parameter is mixed.  Ranks that start equal stay equal.
- **WinPut**: the local step, then the one-sided window round: publish the
  new parameters (``win_sync``), put them into every out-neighbour's landing
  slot (``win_put``, kernel K2) and merge self and slots (``win_update``).
  With one static topology that equals an ATC gossip step.

``num_steps_per_communication=k`` gossips on every k-th step only and runs
plain local steps in between (the allreduce type averages every step, as in
the JAX package).
"""

from __future__ import annotations

import enum
from typing import List

import torch

from bluefog_tpu_torch.ops import collectives as C
from bluefog_tpu_torch.ops import windows as W
from bluefog_tpu_torch.topology.graphs import Topology
from bluefog_tpu_torch.topology.schedule import GossipSchedule, build_schedule

__all__ = [
    "CommunicationType",
    "DecentralizedOptimizer",
    "decentralized_optimizer",
    "DistributedNeighborAllreduceOptimizer",
    "DistributedGradientAllreduceOptimizer",
    "DistributedHierarchicalNeighborAllreduceOptimizer",
    "DistributedWinPutOptimizer",
]


class CommunicationType(enum.Enum):
    """Reference ``optimizers.CommunicationType`` (upstream)."""

    neighbor_allreduce = "neighbor.allreduce"
    hierarchical_neighbor_allreduce = "hierarchical.neighbor.allreduce"
    allreduce = "allreduce"
    win_put = "win.put"
    empty = "empty"


_PORTED = (CommunicationType.neighbor_allreduce,
           CommunicationType.hierarchical_neighbor_allreduce,
           CommunicationType.allreduce, CommunicationType.empty)


class DecentralizedOptimizer:
    """A base ``torch.optim.Optimizer`` over rank-stacked parameters whose
    :meth:`step` also runs the decentralized combine (see the module
    docstring).  Built by :func:`decentralized_optimizer` and
    :func:`DistributedWinPutOptimizer`; the ``win_put`` type keeps its
    window in :attr:`window`, the hierarchical type its machine schedule in
    :attr:`machine_schedule`."""

    def __init__(self, base: torch.optim.Optimizer, schedule, *,
                 communication_type: CommunicationType, atc: bool,
                 num_steps_per_communication: int, backend: str,
                 machine_schedule=None, local_size: int = 1):
        self.base = base
        self.schedule = schedule
        self.machine_schedule = machine_schedule
        self.local_size = local_size
        self.communication_type = communication_type
        self.atc = atc
        self.num_steps_per_communication = num_steps_per_communication
        self.backend = backend
        self.count = 0
        self.window = None
        size = (schedule.size if schedule is not None else
                machine_schedule.size * local_size
                if machine_schedule is not None else None)
        if size is not None:
            for p in self._params():
                if p.dim() == 0 or p.shape[0] != size:
                    raise ValueError(
                        "parameters must be rank-stacked with leading axis "
                        f"{size}, got shape {tuple(p.shape)}")
        if communication_type == CommunicationType.win_put:
            self.window = W.win_create(self._params(), schedule,
                                       name="winput_opt")

    @property
    def param_groups(self):
        return self.base.param_groups

    @property
    def state(self):
        return self.base.state

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.base.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)

    def _mix(self, change: bool = False) -> List[torch.Tensor]:
        """The mixed parameters, out of place: gossip (flat or hierarchical)
        fused into one buffer per dtype, or the window round over the
        window's one buffer per dtype.  With ``change``, the flat gossip's
        change to each parameter (the mixed value less the parameter)
        instead: the same gossip with every self weight one less."""
        params = self._params()
        if self.window is not None:
            W.win_sync(self.window, params)
            W.win_put(self.window, None, backend=self.backend)
            return W.win_update(self.window)[0]
        if self.machine_schedule is not None:
            return C.fuse_apply(
                lambda t: C.hierarchical_neighbor_allreduce(
                    t, self.machine_schedule, local_size=self.local_size,
                    backend=self.backend), params)
        sw = self.schedule.self_weights - 1.0 if change else None
        return C.fuse_apply(
            lambda t: C.neighbor_allreduce(t, self.schedule, self_weight=sw,
                                           backend=self.backend), params)

    def _average_grads(self) -> None:
        """Each ``.grad`` replaced in place by its mean over the ranks, one
        fused allreduce per dtype."""
        grads = [p.grad for p in self._params() if p.grad is not None]
        for g, avg in zip(grads, C.fuse_apply(C.allreduce, grads)):
            g.copy_(avg)

    def _communicates(self) -> bool:
        if self.schedule is None and self.machine_schedule is None:
            return False
        k = self.num_steps_per_communication
        return k <= 1 or (self.count + 1) % k == 0

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every rank: the base step, and on communicating steps
        the gossip before it (AWC) or after it (ATC)."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self.communication_type == CommunicationType.allreduce:
            self._average_grads()
            self.base.step()
        elif not self._communicates():
            self.base.step()
        elif self.atc:
            self.base.step()
            for p, m in zip(self._params(), self._mix()):
                p.copy_(m)
        elif self.machine_schedule is not None:
            # the hierarchical mix less the parameters, out of place, then
            # the base step on the un-mixed parameters
            params = self._params()
            change = [m.sub_(p) for p, m in zip(params, self._mix())]
            self.base.step()
            for p, d in zip(params, change):
                p.add_(d)
        else:
            # the mix's change to each parameter, then the base step on the
            # un-mixed parameters
            params = self._params()
            change = self._mix(change=True)
            self.base.step()
            for p, d in zip(params, change):
                p.add_(d)
        self.count += 1
        return loss

    def state_dict(self):
        return {"base": self.base.state_dict(), "count": self.count}

    def load_state_dict(self, state) -> None:
        self.base.load_state_dict(state["base"])
        self.count = int(state["count"])


def decentralized_optimizer(
    base: torch.optim.Optimizer,
    topology,
    *,
    communication_type: CommunicationType = CommunicationType.neighbor_allreduce,
    atc: bool = False,
    num_steps_per_communication: int = 1,
    local_size: int = 1,
    machine_topology=None,
    backend: str = "auto",
) -> DecentralizedOptimizer:
    """Wrap ``base`` so each :meth:`~DecentralizedOptimizer.step` also
    performs decentralized averaging.

    Args:
      base: a ``torch.optim`` optimizer over rank-stacked parameters.
      topology: a static :class:`Topology` or :class:`GossipSchedule`
        (``None`` for the ``hierarchical_neighbor_allreduce``,
        ``allreduce`` and ``empty`` types).
      communication_type: ``neighbor_allreduce``,
        ``hierarchical_neighbor_allreduce``, ``allreduce`` or ``empty``;
        ``win_put`` is built by :func:`DistributedWinPutOptimizer`.
      atc: adapt-then-combine when True, adapt-with-combine when False.
      num_steps_per_communication: gossip every k-th step (local SGD).
      local_size / machine_topology: the hierarchical type's ranks per
        machine and its machine-level :class:`Topology` or
        :class:`GossipSchedule`.
      backend: gossip path, ``'kernel'``, ``'plain'`` or ``'auto'`` (see
        :func:`bluefog_tpu_torch.ops.collectives.neighbor_allreduce`).
    """
    ct = communication_type
    if ct not in _PORTED:
        raise NotImplementedError(
            f"communication_type {ct.value!r} is not ported yet")
    machine_schedule = None
    if ct == CommunicationType.hierarchical_neighbor_allreduce:
        if machine_topology is None:
            raise ValueError("hierarchical mode needs machine_topology")
        machine_schedule = (build_schedule(machine_topology)
                            if isinstance(machine_topology, Topology)
                            else machine_topology)
        if not isinstance(machine_schedule, GossipSchedule):
            raise ValueError(
                "hierarchical mode takes a single machine topology")
    schedule = None
    if ct == CommunicationType.neighbor_allreduce:
        if isinstance(topology, Topology):
            schedule = build_schedule(topology)
        elif isinstance(topology, GossipSchedule):
            schedule = topology
        elif topology is None:
            raise ValueError(
                "communication_type=neighbor_allreduce requires a topology")
        else:
            raise NotImplementedError(
                "dynamic (sequence or callable) topologies are not ported yet;"
                " pass one Topology or GossipSchedule")
    return DecentralizedOptimizer(
        base, schedule, communication_type=ct, atc=atc,
        num_steps_per_communication=num_steps_per_communication,
        backend=backend, machine_schedule=machine_schedule,
        local_size=local_size)


def DistributedNeighborAllreduceOptimizer(
    base: torch.optim.Optimizer,
    *,
    topology,
    atc: bool = False,
    num_steps_per_communication: int = 1,
    backend: str = "auto",
) -> DecentralizedOptimizer:
    """Reference ``bf.DistributedNeighborAllreduceOptimizer``: decentralized
    gossip averaging of the parameters each step."""
    return decentralized_optimizer(
        base, topology,
        communication_type=CommunicationType.neighbor_allreduce,
        atc=atc, num_steps_per_communication=num_steps_per_communication,
        backend=backend)


def DistributedGradientAllreduceOptimizer(
        base: torch.optim.Optimizer) -> DecentralizedOptimizer:
    """Reference ``bf.DistributedGradientAllreduceOptimizer``, the
    centralized (Horovod-style) baseline: every step averages the gradients
    over all ranks before the base step."""
    return decentralized_optimizer(
        base, None, communication_type=CommunicationType.allreduce)


def DistributedHierarchicalNeighborAllreduceOptimizer(
    base: torch.optim.Optimizer,
    *,
    machine_topology,
    local_size: int,
    atc: bool = False,
    num_steps_per_communication: int = 1,
    backend: str = "auto",
) -> DecentralizedOptimizer:
    """Reference ``bf.DistributedHierarchicalNeighborAllreduceOptimizer``:
    each step, the exact average within every machine of ``local_size``
    consecutive ranks, then gossip between machines along
    ``machine_topology``, in ATC or AWC.  ``backend`` picks the machine
    fold's path (K1 for a circulant machine schedule under ``'auto'``)."""
    if local_size is None or local_size < 1:
        raise ValueError("hierarchical mode requires local_size >= 1")
    return decentralized_optimizer(
        base, None,
        communication_type=CommunicationType.hierarchical_neighbor_allreduce,
        atc=atc, num_steps_per_communication=num_steps_per_communication,
        local_size=local_size, machine_topology=machine_topology,
        backend=backend)


def DistributedWinPutOptimizer(
    base: torch.optim.Optimizer,
    *,
    topology,
    num_steps_per_communication: int = 1,
    async_: bool = False,
    lr=None,
) -> DecentralizedOptimizer:
    """Reference ``bf.DistributedWinPutOptimizer``, synchronous mode: after
    the local step, push the parameters to the out-neighbours with
    ``win_put`` and merge the landed ones with ``win_update`` (see the module
    docstring).  The window is created from the parameters at construction
    and lives in the optimizer's ``window``.

    Args:
      base: a ``torch.optim`` optimizer over rank-stacked parameters.
      topology: one static :class:`Topology` or :class:`GossipSchedule` (a
        sequence of exactly one is accepted; longer ones raise).
      num_steps_per_communication: run the window round every k-th step;
        the window keeps its stale slots in between.
      async_: the host-runtime mode (rank loops at independent rates); not
        ported yet, raises ``NotImplementedError``.
      lr: the async mode's learning rate; passing it without ``async_``
        raises, as in the JAX package.

    The put takes the ``'auto'`` route (K2 for a circulant schedule); the
    returned optimizer's ``backend`` attribute selects another.
    """
    if async_:
        raise NotImplementedError(
            "DistributedWinPutOptimizer(async_=True) runs on the host runtime "
            "(rank loops at independent rates), which is not ported yet; it "
            "comes with slice 6")
    if lr is not None:
        raise ValueError(
            "lr= applies only to async_=True (the sync path takes its "
            "learning rate from `base`); remove lr= or set async_=True")
    if topology is None:
        raise ValueError("DistributedWinPutOptimizer requires a topology")
    scheds = ([topology] if isinstance(topology, (Topology, GossipSchedule))
              else list(topology))
    if len(scheds) != 1:
        raise ValueError(
            "DistributedWinPutOptimizer takes a single static topology "
            "(dynamic schedule lists are only supported by the "
            "neighbor_allreduce optimizer)")
    sched = scheds[0]
    if isinstance(sched, Topology):
        sched = build_schedule(sched)
    return DecentralizedOptimizer(
        base, sched, communication_type=CommunicationType.win_put, atc=True,
        num_steps_per_communication=num_steps_per_communication,
        backend="auto")

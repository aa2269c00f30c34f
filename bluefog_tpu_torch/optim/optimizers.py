"""Decentralized optimizers: a ``torch.optim`` optimizer plus gossip.

Counterpart of ``bluefog_tpu/optim/optimizers.py`` for
:class:`CommunicationType`, :func:`decentralized_optimizer` (the
``neighbor_allreduce``, ``hierarchical_neighbor_allreduce``, ``allreduce``
and ``empty`` types, static, periodic or aperiodic topologies),
:func:`set_comm_every` and :func:`get_comm_every`,
:func:`DistributedNeighborAllreduceOptimizer`,
:func:`DistributedHierarchicalNeighborAllreduceOptimizer`,
:func:`DistributedGradientAllreduceOptimizer`, the synchronous
:func:`DistributedWinPutOptimizer`, :func:`DistributedChocoSGDOptimizer`,
:func:`DistributedGradientTrackingOptimizer` and
:func:`DistributedExactDiffusionOptimizer`.

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
  every self weight less one (the current phase's, or ``W[i, i] - 1`` of a
  callable's matrix); the hierarchical mix has a local mean in front of its
  gossip, so its change is the mix less the parameters.
- **Allreduce** (the centralized baseline): every parameter's ``.grad`` is
  replaced by its mean over the ranks, one fused buffer per dtype, then the
  base step runs; no parameter is mixed.  Ranks that start equal stay equal.
- **WinPut**: the local step, then the one-sided window round: publish the
  new parameters (``win_sync``), put them into every out-neighbour's landing
  slot (``win_put``, kernel K2) and merge self and slots (``win_update``).
  With one static topology that equals an ATC gossip step.

A ``neighbor_allreduce`` topology may change with time: a sequence of
topologies is cycled by the *communication* count (not the step count, so
that local steps between gossips do not pin one phase), and a callable
``comm_count -> W`` gives any matrix each round
(:func:`~bluefog_tpu_torch.ops.collectives.neighbor_allreduce_aperiodic`).

``num_steps_per_communication=k`` gossips on every k-th step only and runs
plain local steps in between (the allreduce type averages every step, as in
the JAX package).

In a context that spans processes the parameters carry this process's
owned block of ranks, and every optimizer here runs over it, its gossip,
mean, window round or compressed payloads crossing the processes: a
callable topology is called with the communication count in every process
(each must return the same matrix); gradient tracking's two mixes a step
are two exchanges; exact diffusion's symmetry check reads the global
schedule; ``u``'s snapshot, step, difference and restore stay in each
process.  CHOCO-SGD's hierarchical form needs each process to hold whole
machines.

The JAX optimizers are optax transformations that return the base
transform's update direction ``u``; a ``torch.optim`` base instead steps the
parameters in place.  Gradient tracking and exact diffusion need ``u`` on
its own, so they take it as the base step's change on the un-mixed
parameters (snapshot, step, difference, restore).  In f32 that difference
rounds ``u`` to the parameters' ulp, one rounding per step that the optax
form does not have.
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bluefog_tpu_torch.ops import collectives as C
from bluefog_tpu_torch.ops import compression as CP
from bluefog_tpu_torch.ops import transport as T
from bluefog_tpu_torch.ops import windows as W
from bluefog_tpu_torch.topology.graphs import Topology
from bluefog_tpu_torch.topology.schedule import GossipSchedule, build_schedule

__all__ = [
    "CommunicationType",
    "DecentralizedOptimizer",
    "GradientTrackingOptimizer",
    "ExactDiffusionOptimizer",
    "ChocoSGDOptimizer",
    "decentralized_optimizer",
    "set_comm_every",
    "get_comm_every",
    "DistributedNeighborAllreduceOptimizer",
    "DistributedGradientAllreduceOptimizer",
    "DistributedHierarchicalNeighborAllreduceOptimizer",
    "DistributedWinPutOptimizer",
    "DistributedChocoSGDOptimizer",
    "DistributedGradientTrackingOptimizer",
    "DistributedExactDiffusionOptimizer",
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


def _as_schedules(topology) -> List[GossipSchedule]:
    if isinstance(topology, (Topology, GossipSchedule)):
        topology = [topology]
    scheds = [t if isinstance(t, GossipSchedule) else build_schedule(t)
              for t in topology]
    if not scheds:
        raise ValueError("a topology sequence needs at least one topology")
    return scheds


def _assign(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    # the optimizers' own tensors are updated in place, so a caller holding
    # them (``tensors()``) sees the new values
    for t, v in zip(dst, src):
        t.copy_(v)


def _check_stacked(params, size: int) -> None:
    """Every parameter carries the ranks this process holds of a ``size``
    rank graph on its leading axis: all of them in one process, the owned
    block over several."""
    size = T.owned_rows(size)
    for p in params:
        if p.dim() == 0 or p.shape[0] != size:
            raise ValueError(
                "parameters must be rank-stacked with leading axis "
                f"{size}, got shape {tuple(p.shape)}")


class _Wrapped:
    """What every optimizer here shares: the base ``torch.optim`` optimizer
    over rank-stacked parameters, its ``param_groups`` and ``state``, the
    step count and the gossip ``backend``."""

    window = None

    def __init__(self, base: torch.optim.Optimizer, backend: str):
        self.base = base
        self.backend = backend
        self.count = 0

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

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor the optimizer carries besides the parameters and the
        base optimizer's state, by name (empty here); each step updates them
        in place."""
        return {}

    def _base_update(self) -> List[torch.Tensor]:
        """The base step's change ``u`` to each parameter, the parameters
        left as they were: snapshot, step, difference, restore."""
        params = self._params()
        snap = [p.clone() for p in params]
        self.base.step()
        u = [p - s for p, s in zip(params, snap)]
        for p, s in zip(params, snap):
            p.copy_(s)
        return u

    def _gossip(self, tree) -> List[torch.Tensor]:
        """One gossip of ``tree`` along the optimizer's static schedule,
        fused into one buffer per dtype (one K1 launch each)."""
        return C.fuse_apply(
            lambda t: C.neighbor_allreduce(t, self.schedule,
                                           backend=self.backend), tree)


class DecentralizedOptimizer(_Wrapped):
    """A base ``torch.optim.Optimizer`` over rank-stacked parameters whose
    :meth:`step` also runs the decentralized combine (see the module
    docstring).  Built by :func:`decentralized_optimizer` and
    :func:`DistributedWinPutOptimizer`; the ``win_put`` type keeps its
    window in :attr:`window`, the hierarchical type its machine schedule in
    :attr:`machine_schedule`, a periodic topology its phases in
    :attr:`schedules` and an aperiodic one its callable in
    :attr:`matrix_fn`."""

    def __init__(self, base: torch.optim.Optimizer,
                 schedules: Optional[Sequence[GossipSchedule]], *,
                 communication_type: CommunicationType, atc: bool,
                 num_steps_per_communication: int, backend: str,
                 machine_schedule=None, local_size: int = 1,
                 matrix_fn=None, max_rotations: Optional[int] = None,
                 runtime_cadence: bool = False):
        super().__init__(base, backend)
        self.schedules = tuple(schedules) if schedules else None
        self.matrix_fn = matrix_fn
        self.max_rotations = max_rotations
        self.machine_schedule = machine_schedule
        self.local_size = local_size
        self.communication_type = communication_type
        self.atc = atc
        self.runtime_cadence = runtime_cadence
        self.comm_every = max(1, num_steps_per_communication)
        self.comm_count = 0
        size = (self.schedules[0].size if self.schedules else
                machine_schedule.size * local_size
                if machine_schedule is not None else None)
        if size is not None:
            if any(s.size != size for s in self.schedules or ()):
                raise ValueError("every phase of a dynamic topology must "
                                 "have the same size")
            _check_stacked(self._params(), size)
        if communication_type == CommunicationType.win_put:
            self.window = W.win_create(self._params(), self.schedule,
                                       name="winput_opt")

    @property
    def schedule(self) -> Optional[GossipSchedule]:
        """The schedule the next gossip runs: the static one, or the current
        phase of a periodic topology (None for the other types)."""
        if not self.schedules:
            return None
        return self.schedules[self.comm_count % len(self.schedules)]

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The window's self and landing buffers (``win_put`` type)."""
        out = {}
        if self.window is not None:
            for dt, buf in self.window.bufs.items():
                out[f"window.self.{dt}"] = buf
                out[f"window.peers.{dt}"] = self.window.peers[dt]
        return out

    def _mix(self, change: bool = False) -> List[torch.Tensor]:
        """The mixed parameters, out of place: gossip (flat, dynamic or
        hierarchical) fused into one buffer per dtype, or the window round
        over the window's one buffer per dtype.  With ``change``, the flat
        gossip's change to each parameter (the mixed value less the
        parameter) instead: the same gossip with every self weight one
        less."""
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
        if self.matrix_fn is not None:
            w = torch.as_tensor(self.matrix_fn(self.comm_count),
                                dtype=torch.float32)
            if change:
                w = w - torch.eye(w.shape[0])
            return C.fuse_apply(
                lambda t: C.neighbor_allreduce_aperiodic(
                    t, w, max_rotations=self.max_rotations), params)
        sched = self.schedule
        sw = sched.self_weights - 1.0 if change else None
        return C.fuse_apply(
            lambda t: C.neighbor_allreduce(t, sched, self_weight=sw,
                                           backend=self.backend), params)

    def _average_grads(self) -> None:
        """Each ``.grad`` replaced in place by its mean over the ranks, one
        fused allreduce per dtype."""
        grads = [p.grad for p in self._params() if p.grad is not None]
        for g, avg in zip(grads, C.fuse_apply(C.allreduce, grads)):
            g.copy_(avg)

    def _communicates(self) -> bool:
        k = self.comm_every
        return k <= 1 or (self.count + 1) % k == 0

    @torch.no_grad()
    def step(self, closure=None):
        """One update of every rank: the base step, and on communicating steps
        the gossip before it (AWC) or after it (ATC)."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        comm = True
        if self.communication_type == CommunicationType.allreduce:
            self._average_grads()
            self.base.step()
        elif self.communication_type == CommunicationType.empty:
            self.base.step()
        elif not self._communicates():
            comm = False
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
        self.comm_count += int(comm)
        return loss

    def state_dict(self):
        out = {"base": self.base.state_dict(), "count": self.count,
               "comm_count": self.comm_count}
        if self.runtime_cadence:
            out["comm_every"] = self.comm_every
        return out

    def load_state_dict(self, state) -> None:
        self.base.load_state_dict(state["base"])
        self.count = int(state["count"])
        self.comm_count = int(state["comm_count"])
        if self.runtime_cadence:
            self.comm_every = int(state["comm_every"])


def set_comm_every(opt: DecentralizedOptimizer, k: int) -> None:
    """Retune a ``runtime_cadence=True`` optimizer to gossip every ``k``-th
    step (1 = every step) from its next step on.  The JAX package rewrites a
    scalar of the optimizer state so the compiled step runs unchanged; here
    the optimizer holds the cadence and reads it at each step."""
    if not getattr(opt, "runtime_cadence", False):
        raise TypeError(
            "set_comm_every needs a runtime_cadence=True optimizer (got "
            f"{type(opt).__name__}; pass runtime_cadence=True to "
            "decentralized_optimizer)")
    opt.comm_every = max(int(k), 1)


def get_comm_every(opt: DecentralizedOptimizer) -> int:
    """The current gossip cadence of a ``runtime_cadence=True`` optimizer."""
    if not getattr(opt, "runtime_cadence", False):
        raise TypeError(
            "get_comm_every needs a runtime_cadence=True optimizer (got "
            f"{type(opt).__name__})")
    return opt.comm_every


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
    max_rotations: Optional[int] = None,
    runtime_cadence: bool = False,
) -> DecentralizedOptimizer:
    """Wrap ``base`` so each :meth:`~DecentralizedOptimizer.step` also
    performs decentralized averaging.

    Args:
      base: a ``torch.optim`` optimizer over rank-stacked parameters.
      topology: a static :class:`Topology` or :class:`GossipSchedule`; a
        *sequence* of them for periodic time-varying gossip, cycled by the
        communication count (e.g. ``one_peer_exponential_two_schedules(n)``);
        or a **callable** ``comm_count -> (n, n)`` mixing matrix on the host
        for aperiodic gossip (e.g. ``functools.partial(
        one_peer_exp2_mixing_matrix, n)``).  ``None`` for the
        ``hierarchical_neighbor_allreduce``, ``allreduce`` and ``empty``
        types.
      communication_type: ``neighbor_allreduce``,
        ``hierarchical_neighbor_allreduce``, ``allreduce`` or ``empty``;
        ``win_put`` is built by :func:`DistributedWinPutOptimizer`.
      atc: adapt-then-combine when True, adapt-with-combine when False.
      num_steps_per_communication: gossip every k-th step (local SGD).
      local_size / machine_topology: the hierarchical type's ranks per
        machine and its machine-level :class:`Topology` or
        :class:`GossipSchedule`.
      backend: gossip path, ``'kernel'``, ``'plain'`` or ``'auto'`` (see
        :func:`bluefog_tpu_torch.ops.collectives.neighbor_allreduce`); the
        aperiodic gossip always runs on K1.
      max_rotations: the callable mode's cap on active rotations; a matrix
        with more poisons the parameters with NaN (see
        :func:`~bluefog_tpu_torch.ops.collectives.
        neighbor_allreduce_aperiodic`).
      runtime_cadence: let :func:`set_comm_every` retune the gossip cadence
        between steps (it starts at ``num_steps_per_communication``); gossip
        types only.
    """
    ct = communication_type
    if ct not in _PORTED:
        raise NotImplementedError(
            f"communication_type {ct.value!r} is not ported yet")
    schedules = None
    matrix_fn = None
    if ct == CommunicationType.neighbor_allreduce:
        if topology is None:
            raise ValueError(
                "communication_type=neighbor_allreduce requires a topology")
        if callable(topology) and not isinstance(
                topology, (Topology, GossipSchedule)):
            matrix_fn = topology
        else:
            schedules = _as_schedules(topology)
    if max_rotations is not None and matrix_fn is None:
        # silently ignoring the cap would gossip every rotation, the size
        # the parameter exists to bound
        raise ValueError(
            "max_rotations applies only to the callable-topology "
            "(aperiodic) mode; static topologies/schedules gossip one slot "
            "per edge class already")
    machine_schedule = None
    if ct == CommunicationType.hierarchical_neighbor_allreduce:
        if machine_topology is None:
            raise ValueError("hierarchical mode needs machine_topology")
        mscheds = _as_schedules(machine_topology)
        if len(mscheds) != 1:
            raise ValueError(
                "hierarchical mode takes a single machine topology")
        machine_schedule = mscheds[0]
    if runtime_cadence and ct in (CommunicationType.allreduce,
                                  CommunicationType.empty):
        raise ValueError(
            "runtime_cadence applies to the gossip communication types "
            "(there is no local-SGD gate to retune on "
            f"{ct.value!r})")
    return DecentralizedOptimizer(
        base, schedules, communication_type=ct, atc=atc,
        num_steps_per_communication=num_steps_per_communication,
        backend=backend, machine_schedule=machine_schedule,
        local_size=local_size, matrix_fn=matrix_fn,
        max_rotations=max_rotations, runtime_cadence=runtime_cadence)


def DistributedNeighborAllreduceOptimizer(
    base: torch.optim.Optimizer,
    *,
    topology,
    atc: bool = False,
    num_steps_per_communication: int = 1,
    backend: str = "auto",
    max_rotations: Optional[int] = None,
    runtime_cadence: bool = False,
) -> DecentralizedOptimizer:
    """Reference ``bf.DistributedNeighborAllreduceOptimizer``: decentralized
    gossip averaging of the parameters each step, over a static, periodic
    or aperiodic topology (see :func:`decentralized_optimizer`)."""
    return decentralized_optimizer(
        base, topology,
        communication_type=CommunicationType.neighbor_allreduce,
        atc=atc, num_steps_per_communication=num_steps_per_communication,
        backend=backend, max_rotations=max_rotations,
        runtime_cadence=runtime_cadence)


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
    fold's path (K1 under ``'auto'``)."""
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

    The put takes the ``'auto'`` route (K2 for any schedule with a slot);
    the returned optimizer's ``backend`` attribute selects another.
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
    scheds = _as_schedules(topology)
    if len(scheds) != 1:
        raise ValueError(
            "DistributedWinPutOptimizer takes a single static topology "
            "(dynamic schedule lists are only supported by the "
            "neighbor_allreduce optimizer)")
    return DecentralizedOptimizer(
        base, scheds, communication_type=CommunicationType.win_put, atc=True,
        num_steps_per_communication=num_steps_per_communication,
        backend="auto")


def _symmetric_schedule(topology, what: str) -> GossipSchedule:
    scheds = _as_schedules(topology)
    if len(scheds) != 1:
        raise ValueError(f"{what} takes a single static topology")
    mix = scheds[0].mixing_matrix()
    if not np.allclose(mix, mix.T, atol=1e-8):
        raise ValueError(
            f"{what} requires a symmetric mixing matrix (ring/grid/full); "
            f"got an asymmetric one (max |W - W^T| = "
            f"{np.abs(mix - mix.T).max():.3g})")
    return scheds[0]


class ChocoSGDOptimizer(_Wrapped):
    """CHOCO-SGD over rank-stacked parameters: the base step, then one
    CHOCO-Gossip round of the stepped parameters (flat, or hierarchical
    with ``local_size > 1``).  Built by
    :func:`DistributedChocoSGDOptimizer`; the mirrors and the round counter
    live in :attr:`choco`."""

    def __init__(self, base, schedule: GossipSchedule, *,
                 compressor: CP.Compressor, gamma: float, key,
                 local_size: int):
        super().__init__(base, "plain")
        self.schedule = schedule
        self.compressor = compressor
        self.gamma = gamma
        self.key = key
        self.local_size = local_size
        _check_stacked(self._params(), schedule.size * local_size)
        self.choco = CP.choco_init(self._params(), schedule)

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The public copies and the neighbour mirrors, per parameter."""
        out = {f"choco.self.{i}": t
               for i, t in enumerate(self.choco.xhat_self)}
        out.update({f"choco.nbrs.{i}": t
                    for i, t in enumerate(self.choco.xhat_nbrs)})
        return out

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.base.step()
        params = self._params()
        kw = dict(compressor=self.compressor, gamma=self.gamma, key=self.key)
        if self.local_size > 1:
            new, choco = CP.hierarchical_choco_gossip(
                params, self.choco, self.schedule,
                local_size=self.local_size, **kw)
        else:
            new, choco = CP.choco_gossip(params, self.choco, self.schedule,
                                         **kw)
        _assign(params + self.choco.xhat_self + self.choco.xhat_nbrs,
                list(new) + list(choco.xhat_self) + list(choco.xhat_nbrs))
        self.choco = self.choco._replace(round=choco.round)
        self.count += 1
        return loss

    def state_dict(self):
        return {"base": self.base.state_dict(), "count": self.count,
                "xhat_self": list(self.choco.xhat_self),
                "xhat_nbrs": list(self.choco.xhat_nbrs),
                "round": self.choco.round}

    def load_state_dict(self, state) -> None:
        self.base.load_state_dict(state["base"])
        self.count = int(state["count"])
        _assign(self.choco.xhat_self + self.choco.xhat_nbrs,
                list(state["xhat_self"]) + list(state["xhat_nbrs"]))
        self.choco = self.choco._replace(round=int(state["round"]))


def DistributedChocoSGDOptimizer(
    base: torch.optim.Optimizer,
    topology,
    *,
    compressor: Optional[CP.Compressor] = None,
    gamma: Optional[float] = None,
    key: Optional[int] = None,
    local_size: int = 1,
) -> ChocoSGDOptimizer:
    """CHOCO-SGD (Koloskova et al., ICML 2019): the local step, then
    *compressed* gossip that still reaches exact consensus (see
    :mod:`bluefog_tpu_torch.ops.compression`).

    ``topology`` must give a symmetric mixing matrix (ring, grid, full;
    checked here).  ``compressor`` defaults to ``random_block_k(0.1)``;
    ``gamma`` is the consensus step size, and ``None`` takes the
    compressor's ``delta`` (stable in every configuration the JAX package
    measured).  ``key`` is the integer seed of the shared masks (default
    0).  The state holds ``K + 1`` copies of the parameters (the public copy
    and one mirror per slot).

    Hierarchical form: with ``local_size > 1``, ``topology`` is the
    *machine* topology over ``n / local_size`` machines of consecutive
    ranks: the exact mean inside each machine, CHOCO across machines
    (:func:`~bluefog_tpu_torch.ops.compression.hierarchical_choco_gossip`).
    The JAX package takes a ``(machine_axis, local_axis)`` pair instead.
    """
    sched = _symmetric_schedule(topology, "CHOCO-SGD")
    if local_size < 1:
        raise ValueError(f"local_size must be >= 1, got {local_size}")
    comp = compressor if compressor is not None else CP.random_block_k(0.1)
    return ChocoSGDOptimizer(
        base, sched, compressor=comp,
        gamma=float(comp.delta) if gamma is None else gamma, key=key,
        local_size=local_size)


class GradientTrackingOptimizer(_Wrapped):
    """Gradient tracking over rank-stacked parameters: ``y <- W y + u -
    u_prev`` and ``x <- W x + y``, each mix one fused gossip (K1 under
    ``'auto'``).  Built by :func:`DistributedGradientTrackingOptimizer`;
    the trackers live in :attr:`y` and :attr:`u_prev`."""

    def __init__(self, base, schedule: GossipSchedule, backend: str):
        super().__init__(base, backend)
        self.schedule = schedule
        params = self._params()
        _check_stacked(params, schedule.size)
        self.y = [torch.zeros_like(p) for p in params]
        self.u_prev = [torch.zeros_like(p) for p in params]

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The tracker ``y`` and the last update ``u_prev``, per parameter."""
        out = {f"tracker.y.{i}": t for i, t in enumerate(self.y)}
        out.update({f"tracker.u_prev.{i}": t
                    for i, t in enumerate(self.u_prev)})
        return out

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        u = self._base_update()
        y = [ym + un - uo for ym, un, uo in
             zip(self._gossip(self.y), u, self.u_prev)]
        params = self._params()
        for p, xm, yt in zip(params, self._gossip(params), y):
            p.copy_(xm.float() + yt.float())
        _assign(self.y + self.u_prev, y + u)
        self.count += 1
        return loss

    def state_dict(self):
        return {"base": self.base.state_dict(), "count": self.count,
                "y": list(self.y), "u_prev": list(self.u_prev)}

    def load_state_dict(self, state) -> None:
        self.base.load_state_dict(state["base"])
        self.count = int(state["count"])
        _assign(self.y + self.u_prev,
                list(state["y"]) + list(state["u_prev"]))


def DistributedGradientTrackingOptimizer(
    base: torch.optim.Optimizer,
    topology,
    *,
    backend: str = "auto",
) -> GradientTrackingOptimizer:
    """Gradient tracking (DIGing): decentralized training that reaches the
    *global* optimum at a constant step size under heterogeneous data,
    where plain decentralized SGD stalls at a topology-dependent bias.

    The recursion, with ``W`` the gossip matrix and ``u`` the base step's
    update (momentum, weight decay and all)::

        y_{t+1} = W y_t + u_{t+1} - u_t      (track the average update)
        x_{t+1} = W x_t + y_{t+1}

    ``y`` and ``u_prev`` start at zero, so the first ``y`` is the first
    update, and ``sum_i y_i = sum_i u_i`` holds after every step.  ``u`` is
    the base step's change on the un-mixed parameters (see the module
    docstring).  Two fused mixes a step, ``y``'s then ``x``'s, each through
    K1 under ``'auto'``.  A single static topology only: a time-varying
    ``W`` breaks the tracking invariant.

    The JAX package gives the two mixes disjoint collective-id ranges
    (``GT_COLLECTIVE_ID_RANGES``) so that two kernels' barrier semaphores
    on the TPU cannot meet; the ranks here are virtual and K1 has no
    semaphores, so the port has no such ranges.
    """
    scheds = _as_schedules(topology)
    if len(scheds) != 1:
        raise ValueError("gradient tracking takes a single static topology "
                         "(time-varying W breaks the tracking invariant)")
    return GradientTrackingOptimizer(base, scheds[0], backend)


class ExactDiffusionOptimizer(_Wrapped):
    """Exact diffusion over rank-stacked parameters, on an f32 master copy.
    Built by :func:`DistributedExactDiffusionOptimizer`; the master, the
    last ``psi`` and the first-step flag live in :attr:`master`,
    :attr:`prev_psi` and :attr:`first`."""

    def __init__(self, base, schedule: GossipSchedule, backend: str):
        super().__init__(base, backend)
        self.schedule = schedule
        params = self._params()
        _check_stacked(params, schedule.size)
        self.master = [p.detach().float().clone() for p in params]
        self.prev_psi = [torch.zeros_like(m) for m in self.master]
        self.first = True

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The f32 master copy and the last ``psi``, per parameter."""
        out = {f"master.{i}": t for i, t in enumerate(self.master)}
        out.update({f"prev_psi.{i}": t for i, t in enumerate(self.prev_psi)})
        return out

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        u = self._base_update()
        psi = [x + un.float() for x, un in zip(self.master, u)]
        phi = psi if self.first else [
            ps + x - pp for ps, x, pp in zip(psi, self.master, self.prev_psi)]
        new_x = self._gossip(phi)
        for p, nx in zip(self._params(), new_x):
            p.copy_(nx)
        _assign(self.master + self.prev_psi, list(new_x) + psi)
        self.first = False
        self.count += 1
        return loss

    def state_dict(self):
        return {"base": self.base.state_dict(), "count": self.count,
                "master": list(self.master),
                "prev_psi": list(self.prev_psi), "first": self.first}

    def load_state_dict(self, state) -> None:
        self.base.load_state_dict(state["base"])
        self.count = int(state["count"])
        _assign(self.master + self.prev_psi,
                list(state["master"]) + list(state["prev_psi"]))
        self.first = bool(state["first"])


def DistributedExactDiffusionOptimizer(
    base: torch.optim.Optimizer,
    topology,
    *,
    backend: str = "auto",
) -> ExactDiffusionOptimizer:
    """Exact diffusion / D^2 (Yuan, Ying, Zhao & Sayed, 2017): bias-free
    decentralized training with one gossip a step::

        psi_t = x_{t-1} + u_t                  (local step)
        phi_t = psi_t + x_{t-1} - psi_{t-1}    (correction; phi = psi first)
        x_t   = W phi_t                        (combine, one fused K1 mix)

    ``W`` must be symmetric (ring, grid, full; checked here).  The whole
    recursion runs on an f32 master copy of the parameters: the dual
    variable is implicit in the difference of consecutive ``psi``, and
    rounding ``x`` to bf16 every step destroys it.  The visible parameters
    are set to the master's cast after each step, so they must change only
    through this optimizer.  ``u`` is the base step's change on the visible
    parameters (see the module docstring).
    """
    return ExactDiffusionOptimizer(
        base, _symmetric_schedule(topology, "exact diffusion"), backend)

"""Dynamic (time-varying) topology generators.

Counterpart of ``bluefog_tpu/topology/dynamic.py`` (numpy and torch, copied so
the port never imports the JAX package): the reference's per-rank infinite
generators (``GetDynamicOnePeerSendRecvRanks`` and the machine-aware
inner-outer variants), one period of a dynamic process materialized as a
list of :class:`~bluefog_tpu_torch.topology.graphs.Topology` objects for
:func:`~bluefog_tpu_torch.ops.collectives.neighbor_allreduce_dynamic`, and
the ``step -> W`` builder of the aperiodic gossip
(:func:`~bluefog_tpu_torch.ops.collectives.neighbor_allreduce_aperiodic`).

The JAX package's ``one_peer_exp2_mixing_matrix`` is jittable and returns a
traced array; here the step is a Python integer and the matrix a CPU float32
tensor, which the aperiodic gossip reads on the host to build K1's tables.
"""

from __future__ import annotations

import math
from typing import Callable, Generator, Iterator, List, Tuple

import numpy as np
import torch

from bluefog_tpu_torch.topology.graphs import Topology

__all__ = [
    "GetDynamicOnePeerSendRecvRanks",
    "GetExp2DynamicSendRecvMachineRanks",
    "GetInnerOuterRingDynamicSendRecvRanks",
    "GetInnerOuterExpo2DynamicSendRecvRanks",
    "one_peer_exponential_two_schedules",
    "one_peer_ring_schedules",
    "one_peer_exp2_mixing_matrix",
    "dynamic_topologies_from_generator",
]

SendRecv = Tuple[List[int], List[int]]


def GetDynamicOnePeerSendRecvRanks(
    topo: Topology, self_rank: int
) -> Generator[SendRecv, None, None]:
    """Cycle through the static topology's neighbors one peer at a time.

    Yields ``(send_ranks, recv_ranks)`` — one out-neighbor and one in-neighbor
    per step, in sorted-offset order, repeating forever.  Mirrors the upstream
    generator of the same name used for dynamic exponential-2 training
    (BASELINE.json config[1] flavor).
    """
    out_nbrs = sorted(topo.out_neighbors(self_rank), key=lambda d: (d - self_rank) % topo.size)
    in_nbrs = sorted(topo.in_neighbors(self_rank), key=lambda s: (self_rank - s) % topo.size)
    if not out_nbrs or not in_nbrs:
        while True:
            yield ([], [])
    i = 0
    while True:
        yield ([out_nbrs[i % len(out_nbrs)]], [in_nbrs[i % len(in_nbrs)]])
        i += 1


def GetExp2DynamicSendRecvMachineRanks(
    world_size: int, local_size: int, self_rank: int, local_rank: int
) -> Generator[SendRecv, None, None]:
    """Machine-level one-peer exponential-2 generator (upstream name).

    For hierarchical dynamic training: only the designated cross-machine rank
    (``local_rank == 0`` by convention) participates; yields the *global* rank
    of the paired machine's cross-rank.
    """
    if world_size % local_size != 0:
        raise ValueError("world_size must be divisible by local_size")
    n_machines = world_size // local_size
    machine = self_rank // local_size
    phases = max(1, math.ceil(math.log2(n_machines))) if n_machines > 1 else 0
    if phases == 0 or local_rank != 0:
        while True:
            yield ([], [])
    k = 0
    while True:
        o = 2 ** (k % phases)
        send_m = (machine + o) % n_machines
        recv_m = (machine - o) % n_machines
        yield ([send_m * local_size + local_rank], [recv_m * local_size + local_rank])
        k += 1


def _inner_outer(
    world_size: int,
    local_size: int,
    self_rank: int,
    outer_offsets: List[int],
) -> Generator[SendRecv, None, None]:
    """Alternate an intra-machine ring step with a cross-machine step.

    Even phases: unidirectional ring inside the machine.  Odd phases: the
    rank communicates with the same local_rank on another machine, cycling
    through ``outer_offsets`` (machine-index offsets).
    """
    n_machines = world_size // local_size
    machine, local = divmod(self_rank, local_size)
    k = 0
    outer_i = 0
    while True:
        if k % 2 == 0 and local_size > 1:
            send = machine * local_size + (local + 1) % local_size
            recv = machine * local_size + (local - 1) % local_size
            yield ([send], [recv])
        elif n_machines > 1 and outer_offsets:
            o = outer_offsets[outer_i % len(outer_offsets)]
            send = ((machine + o) % n_machines) * local_size + local
            recv = ((machine - o) % n_machines) * local_size + local
            outer_i += 1
            yield ([send], [recv])
        else:
            yield ([], [])
        k += 1


def GetInnerOuterRingDynamicSendRecvRanks(
    world_size: int, local_size: int, self_rank: int
) -> Generator[SendRecv, None, None]:
    """Upstream-named inner(machine-ring)/outer(cross-machine-ring) generator."""
    if world_size % local_size != 0:
        raise ValueError("world_size must be divisible by local_size")
    return _inner_outer(world_size, local_size, self_rank, outer_offsets=[1])


def GetInnerOuterExpo2DynamicSendRecvRanks(
    world_size: int, local_size: int, self_rank: int
) -> Generator[SendRecv, None, None]:
    """Upstream-named inner-ring / outer-exponential-2 generator."""
    if world_size % local_size != 0:
        raise ValueError("world_size must be divisible by local_size")
    n_machines = world_size // local_size
    offs, o = [], 1
    while o < n_machines:
        offs.append(o)
        o *= 2
    return _inner_outer(world_size, local_size, self_rank, outer_offsets=offs)


# ---------------------------------------------------------------------------
# Periodic schedules and the aperiodic matrix builder
# ---------------------------------------------------------------------------


def _one_peer_shift_topology(size: int, shift: int) -> Topology:
    """Everyone sends to ``rank + shift``: a full permutation matching with
    1/2–1/2 mixing weights (the one-peer gossip matrix)."""
    w = np.zeros((size, size))
    for r in range(size):
        src = (r - shift) % size
        if src == r:
            w[r, r] = 1.0
        else:
            w[r, r] = 0.5
            w[r, src] = 0.5
    return Topology(weights=w, name=f"OnePeerShift({shift})")


def one_peer_exponential_two_schedules(size: int) -> List[Topology]:
    """One period of the one-peer dynamic exponential-2 process:
    phase ``k`` pairs ``i -> i + 2^k (mod n)`` with 1/2–1/2 weights.

    This is the time-varying graph sequence of the reference's dynamic-exp2
    training mode, materialized as one period of phases.
    """
    if size <= 1:
        return [_one_peer_shift_topology(size, 0)]
    phases = math.ceil(math.log2(size))
    return [_one_peer_shift_topology(size, 2**k) for k in range(phases)]


def one_peer_ring_schedules(size: int) -> List[Topology]:
    """Two-phase one-peer ring: alternate sending right / left."""
    if size <= 1:
        return [_one_peer_shift_topology(size, 0)]
    if size == 2:
        return [_one_peer_shift_topology(size, 1)]
    return [_one_peer_shift_topology(size, 1), _one_peer_shift_topology(size, -1)]


def one_peer_exp2_mixing_matrix(size: int, step: int) -> torch.Tensor:
    """``step -> (n, n)`` mixing matrix for one-peer dynamic exp2, as a CPU
    float32 tensor: phase ``step % ceil(log2 n)`` pairs ``i -> i + 2^phase
    (mod n)`` with 1/2-1/2 weights, the same process as
    :func:`one_peer_exponential_two_schedules`, but produced as *data* for
    :func:`~bluefog_tpu_torch.ops.collectives.neighbor_allreduce_aperiodic`
    instead of a period of schedules."""
    if size <= 1:
        return torch.ones((1, 1), dtype=torch.float32)
    phases = math.ceil(math.log2(size))
    # 2^(phase) < size always: phase <= ceil(log2 n) - 1 => shift < n
    shift = 1 << (int(step) % phases)
    rows = torch.arange(size)
    srcs = (rows - shift) % size  # src != row since 0 < shift < size
    w = torch.zeros((size, size), dtype=torch.float32)
    w[rows, rows] = 0.5
    w[rows, srcs] = 0.5
    return w


def dynamic_topologies_from_generator(
    size: int,
    gen_factory: Callable[[int], Iterator[SendRecv]],
    num_steps: int,
    name: str = "dynamic",
) -> List[Topology]:
    """Materialize ``num_steps`` global topologies from per-rank generators.

    ``gen_factory(rank)`` must return the rank's ``(send, recv)`` generator
    (e.g. ``lambda r: GetDynamicOnePeerSendRecvRanks(topo, r)``).  Each step's
    edge set is the union of every rank's send list that step; weights are
    uniform ``1/(in_degree+1)``.  Consistency between send and recv lists is
    validated — mismatches would deadlock the reference's MPI path and produce
    wrong averages here.
    """
    gens = [gen_factory(r) for r in range(size)]
    topos: List[Topology] = []
    for step in range(num_steps):
        edges = []
        recv_claims = set()
        for r in range(size):
            send, recv = next(gens[r])
            for d in send:
                edges.append((r, d))
            for s in recv:
                recv_claims.add((s, r))
        if set(edges) != recv_claims:
            raise ValueError(
                f"step {step}: send/recv lists inconsistent: "
                f"sends {sorted(set(edges) - recv_claims)} unclaimed, "
                f"recvs {sorted(recv_claims - set(edges))} unmatched"
            )
        topos.append(Topology.from_edges(size, edges, name=f"{name}[{step}]"))
    return topos

"""Compressed decentralized gossip: CHOCO-Gossip over rank-stacked tensors.

Counterpart of ``bluefog_tpu/ops/compression.py`` for :class:`Compressor`,
:func:`identity`, :func:`random_block_k`, :func:`top_k`, :class:`ChocoState`,
:func:`choco_init`, :func:`choco_gossip` and
:func:`hierarchical_choco_gossip`.  CHOCO-Gossip (Koloskova, Stich & Jaggi,
ICML 2019) gossips compressed *innovations* against mirror copies every rank
keeps of its neighbours' public state, and still reaches exact consensus:

    d_i   = x_i - xhat_i                          (innovation)
    q_i   = C(d_i)                                (this rides the wire)
    xhat_j += q_j  for j in {i} and in-neighbours (every mirror advances)
    x_i   += gamma * sum_j w_ij (xhat_j - xhat_i)

with a symmetric doubly stochastic mixing matrix.  The JAX package runs the
round in XLA (``ppermute`` of the payloads, no Pallas kernel), so it is plain
PyTorch here: each slot's payload is a gather of the source rank's row, zeros
where a rank has no in-edge in that slot, as from ``ppermute``.

Every leaf is rank-stacked, ``x[r]`` being rank ``r``'s value, so a
compressor works on each rank's value of a stacked leaf at once, and a
mirror leaf is ``(n, K, ...)``: rank ``i``'s mirror of its slot-``k``
source.  Two differences from the JAX package:

- ``key`` is an integer seed, not a ``jax.random`` key.  The key a
  compressor gets for one round and leaf is the tuple ``(seed, round,
  leaf_index)``, the same on every rank.  ``leaf_index`` counts leaves in
  torch's pytree order, which takes a dict's keys in insertion order where
  JAX sorts them.
- :func:`random_block_k` draws its block's offset with :func:`shared_offset`
  from a ``torch.Generator`` seeded by those three numbers, where the JAX
  package folds them into a threefry key.  The offsets differ; the law (a
  uniform offset per round and leaf, shared by every rank) is the same.

In a context that spans processes (:mod:`bluefog_tpu_torch.ops.transport`)
every leaf is the process's owned ``(m, ...)`` block and a mirror leaf ``(m,
K, ...)``.  A round's payloads, every leaf's and every part of a
compressor's (``top_k``'s values and int32 indices), are laid side by side
in one buffer per dtype and cross in one exchange; each owned rank's
received payloads then go through the same decompress-and-mix code as in
one process, so the results are bit-equal to it.  The hierarchical form
needs each process to hold whole machines.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from bluefog_tpu_torch.ops import gossip_kernel as _k1
from bluefog_tpu_torch.ops import transport as _T
from bluefog_tpu_torch.ops.collectives import _acc_dtype, _as_schedule
from bluefog_tpu_torch.topology.schedule import GossipSchedule

__all__ = [
    "Compressor", "identity", "random_block_k", "top_k", "shared_offset",
    "ChocoState", "choco_init", "choco_gossip", "hierarchical_choco_gossip",
]

# (seed, round, leaf_index): what a compressor is given as its key
Key = Tuple[int, int, int]


class Compressor(NamedTuple):
    """Leaf-wise compression operator with static-shape payloads.

    ``compress(leaf, key) -> payload`` takes a rank-stacked ``(n, ...)``
    leaf and returns a pytree of rank-stacked tensors whose shapes depend
    only on ``leaf.shape``; ``decompress(payload, key, like) -> dense``
    returns a tensor of ``like.shape``.  ``key`` is the ``(seed, round,
    leaf_index)`` tuple: shared-seed compressors place their values from it
    alone, data-dependent ones ignore it.  ``wire_ratio(leaf)`` estimates
    payload bytes over dense bytes for one rank's value; ``delta`` is the
    contraction quality, ``E||C(x) - x||^2 <= (1 - delta) ||x||^2``.
    """

    name: str
    compress: Callable[[torch.Tensor, Key], Any]
    decompress: Callable[[Any, Key, torch.Tensor], torch.Tensor]
    wire_ratio: Callable[[torch.Tensor], float]
    delta: float = 1.0


def identity() -> Compressor:
    """No compression (delta = 1): CHOCO is exact gossip after one mirror
    round."""
    return Compressor(
        name="identity",
        compress=lambda leaf, key: leaf,
        decompress=lambda payload, key, like: payload,
        wire_ratio=lambda leaf: 1.0,
        delta=1.0,
    )


def _kept(n: int, ratio: float) -> int:
    return max(1, min(n, int(round(ratio * n))))


def _per_rank_size(leaf: torch.Tensor) -> int:
    return int(np.prod(leaf.shape[1:], dtype=np.int64))


def shared_offset(seed: int, rnd: int, leaf_index: int, n: int) -> int:
    """The offset in ``[0, n)`` of :func:`random_block_k`'s block for one
    round and leaf: one draw of a ``torch.Generator`` seeded by ``(seed,
    rnd, leaf_index)`` (mixed by numpy's ``SeedSequence``), the same on
    every rank, so the wire carries values and no indices."""
    mixed = np.random.SeedSequence(
        [int(seed), int(rnd), int(leaf_index)]).generate_state(1, np.uint64)
    gen = torch.Generator().manual_seed(int(mixed[0]) & ((1 << 63) - 1))
    return int(torch.randint(0, n, (), generator=gen))


def random_block_k(ratio: float) -> Compressor:
    """Keep a contiguous block of ``round(ratio * m)`` coordinates (at least
    one) of each rank's ``m`` values, at a shared-seed offset with
    wrap-around (:func:`shared_offset`).  Every coordinate is kept with
    probability ``k / m`` over the offset, so the operator is a ``delta =
    ratio`` contraction in expectation at O(k) work, and the wire is exactly
    ``k`` values per rank."""
    if not 0.0 < ratio <= 1.0:
        raise ValueError(f"ratio must be in (0, 1], got {ratio}")

    def index(key, m, device):
        k = _kept(m, ratio)
        start = shared_offset(*key, m)
        return (start + torch.arange(k, device=device)) % m

    def compress(leaf, key):
        flat = leaf.reshape(leaf.shape[0], -1)
        return flat[:, index(key, flat.shape[1], leaf.device)]

    def decompress(payload, key, like):
        m = _per_rank_size(like)
        flat = torch.zeros(like.shape[0], m, dtype=payload.dtype,
                           device=payload.device)
        flat[:, index(key, m, payload.device)] = payload
        return flat.reshape(like.shape)

    return Compressor(
        "random_block_k", compress, decompress,
        lambda leaf: _kept(_per_rank_size(leaf), ratio)
        / _per_rank_size(leaf), delta=ratio)


def top_k(ratio: float) -> Compressor:
    """Keep each rank's ``round(ratio * m)`` largest-magnitude coordinates
    (at least one); data-dependent, so the payload carries int32 indices
    beside the values."""
    if not 0.0 < ratio <= 1.0:
        raise ValueError(f"ratio must be in (0, 1], got {ratio}")

    def compress(leaf, key):
        flat = leaf.reshape(leaf.shape[0], -1)
        k = _kept(flat.shape[1], ratio)
        idx = torch.topk(flat.float().abs(), k, dim=1).indices
        return {"vals": torch.gather(flat, 1, idx),
                "idx": idx.to(torch.int32)}

    def decompress(payload, key, like):
        vals = payload["vals"]
        flat = torch.zeros(like.shape[0], _per_rank_size(like),
                           dtype=vals.dtype, device=vals.device)
        flat.scatter_(1, payload["idx"].long(), vals)
        return flat.reshape(like.shape)

    def ratio_fn(leaf):
        m = _per_rank_size(leaf)
        k = _kept(m, ratio)
        return k * (leaf.element_size() + 4) / (m * leaf.element_size())

    return Compressor("top_k", compress, decompress, ratio_fn, delta=ratio)


class ChocoState(NamedTuple):
    """Mirror copies and the round counter, carried across gossip rounds:
    ``xhat_self`` is like ``x`` (each rank's public copy), ``xhat_nbrs``
    holds ``(n, K, ...)`` leaves (rank ``i``'s mirror of its slot-``k``
    source), and ``round`` drives the shared-seed masks."""

    xhat_self: Any
    xhat_nbrs: Any
    round: int


def choco_init(x, schedule) -> ChocoState:
    """Zero mirrors (the algorithm's ``xhat^0 = 0``) for the rank-stacked
    pytree ``x`` and a schedule of ``K`` slots."""
    k = _as_schedule(schedule).num_slots
    return ChocoState(
        pytree.tree_map(torch.zeros_like, x),
        pytree.tree_map(lambda t: torch.zeros((t.shape[0], k) + t.shape[1:],
                                              dtype=t.dtype, device=t.device),
                        x),
        0)


def _received(sched: GossipSchedule, payloads):
    """What this process's ranks receive: per payload and slot ``k``, the
    payload pytree of each rank's slot-``k`` source (zeros
    where the rank has no slot-``k`` edge, as from ``ppermute``).  In one
    process a gather of the source rows; over several, one exchange of
    every payload's leaves, packed into one buffer per dtype."""
    tr = _T.active()
    if tr is None:
        out = []
        for payload in payloads:
            device = pytree.tree_leaves(payload)[0].device
            src = _k1.slot_tables(sched, device)[0]
            slots = []
            for k in range(sched.num_slots):
                s = src[:, k].long()
                live = s >= 0
                slots.append(pytree.tree_map(
                    lambda t: torch.where(
                        live.reshape((-1,) + (1,) * (t.dim() - 1)),
                        t[s.clamp(min=0)], torch.zeros((), dtype=t.dtype,
                                                       device=t.device)),
                    payload))
            out.append(slots)
        return out
    flat_payloads = [pytree.tree_flatten(p) for p in payloads]
    parts = [t for leaves, _ in flat_payloads for t in leaves]
    m = parts[0].shape[0]
    groups: dict = {}
    for i, t in enumerate(parts):
        groups.setdefault(t.dtype, []).append(i)
    try:
        bufs = [tr.pack([parts[i].reshape(m, -1) for i in idxs])
                for idxs in groups.values()]
        with tr.exchange(sched, bufs) as rows:
            got = [r.gather(parts[0].device) for r in rows]
    finally:
        tr.settle()
    # (m, K, ...) per part, in the order of ``parts``
    recv: list = [None] * len(parts)
    for idxs, g in zip(groups.values(), got):
        off = 0
        for i in idxs:
            size = parts[i][0].numel()
            recv[i] = g[:, :, off:off + size].reshape(
                m, sched.num_slots, *parts[i].shape[1:])
            off += size
    out, at = [], 0
    for leaves, spec in flat_payloads:
        mine = recv[at:at + len(leaves)]
        at += len(leaves)
        out.append([pytree.tree_unflatten([t[:, k] for t in mine], spec)
                    for k in range(sched.num_slots)])
    return out


def choco_gossip(x, state: ChocoState, schedule, *, compressor: Compressor,
                 gamma: float = 1.0, key=None):
    """One CHOCO-Gossip round on the rank-stacked pytree ``x``.  Returns
    ``(x_new, state_new)``.

    ``key`` is an integer seed (default 0); leaf ``li`` of round ``r`` is
    compressed with the key ``(key, r, li)``, identical on every rank.  The
    mirrors and payloads keep the leaves' dtype; the mix accumulates in f32
    for bf16/f16 leaves.  Only the receive weights enter the mix: under the
    required double stochasticity their sum is one less the self weight."""
    sched = _as_schedule(schedule)
    seed = 0 if key is None else int(key)
    rows, start = _T.owned_rows(sched.size), _T.owned_start(sched.size)
    leaves, spec = pytree.tree_flatten(x)
    hat_self = pytree.tree_flatten(state.xhat_self)[0]
    hat_nbrs = pytree.tree_flatten(state.xhat_nbrs)[0]
    payloads, new_self = [], []
    for li, (leaf, hs) in enumerate(zip(leaves, hat_self)):
        if leaf.dim() == 0 or leaf.shape[0] != rows:
            raise ValueError(
                f"leaves must be rank-stacked with leading axis {rows} of "
                f"the schedule's {sched.size}, got shape {tuple(leaf.shape)}")
        lkey = (seed, int(state.round), li)
        payload = compressor.compress((leaf - hs).to(leaf.dtype), lkey)
        payloads.append(payload)
        new_self.append(hs + compressor.decompress(payload, lkey, leaf))
    received = _received(sched, payloads) if leaves else []
    new_x, new_nbrs = [], []
    for li, (leaf, hs2, hn) in enumerate(zip(leaves, new_self, hat_nbrs)):
        lkey = (seed, int(state.round), li)
        acc = _acc_dtype(leaf.dtype)
        _, rw, _ = _k1.schedule_tables(sched, leaf.device, dtype=acc)
        rw = rw[start:start + rows]
        bcast = (leaf.shape[0],) + (1,) * (leaf.dim() - 1)
        mix = torch.zeros(leaf.shape, dtype=acc, device=leaf.device)
        wsum = torch.zeros(leaf.shape[0], dtype=acc, device=leaf.device)
        hn2 = []
        for k in range(sched.num_slots):
            hk = hn[:, k] + compressor.decompress(received[li][k], lkey, leaf)
            hn2.append(hk)
            mix = mix + rw[:, k].reshape(bcast) * hk.to(acc)
            wsum = wsum + rw[:, k]
        x2 = (leaf.to(acc) + gamma * (mix - wsum.reshape(bcast)
                                      * hs2.to(acc))).to(leaf.dtype)
        new_x.append(x2)
        new_nbrs.append(torch.stack(hn2, dim=1) if hn2 else hn)
    unf = functools.partial(pytree.tree_unflatten, treespec=spec)
    return unf(new_x), ChocoState(unf(new_self), unf(new_nbrs),
                                  int(state.round) + 1)


@functools.lru_cache(maxsize=64)
def _lane_schedule(machine_schedule: GossipSchedule,
                   local_size: int) -> GossipSchedule:
    """The machine schedule lifted to every lane: rank ``m * L + l`` takes
    machine ``m``'s slots from lane ``l`` of the source machine."""
    L = local_size
    src_m = machine_schedule.recv_src
    lanes = np.arange(L)
    src = np.where(src_m[:, None, :] >= 0,
                   src_m[:, None, :] * L + lanes[None, :, None], -1)
    return GossipSchedule(
        size=machine_schedule.size * L,
        perms=tuple(tuple((s * L + l, d * L + l) for s, d in perm
                          for l in range(L))
                    for perm in machine_schedule.perms),
        self_weights=np.repeat(machine_schedule.self_weights, L),
        recv_weights=np.repeat(machine_schedule.recv_weights, L, axis=0),
        recv_src=src.reshape(-1, src_m.shape[1]).astype(np.int32),
        is_circulant=False,
        name=f"{machine_schedule.name}x{L}")


def hierarchical_choco_gossip(x, state: ChocoState, machine_schedule, *,
                              local_size: int, compressor: Compressor,
                              gamma: float = 1.0, key=None):
    """The exact mean within each machine of ``local_size`` consecutive
    ranks (the JAX package's ``pmean`` over the local axis, in f32 for
    bf16/f16 leaves), then CHOCO across machines along ``machine_schedule``:
    every local rank of a machine then holds the same value and advances the
    same mirrors, so the machine acts as one CHOCO node.  ``state`` comes
    from ``choco_init(x, machine_schedule)``.  Returns ``(x_new,
    state_new)``, ``x_new`` equal across each machine's local ranks.  Over
    several processes each holds whole machines: its owned block of the
    machine schedule's rows, times ``local_size`` ranks."""
    msched = _as_schedule(machine_schedule)
    machines = _T.owned_rows(msched.size)
    n = machines * local_size

    def local_mean(leaf):
        if leaf.dim() == 0 or leaf.shape[0] != n:
            raise ValueError(
                f"leaves must be rank-stacked with leading axis {n} "
                f"({machines} machines x {local_size}), got shape "
                f"{tuple(leaf.shape)}")
        lanes = leaf.reshape((machines, local_size) + leaf.shape[1:])
        avg = (lanes.to(_acc_dtype(leaf.dtype)).sum(1) / local_size).to(
            leaf.dtype)
        return avg.repeat_interleave(local_size, dim=0)

    return choco_gossip(pytree.tree_map(local_mean, x), state,
                        _lane_schedule(msched, local_size),
                        compressor=compressor, gamma=gamma, key=key)

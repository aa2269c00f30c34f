"""Collectives over rank-stacked tensors.

Counterpart of ``bluefog_tpu/ops/collectives.py`` for :func:`fuse_apply`,
:func:`_acc_dtype`, :func:`neighbor_allreduce`, the flat collectives
(:func:`allreduce`, :func:`allgather`, :func:`broadcast`, :func:`barrier`,
:func:`pair_gossip`, :func:`neighbor_allgather`) and the hierarchical gossip
(:func:`hierarchical_neighbor_allreduce` and its two-level form).  The JAX
functions run inside ``shard_map`` on one rank's value; here the ``n`` ranks
are virtual and every leaf carries them on its leading axis, ``x[r]`` being
rank ``r``'s value, as in the JAX package's stacked-array API
(``parallel/api.py``).  The flat collectives are XLA collectives in the JAX
package, not Pallas kernels, so they are plain PyTorch here: reductions or
gathers over the leading axis.  Every result is a fresh tensor, never a view
of its input or an ``expand``, so callers may write into it in place.

Two gossip backends, resolved per call by
:func:`bluefog_tpu_torch.ops.gossip_kernel.resolve_backend`:

- ``'kernel'``: K1, the fused weighted reduction of ``csrc/gossip_mix.cu``
  (the counterpart of ``'pallas'``), any schedule: the ranks are rows of
  one buffer, so K1 reads each slot's source row through its table where
  the TPU kernel needs a circulant schedule for its remote DMA;
- ``'plain'``: one gathered copy per schedule slot, then a multiply-add (the
  counterpart of ``'xla'``); any schedule, and the only path that honours
  ``send_weights``.

The hierarchical gossip runs its machine-level fold on K1 the same way.

In a context that spans processes (:mod:`bluefog_tpu_torch.ops.transport`)
every rank-stacked leaf is the process's owned ``(m, ...)`` block of the
schedule's rows.  ``neighbor_allreduce`` then exchanges the rows the owned
ranks read and runs K1's peer form (``'kernel'``) or its plain twin
(``'plain'``).  On the card ``fuse_apply`` fuses every leaf and packs each
buffer straight into the transport's symmetric buffer: the pack is each
payload's one copy, and the exchange adds none.  The flat collectives
gather every process's block and compute what one process would, so their
results are bit-equal to the one-process run's.  The hierarchical gossip
treats a machine as a block of ranks inside one process: the local mean
stays in the process and the machine fold goes through K1's peer form.
``neighbor_allreduce_aperiodic`` lowers each distinct matrix to a schedule of
its active rotations and runs it the same way (every process checks, once
per new matrix, that the others pass the same one); ``pair_gossip`` is a
one-slot schedule of the pairing on K1's peer form; ``neighbor_allgather``
hands each owned rank its in-neighbours' rows as they arrived; and
``send_weights`` (the plain route) has each receiver scale the rows it got
by their senders' weights, as the sender would have before shipping.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from bluefog_tpu_torch.ops import gossip_kernel as _k1
from bluefog_tpu_torch.ops import transport as _T
from bluefog_tpu_torch.topology.graphs import Topology
from bluefog_tpu_torch.topology.schedule import GossipSchedule, build_schedule

__all__ = ["fuse_apply", "fuse_plan", "neighbor_allreduce",
           "neighbor_allreduce_dynamic", "neighbor_allreduce_aperiodic",
           "allreduce",
           "allgather", "broadcast", "barrier", "pair_gossip",
           "neighbor_allgather", "hierarchical_neighbor_allreduce",
           "hierarchical_neighbor_allreduce_2d"]


def fuse_plan(leaves: List[torch.Tensor], threshold_bytes=8 << 20
              ) -> Tuple[Dict[torch.dtype, List[int]], List[int]]:
    """How :func:`fuse_apply` packs rank-stacked ``leaves``: ``(groups,
    big)``, where ``groups`` maps each dtype to the indices of the leaves
    fused into its one buffer, and ``big`` lists the leaves that ship alone
    because one rank's share is at least ``threshold_bytes`` (``None``: fuse
    everything).  One gossip call makes ``len(groups) + len(big)`` kernel
    launches."""
    big = []
    if threshold_bytes is not None:
        big = [i for i, leaf in enumerate(leaves)
               if leaf[0].numel() * leaf.element_size() >= threshold_bytes]
    groups: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        if i not in big:
            groups.setdefault(leaf.dtype, []).append(i)
    return groups, big


def fuse_apply(fn, x, *, threshold_bytes=8 << 20):
    """Tensor fusion: run a leaf-wise collective ``fn`` on ONE flat ``(n, L)``
    buffer per dtype instead of per leaf.

    ``x`` is a pytree of rank-stacked tensors.  Leaves whose per-rank size
    reaches ``threshold_bytes`` ship unfused: a large tensor is already one
    bandwidth-bound call, and concatenating it would cost a transient copy.
    Returns ``x``'s structure; each leaf of the result is a view into the
    buffer ``fn`` returned.

    In a context that spans processes the transport packs each buffer
    (:meth:`~bluefog_tpu_torch.ops.transport.Transport.pack`): on the card an
    f32 or bf16 buffer is laid straight into the staged peer memory the
    gossip reads, and since every payload is copied into peer memory once
    anyway, the large leaves fuse too (one launch a dtype, no copy of their
    own)."""
    leaves, spec = pytree.tree_flatten(x)
    if len(leaves) <= 1:
        return fn(x)
    tr = _T.active()
    if tr is not None and tr.device.type == "cuda":
        threshold_bytes = None
    groups, big = fuse_plan(leaves, threshold_bytes)
    n = leaves[0].shape[0]
    pack = (functools.partial(torch.cat, dim=1) if tr is None else tr.pack)
    try:
        bufs = {str(dt): pack([leaves[i].reshape(n, -1) for i in idxs])
                for dt, idxs in groups.items()}
        out_all = fn({"fused": bufs, "big": {str(i): leaves[i] for i in big}})
    finally:
        if tr is not None:
            tr.settle()
    out: List = [None] * len(leaves)
    for i in big:
        out[i] = out_all["big"][str(i)]
    for dt, idxs in groups.items():
        buf, off = out_all["fused"][str(dt)], 0
        for i in idxs:
            size = leaves[i][0].numel()
            out[i] = buf[:, off:off + size].reshape(leaves[i].shape)
            off += size
    return pytree.tree_unflatten(out, spec)


@functools.lru_cache(maxsize=256)
def _lowered(topology: Topology) -> GossipSchedule:
    # topologies hash by identity: repeated calls with one Topology object
    # reuse one schedule, and with it the schedule's cached device tables
    return build_schedule(topology)


def _as_schedule(s) -> GossipSchedule:
    if isinstance(s, GossipSchedule):
        return s
    if isinstance(s, Topology):
        return _lowered(s)
    raise TypeError(f"expected Topology or GossipSchedule, got {type(s)}")


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    # accumulate low-precision gossip in f32: the mixing weights (1/3, 1/5,
    # ...) are not representable in bf16, and repeated averaging drifts
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


def _per_rank(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """``(n,)`` -> ``(n, 1, ..., 1)`` to broadcast over a stacked leaf."""
    return v.reshape(v.shape[0], *([1] * (ndim - 1)))


def _kernel_leaf(leaf, sw, rw, src):
    """K1 on one rank-stacked leaf, flattened to ``(n, L)`` in its wire
    dtype, with the tables ``(sw, rw, recv_src)``."""
    flat = leaf.reshape(leaf.shape[0], -1).to(
        _k1._wire_dtype(leaf.dtype)).contiguous()
    return _k1.gossip_mix(flat, sw, rw, src).reshape(leaf.shape).to(leaf.dtype)


def _plain_leaf(leaf, sw, rw, src, received=None, send_w=None):
    """``out[i] = sw[i] leaf[i] + sum_k rw[i, k] r_k[i]`` in ``sw``'s
    (accumulation) dtype, in slot order, where ``r_k[i]`` is the row rank
    ``i`` receives in slot ``k`` from rank ``src[i, k]``: ``received[:, k]``
    (the ``(m, K, ...)`` rows an exchange brought), or in one process
    ``leaf[src[:, k]]``.  With the senders' ``(n, K)`` table ``send_w`` the
    row is first scaled as the reference's sender ships it, ``send_w[j, k]
    x_j`` in the accumulation dtype rounded to the leaf's."""
    acc = sw.dtype
    out = _per_rank(sw, leaf.dim()) * leaf.to(acc)
    for k in range(src.shape[1]):
        s = src[:, k].long()
        shipped = (leaf[s.clamp(min=0)] if received is None
                   else received[:, k])
        if send_w is not None:
            shipped = (_per_rank(send_w[s.clamp(min=0), k], leaf.dim()).to(acc)
                       * shipped.to(acc)).to(leaf.dtype)
        # a rank no slot-k edge reaches receives zeros, as from ppermute
        recvd = torch.where(_per_rank(s >= 0, leaf.dim()), shipped, 0).to(acc)
        out = out + _per_rank(rw[:, k], leaf.dim()) * recvd
    return out.to(leaf.dtype)


def neighbor_allreduce(x, schedule, *, self_weight=None, recv_weights=None,
                       send_weights=None, backend: str = "auto"):
    """Weighted average with in-neighbors, ``out[i] = w_ii x[i] + sum_k
    w_ik x[recv_src[i, k]]``, on every leaf of a pytree of rank-stacked
    tensors (leading axis = the schedule's ``n`` ranks).

    Args:
      schedule: :class:`GossipSchedule` (or a :class:`Topology`, lowered on
        the fly).
      self_weight / recv_weights: per-call overrides of the schedule's
        weights: a scalar or ``(n,)`` per-rank self weight; ``(K,)`` for
        every rank or an ``(n, K)`` table of slot weights.
      send_weights: sender-side scaling, ``(K,)`` or ``(n, K)``: slot ``k``'s
        payload leaves rank ``j`` as ``send_weights[j, k] * x[j]``.  Only the
        plain path honours it: ``'auto'`` keeps plain, ``'kernel'`` raises.
      backend: ``'kernel'`` (K1), ``'plain'``, or ``'auto'`` (K1 for any
        schedule with at least one slot; see
        :func:`~bluefog_tpu_torch.ops.gossip_kernel.auto_gossip_backend` for
        why this differs from the JAX package's rule).  On a CPU tensor K1's
        wrapper runs its plain version.

    Every weighted sum runs in f32 for bf16/f16 leaves.  On the kernel path
    the payload travels in the wire dtype (bf16 for bf16 leaves, else f32).
    """
    sched = _as_schedule(schedule)
    tr = _T.active()
    if tr is not None:
        return _neighbor_allreduce_procs(tr, x, sched, self_weight,
                                         recv_weights, send_weights, backend)
    if send_weights is not None:
        if backend == "kernel":
            raise NotImplementedError(
                "backend='kernel' cannot honour send_weights: the kernel folds "
                "weights on the receiving side only; use backend='plain'")
        backend = "plain" if backend == "auto" else backend
    backend = _k1.resolve_backend(backend, sched)
    leaves, spec = pytree.tree_flatten(x)
    for leaf in leaves:
        if leaf.dim() == 0 or leaf.shape[0] != sched.size:
            raise ValueError(
                f"leaves must be rank-stacked with leading axis {sched.size}, "
                f"got shape {tuple(leaf.shape)}")
    if backend == "kernel" and leaves:
        tables = _k1.schedule_tables(sched, leaves[0].device, self_weight,
                                     recv_weights)
        outs = [_kernel_leaf(leaf, *tables) for leaf in leaves]
    else:
        send_w = None
        if send_weights is not None:
            send_w = _send_table(send_weights, sched, leaves[0].device)
        outs = []
        for leaf in leaves:
            sw, rw, src = _k1.schedule_tables(
                sched, leaf.device, self_weight, recv_weights,
                dtype=_acc_dtype(leaf.dtype))
            outs.append(_plain_leaf(leaf, sw, rw, src, send_w=send_w))
    return pytree.tree_unflatten(outs, spec)


def _owned_tables(tr, sched, device, self_weight=None, recv_weights=None,
                  dtype=torch.float32):
    """The schedule's ``(sw, rw)`` for one call (overrides in the global
    ``(n,)`` / ``(n, K)`` shapes, or scalars and ``(K,)``), cut to this
    process's rows."""
    sw, rw, _ = _k1.schedule_tables(sched, device, self_weight, recv_weights,
                                    dtype=dtype)
    s, m = tr.start(sched.size), tr.rows(sched.size)
    return sw[s:s + m], rw[s:s + m]


def _neighbor_allreduce_procs(tr, x, sched, self_weight, recv_weights,
                              send_weights, backend):
    """``neighbor_allreduce`` on this process's owned rows: the rows the
    owned ranks read arrive through the transport, then K1's peer form
    (``'kernel'``) or its plain twin folds them; with ``send_weights``
    :func:`_plain_leaf` folds them, as in one process."""
    if send_weights is not None:
        if backend == "kernel":
            raise NotImplementedError(
                "backend='kernel' cannot honour send_weights: the kernel folds "
                "weights on the receiving side only; use backend='plain'")
        backend = "plain"
    backend = _k1.resolve_backend(backend, sched)
    m = tr.rows(sched.size)
    leaves, spec = pytree.tree_flatten(x)
    for leaf in leaves:
        if leaf.dim() == 0 or leaf.shape[0] != m:
            raise ValueError(
                f"leaves must be this process's rank-stacked block, leading "
                f"axis {m} of the schedule's {sched.size}, got shape "
                f"{tuple(leaf.shape)}")
    if not leaves:
        return x
    dev = leaves[0].device
    if send_weights is not None:
        send_w = _send_table(send_weights, sched, dev)
        return pytree.tree_unflatten(
            _plain_procs(tr, leaves, sched, lambda acc: _owned_tables(
                tr, sched, dev, self_weight, recv_weights, dtype=acc),
                send_w), spec)
    sw, rw = _owned_tables(tr, sched, dev, self_weight, recv_weights)
    return pytree.tree_unflatten(
        _mix_procs(tr, leaves, sched, sw, rw, backend), spec)


def _mix_procs(tr, leaves, sched, sw, rw, backend):
    """Every leaf's owned rows folded with the owned tables ``(sw, rw)``,
    their sources' rows brought by one exchange: K1's peer form
    (``'kernel'``) or its plain twin, in the leaf's wire dtype."""
    m = leaves[0].shape[0]
    flats = [leaf.reshape(m, -1).to(_k1._wire_dtype(leaf.dtype)).contiguous()
             for leaf in leaves]
    mix = (_k1.gossip_mix_peer if backend == "kernel"
           else _k1.gossip_mix_peer_plain)
    with tr.exchange(sched, flats) as rows:
        outs = [mix(f, sw, rw, r) for f, r in zip(flats, rows)]
    return [o.reshape(leaf.shape).to(leaf.dtype)
            for o, leaf in zip(outs, leaves)]


def _plain_procs(tr, leaves, sched, tables, send_w=None):
    """Every leaf's owned rows folded by :func:`_plain_leaf` in its own
    dtype, their sources' rows brought unscaled by one exchange;
    ``tables(acc)`` gives the owned ``(sw, rw)`` in the accumulation dtype
    ``acc``."""
    m, start = leaves[0].shape[0], tr.start(sched.size)
    dev = leaves[0].device
    src = torch.as_tensor(sched.recv_src[start:start + m, :sched.num_slots],
                          dtype=torch.long, device=dev)
    flats = [leaf.reshape(m, -1).contiguous() for leaf in leaves]
    with tr.exchange(sched, flats) as rows:
        got = [r.gather(dev) for r in rows]
    return [_plain_leaf(f, *tables(_acc_dtype(f.dtype)), src, g,
                        send_w).reshape(leaf.shape)
            for leaf, f, g in zip(leaves, flats, got)]


def _send_table(send_weights, sched, device) -> torch.Tensor:
    """``send_weights`` as the ``(n, K)`` f32 table of every sender's slot
    weights."""
    send_w = torch.as_tensor(send_weights, dtype=torch.float32, device=device)
    if send_w.dim() == 1:
        send_w = send_w.expand(sched.size, -1)
    if send_w.shape != (sched.size, sched.num_slots):
        raise ValueError(
            f"send_weights must be ({sched.num_slots},) or "
            f"({sched.size}, {sched.num_slots}), got {tuple(send_w.shape)}")
    return send_w


def neighbor_allreduce_dynamic(x, schedules, step: int, *,
                               backend: str = "auto"):
    """Time-varying gossip: :func:`neighbor_allreduce` along
    ``schedules[step % len(schedules)]``; a period of one is a plain
    ``neighbor_allreduce``.

    The JAX package compiles the period into one ``lax.switch`` over a
    traced step.  Here the step is a Python integer and the phase is picked
    on the host.  Each phase's schedule keys the cache of its K1 tables (a
    :class:`Topology` is lowered once per object), so a period of ``p``
    phases builds and uploads ``p`` table sets once; a one-peer phase is
    one slot, one K1 launch per fused buffer."""
    if len(schedules) == 0:
        raise ValueError("schedules must hold at least one Topology or "
                         "GossipSchedule")
    return neighbor_allreduce(x, schedules[int(step) % len(schedules)],
                              backend=backend)


def _host_matrix(mixing_matrix) -> np.ndarray:
    if isinstance(mixing_matrix, torch.Tensor):
        if mixing_matrix.device.type != "cpu":
            raise ValueError(
                "mixing_matrix must be on the host (numpy or a CPU tensor): "
                "its active rotations are read there to build K1's tables, "
                f"got a tensor on {mixing_matrix.device}")
        mixing_matrix = mixing_matrix.detach().numpy()
    w = np.ascontiguousarray(mixing_matrix, dtype=np.float32)
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        raise ValueError(f"mixing_matrix must be (n, n), got {w.shape}")
    return w


def _digest(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little", signed=True)


@functools.lru_cache(maxsize=64)
def _aperiodic_tables(w_bytes: bytes, n: int, device: str):
    """K1's ``(sw, rw, recv_src)`` for the f32 matrix with these bytes, and
    the :class:`GossipSchedule` of its slots: one slot per active rotation
    ``s`` (some ``W[i, (i - s) % n] != 0``), in increasing ``s``, with
    ``recv_src[i, k] = (i - s_k) % n`` and ``rw[i, k] = W[i, recv_src[i,
    k]]`` (0 where rank ``i`` has no such edge).  In a context over several
    processes a new matrix is first checked to be every process's."""
    tr = _T.active()
    if tr is not None:
        tr.agree(_digest(w_bytes), f"an aperiodic mixing matrix ({n}x{n} "
                 "f32, lowered for the first time in this process)")
    w = np.frombuffer(w_bytes, dtype=np.float32).reshape(n, n)
    rows = np.arange(n)
    shifts = [s for s in range(1, n) if (w[rows, (rows - s) % n] != 0).any()]
    src = (np.stack([(rows - s) % n for s in shifts], axis=1)
           if shifts else np.zeros((n, 0), np.int64)).astype(np.int32)
    rw = w[rows[:, None], src].copy()
    sched = GossipSchedule(
        size=n,
        perms=tuple(tuple((int((d - s) % n), int(d)) for d in range(n))
                    for s in shifts),
        self_weights=np.diag(w).copy(), recv_weights=rw, recv_src=src,
        is_circulant=True, name=f"aperiodic-{_digest(w_bytes) & 0xffff:04x}")
    return (torch.as_tensor(np.diag(w).copy(), device=device),
            torch.as_tensor(rw, device=device),
            torch.as_tensor(src, device=device), sched)


def neighbor_allreduce_aperiodic(x, mixing_matrix, *,
                                 max_rotations: Optional[int] = None):
    """Gossip with an arbitrary per-call topology, ``out_i = W[i, i] x_i +
    sum_s W[i, (i - s) % n] x_{(i - s) % n}`` over the *active* rotations
    ``s`` (those with a nonzero edge on some rank) in increasing order, on
    every leaf of a pytree of rank-stacked tensors, in f32 for bf16/f16
    leaves.

    The JAX package decomposes ``W`` into its ``n - 1`` circulant rotations,
    each a ``ppermute`` that runs only when active, so the edge set is data
    to one compiled program.  Here the active rotations become K1's slots:
    ``W`` is read on the host, so it must be a numpy array or a CPU tensor
    (:func:`~bluefog_tpu_torch.topology.one_peer_exp2_mixing_matrix` gives
    one), and its tables are built and copied to the device once per
    distinct matrix (an LRU keyed by the f32 bytes of ``W``).  A repeated
    matrix costs a call the hash of its ``4 n^2`` bytes; a one-peer phase is
    one slot, one K1 launch per leaf.

    Over several processes every process passes the whole ``(n, n)`` matrix
    and its owned block of each leaf; the rotations' rows cross as in
    :func:`neighbor_allreduce` and K1's peer form folds them.  A matrix new
    to the LRU is hashed and the hashes compared across the processes (one
    small gather; a mismatch raises).

    ``max_rotations=D`` is the JAX package's program-size cap.  Within the
    cap the result equals the full form; with more than ``D`` active
    rotations every output is NaN (the reference's fail-loud rule: a dropped
    edge would bias the consensus silently), and nothing crosses."""
    w = _host_matrix(mixing_matrix)
    n = w.shape[0]
    if max_rotations is not None and int(max_rotations) < 1:
        raise ValueError(f"max_rotations must be >= 1, got {max_rotations}")
    tr = _T.active()
    rows = n if tr is None else tr.rows(n)
    leaves, spec = _stacked_leaves(x)
    for leaf in leaves:
        if leaf.shape[0] != rows:
            raise ValueError(f"leaves must be rank-stacked with leading axis "
                             f"{rows} of the matrix's {n} ranks, got shape "
                             f"{tuple(leaf.shape)}")
    if not leaves:
        return x
    sw, rw, src, sched = _aperiodic_tables(w.tobytes(), n,
                                           str(leaves[0].device))
    if max_rotations is not None and rw.shape[1] > int(max_rotations):
        outs = [torch.full_like(leaf, float("nan")) for leaf in leaves]
    elif tr is None:
        outs = [_kernel_leaf(leaf, sw, rw, src) for leaf in leaves]
    else:
        start = tr.start(n)
        outs = _mix_procs(tr, leaves, sched, sw[start:start + rows],
                          rw[start:start + rows].contiguous(), "kernel")
    return pytree.tree_unflatten(outs, spec)


# ---------------------------------------------------------------------------
# Flat collectives: reductions and gathers over the leading (rank) axis
# ---------------------------------------------------------------------------


def _stacked_leaves(x):
    leaves, spec = pytree.tree_flatten(x)
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            raise ValueError("leaves must be rank-stacked tensors with a "
                             f"leading rank axis, got {leaf!r:.80}")
    return leaves, spec


def _to_ranks(row: torch.Tensor, n: int) -> torch.Tensor:
    """``row`` as every one of ``n`` ranks' value: a new contiguous ``(n,
    ...)`` tensor, never a view of ``row``."""
    return row.expand(n, *row.shape).clone(
        memory_format=torch.contiguous_format)


def _rank_sum(leaf: torch.Tensor) -> torch.Tensor:
    """``psum`` over the leading axis in the leaf's dtype: bf16/f16 summed
    in f32 and rounded once (what the JAX package's CPU mesh computes),
    integers in their own dtype, booleans counted."""
    if leaf.dtype.is_floating_point:
        return leaf.sum(0, dtype=_acc_dtype(leaf.dtype)).to(leaf.dtype)
    if leaf.dtype == torch.bool:
        return leaf.sum(0)
    return leaf.sum(0, dtype=leaf.dtype)


def _gathered(x):
    """``(spec, wholes, rows)``: in one process each leaf is its own whole
    and ``rows`` its rank count; over several, ``wholes`` are the ``(n,
    ...)`` stacks of every process's blocks of each leaf, in rank order,
    and ``rows`` the owned counts."""
    leaves, spec = _stacked_leaves(x)
    rows = [leaf.shape[0] for leaf in leaves]
    tr = _T.active()
    if tr is None or not leaves:
        return spec, leaves, rows
    flats = [leaf.reshape(leaf.shape[0], -1) for leaf in leaves]
    flats = [f.view(torch.uint8) if f.dtype == torch.bool else f.contiguous()
             for f in flats]
    wholes = tr.gather_all(flats)
    return spec, [w.view(leaf.dtype).reshape(-1, *leaf.shape[1:])
                  for w, leaf in zip(wholes, leaves)], rows


def allreduce(x, *, average: bool = True):
    """Global sum, or mean (the reference default), over the ranks of every
    leaf of a pytree of rank-stacked tensors; every rank gets the result.

    As the reference computes it: the sum in the leaf's dtype, then ``/ n``
    in the accumulation dtype (f32 for bf16/f16) and back.  Integer and
    boolean leaves keep their dtype: the mean is the f32 quotient cast
    back, as ``astype`` casts it there.  Over several processes every
    process gathers all blocks and sums them in rank order, as one process
    does."""

    def one(leaf, rows):
        n = leaf.shape[0]
        s = _rank_sum(leaf)
        if average:
            if leaf.dtype.is_floating_point:
                s = (s.to(_acc_dtype(leaf.dtype)) / n).to(leaf.dtype)
            else:
                s = (s.float() / n).to(leaf.dtype)
        return _to_ranks(s.to(leaf.dtype), rows)

    spec, wholes, rows = _gathered(x)
    return pytree.tree_unflatten([one(w, r) for w, r in zip(wholes, rows)],
                                 spec)


def allgather(x, *, axis: int = 0, tiled: bool = False):
    """Every rank gets every rank's value: per rank, the ``n`` values
    stacked at ``axis`` (a new axis), or with ``tiled`` concatenated along
    ``axis`` (the reference concatenates along dim 0)."""

    def one(leaf, rows):
        if tiled:
            if leaf.dim() < 2:
                raise ValueError("tiled allgather needs per-rank values of "
                                 "rank >= 1")
            row = torch.cat(list(leaf.unbind(0)), dim=axis)
        else:
            row = torch.movedim(leaf, 0, axis)
        return _to_ranks(row, rows)

    spec, wholes, rows = _gathered(x)
    return pytree.tree_unflatten([one(w, r) for w, r in zip(wholes, rows)],
                                 spec)


def broadcast(x, root_rank: int = 0):
    """Every rank gets ``root_rank``'s value, in the leaf's dtype."""

    def one(leaf, rows):
        n = leaf.shape[0]
        if not 0 <= root_rank < n:
            raise ValueError(f"root_rank {root_rank} outside [0, {n})")
        return _to_ranks(leaf[root_rank], rows)

    spec, wholes, rows = _gathered(x)
    return pytree.tree_unflatten([one(w, r) for w, r in zip(wholes, rows)],
                                 spec)


def barrier(device=None) -> bool:
    """Synchronization point (``bf.barrier``): waits for the work queued on
    the device (a no-op on the CPU), and over several processes for every
    process to arrive."""
    dev = torch.device(device) if device is not None else None
    if (dev is None and torch.cuda.is_available()) or (
            dev is not None and dev.type == "cuda"):
        torch.cuda.synchronize(dev)
    tr = _T.active()
    if tr is not None:
        tr.barrier()
    return True


def pair_gossip(x, *, perm, self_weight=0.5):
    """Average with one partner: ``out[d] = w x[d] + (1 - w) x[s]`` for every
    ``(s, d)`` of the pairing ``perm``, in the accumulation dtype; ranks that
    are no destination keep their value.

    Over several processes the pairing is a one-slot schedule with
    ``recv_src[d] = s``, its rows cross as in :func:`neighbor_allreduce`,
    and f32, bf16 and f16 leaves fold on K1's peer form with ``sw = w`` and
    ``rw = 1 - w`` (``1 - w`` rounded to f32 as here) on the destinations,
    ``sw = 1`` and no slot elsewhere, which returns a rank's value exactly;
    other dtypes fold plainly with those weights in their own dtype."""
    pairs = [(int(s), int(d)) for s, d in perm]
    leaves, spec = _stacked_leaves(x)
    tr = _T.active()
    if tr is not None and leaves:
        return pytree.tree_unflatten(
            _pair_gossip_procs(tr, leaves, tuple(pairs), float(self_weight)),
            spec)

    def one(leaf):
        acc = _acc_dtype(leaf.dtype)
        w = torch.as_tensor(self_weight, dtype=acc, device=leaf.device)
        out = leaf.clone(memory_format=torch.contiguous_format)
        if pairs:
            src = torch.tensor([s for s, _ in pairs], device=leaf.device)
            dst = torch.tensor([d for _, d in pairs], device=leaf.device)
            mixed = w * leaf[dst].to(acc) + (1 - w) * leaf[src].to(acc)
            out[dst] = mixed.to(leaf.dtype)
        return out

    return pytree.tree_unflatten([one(leaf) for leaf in leaves], spec)


@functools.lru_cache(maxsize=64)
def _pair_schedule(pairs: Tuple[Tuple[int, int], ...], n: int,
                   self_weight: float) -> GossipSchedule:
    """The pairing as a one-slot partial schedule: destination ``d`` reads
    ``s`` with ``rw = 1 - w`` and keeps ``sw = w`` (in f32, as the
    one-process form rounds them); every other rank has no edge and ``sw =
    1``."""
    src = np.full((n, 1), -1, np.int32)
    for s, d in pairs:
        if not (0 <= s < n and 0 <= d < n):
            raise ValueError(f"pair ({s}, {d}) outside [0, {n})")
        src[d, 0] = s
    w = np.float32(self_weight)
    is_dst = src[:, 0] >= 0
    return GossipSchedule(
        size=n, perms=(pairs,),
        self_weights=np.where(is_dst, w, np.float32(1)).astype(np.float32),
        recv_weights=np.where(is_dst, np.float32(1) - w,
                              np.float32(0)).astype(np.float32)[:, None],
        recv_src=src, is_circulant=False, name="pair")


def _pair_gossip_procs(tr, leaves, pairs, self_weight):
    m = leaves[0].shape[0]
    dev = leaves[0].device
    sched = _pair_schedule(pairs, m * tr.processes, self_weight)
    kernel = [i for i, leaf in enumerate(leaves)
              if _acc_dtype(leaf.dtype) == torch.float32]
    rest = [i for i in range(len(leaves)) if i not in kernel]
    outs: List[Optional[torch.Tensor]] = [None] * len(leaves)
    if kernel:
        mixed = _mix_procs(tr, [leaves[i] for i in kernel], sched,
                           *_owned_tables(tr, sched, dev), "kernel")
        for i, out in zip(kernel, mixed):
            outs[i] = out
    if rest:
        start = tr.start(sched.size)
        is_dst = torch.as_tensor(sched.recv_src[start:start + m, 0] >= 0,
                                 device=dev)

        def tables(acc):
            w = torch.as_tensor(self_weight, dtype=acc, device=dev)
            return (torch.where(is_dst, w, torch.ones_like(w)),
                    torch.where(is_dst, 1 - w, torch.zeros_like(w))[:, None])

        mixed = _plain_procs(tr, [leaves[i] for i in rest], sched, tables)
        for i, out in zip(rest, mixed):
            outs[i] = out
    return outs


def neighbor_allgather(x: torch.Tensor, schedule):
    """In-neighbour values: ``(slots, mask)``, ``slots`` of shape ``(n, K,
    ...)`` with ``slots[i, k] = x[recv_src[i, k]]`` (zeros where rank ``i``
    has no slot-``k`` edge) and ``mask`` the ``(n, K)`` bool table of real
    entries.  As in the reference, irregular graphs pad to ``K =
    num_slots`` in place of ``bf.neighbor_allgather``'s ragged result.
    Over several processes ``x`` is the owned ``(m, ...)`` block, the rows
    arrive through the transport, and both results are the owned rows."""
    sched = _as_schedule(schedule)
    tr = _T.active()
    rows = sched.size if tr is None else tr.rows(sched.size)
    if x.dim() == 0 or x.shape[0] != rows:
        raise ValueError(f"x must be rank-stacked with leading axis "
                         f"{rows} of the schedule's {sched.size}, got shape "
                         f"{tuple(x.shape)}")
    start = 0 if tr is None else tr.start(sched.size)
    src = torch.as_tensor(
        sched.recv_src[start:start + rows, :sched.num_slots],
        dtype=torch.long, device=x.device)
    mask = src >= 0
    if tr is None:
        slots = x[src.clamp(min=0)]
        slots[~mask] = 0
        return slots, mask
    flat = x.reshape(rows, -1)
    flat = (flat.view(torch.uint8) if x.dtype == torch.bool
            else flat).contiguous()
    with tr.exchange(sched, [flat]) as (got,):
        slots = got.gather(x.device)
    return (slots.view(x.dtype).reshape(rows, sched.num_slots,
                                        *x.shape[1:]), mask)


# ---------------------------------------------------------------------------
# Hierarchical gossip: exact mean within each machine, gossip between them
# ---------------------------------------------------------------------------


def _machine_fold(avg, shipped, sched, self_weight, recv_weights, backend):
    """``out[m] = sw[m] avg[m] + sum_k rw[m, k] shipped[recv_src[m, k]]``
    over the ``M`` machine rows, in ``avg``'s (accumulation) dtype.

    f32 rows go through K1 (``'kernel'``) or K1's plain version
    (``'plain'``) as they are.  For rows rounded to a narrower wire dtype
    before shipping (bf16/f16 leaves) the self term stays unrounded, as in
    the reference: K1 reads ``2M`` f32 rows, the unrounded ``avg`` for the
    self terms and the rounded ``shipped`` for the slots, and its first
    ``M`` rows are the result.  Other dtypes (f64) fold in plain PyTorch."""
    tr = _T.active()
    if tr is not None:
        return _machine_fold_procs(tr, avg, shipped, sched, self_weight,
                                   recv_weights, backend)
    m = sched.size
    if avg.dtype != torch.float32:
        acc = avg.dtype
        sw, rw, src = _k1.schedule_tables(sched, avg.device, self_weight,
                                          recv_weights, dtype=acc)
        out = sw[:, None] * avg
        for k in range(sched.num_slots):
            s = src[:, k].long()
            recvd = torch.where((s >= 0)[:, None], shipped[s.clamp(min=0)], 0)
            out = out + rw[:, k, None] * recvd.to(acc)
        return out
    sw, rw, src = _k1.schedule_tables(sched, avg.device, self_weight,
                                      recv_weights)
    mix = _k1.gossip_mix if backend == "kernel" else _k1.gossip_mix_plain
    if shipped is avg:
        return mix(avg.contiguous(), sw, rw, src)
    rows = torch.cat([avg, shipped.float()]).contiguous()
    src2 = torch.cat([torch.where(src >= 0, src + m, src),
                      torch.full_like(src, -1)]).contiguous()
    sw2 = torch.cat([sw, torch.zeros_like(sw)])
    rw2 = torch.cat([rw, torch.zeros_like(rw)]).contiguous()
    return mix(rows, sw2, rw2, src2)[:m]


def _machine_fold_procs(tr, avg, shipped, sched, self_weight, recv_weights,
                        backend):
    """:func:`_machine_fold` on this process's machine rows: the shipped
    rows of the machines each owned machine reads arrive through the
    transport; the self terms are the unrounded ``avg``, as in one
    process."""
    dev = avg.device
    if avg.dtype != torch.float32:
        acc = avg.dtype
        sw, rw = _owned_tables(tr, sched, dev, self_weight, recv_weights,
                               dtype=acc)
        with tr.exchange(sched, [shipped.contiguous()]) as (rows,):
            recvd = rows.gather(dev)
        out = sw[:, None] * avg
        for k in range(sched.num_slots):
            out = out + rw[:, k, None] * recvd[:, k].to(acc)
        return out
    sw, rw = _owned_tables(tr, sched, dev, self_weight, recv_weights)
    mix = (_k1.gossip_mix_peer if backend == "kernel"
           else _k1.gossip_mix_peer_plain)
    with tr.exchange(sched, [shipped.float().contiguous()]) as (rows,):
        return mix(avg.contiguous(), sw, rw, rows)


def _hierarchical(x, machine_schedule, local_size, self_weight, recv_weights,
                  backend, round_local_sum):
    msched = _as_schedule(machine_schedule)
    backend = _k1.resolve_backend(backend, msched)
    # this process's machines: all of them in one process
    n_machines = _T.owned_rows(msched.size)
    n = n_machines * local_size
    leaves, spec = _stacked_leaves(x)

    def one(leaf):
        if leaf.shape[0] != n:
            raise ValueError(
                f"leaves must be rank-stacked with leading axis {n} "
                f"({n_machines} machines x {local_size}), got shape "
                f"{tuple(leaf.shape)}")
        acc = _acc_dtype(leaf.dtype)
        lanes = leaf.reshape(n_machines, local_size, -1)
        if round_local_sum:
            # psum within the machine in the leaf's dtype, then / L in f32
            local_sum = lanes.sum(1, dtype=acc).to(leaf.dtype).to(acc)
        else:
            # pmean of the f32 values
            local_sum = lanes.to(acc).sum(1)
        avg = local_sum / local_size
        # every lane of a machine holds this average, so the machine
        # gossip folds M rows, and each lane's counterpart on a peer
        # machine sends the same row
        shipped = avg if acc == leaf.dtype else avg.to(leaf.dtype)
        out = _machine_fold(avg, shipped, msched, self_weight, recv_weights,
                            backend).to(leaf.dtype)
        # contiguous: with one machine the reshape would be an expand's view
        return out.unsqueeze(1).expand(n_machines, local_size, out.shape[1]
                                       ).reshape(leaf.shape).contiguous()

    return pytree.tree_unflatten([one(leaf) for leaf in leaves], spec)


def hierarchical_neighbor_allreduce(x, machine_schedule, *, local_size: int,
                                    self_weight=None, recv_weights=None,
                                    backend: str = "auto"):
    """Exact average within each machine, then gossip between machines, on
    every leaf of a pytree of rank-stacked tensors (reference
    ``hierarchical_neighbor_allreduce``).

    Rank ``r`` sits on machine ``r // local_size``.  The local sum runs in
    the leaf's dtype, then ``/ local_size`` in f32 (the reference's ``psum``
    over ``axis_index_groups``); machines then mix along ``machine_schedule``
    (a :class:`GossipSchedule` or :class:`Topology` over ``n /
    local_size`` nodes), each local rank with its counterpart lane on the
    peer machine, shipping the average rounded to the leaf's dtype and
    keeping its own term in f32.  Every local rank of a machine ends with
    the same value.

    ``self_weight`` (a scalar or ``(M,)``) and ``recv_weights`` (``(K,)`` or
    ``(M, K)``) override the machine schedule's weights.  ``backend``:
    ``'kernel'`` runs the machine fold on K1, ``'plain'`` on K1's plain
    version, ``'auto'`` picks K1 for any machine schedule with a slot."""
    return _hierarchical(x, machine_schedule, local_size, self_weight,
                         recv_weights, backend, round_local_sum=True)


def hierarchical_neighbor_allreduce_2d(x, machine_schedule, *,
                                       local_size: int, self_weight=None,
                                       recv_weights=None,
                                       backend: str = "auto"):
    """The two-level ``(machine, local)`` form of
    :func:`hierarchical_neighbor_allreduce` (reference
    ``hierarchical_neighbor_allreduce_2d``): the same computation, except
    that the local average is the ``pmean`` of the f32 values, so bf16/f16
    local sums are not rounded to the leaf's dtype first."""
    return _hierarchical(x, machine_schedule, local_size, self_weight,
                         recv_weights, backend, round_local_sum=False)

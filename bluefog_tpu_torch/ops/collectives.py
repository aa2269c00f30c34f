"""Gossip collectives over rank-stacked tensors.

Counterpart of ``bluefog_tpu/ops/collectives.py`` for :func:`fuse_apply`,
:func:`_acc_dtype` and :func:`neighbor_allreduce`.  The JAX functions run
inside ``shard_map`` on one rank's value; here the ``n`` ranks are virtual and
every leaf carries them on its leading axis, ``x[r]`` being rank ``r``'s
value, as in the JAX package's stacked-array API (``parallel/api.py``).

Two backends, resolved per call by
:func:`bluefog_tpu_torch.ops.gossip_kernel.resolve_backend`:

- ``'kernel'``: K1, the fused weighted reduction of ``csrc/gossip_mix.cu``
  (the counterpart of ``'pallas'``), circulant schedules only;
- ``'plain'``: one gathered copy per schedule slot, then a multiply-add (the
  counterpart of ``'xla'``); any schedule, and the only path that honours
  ``send_weights``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree

from bluefog_tpu_torch.ops import gossip_kernel as _k1
from bluefog_tpu_torch.topology.graphs import Topology
from bluefog_tpu_torch.topology.schedule import GossipSchedule, build_schedule

__all__ = ["fuse_apply", "fuse_plan", "neighbor_allreduce"]


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
    buffer ``fn`` returned."""
    leaves, spec = pytree.tree_flatten(x)
    if len(leaves) <= 1:
        return fn(x)
    groups, big = fuse_plan(leaves, threshold_bytes)
    n = leaves[0].shape[0]
    bufs = {str(dt): torch.cat([leaves[i].reshape(n, -1) for i in idxs], dim=1)
            for dt, idxs in groups.items()}
    out_all = fn({"fused": bufs, "big": {str(i): leaves[i] for i in big}})
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


def _as_schedule(s) -> GossipSchedule:
    if isinstance(s, GossipSchedule):
        return s
    if isinstance(s, Topology):
        return build_schedule(s)
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


def _kernel_leaf(leaf, sched, self_weight, recv_weights):
    n = sched.size
    flat = leaf.reshape(n, -1).to(_k1._wire_dtype(leaf.dtype)).contiguous()
    sw, rw, src = _k1.schedule_tables(sched, leaf.device, self_weight,
                                      recv_weights)
    return _k1.gossip_mix(flat, sw, rw, src).reshape(leaf.shape).to(leaf.dtype)


def _plain_leaf(leaf, sched, self_weight, recv_weights, send_w):
    acc = _acc_dtype(leaf.dtype)
    sw, rw, src = _k1.schedule_tables(sched, leaf.device, self_weight,
                                      recv_weights, dtype=acc)
    out = _per_rank(sw, leaf.dim()) * leaf.to(acc)
    for k in range(sched.num_slots):
        shipped = leaf
        if send_w is not None:
            shipped = (_per_rank(send_w[:, k], leaf.dim()).to(acc)
                       * leaf.to(acc)).to(leaf.dtype)
        s = src[:, k].long()
        # a rank no slot-k edge reaches receives zeros, as from ppermute
        recvd = torch.where(_per_rank(s >= 0, leaf.dim()),
                            shipped[s.clamp(min=0)], 0).to(acc)
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
      backend: ``'kernel'`` (K1; circulant schedules only), ``'plain'``, or
        ``'auto'`` (K1 for a circulant schedule with at least one slot).  On
        a CPU tensor K1's wrapper runs its plain version.

    Every weighted sum runs in f32 for bf16/f16 leaves.  On the kernel path
    the payload travels in the wire dtype (bf16 for bf16 leaves, else f32).
    """
    sched = _as_schedule(schedule)
    if send_weights is not None:
        if backend == "kernel":
            raise NotImplementedError(
                "backend='kernel' cannot honour send_weights: the kernel folds "
                "weights on the receiving side only; use backend='plain'")
        backend = "plain" if backend == "auto" else backend
    backend = _k1.resolve_backend(backend, sched)
    if backend == "kernel" and _k1.circulant_shifts(sched) is None:
        raise ValueError("kernel gossip requires a circulant schedule")
    leaves, spec = pytree.tree_flatten(x)
    for leaf in leaves:
        if leaf.dim() == 0 or leaf.shape[0] != sched.size:
            raise ValueError(
                f"leaves must be rank-stacked with leading axis {sched.size}, "
                f"got shape {tuple(leaf.shape)}")
    if backend == "kernel":
        outs = [_kernel_leaf(leaf, sched, self_weight, recv_weights)
                for leaf in leaves]
    else:
        send_w = None
        if send_weights is not None:
            send_w = torch.as_tensor(send_weights, dtype=torch.float32,
                                     device=leaves[0].device)
            if send_w.dim() == 1:
                send_w = send_w.expand(sched.size, -1)
            if send_w.shape != (sched.size, sched.num_slots):
                raise ValueError(
                    f"send_weights must be ({sched.num_slots},) or "
                    f"({sched.size}, {sched.num_slots}), got "
                    f"{tuple(send_w.shape)}")
        outs = [_plain_leaf(leaf, sched, self_weight, recv_weights, send_w)
                for leaf in leaves]
    return pytree.tree_unflatten(outs, spec)

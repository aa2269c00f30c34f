"""Local softmax attention on K3, and sequence parallelism over an axis.

Counterpart of ``bluefog_tpu/ops/ring_attention.py``:

- :func:`local_attention` and its gate :func:`_flash_eligible`: K3 where the
  library kernel would run;
- :func:`ring_attention`: blockwise attention with the KV blocks rotating
  around a sequence-parallel axis and folded into a running online softmax
  (:func:`_fold_block`), in the contiguous or the load-balanced zigzag
  layout (:func:`zigzag_shard`, :func:`zigzag_unshard`);
- :func:`all_to_all_attention` (Ulysses): sequence and heads reshard over
  the axis, :func:`local_attention` with the caller's backend on the full
  sequence, and the inverse reshard.

Layout is the JAX package's, ``(B, T, H, D)`` in and out; K3 takes the
library's ``(B, H, T, D)``, so the call transposes (views, no copies) on the
way in and out, as ``ring_attention.py:126-131`` does.  Dimensions before
``B`` (the ranks of a mesh, see :mod:`bluefog_tpu_torch.parallel.axes`)
fold into K3's batch, so one launch serves every rank of a group.

The sequence-parallel functions take the ranks of their axis on a leading
dimension (``q (*ranks, B, T_local, H, D)``, the axis's dimension among the
leading ones).  The fold is XLA in the JAX package (a ``lax.scan`` of
rematerialised tiles), not a Pallas kernel, so it is plain PyTorch here: each
tile under ``torch.utils.checkpoint``.  The causal ring stays a skip: at each
step only the ranks whose arriving block lies in their past are gathered
into one batch and folded; the others do no work.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from bluefog_tpu_torch.ops.flash_kernel import (
    BUILT, DTYPES, HEAD_DIMS, flash_attention)
from bluefog_tpu_torch.parallel import axes as ax

__all__ = ["local_attention", "ring_attention", "all_to_all_attention",
           "zigzag_shard", "zigzag_unshard", "BACKENDS"]

_NEG_INF = -1e30  # the JAX dense path's mask value: exp never sees -inf
BACKENDS = ("dense", "flash", "auto")


def _built(q) -> bool:
    """Whether K3 is built for q's dtype and head dim (``HEAD_DIMS``): the
    same answer on every device, so a call takes the same route on the CPU
    as on the card."""
    return q.dtype in DTYPES and q.shape[-1] in HEAD_DIMS[q.dtype]


def _flash_eligible(q, k, causal, q_offset, k_offset) -> bool:
    """Whether K3 computes this call: ``_flash_eligible`` of the JAX package
    without its TPU-backend clause (on a CPU tensor K3's twins run), and with
    a clause for what K3 builds.  The library kernel needs T a multiple of
    its 128-row block and at least 128, Tq == Tk, D >= 32, and, because its
    causal mask is the aligned one, static (int) offsets with ``q_offset ==
    k_offset`` when causal; K3 also needs a dtype and head dim it is built
    for (``BUILT``)."""
    if not (isinstance(q_offset, int) and isinstance(k_offset, int)):
        return False
    if causal and q_offset != k_offset:
        return False
    t_q, t_k = q.shape[1], k.shape[1]
    return (t_q == t_k and t_q >= 128 and t_q % 128 == 0
            and q.shape[-1] >= 32 and _built(q))


def local_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, q_offset=0, k_offset=0,
                    backend: str = "dense") -> torch.Tensor:
    """Plain softmax attention on local blocks.

    Shapes: ``q (B, Tq, H, D)``, ``k/v (B, Tk, H, D)`` -> ``(B, Tq, H, D)``
    in ``q``'s dtype; leading dimensions before ``B`` (a group's ranks)
    fold into the batch.  ``q_offset``/``k_offset`` are the global positions of
    the first query / key row, used by the causal mask of shifted blocks
    (ints, or tensors, which never take K3).  ``scale`` defaults to
    ``1 / sqrt(D)``.

    ``backend``: ``'dense'`` (default) materialises the f32 ``(Tq, Tk)``
    scores with the ``-1e30`` mask, takes an f32 softmax, rounds it to
    ``v``'s dtype and sums the product in f32; ``'flash'`` forces K3 and
    raises where :func:`_flash_eligible` does not hold; ``'auto'`` takes K3
    wherever it holds, and the dense path elsewhere (a shape K3 is not
    built for among them: the route is chosen from the shape before any
    launch, the same on every device).  An eligible call on a CUDA tensor
    launches the kernels; on a CPU tensor their twins run.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if q.dim() > 4:
        lead = q.shape[:-3]
        out = local_attention(
            q.flatten(0, -4), k.flatten(0, -4), v.flatten(0, -4),
            causal=causal, scale=scale, q_offset=q_offset,
            k_offset=k_offset, backend=backend)
        return out.unflatten(0, lead)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    eligible = _flash_eligible(q, k, causal, q_offset, k_offset)
    if backend == "flash" and not eligible:
        raise ValueError(
            "backend='flash' requires Tq == Tk with T a multiple of 128, "
            "head_dim >= 32, static equal offsets when causal, and a dtype "
            f"and head dim K3 is built for ({BUILT}); got Tq={q.shape[1]}, "
            f"Tk={k.shape[1]}, D={q.shape[-1]}, {q.dtype}, causal={causal}, "
            f"offsets=({q_offset}, {k_offset}): the kernel has no offset "
            "mask, so forcing it where offsets differ would be silently "
            "wrong")
    if backend == "flash" or (backend == "auto" and eligible):
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              sm_scale=scale)
        return out.transpose(1, 2).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=k.device)
        scores = torch.where((qpos[:, None] >= kpos[None, :])[None, None],
                             scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _fold_tile(m, denom, o, q, kt, vt, kt0, qpos, *, scale: float,
               masked: bool):
    """One key tile into the online-softmax state ``(m, denom, o)``: f32
    scores (products of the inputs summed in f32), the ``-1e30`` causal mask
    of query positions ``qpos`` against keys ``kt0 + arange(tile)``, the
    probabilities rounded to ``v``'s dtype before the product with ``v``."""
    scores = torch.einsum("...qhd,...khd->...hqk", q.float(),
                          kt.float()) * scale
    if masked:
        kpos = kt0 + torch.arange(kt.shape[-3], device=kt.device)
        scores = torch.where(qpos[:, None] >= kpos[None, :], scores,
                             _NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    denom = denom * alpha + p.sum(dim=-1)
    o = o * alpha[..., None] + torch.einsum(
        "...hqk,...khd->...hqd", p.to(vt.dtype).float(), vt.float())
    return m_new, denom, o


def _fold_block(state, q, k, v, *, scale: float, kpos0, qpos, masked: bool,
                kv_tile: int):
    """Fold one KV block into the running online-softmax state ``(m, denom,
    o)`` (reference ``ring_attention.py::_fold_block``): the block in
    ``kv_tile``-wide key tiles, each under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of its scan body), so the live scores are
    ``(..., H, t_q, tile)`` and the backward recomputes them.  ``masked``
    applies the causal mask of ``qpos`` against ``kpos0 + arange``.

    ``q (..., t_q, H, D)``, ``k``/``v`` ``(..., t_k, H, D)``; ``m`` and
    ``denom`` ``(..., H, t_q)`` and ``o`` ``(..., H, t_q, D)`` in f32."""
    t_k = k.shape[-3]
    # the largest divisor of t_k not over kv_tile, or the whole block where
    # only degenerate divisors exist (as in the reference)
    tile = min(kv_tile, t_k)
    while t_k % tile:
        tile -= 1
    if tile < min(8, t_k, kv_tile):
        tile = t_k
    for j in range(t_k // tile):
        sl = slice(j * tile, (j + 1) * tile)
        state = checkpoint(_fold_tile, *state, q, k[..., sl, :, :],
                           v[..., sl, :, :], kpos0 + j * tile, qpos,
                           scale=scale, masked=masked, use_reentrant=False)
    return state


def _fold_rows(state, rows, q, k, v, **kw):
    """:func:`_fold_block` on the ranks ``rows`` of rank-major ``q``, ``k``,
    ``v`` and state (gathered into one batch); the other ranks' state passes
    through untouched."""
    if rows.numel() == q.shape[0]:
        return _fold_block(state, q, k, v, **kw)
    # no rows (a process whose ranks all skip this block) still folds its
    # empty batch: every process must use each rotated block, so that each
    # process runs the backward of every rotation
    pick = lambda t: t.index_select(0, rows)  # noqa: E731
    new = _fold_block(tuple(map(pick, state)), pick(q), pick(k), pick(v),
                      **kw)
    return tuple(t.index_copy(0, rows, u) for t, u in zip(state, new))


def _rank_major(t: torch.Tensor, axis: ax.Axis) -> torch.Tensor:
    """``(*ranks, B, T, H, D)`` -> ``(n, B', T, H, D)``: the axis first, the
    other leading dimensions folded into the batch."""
    return t.movedim(axis.dim, 0).flatten(1, -4)


def _zigzag_permutation(n: int, t_total: int) -> np.ndarray:
    """The global row order of the load-balanced causal layout: the
    sequence in ``2n`` chunks, rank ``r`` holding chunks ``r`` and
    ``2n-1-r``."""
    c, rem = divmod(t_total, 2 * n)
    if rem:
        raise ValueError(
            f"zigzag layout needs sequence length divisible by 2*axis_size; "
            f"got T={t_total}, n={n}")
    order = []
    for r in range(n):
        order.extend(range(r * c, (r + 1) * c))
        order.extend(range((2 * n - 1 - r) * c, (2 * n - r) * c))
    return np.asarray(order)


def zigzag_shard(x: torch.Tensor, axis_size: int, axis: int = 1
                 ) -> torch.Tensor:
    """Reorder a global sequence dimension into the zigzag layout, so that
    cutting it into ``axis_size`` contiguous blocks gives each rank a front
    chunk and its mirrored back chunk."""
    idx = _zigzag_permutation(axis_size, x.shape[axis])
    return x.index_select(axis, torch.from_numpy(idx).to(x.device))


def zigzag_unshard(x: torch.Tensor, axis_size: int, axis: int = 1
                   ) -> torch.Tensor:
    """Inverse of :func:`zigzag_shard` (global sequence order back)."""
    idx = np.argsort(_zigzag_permutation(axis_size, x.shape[axis]))
    return x.index_select(axis, torch.from_numpy(idx).to(x.device))


def ring_attention(q, k, v, axis: ax.Axis, *, causal: bool = False,
                   scale: Optional[float] = None, kv_tile: int = 512,
                   layout: str = "contiguous") -> torch.Tensor:
    """Blockwise ring attention over a sequence-parallel axis (reference
    ``ring_attention.py::ring_attention``).

    ``q``, ``k``, ``v``: ``(*ranks, B, T_local, H, D)``, rank ``r`` of
    ``axis`` holding its block of the global sequence of ``n * T_local``
    rows.  The KV blocks rotate around the ring (:func:`~bluefog_tpu_torch.
    parallel.axes.shift`), each arrival folded into the running online
    softmax (:func:`_fold_block`), so the result is full attention over the
    global sequence, returned sequence-sharded in ``q``'s dtype.

    Causal, ``layout='contiguous'`` (rank ``r`` holds rows ``[r T_local,
    (r+1) T_local)``): step 0 folds the diagonal block with the triangle
    mask; at step ``s > 0`` only the ranks whose arriving block is strictly
    past (``r >= s``) fold it, gathered into one batch, unmasked, and the
    rest skip it.  ``layout='zigzag'`` (see :func:`zigzag_shard`; the output
    stays in zigzag order): every rank folds exactly two half-chunks a step
    (:func:`_ring_zigzag_causal`).  Non-causal attention ignores the layout.
    Over processes the leading dimension holds the axis's ranks this
    process owns, and the KV rotation crosses the processes.
    """
    n = axis.size
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    if causal and q.shape[-3] != k.shape[-3]:
        raise ValueError(
            f"causal ring attention requires equal q/k shard widths, got "
            f"t_q={q.shape[-3]}, t_k={k.shape[-3]}")
    lead = q.movedim(axis.dim, 0).shape[:-3]
    q, k, v = (_rank_major(t, axis) for t in (q, k, v))
    ring = axis.at(0)
    local, b, t_q, h, d = q.shape
    dev = q.device
    state = (torch.full((local, b, h, t_q), _NEG_INF, device=dev),
             torch.zeros((local, b, h, t_q), device=dev),
             torch.zeros((local, b, h, t_q, d), device=dev))
    kw = dict(scale=scale, kv_tile=kv_tile)
    if causal and layout == "zigzag":
        denom, o = _ring_zigzag_causal(state, q, k, v, ring, **kw)
    else:
        # a masked fold is always a diagonal block, whose query and key
        # positions are aligned: the mask needs only their offsets in it
        qpos = torch.arange(t_q, device=dev)
        for s in range(n):
            if not causal or s == 0:
                state = _fold_block(state, q, k, v, kpos0=0, qpos=qpos,
                                    masked=causal, **kw)
            else:
                state = _fold_rows(state, _ring_rows(ring, s, n, dev),
                                   q, k, v, kpos0=0, qpos=qpos,
                                   masked=False, **kw)
            if s != n - 1:
                k, v = ax.shift(k, ring), ax.shift(v, ring)
        _, denom, o = state
    out = o / torch.clamp(denom[..., None], min=1e-30)
    out = out.transpose(-3, -2).to(q.dtype)             # (n, B', t, H, D)
    return out.reshape(*lead, *out.shape[-3:]).movedim(0, axis.dim)


def _ring_rows(ring: ax.Axis, lo: int, hi: int, dev) -> torch.Tensor:
    """The rows of rank-major tensors whose ranks are in ``[lo, hi)``: of
    the ring's ranks held here (all of them in one process)."""
    held = ring.local_ranks()
    first, last = max(lo, held.start), min(hi, held.stop)
    return torch.arange(first - held.start, max(first, last) - held.start,
                        device=dev)


def _ring_zigzag_causal(state, q, k, v, ring: ax.Axis, *, scale: float,
                        kv_tile: int):
    """The load-balanced causal ring (reference
    ``ring_attention.py::_ring_zigzag_causal``) on rank-major tensors.

    Rank ``r`` holds chunks ``r`` (front) and ``2n-1-r`` (back) of width
    ``c``.  For the block arriving from rank ``src``: ``q_back x k_front`` is
    always past (folded unmasked by every rank each step), ``q_front x
    k_back`` always future (never folded), ``q_front x k_front`` past iff
    ``src < r`` and ``q_back x k_back`` past iff ``src > r``; at step 0 both
    are the masked diagonals.  So at step ``s > 0`` ranks ``r >= s`` fold
    their front half and the others their back half: two half-chunks a rank,
    each group gathered into one batch.  Returns ``(denom, o)``."""
    n = ring.size
    t_q = q.shape[2]
    if t_q % 2:
        raise ValueError(
            f"zigzag layout needs an even local width, got t_q={t_q}")
    c = t_q // 2
    dev = q.device
    qf, qb = q[:, :, :c], q[:, :, c:]
    rel = torch.arange(c, device=dev)
    m, denom, o = state
    front = (m[..., :c], denom[..., :c], o[..., :c, :])
    back = (m[..., c:], denom[..., c:], o[..., c:, :])
    kw = dict(scale=scale, kpos0=0, qpos=rel, kv_tile=kv_tile)
    for s in range(n):
        kf, kb = k[:, :, :c], k[:, :, c:]
        vf, vb = v[:, :, :c], v[:, :, c:]
        if s == 0:
            front = _fold_block(front, qf, kf, vf, masked=True, **kw)
            back = _fold_block(back, qb, kb, vb, masked=True, **kw)
            back = _fold_block(back, qb, kf, vf, masked=False, **kw)
        else:
            back = _fold_block(back, qb, kf, vf, masked=False, **kw)
            front = _fold_rows(front, _ring_rows(ring, s, n, dev), qf,
                               kf, vf, masked=False, **kw)
            back = _fold_rows(back, _ring_rows(ring, 0, s, dev), qb, kb,
                              vb, masked=False, **kw)
        if s != n - 1:
            k, v = ax.shift(k, ring), ax.shift(v, ring)
    return (torch.cat([front[1], back[1]], dim=-1),
            torch.cat([front[2], back[2]], dim=-2))


def all_to_all_attention(q, k, v, axis: ax.Axis, *, causal: bool = False,
                         scale: Optional[float] = None,
                         backend: str = "dense") -> torch.Tensor:
    """Ulysses sequence parallelism (reference
    ``ring_attention.py::all_to_all_attention``): ``(*ranks, B, T_local, H,
    D)`` sequence-sharded in; an all-to-all over ``axis`` trades the
    sequence shards for head shards ``(*ranks, B, T, H/n, D)``,
    :func:`local_attention` with ``backend`` attends over the whole
    sequence (every rank of the group in one batch: one K3 launch under
    ``'auto'`` where it is eligible), and the inverse all-to-all brings the
    sequence shards back.  Needs ``H % n == 0``."""
    n, h = axis.size, q.shape[-2]
    if h % n:
        raise ValueError(f"num_heads={h} not divisible by axis size {n}; "
                         "use ring_attention for head counts below the mesh "
                         "size")
    to_heads = lambda t: ax.all_to_all(t, axis, -2, -3, tiled=True)  # noqa
    out = local_attention(to_heads(q), to_heads(k), to_heads(v),
                          causal=causal, scale=scale, backend=backend)
    return ax.all_to_all(out, axis, -3, -2, tiled=True)

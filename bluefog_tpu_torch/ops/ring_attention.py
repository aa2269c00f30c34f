"""Local softmax attention, on K3 where the library kernel would run.

Counterpart of ``bluefog_tpu/ops/ring_attention.py`` for
:func:`local_attention` and its gate :func:`_flash_eligible`.  The
sequence-parallel ``ring_attention``, ``all_to_all_attention`` and the zigzag
layout helpers come with the sequence-parallel slice.

Layout is the JAX package's, ``(B, T, H, D)`` in and out; K3 takes the
library's ``(B, H, T, D)``, so the call transposes (views, no copies) on the
way in and out, as ``ring_attention.py:126-131`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bluefog_tpu_torch.ops.flash_kernel import flash_attention

__all__ = ["local_attention", "BACKENDS"]

_NEG_INF = -1e30  # the JAX dense path's mask value: exp never sees -inf
BACKENDS = ("dense", "flash", "auto")


def _flash_eligible(q, k, causal, q_offset, k_offset) -> bool:
    """Whether K3 computes this call: ``_flash_eligible`` of the JAX package
    without its TPU-backend clause (on a CPU tensor K3's twins run).  The
    library kernel needs T a multiple of its 128-row block and at least 128,
    Tq == Tk, D >= 32, and, because its causal mask is the aligned one,
    static (int) offsets with ``q_offset == k_offset`` when causal."""
    if not (isinstance(q_offset, int) and isinstance(k_offset, int)):
        return False
    if causal and q_offset != k_offset:
        return False
    t_q, t_k = q.shape[1], k.shape[1]
    return t_q == t_k and t_q >= 128 and t_q % 128 == 0 and q.shape[-1] >= 32


def local_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, q_offset=0, k_offset=0,
                    backend: str = "dense") -> torch.Tensor:
    """Plain softmax attention on local blocks.

    Shapes: ``q (B, Tq, H, D)``, ``k/v (B, Tk, H, D)`` -> ``(B, Tq, H, D)``
    in ``q``'s dtype.  ``q_offset``/``k_offset`` are the global positions of
    the first query / key row, used by the causal mask of shifted blocks
    (ints, or tensors, which never take K3).  ``scale`` defaults to
    ``1 / sqrt(D)``.

    ``backend``: ``'dense'`` (default) materialises the f32 ``(Tq, Tk)``
    scores with the ``-1e30`` mask, takes an f32 softmax, rounds it to
    ``v``'s dtype and sums the product in f32; ``'flash'`` forces K3 and
    raises where :func:`_flash_eligible` does not hold; ``'auto'`` takes K3
    wherever it holds.  An eligible call on a CUDA tensor launches the
    kernels; on a CPU tensor their twins run.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    eligible = _flash_eligible(q, k, causal, q_offset, k_offset)
    if backend == "flash" and not eligible:
        raise ValueError(
            "backend='flash' requires Tq == Tk with T a multiple of 128, "
            "head_dim >= 32, and static equal offsets when causal; got "
            f"Tq={q.shape[1]}, Tk={k.shape[1]}, D={q.shape[-1]}, "
            f"causal={causal}, offsets=({q_offset}, {k_offset}): the kernel "
            "has no offset mask, so forcing it here would be silently wrong")
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

"""Mixture-of-experts routing and expert parallelism (Switch / GShard).

Counterpart of ``bluefog_tpu/ops/moe.py``: dense ``(T, E, C)`` dispatch and
combine tensors with a static per-shard capacity, and an expert-parallel FFN
whose experts are sharded over an ``ep`` mesh axis, tokens reaching their
expert through a pair of all-to-alls.  The reference's einsums and
all-to-alls are XLA, not Pallas, so this is plain PyTorch; over virtual
ranks the all-to-all is a transpose of the axis
(:func:`~bluefog_tpu_torch.parallel.axes.all_to_all`).

The routers take tokens ``(..., T, D)``: leading dimensions (a group's
ranks) are independent shards, each with its own slot queues, so a router
runs every rank of an ``ep`` group in one call.  What must match the
reference: ``argmax`` keeps the first index on ties (``torch.argmax`` does),
slots come from a cumulative sum over the tokens (so capacity drops the same
tokens), the expert FFN's GELU is the tanh form (``jax.nn.gelu``'s default),
and a one-hot of a slot past the capacity is all zeros (``jax.nn.one_hot``).
The reference's router noise draws from ``jax.random``; here the caller
passes the noise itself (``noise``, the logits' shape), so both packages can
be fed the same numbers.

Gradient convention (reference docstring): normalise each rank's loss by
the *global* token count, so that the ranks' losses sum to the global
objective.  Autograd of that sum is exact for the ep-sharded expert weights.
A replicated parameter (the router, the trunk) held once and applied to
every rank's tokens receives the sum over ranks of their contributions:
the reference's ``lax.psum(g, 'ep')`` is implicit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from bluefog_tpu_torch.parallel import axes as ax
from bluefog_tpu_torch.parallel.axes import Axis

__all__ = [
    "RouterOutput",
    "switch_router",
    "top2_router",
    "get_router",
    "expert_parallel_ffn",
    "moe_ffn_reference",
]


class RouterOutput(NamedTuple):
    """``dispatch`` and ``combine`` ``(..., T, E, C)``; ``aux`` the
    load-balance loss ``(...)``; ``metrics`` (no gradient):
    ``dropped_frac`` (routing assignments past capacity),
    ``fully_dropped_frac`` (tokens with every assignment dropped) and
    ``expert_load`` ``(..., E)``."""

    dispatch: torch.Tensor
    combine: torch.Tensor
    aux: torch.Tensor
    metrics: dict


def _router_probs(x, router_kernel, noise, noise_scale):
    logits = x.float() @ router_kernel.float()
    if noise is not None and noise_scale > 0:
        logits = logits + noise_scale * noise
    return torch.softmax(logits, dim=-1)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot, all zeros where ``idx`` is out of ``[0, n)``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _assign_slots(onehot, capacity: int, base=0.0):
    """Queue one routing choice into expert slots: ``pos`` from a cumulative
    sum over the tokens, offset by ``base`` (top-2's second choices queue
    behind every first choice); returns ``(keep (..., T, E), slot (..., T,
    E, C))``."""
    pos = (base + torch.cumsum(onehot, dim=-2) - 1.0) * onehot
    keep = (pos < capacity) * onehot
    slot = keep[..., None] * _one_hot(pos.long(), capacity)
    return keep, slot


def _gated(slot, gate):
    """``slot * gate`` for a 0/1 ``slot``, with only its boolean mask kept
    for the backward (a quarter of the f32 slot's bytes, the same
    values)."""
    return torch.where(slot.bool(), gate, 0.0)


def _router_metrics(assigned, kept) -> dict:
    with torch.no_grad():
        total = assigned.sum(dim=(-2, -1)).clamp(min=1.0)
        fully = (assigned.sum(-1) > 0) & (kept.sum(-1) == 0)
        return {
            "dropped_frac": 1.0 - kept.sum(dim=(-2, -1)) / total,
            "fully_dropped_frac": fully.float().mean(-1),
            "expert_load": assigned.sum(-2) / total[..., None],
        }


def switch_router(x, router_kernel, *, num_experts: int, capacity: int,
                  noise: Optional[torch.Tensor] = None,
                  noise_scale: float = 0.0) -> RouterOutput:
    """Top-1 (Switch) routing with static ``capacity`` a shard: tokens past
    an expert's capacity are dropped (zero combine weight)."""
    probs = _router_probs(x, router_kernel, noise, noise_scale)
    onehot = _one_hot(torch.argmax(probs, dim=-1), num_experts)
    keep, dispatch = _assign_slots(onehot, capacity)
    gate = (probs * onehot).sum(-1, keepdim=True)
    combine = _gated(dispatch, gate[..., None])
    aux = num_experts * (onehot.mean(-2) * probs.mean(-2)).sum(-1)
    return RouterOutput(dispatch, combine, aux,
                        _router_metrics(onehot, keep))


def top2_router(x, router_kernel, *, num_experts: int, capacity: int,
                noise: Optional[torch.Tensor] = None,
                noise_scale: float = 0.0) -> RouterOutput:
    """Top-2 (GShard) routing: each token to its two most probable experts,
    gates renormalised over the pair, second choices queued behind all of an
    expert's first choices; the aux loss over first choices."""
    if num_experts < 2:
        raise ValueError(
            f"top2_router requires num_experts >= 2, got {num_experts}; "
            "with a single expert the second choice duplicates the first "
            "(capacity silently halves): use switch_router / router='top1'")
    probs = _router_probs(x, router_kernel, noise, noise_scale)
    oh1 = _one_hot(torch.argmax(probs, dim=-1), num_experts)
    oh2 = _one_hot(torch.argmax(probs * (1.0 - oh1), dim=-1), num_experts)
    g1 = (probs * oh1).sum(-1)
    g2 = (probs * oh2).sum(-1)
    denom = g1 + g2 + 1e-9
    g1n, g2n = g1 / denom, g2 / denom
    keep1, slot1 = _assign_slots(oh1, capacity)
    keep2, slot2 = _assign_slots(oh2, capacity,
                                 base=oh1.sum(-2, keepdim=True))
    dispatch = slot1 + slot2
    combine = (_gated(slot1, g1n[..., None, None])
               + _gated(slot2, g2n[..., None, None]))
    aux = num_experts * (oh1.mean(-2) * probs.mean(-2)).sum(-1)
    return RouterOutput(dispatch, combine, aux,
                        _router_metrics(oh1 + oh2, keep1 + keep2))


def get_router(name: str):
    """``'top1'`` -> :func:`switch_router`, ``'top2'`` ->
    :func:`top2_router`."""
    try:
        return {"top1": switch_router, "top2": top2_router}[name]
    except KeyError:
        raise ValueError(f"unknown router {name!r}; expected 'top1' or "
                         "'top2'") from None


def _local_ffn(inputs, wi, wo):
    """``(..., El, S, D) x (..., El, D, H) x (..., El, H, D)``: each expert's
    GELU (tanh form) MLP."""
    h = F.gelu(torch.matmul(inputs, wi), approximate="tanh")
    return torch.matmul(h, wo)


def expert_parallel_ffn(x, router_kernel, wi_local, wo_local, *, axis: Axis,
                        num_experts: int, capacity: int,
                        router: str = "top1",
                        noise: Optional[torch.Tensor] = None,
                        noise_scale: float = 0.0):
    """The MoE FFN with experts sharded over ``axis`` (reference
    ``moe.py::expert_parallel_ffn``), for every rank of the axis at once.

    ``x``: ``(ep, T_local, D)`` each rank's tokens; ``wi_local`` /
    ``wo_local``: ``(ep, E / ep, D, H)`` / ``(ep, E / ep, H, D)`` each
    rank's experts (global expert ``e = s (E / ep) + j`` on rank ``s``).
    Over processes the leading dimension holds the axis's ranks this
    process owns (``axis.local`` of them) and the all-to-all crosses.
    Returns ``(y, aux, metrics)``: ``(ep, T_local, D)`` expert outputs (zero
    for dropped tokens; add the residual outside), each rank's aux loss
    ``(ep,)`` and its router metrics."""
    if axis.dim != 0:
        raise ValueError(f"expert_parallel_ffn takes the {axis.name!r} ranks "
                         f"on dim 0, got dim {axis.dim}")
    ep, local_e, d = axis.size, wi_local.shape[1], x.shape[-1]
    held = axis.local                   # ranks of the axis held here
    dispatch, combine, aux, metrics = get_router(router)(
        x, router_kernel, num_experts=num_experts, capacity=capacity,
        noise=noise, noise_scale=noise_scale)
    # (ep, T, E, C) x (ep, T, D) -> each rank's expert-major send buffer
    sends = torch.einsum("rtec,rtd->recd", dispatch.to(x.dtype), x)
    sends = sends.reshape(held, ep, local_e, capacity, d)  # (src, dst, ...)
    recvd = ax.all_to_all(sends, axis, -4, -4)            # (dst, src, ...)
    inputs = recvd.transpose(1, 2).reshape(held, local_e, ep * capacity, d)
    outputs = _local_ffn(inputs, wi_local, wo_local)
    outputs = outputs.reshape(held, local_e, ep, capacity, d).transpose(1, 2)
    back = ax.all_to_all(outputs, axis, -4, -4)           # (src, holder, ...)
    expert_outputs = back.reshape(held, num_experts, capacity, d)
    y = torch.einsum("rtec,recd->rtd", combine.to(x.dtype), expert_outputs)
    return y, aux, metrics


def moe_ffn_reference(x, router_kernel, wi, wo, *, num_experts: int,
                      capacity: int, router: str = "top1"):
    """Unsharded reference: every expert local, ``x (..., T, D)`` and ``wi``
    / ``wo`` ``(E, D, H)`` / ``(E, H, D)``."""
    dispatch, combine, aux, metrics = get_router(router)(
        x, router_kernel, num_experts=num_experts, capacity=capacity)
    inputs = torch.einsum("...tec,...td->...ecd", dispatch.to(x.dtype), x)
    outputs = _local_ffn(inputs, wi, wo)
    y = torch.einsum("...tec,...ecd->...td", combine.to(x.dtype), outputs)
    return y, aux, metrics

"""K1: the gossip kernel, its plain PyTorch version, and backend routing.

Counterpart of ``bluefog_tpu/ops/pallas_gossip.py`` for
:func:`~bluefog_tpu.ops.pallas_gossip.neighbor_allreduce_pallas`.  The ranks
are virtual: rows of one rank-stacked ``(n, L)`` buffer on one device, so the
TPU kernel's per-slot remote DMA becomes a read of the source rank's row.  The
CUDA source is ``bluefog_tpu_torch/csrc/gossip_mix.cu``; its header states
the bound and the design.

:func:`gossip_mix` is the wrapper.  On a CUDA tensor it launches the kernel
(or raises); on a CPU tensor, and only there, it runs :func:`gossip_mix_plain`,
which computes the same function with the same rounding in plain PyTorch.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from bluefog_tpu_torch.topology.schedule import GossipSchedule

__all__ = [
    "auto_gossip_backend",
    "resolve_backend",
    "gossip_mix",
    "gossip_mix_plain",
    "schedule_tables",
    "slot_tables",
    "BACKENDS",
]

# "kernel": K1 (gossip_mix); "plain": the portable path of ops.collectives,
# one gathered copy per slot, the counterpart of the JAX package's 'xla'.
BACKENDS = ("auto", "plain", "kernel")


def auto_gossip_backend(sched: GossipSchedule) -> str:
    """Resolve ``backend='auto'``: ``'kernel'`` for any schedule with at
    least one slot over more than one rank, else ``'plain'``.

    This differs from ``pallas_gossip.auto_gossip_backend``, which also asks
    for a circulant schedule: on the TPU each slot is a remote DMA, and a
    DMA pattern needs one uniform shift for every rank.  Here the ranks are
    virtual rows of one buffer, and K1 reads any source row through its
    ``recv_src`` table, skipping the slots with no in-edge, so a grid, a
    star or one phase of a time-varying graph takes the kernel too.  The
    device does not enter: on a CPU tensor the kernel's wrapper runs its
    plain version."""
    if sched.size <= 1 or sched.num_slots == 0:
        return "plain"
    return "kernel"


def resolve_backend(backend: str, sched: GossipSchedule) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return auto_gossip_backend(sched) if backend == "auto" else backend


def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    """On-wire dtype of a leaf: bf16 leaves ship as bf16, everything else as
    f32.  The weighted sum runs in f32 either way."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


@functools.lru_cache(maxsize=64)
def _cached_slots(sched: GossipSchedule, device: str):
    src = torch.as_tensor(sched.recv_src[:, :sched.num_slots],
                          dtype=torch.int32, device=device).contiguous()
    return src, (src >= 0).to(torch.int32)


def slot_tables(sched: GossipSchedule, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(recv_src (n, K), mask (n, K))``, both int32 on ``device``: the rank
    feeding slot ``k`` of rank ``i`` (-1 where no edge) and whether that slot
    has an in-edge (``recv_src >= 0``).  Cached per schedule and device."""
    return _cached_slots(sched, str(torch.device(device)))


@functools.lru_cache(maxsize=64)
def _cached_weights(sched: GossipSchedule, device: str, dtype: torch.dtype):
    return (torch.as_tensor(sched.self_weights, dtype=dtype, device=device),
            torch.as_tensor(sched.recv_weights[:, :sched.num_slots],
                            dtype=dtype, device=device).contiguous())


def schedule_tables(sched: GossipSchedule, device, self_weight=None,
                    recv_weights=None, dtype: torch.dtype = torch.float32):
    """``(sw (n,), rw (n, K), recv_src (n, K))`` on ``device`` for one call,
    the weights in ``dtype``.

    ``self_weight`` overrides the schedule's self weights: a scalar for every
    rank or an ``(n,)`` per-rank vector.  ``recv_weights`` overrides the
    receive weights: ``(K,)`` for every rank or an ``(n, K)`` table.  The
    schedule's own tables are cached per device and dtype."""
    n, k = sched.size, sched.num_slots
    sw, rw = _cached_weights(sched, str(torch.device(device)), dtype)
    src = slot_tables(sched, device)[0]
    if self_weight is not None:
        sw = torch.as_tensor(self_weight, dtype=dtype, device=device)
        sw = sw.expand(n).contiguous() if sw.dim() == 0 else sw
        if sw.shape != (n,):
            raise ValueError(f"self_weight must be a scalar or ({n},), got "
                             f"{tuple(sw.shape)}")
    if recv_weights is not None:
        rw = torch.as_tensor(recv_weights, dtype=dtype, device=device)
        rw = rw.expand(n, k).contiguous() if rw.dim() == 1 else rw
        if rw.shape != (n, k):
            raise ValueError(f"recv_weights must be ({k},) or ({n}, {k}), got "
                             f"{tuple(rw.shape)}")
    return sw, rw, src


def _check(x: torch.Tensor, sw: torch.Tensor, rw: torch.Tensor,
           recv_src: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (n, L), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    n = x.shape[0]
    k = recv_src.shape[1] if recv_src.dim() == 2 else -1
    if sw.shape != (n,) or sw.dtype != torch.float32:
        raise ValueError(f"sw must be float32 ({n},), got {sw.dtype} "
                         f"{tuple(sw.shape)}")
    if recv_src.shape != (n, k) or recv_src.dtype != torch.int32:
        raise ValueError(f"recv_src must be int32 ({n}, K), got "
                         f"{recv_src.dtype} {tuple(recv_src.shape)}")
    if rw.shape != (n, k) or rw.dtype != torch.float32:
        raise ValueError(f"rw must be float32 ({n}, {k}), got {rw.dtype} "
                         f"{tuple(rw.shape)}")
    for name, t in (("sw", sw), ("rw", rw), ("recv_src", recv_src)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def gossip_mix_plain(x: torch.Tensor, sw: torch.Tensor, rw: torch.Tensor,
                     recv_src: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: ``out[i] = sw[i] x[i] + sum_k rw[i,k]
    x[recv_src[i,k]]`` in f32, in slot order, each product and sum rounded on
    its own; slots with a source outside ``[0, n)`` are skipped.  Returns the
    dtype of ``x``."""
    _check(x, sw, rw, recv_src)
    n = x.shape[0]
    acc = sw[:, None] * x.float()
    for k in range(recv_src.shape[1]):
        src = recv_src[:, k].long()
        valid = ((src >= 0) & (src < n))[:, None]
        recvd = x[src.clamp(0, n - 1)].float()
        acc = torch.where(valid, acc + rw[:, k, None] * recvd, acc)
    return acc.to(x.dtype)


def _vector_width(x: torch.Tensor, out: torch.Tensor) -> int:
    """16 bytes' worth of elements when every row of ``x`` and ``out`` (rows
    of ``x.shape[1]`` elements) starts 16-byte aligned, else 1."""
    vec = 16 // x.element_size()
    aligned = (x.shape[1] % vec == 0 and x.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    return vec if aligned else 1


def gossip_mix(x: torch.Tensor, sw: torch.Tensor, rw: torch.Tensor,
               recv_src: torch.Tensor) -> torch.Tensor:
    """K1 on a rank-stacked ``(n, L)`` f32 or bf16 buffer (see
    :func:`gossip_mix_plain` for the function).

    A CUDA tensor launches the kernel on the current stream and adds one to
    ``gossip_mix.launches``; a launch error raises.  A CPU tensor runs the
    plain version.  Any other device raises."""
    _check(x, sw, rw, recv_src)
    if x.device.type == "cpu":
        return gossip_mix_plain(x, sw, rw, recv_src)
    if x.device.type != "cuda":
        raise ValueError(f"gossip_mix runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and sw.is_contiguous() and rw.is_contiguous()
            and recv_src.is_contiguous()):
        raise ValueError("gossip_mix needs contiguous x, sw, rw, recv_src")
    from bluefog_tpu_torch.ops import _build

    lib = _build.load()
    out = torch.empty_like(x)
    n, length = x.shape
    if length == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.bf_gossip_mix(
            x.data_ptr(), out.data_ptr(), sw.data_ptr(), rw.data_ptr(),
            recv_src.data_ptr(), n, recv_src.shape[1], length,
            0 if x.dtype == torch.float32 else 1, _vector_width(x, out),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gossip_mix launch failed: cudaError {err}")
    gossip_mix.launches += 1
    return out


gossip_mix.launches = 0

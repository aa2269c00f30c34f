"""K2: the window deliver kernel, its plain PyTorch version, and routing.

Counterpart of ``bluefog_tpu/ops/pallas_gossip.py`` for
:func:`~bluefog_tpu.ops.pallas_gossip.deliver_pallas` (the ``put`` and ``acc``
modes of the exchange kernel) and the window half of its
``resolve_backend(..., chunkable=False)``.  The ranks are virtual: rows of a
rank-stacked ``(n, L)`` payload, delivered into a rank-stacked ``(n, K, L)``
block of landing buffers on the same device, so the TPU kernel's remote DMA
into a neighbour's slot becomes a read of the sender's row.  The CUDA source
is ``bluefog_tpu_torch/csrc/window_deliver.cu``; its header states the bound
and the design.

:func:`window_deliver` is the wrapper.  On a CUDA tensor it launches the
kernel (or raises); on a CPU tensor, and only there, it runs
:func:`window_deliver_plain`, which computes the same function with the same
rounding in plain PyTorch.  Both update ``bufs`` in place.

K2 takes every float dtype a window holds.  f32 and bf16 travel in their own
dtype, f16 on an f32 wire (f32 arithmetic, rounded back to f16 on landing),
as ``deliver_pallas`` carries them.  f64 is carried in f64: the TPU kernel
rounds it through an f32 wire because the TPU has no f64, while K2, the plain
version and the JAX package's portable path all keep it exact.

Two mechanisms of the TPU routing are not carried over, and neither changes a
result: the 4 MiB payload cap (``DEFAULT_AUTO_MAX_BYTES``), which sizes a
window to TPU VMEM (on the card every window with a slot takes K2 whatever
its size), and the collective-id bases with their CRC32 claim table, which keep
barrier semaphores apart on the TPU.
"""

from __future__ import annotations

import torch

from bluefog_tpu_torch.ops.gossip_kernel import (
    BACKENDS, _vector_width, auto_gossip_backend, slot_tables)
from bluefog_tpu_torch.topology.schedule import GossipSchedule

__all__ = [
    "auto_window_backend",
    "resolve_window_backend",
    "deliver_tables",
    "window_deliver",
    "window_deliver_plain",
    "KERNEL_DTYPES",
]

# the buffer dtypes K2 takes, by the code its C entry point reads
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                 torch.float64: 3}


def auto_window_backend(sched: GossipSchedule) -> str:
    """Resolve ``backend='auto'`` for a window: ``'kernel'`` for any
    schedule with at least one slot over more than one rank, else
    ``'plain'``.  ``deliver_pallas`` also needs a circulant schedule, since
    its remote DMA needs one uniform shift; K2 reads each slot's sender row
    through ``recv_src`` and masks the slots with no in-edge, so it takes
    any schedule (the rule of K1's
    :func:`~bluefog_tpu_torch.ops.gossip_kernel.auto_gossip_backend`)."""
    return auto_gossip_backend(sched)


def resolve_window_backend(backend: str, sched: GossipSchedule) -> str:
    """Validate ``backend`` and resolve ``'auto'``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "auto":
        return auto_window_backend(sched)
    return backend


# (recv_src, mask) of a schedule: the tables K1 reads too
deliver_tables = slot_tables


def _check(x: torch.Tensor, bufs: torch.Tensor, recv_src: torch.Tensor,
           mask: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (n, L), got shape {tuple(x.shape)}")
    n, length = x.shape
    k = recv_src.shape[1] if recv_src.dim() == 2 else -1
    if bufs.shape != (n, k, length) or bufs.dtype != x.dtype:
        raise ValueError(f"bufs must be {x.dtype} ({n}, {k}, {length}), got "
                         f"{bufs.dtype} {tuple(bufs.shape)}")
    for name, t in (("recv_src", recv_src), ("mask", mask)):
        if t.shape != (n, k) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 ({n}, K), got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("bufs", bufs), ("recv_src", recv_src), ("mask", mask)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def window_deliver_plain(x: torch.Tensor, bufs: torch.Tensor,
                         recv_src: torch.Tensor, mask: torch.Tensor,
                         dst_weight: float = 1.0, *,
                         accumulate: bool) -> torch.Tensor:
    """Plain version of K2, in place on ``bufs``: for each slot ``k`` in
    order, ``pay = (f32(dst_weight) * x[recv_src[:, k]])`` rounded to
    ``x``'s dtype, then ``bufs[:, k] = pay`` (put) or ``bufs[:, k] + pay``
    added in f32 and rounded to the buffers' dtype (acc), kept only where
    ``mask[:, k] != 0`` and the source lies in ``[0, n)``.  Any float dtype
    (f64 computes in f64); returns ``bufs``."""
    _check(x, bufs, recv_src, mask)
    n = x.shape[0]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    w = torch.tensor(float(dst_weight), dtype=acc, device=x.device)
    for k in range(recv_src.shape[1]):
        src = recv_src[:, k].long()
        live = ((mask[:, k] != 0) & (src >= 0) & (src < n))[:, None]
        pay = (w * x[src.clamp(0, n - 1)].to(acc)).to(x.dtype)
        old = bufs[:, k]
        new = (old.to(acc) + pay.to(acc)).to(x.dtype) if accumulate else pay
        old.copy_(torch.where(live, new, old))
    return bufs


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def window_deliver(x: torch.Tensor, bufs: torch.Tensor,
                   recv_src: torch.Tensor, mask: torch.Tensor,
                   dst_weight: float = 1.0, *,
                   accumulate: bool) -> torch.Tensor:
    """K2 on a rank-stacked ``(n, L)`` float payload (f32, bf16, f16 or f64)
    and its ``(n, K, L)`` landing buffers of the same dtype, updated in place
    (see :func:`window_deliver_plain` for the function).  Returns ``bufs``.

    A CUDA tensor launches the kernel on the current stream and adds one to
    ``window_deliver.launches``; a launch error raises, and so does a
    payload that overlaps ``bufs``.  A CPU tensor runs the plain version.
    Any other device raises.  With no slots or an empty row nothing is
    launched."""
    _check(x, bufs, recv_src, mask)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"x must be float32, bfloat16, float16 or float64, "
                        f"got {x.dtype}")
    if x.device.type == "cpu":
        return window_deliver_plain(x, bufs, recv_src, mask, dst_weight,
                                    accumulate=accumulate)
    if x.device.type != "cuda":
        raise ValueError(f"window_deliver runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and bufs.is_contiguous()
            and recv_src.is_contiguous() and mask.is_contiguous()):
        raise ValueError("window_deliver needs contiguous x, bufs, recv_src, "
                         "mask")
    n, length = x.shape
    num_slots = recv_src.shape[1]
    if num_slots == 0 or length == 0:
        return bufs
    if _overlaps(x, bufs):
        raise ValueError("window_deliver updates bufs in place; the payload "
                         "must not overlap it")
    from bluefog_tpu_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.bf_window_deliver(
            x.data_ptr(), bufs.data_ptr(), recv_src.data_ptr(),
            mask.data_ptr(), float(dst_weight), n, num_slots, length,
            KERNEL_DTYPES[x.dtype], _vector_width(x, bufs),
            1 if accumulate else 0,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_deliver launch failed: cudaError {err}")
    window_deliver.launches += 1
    return bufs


window_deliver.launches = 0

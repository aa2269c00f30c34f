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

:func:`window_deliver_peer` is K2's peer-memory form, for a context that
spans processes: this process's payload rows land in the landing slots of
the receiving ranks, wherever they live (a peer's window mapped into this
process, or this process's own), named by a
:class:`~bluefog_tpu_torch.ops.transport.PeerTargets` table.  Its plain twin
:func:`window_deliver_peer_plain` does the same with tensor copies into the
mapped views.  Over gloo on the CPU the receiver applies the arrivals
instead (:func:`window_deliver_rows_plain`).

Two mechanisms of the TPU routing are not carried over, and neither changes a
result: the 4 MiB payload cap (``DEFAULT_AUTO_MAX_BYTES``), which sizes a
window to TPU VMEM (on the card every window with a slot takes K2 whatever
its size), and the collective-id bases with their CRC32 claim table, which keep
barrier semaphores apart on the TPU.

Each wrapper counts its calls in :data:`CALLS` (whichever route runs
them) beside its kernel launches (``.launches``).
"""

from __future__ import annotations

import torch

from bluefog_tpu_torch.ops.gossip_kernel import (
    BACKENDS, _vector_width, auto_gossip_backend, slot_tables)
from bluefog_tpu_torch.topology.schedule import GossipSchedule

#: calls of each wrapper, whichever route ran them (the launches are
#: each wrapper's ``.launches``)
CALLS: Dict[str, int] = {"window_deliver": 0, "window_deliver_peer": 0}

__all__ = [
    "auto_window_backend",
    "resolve_window_backend",
    "deliver_tables",
    "window_deliver",
    "window_deliver_plain",
    "window_deliver_peer",
    "window_deliver_peer_plain",
    "window_deliver_rows_plain",
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
    CALLS["window_deliver"] += 1
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


def _arith(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _land(dst: torch.Tensor, src_row: torch.Tensor, w: torch.Tensor,
          accumulate: bool) -> None:
    """One delivery with K2's rounding: the weighted payload rounded to the
    buffers' dtype, then kept (put) or added in the arithmetic type and
    rounded (acc)."""
    acc = w.dtype
    pay = (w * src_row.to(acc)).to(dst.dtype)
    dst.copy_((dst.to(acc) + pay.to(acc)).to(dst.dtype) if accumulate
              else pay)


def _check_peer(x: torch.Tensor, targets) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (m, L), got shape {tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"x must be float32, bfloat16, float16 or float64, "
                        f"got {x.dtype}")
    if targets.length != x.shape[1] or targets.dtype != x.dtype:
        raise ValueError(f"targets of {targets.length} {targets.dtype} for a "
                         f"payload of {x.dtype} {tuple(x.shape)}")
    if any(not 0 <= r < x.shape[0] for r in targets.src_rows):
        raise ValueError("a delivery names a payload row outside x")


def window_deliver_peer_plain(x: torch.Tensor, targets,
                              dst_weight: float = 1.0, *,
                              accumulate: bool) -> None:
    """Plain version of K2's peer form: for each delivery ``d`` in order,
    ``pay = (f32(dst_weight) * x[src_rows[d]])`` rounded to ``x``'s dtype,
    then the landing slot ``views[d]`` becomes ``pay`` (put) or ``slot +
    pay`` added in f32 and rounded (acc); f64 computes in f64.  The slots
    may lie in other processes' windows, mapped into this one."""
    _check_peer(x, targets)
    w = torch.tensor(float(dst_weight), dtype=_arith(x.dtype),
                     device=x.device)
    for dst, r in zip(targets.views, targets.src_rows):
        _land(dst, x[r], w, accumulate)


def window_deliver_peer(x: torch.Tensor, targets, dst_weight: float = 1.0,
                        *, accumulate: bool) -> None:
    """K2's peer form: this process's ``(m, L)`` payload ``x`` into the
    landing slots of ``targets``, a
    :class:`~bluefog_tpu_torch.ops.transport.PeerTargets` (see
    :func:`window_deliver_peer_plain` for the function).

    A CUDA tensor launches the kernel on the current stream through the
    table of landing addresses and adds one to
    ``window_deliver_peer.launches``; a table without addresses, or a launch
    error, raises.  A CPU tensor runs the plain version.  Any other device
    raises.  With no delivery or an empty row nothing is launched."""
    CALLS["window_deliver_peer"] += 1
    _check_peer(x, targets)
    if x.device.type == "cpu":
        window_deliver_peer_plain(x, targets, dst_weight,
                                  accumulate=accumulate)
        return
    if x.device.type != "cuda":
        raise ValueError(f"window_deliver_peer runs on cuda or cpu, not "
                         f"{x.device}")
    if not targets.views or x.shape[1] == 0:
        return
    if targets.dsts is None or targets.dsts.device != x.device:
        raise ValueError("window_deliver_peer on the card needs the "
                         "targets' device address table on the same device")
    if not x.is_contiguous():
        raise ValueError("window_deliver_peer needs a contiguous x")
    from bluefog_tpu_torch.ops import _build

    lib = _build.load()
    vec = 16 // x.element_size()
    if not (targets.aligned and x.shape[1] % vec == 0
            and x.data_ptr() % 16 == 0):
        vec = 1
    with torch.cuda.device(x.device):
        err = lib.bf_window_deliver_peer(
            x.data_ptr(), targets.dsts.data_ptr(),
            targets.src_index.data_ptr(), len(targets.views),
            float(dst_weight), x.shape[1], KERNEL_DTYPES[x.dtype], vec,
            1 if accumulate else 0,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_deliver_peer launch failed: cudaError "
                           f"{err}")
    window_deliver_peer.launches += 1


window_deliver_peer.launches = 0


def window_deliver_rows_plain(bufs: torch.Tensor, rows, mask: torch.Tensor,
                              dst_weight: float = 1.0, *,
                              accumulate: bool) -> torch.Tensor:
    """The receiving side of a delivery over gloo: the owned ``(m, K, L)``
    landing buffers ``bufs`` take, in each live slot ``(i, k)`` (``mask[i,
    k] != 0`` and an edge), the arrived row ``rows.views[i][k]`` (a
    :class:`~bluefog_tpu_torch.ops.transport.PeerRows`), with K2's
    rounding.  Returns ``bufs``."""
    m, k, length = bufs.shape
    if len(rows.views) != m or rows.num_slots != k or rows.length != length:
        raise ValueError(f"rows of {len(rows.views)} x {rows.num_slots} x "
                         f"{rows.length} for bufs {tuple(bufs.shape)}")
    w = torch.tensor(float(dst_weight), dtype=_arith(bufs.dtype),
                     device=bufs.device)
    for i, row in enumerate(rows.views):
        for slot, v in enumerate(row):
            if v is not None and int(mask[i, slot]) != 0:
                _land(bufs[i, slot], v, w, accumulate)
    return bufs

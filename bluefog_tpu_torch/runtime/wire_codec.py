"""Host-side wire codecs for the TCP window transport (protocol v2).

The port's copy of ``bluefog_tpu/runtime/wire_codec.py``, byte for byte
in what it puts on the wire: a port peer and a JAX-package peer decode
each other's payloads.  Two lossy codecs plus the identity, negotiated
per connection via the v2 HELLO feature mask and selected per deposit
item by a codec byte:

- ``none``  — dense little-endian array bytes (the window's dtype).
- ``f32``   — values downcast to float32 on the wire, widened back to the
  window dtype on receipt.  Halves the bytes of an f64 window; exact for
  f32 windows.
- ``topk``  — keep the ``ceil(ratio * n)`` largest-|x| coordinates;
  the wire carries ``k | int32 idx[k] | f32 vals[k]``, with :func:`kept`
  matching :func:`bluefog_tpu_torch.ops.compression` top-k arithmetic.
  The receiver reconstructs a dense vector (zeros off-support) and
  applies it through the normal deposit path, so a top-k accumulate
  scatter-adds its kept coordinates.

Lossy codecs change deposited values, so they are opt-in: the
exactly-once / mass-conservation paths (push-sum ``p`` mass) run with
``none``.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "CODEC_NONE", "CODEC_F32", "CODEC_TOPK",
    "CODEC_IDS", "CODEC_NAMES",
    "kept", "encode", "decode", "wire_bytes_bound", "wire_ratio",
]

CODEC_NONE = 0
CODEC_F32 = 1
CODEC_TOPK = 2

CODEC_IDS = {"none": CODEC_NONE, "f32": CODEC_F32, "topk": CODEC_TOPK}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}

_TOPK_HDR = struct.Struct("<q")  # k, then int32 idx[k], then f32 vals[k]


def kept(n: int, ratio: float) -> int:
    """Kept-coordinate count for ``topk``."""
    return max(1, min(n, int(round(ratio * n))))


def encode(arr: np.ndarray, codec: int, *, topk_ratio: float = 0.1,
           ) -> Tuple[List, int]:
    """Encode a contiguous 1-D window payload for the wire.

    Returns ``(views, wire_bytes)`` where ``views`` is a scatter-gather
    list of buffer objects for ``sendmsg`` (never a joined copy) and
    ``wire_bytes`` their total length.  The input is not modified; for
    the lossy codecs the returned views own fresh arrays, so the caller
    may reuse ``arr`` immediately.
    """
    if codec == CODEC_NONE:
        mv = memoryview(np.ascontiguousarray(arr)).cast("B")
        return [mv], len(mv)
    if codec == CODEC_F32:
        mv = memoryview(np.ascontiguousarray(arr, np.float32)).cast("B")
        return [mv], len(mv)
    if codec == CODEC_TOPK:
        flat = np.ascontiguousarray(arr).reshape(-1)
        n = flat.size
        k = kept(n, topk_ratio)
        if k >= n:
            idx = np.arange(n, dtype=np.int32)
        else:
            # argpartition: O(n) selection of the k largest |x|; index
            # order on the wire is unspecified (scatter is order-free)
            idx = np.argpartition(np.abs(flat), n - k)[n - k:]
            idx = idx.astype(np.int32)
        vals = flat[idx].astype(np.float32)
        views = [_TOPK_HDR.pack(int(k)),
                 memoryview(idx).cast("B"), memoryview(vals).cast("B")]
        return views, _TOPK_HDR.size + k * 8
    raise ValueError(f"unknown wire codec id {codec}")


def wire_bytes_bound(n_elems: int, itemsize: int) -> int:
    """Largest wire size any codec may legally claim for a window of
    ``n_elems`` — the server-side allocation guard (a lying length field
    must never make the owner allocate unbounded memory)."""
    return max(n_elems * itemsize,            # dense in the window dtype
               _TOPK_HDR.size + n_elems * 8)  # full-support topk


def decode(codec: int, payload: memoryview, n_elems: int,
           dtype: np.dtype, out: Optional[np.ndarray] = None
           ) -> np.ndarray:
    """Decode a wire payload into a DENSE ``(n_elems,)`` array of the
    window's dtype.  ``out`` (when given, correctly sized) is reused as
    the destination scratch — the server passes a per-connection buffer
    so the hot path allocates nothing.  Raises ``ValueError`` on any
    inconsistent geometry (the caller maps that to a protocol error and
    keeps the stream alive: lengths were known before the payload was
    read, so the framing survives a bad item)."""
    dtype = np.dtype(dtype)
    if out is None or out.size != n_elems or out.dtype != dtype:
        out = np.empty(n_elems, dtype)
    if codec == CODEC_NONE:
        if len(payload) != n_elems * dtype.itemsize:
            raise ValueError("dense payload length mismatch")
        out[:] = np.frombuffer(payload, dtype, count=n_elems)
        return out
    if codec == CODEC_F32:
        if len(payload) != n_elems * 4:
            raise ValueError("f32 payload length mismatch")
        np.copyto(out, np.frombuffer(payload, np.float32, count=n_elems),
                  casting="unsafe")
        return out
    if codec == CODEC_TOPK:
        if len(payload) < _TOPK_HDR.size:
            raise ValueError("topk payload too short")
        (k,) = _TOPK_HDR.unpack_from(payload, 0)
        if k < 0 or k > n_elems or len(payload) != _TOPK_HDR.size + k * 8:
            raise ValueError("topk payload geometry mismatch")
        idx = np.frombuffer(payload, np.int32, count=k,
                            offset=_TOPK_HDR.size)
        vals = np.frombuffer(payload, np.float32, count=k,
                             offset=_TOPK_HDR.size + k * 4)
        if k and (idx.min() < 0 or idx.max() >= n_elems):
            raise ValueError("topk index out of range")
        out[:] = 0
        out[idx] = vals  # duplicate indices are a client bug; last wins
        return out
    raise ValueError(f"unknown wire codec id {codec}")


def wire_ratio(codec: int, n_elems: int, itemsize: int, *,
               topk_ratio: float = 0.1) -> float:
    """wire bytes / dense bytes of one deposit."""
    dense = n_elems * itemsize
    if codec == CODEC_NONE:
        return 1.0
    if codec == CODEC_F32:
        return n_elems * 4 / dense
    if codec == CODEC_TOPK:
        return (_TOPK_HDR.size + kept(n_elems, topk_ratio) * 8) / dense
    raise ValueError(f"unknown wire codec id {codec}")

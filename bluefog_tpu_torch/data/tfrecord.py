"""TFRecord on-disk format: writer, indexed random-access reader, tf.Example
codec, with no TensorFlow dependency.

Counterpart of ``bluefog_tpu/data/tfrecord.py``, with the same functions and
the same bytes on disk:

- **Framing** (:class:`TFRecordWriter`, :func:`read_records`,
  :class:`TFRecordSource`): the standard ``uint64 length | masked crc32c |
  payload | masked crc32c`` record stream.  Checksums and the shard-indexing
  scan run in ``bluefog_tpu_torch/csrc/tfrecord.cc``, which
  :func:`load_native` compiles with the host C++ compiler at first use into
  ``bluefog_tpu_torch/_build/`` and binds with ctypes.  The native library is
  required: a per-byte Python checksum is far too slow for image shards.
- **tf.Example codec** (:func:`encode_example` / :func:`decode_example`): a
  minimal hand-rolled protobuf subset (Example -> Features -> map<string,
  Feature{bytes_list,float_list,int64_list}>), wire-compatible with
  TensorFlow-written files that use those fields.  Decoding walks
  memoryviews of the record, so an image's bytes are copied once.
- **Random access**: :class:`TFRecordSource` indexes every shard once
  (offset/length tables), then serves ``source[idx_array]`` gathers through
  memory-maps: the gatherable-source contract of
  :class:`~bluefog_tpu_torch.data.loader.DistributedLoader`.
"""

from __future__ import annotations

import ctypes
import glob as _glob
import os
import struct
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from bluefog_tpu_torch.utils import hostbuild

__all__ = [
    "crc32c",
    "load_native",
    "native_loaded",
    "TFRecordWriter",
    "read_records",
    "encode_example",
    "decode_example",
    "TFRecordSource",
    "image_classification_decoder",
    "write_image_classification_shards",
]

# ------------------------------------------------------ the native library --

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "tfrecord.cc"
_BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _library_path() -> Path:
    return hostbuild.library_path(_BUILD_DIR, "bf_tfrecord", [_SOURCE],
                                  CXX_FLAGS)


def load_native() -> ctypes.CDLL:
    """The host library of ``csrc/tfrecord.cc``, compiled on first call when
    its hash-named file is missing.  The build goes to a private directory
    and is renamed into place, so concurrent first calls never load a
    half-written file (:mod:`bluefog_tpu_torch.utils.hostbuild`).  Raises
    ``RuntimeError`` without a C++ compiler."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = hostbuild.build_library(_BUILD_DIR, "bf_tfrecord", [_SOURCE],
                                       CXX_FLAGS)
        lib = ctypes.CDLL(str(path))
        lib.bf_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.bf_crc32c.restype = ctypes.c_uint32
        i64p = ctypes.POINTER(ctypes.c_longlong)
        lib.bf_tfrecord_index.argtypes = [ctypes.c_char_p, i64p, i64p,
                                          ctypes.c_longlong, ctypes.c_int,
                                          i64p]
        lib.bf_tfrecord_index.restype = ctypes.c_longlong
        _lib = lib
        return lib


def native_loaded() -> bool:
    """Whether this process has loaded the native library."""
    return _lib is not None


# ---------------------------------------------------------------- crc32c --


def crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli) of ``data``."""
    return int(load_native().bf_crc32c(data if data else None, len(data)))


def _masked(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------- framing --


class TFRecordWriter:
    """Append records to one TFRecord file (context manager)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked(crc32c(header))))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked(crc32c(payload))))

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _index_file(path: str, verify: bool) -> Tuple[np.ndarray, np.ndarray]:
    lib = load_native()
    bad = ctypes.c_longlong(-1)
    n = lib.bf_tfrecord_index(path.encode(), None, None, 0, 0, None)
    if n == -1:
        raise FileNotFoundError(path)
    if n < 0:
        raise ValueError(f"{path}: malformed TFRecord framing")
    offsets = np.zeros(n, np.int64)
    lengths = np.zeros(n, np.int64)
    rc = lib.bf_tfrecord_index(
        path.encode(),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        n, 1 if verify else 0, ctypes.byref(bad))
    if rc == -3:
        raise ValueError(f"{path}: checksum mismatch at record {bad.value}")
    if rc < 0:
        raise ValueError(f"{path}: malformed TFRecord framing")
    return offsets, lengths


def read_records(path: str, *, verify: bool = True) -> Iterable[bytes]:
    """Yield every record payload of one file (sequential read)."""
    offsets, lengths = _index_file(path, verify)
    with open(path, "rb") as f:
        for off, ln in zip(offsets, lengths):
            f.seek(int(off))
            yield f.read(int(ln))


# ----------------------------------------------------- tf.Example codec --
# Minimal protobuf wire subset.  Message graph (field numbers per the public
# tensorflow/core/example/{example,feature}.proto):
#   Example      { Features features = 1; }
#   Features     { map<string, Feature> feature = 1; }
#   Feature      { oneof: BytesList=1 | FloatList=2 | Int64List=3 }
#   BytesList    { repeated bytes value = 1; }
#   FloatList    { repeated float value = 1 [packed]; }
#   Int64List    { repeated int64 value = 1 [packed]; }


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _len_field(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def encode_example(features: Dict[str, object]) -> bytes:
    """Encode a feature dict as a serialized ``tf.Example``.

    Value types: ``bytes``/list of bytes -> bytes_list; float arrays ->
    float_list; int arrays -> int64_list.
    """
    entries = b""
    for key, value in features.items():
        if isinstance(value, bytes):
            value = [value]
        if (isinstance(value, (list, tuple)) and value
                and isinstance(value[0], bytes)):
            flist = _len_field(1, b"".join(_len_field(1, v) for v in value))
        else:
            arr = np.asarray(value)
            if arr.dtype.kind == "f":
                packed = arr.astype("<f4").tobytes()
                flist = _len_field(2, _len_field(1, packed))
            elif arr.dtype.kind in "iub":
                vals = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                                for v in arr.reshape(-1))
                flist = _len_field(3, _len_field(1, vals))
            else:
                raise TypeError(
                    f"feature {key!r}: unsupported dtype {arr.dtype}")
        entry = _len_field(1, key.encode()) + _len_field(2, flist)
        entries += _len_field(1, entry)
    return _len_field(1, entries)


def _parse_fields(buf: memoryview):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        num, wire = tag >> 3, tag & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield num, buf[pos:pos + ln]
            pos += ln
        elif wire == 0:
            val, pos = _read_varint(buf, pos)
            yield num, val
        elif wire == 5:
            yield num, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            yield num, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")


def _decode_feature(feature: memoryview):
    out = None
    for kind, lst in _parse_fields(feature):
        if kind == 1:  # bytes_list
            out = [bytes(v) for n_, v in _parse_fields(lst) if n_ == 1]
        elif kind == 2:  # float_list (packed or repeated fixed32)
            vals = [v for n_, v in _parse_fields(lst) if n_ == 1]
            out = np.frombuffer(b"".join(vals), "<f4")
        elif kind == 3:  # int64_list (packed or repeated varint)
            ints: List[int] = []
            for n_, v in _parse_fields(lst):
                if n_ != 1:
                    continue
                if isinstance(v, int):
                    ints.append(v)
                else:
                    p = 0
                    while p < len(v):
                        val, p = _read_varint(v, p)
                        ints.append(val)
            out = np.asarray(
                [i - (1 << 64) if i >= (1 << 63) else i for i in ints],
                np.int64)
    return out


def decode_example(payload: bytes) -> Dict[str, object]:
    """Parse a serialized ``tf.Example`` into ``{name: np.ndarray |
    [bytes]}``."""
    out: Dict[str, object] = {}
    for num, features_buf in _parse_fields(memoryview(payload)):
        if num != 1:
            continue
        for fnum, entry in _parse_fields(features_buf):
            if fnum != 1:
                continue
            key, feature = None, None
            for enum_, v in _parse_fields(entry):
                if enum_ == 1:
                    key = bytes(v).decode()
                elif enum_ == 2:
                    feature = v
            if key is None or feature is None:
                continue
            value = _decode_feature(feature)
            if value is not None:
                out[key] = value
    return out


# ------------------------------------------------------------- the source --


def image_classification_decoder(example: Dict[str, object]
                                 ) -> Tuple[np.ndarray, np.int32]:
    """Decode ``{image: raw uint8 bytes, shape: int64[3], label: int64}``."""
    shape = tuple(np.asarray(example["shape"], np.int64))
    img = np.frombuffer(example["image"][0], np.uint8).reshape(shape)
    return img, np.int32(np.asarray(example["label"])[0])


class TFRecordSource:
    """Index-gatherable source over TFRecord shards for
    :class:`~bluefog_tpu_torch.data.loader.DistributedLoader`.

    ``pattern`` is a glob (or an explicit list of paths); shards are indexed
    once at construction (the native framing scan), then records are served
    by random access through per-shard memory maps.  ``decode`` maps a
    parsed example dict to a tuple of arrays (default:
    :func:`image_classification_decoder`).
    """

    def __init__(self, pattern, *, decode: Optional[Callable] = None,
                 verify: bool = False):
        paths = (sorted(_glob.glob(pattern)) if isinstance(pattern, str)
                 else list(pattern))
        if not paths:
            raise FileNotFoundError(f"no TFRecord shards match {pattern!r}")
        self.paths = paths
        self.decode = decode or image_classification_decoder
        self._mmaps: List[Optional[np.memmap]] = [None] * len(paths)
        shard_ids, offsets, lengths = [], [], []
        for s, p in enumerate(paths):
            off, ln = _index_file(p, verify)
            shard_ids.append(np.full(len(off), s, np.int32))
            offsets.append(off)
            lengths.append(ln)
        self._shard = np.concatenate(shard_ids)
        self._off = np.concatenate(offsets)
        self._len = np.concatenate(lengths)

    def __len__(self) -> int:
        return len(self._off)

    def _mm(self, s: int) -> np.memmap:
        if self._mmaps[s] is None:
            self._mmaps[s] = np.memmap(self.paths[s], np.uint8, mode="r")
        return self._mmaps[s]

    def record(self, i: int) -> bytes:
        s = int(self._shard[i])
        off, ln = int(self._off[i]), int(self._len[i])
        return bytes(self._mm(s)[off:off + ln])

    def __getitem__(self, idx):
        idx = np.atleast_1d(np.asarray(idx))
        decoded = [self.decode(decode_example(self.record(int(i))))
                   for i in idx.reshape(-1)]
        cols = tuple(np.stack([d[c] for d in decoded])
                     for c in range(len(decoded[0])))
        return cols if len(cols) > 1 else cols[0]


def write_image_classification_shards(
    directory: str,
    images: np.ndarray,
    labels: np.ndarray,
    *,
    shard_size: int = 1024,
    prefix: str = "data",
) -> List[str]:
    """Write ``(N, H, W, C) uint8`` images and int labels as TFRecord shards
    named ``{prefix}-{s:05d}-of-{n:05d}.tfrecord``."""
    images = np.asarray(images)
    labels = np.asarray(labels)
    if images.dtype != np.uint8:
        raise TypeError(f"images must be uint8, got {images.dtype}")
    os.makedirs(directory, exist_ok=True)
    paths = []
    n_shards = (len(images) + shard_size - 1) // shard_size
    for s in range(n_shards):
        path = os.path.join(
            directory, f"{prefix}-{s:05d}-of-{n_shards:05d}.tfrecord")
        with TFRecordWriter(path) as w:
            for i in range(s * shard_size,
                           min((s + 1) * shard_size, len(images))):
                w.write(encode_example({
                    "image": images[i].tobytes(),
                    "shape": np.asarray(images[i].shape, np.int64),
                    "label": np.asarray([labels[i]], np.int64),
                }))
        paths.append(path)
    return paths

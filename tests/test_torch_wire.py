"""The port's wire tables against the JAX package's: ``wire_status``'s
codes, texts and retriable set are the reference's, and ``wire_codec``
gives byte-equal encodings and bit-equal decodings for f32 and top-k at
several ratios and lengths (seeded numpy inputs)."""

import numpy as np
import pytest

from bluefog_tpu.runtime import wire_codec as RC
from bluefog_tpu.runtime import wire_status as RS
from bluefog_tpu_torch.runtime import wire_codec as PC
from bluefog_tpu_torch.runtime import wire_status as PS


def test_status_table_equals_the_reference():
    assert PS.PROTOCOL_VERSION == RS.PROTOCOL_VERSION == 2
    assert PS.STATUS_TEXT == RS.STATUS_TEXT
    assert PS.WIRE_V2_CODES == RS.WIRE_V2_CODES
    assert PS.UNASSIGNED_CODES == RS.UNASSIGNED_CODES
    for name in RS.__all__:
        if name.startswith("ERR_"):
            assert getattr(PS, name) == getattr(RS, name), name
    assert set(PS.__all__) == set(RS.__all__)


@pytest.mark.parametrize("rc", [0, -1, -2, -3, -100, -101, -102, -103,
                                -104, -105, -106, -107, -108, -109, -110,
                                -111, -999])
def test_retriable_and_text_match(rc):
    assert PS.is_retriable(rc) == RS.is_retriable(rc)
    assert PS.err_text(rc) == RS.err_text(rc)


def test_codec_ids_match():
    assert PC.CODEC_IDS == RC.CODEC_IDS
    assert PC.CODEC_NAMES == RC.CODEC_NAMES


def _wire(views):
    return b"".join(bytes(v) for v in views)


@pytest.mark.parametrize("n", [1, 7, 64, 1000, 4099])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_none_and_f32_byte_equal(n, dtype):
    x = np.random.default_rng(n).standard_normal(n).astype(dtype)
    for codec in (PC.CODEC_NONE, PC.CODEC_F32):
        pv, pb = PC.encode(x, codec)
        rv, rb = RC.encode(x, codec)
        assert pb == rb and _wire(pv) == _wire(rv)
        pd = PC.decode(codec, memoryview(_wire(pv)), n, dtype)
        rd = RC.decode(codec, memoryview(_wire(rv)), n, dtype)
        assert pd.tobytes() == rd.tobytes()
    # the f32 round trip is the f32 cast
    f32 = PC.decode(PC.CODEC_F32, memoryview(_wire(PC.encode(
        x, PC.CODEC_F32)[0])), n, dtype)
    np.testing.assert_array_equal(f32, x.astype(np.float32).astype(dtype))


@pytest.mark.parametrize("n", [1, 2, 3, 100, 1023, 8192])
@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.25, 0.5, 1.0])
def test_topk_byte_equal_and_bit_equal(n, ratio):
    x = np.random.default_rng(7 * n).standard_normal(n)
    pv, pb = PC.encode(x, PC.CODEC_TOPK, topk_ratio=ratio)
    rv, rb = RC.encode(x, RC.CODEC_TOPK, topk_ratio=ratio)
    assert pb == rb and _wire(pv) == _wire(rv)
    assert PC.kept(n, ratio) == RC.kept(n, ratio)
    pd = PC.decode(PC.CODEC_TOPK, memoryview(_wire(pv)), n, np.float64)
    rd = RC.decode(RC.CODEC_TOPK, memoryview(_wire(rv)), n, np.float64)
    assert pd.tobytes() == rd.tobytes()
    assert PC.wire_ratio(PC.CODEC_TOPK, n, 8, topk_ratio=ratio) == \
        RC.wire_ratio(RC.CODEC_TOPK, n, 8, topk_ratio=ratio)


def test_kept_matches_the_device_compressor():
    from bluefog_tpu_torch.ops.compression import _kept

    for n in (1, 2, 3, 7, 100, 1023, 65536):
        for r in (0.01, 0.1, 0.25, 0.5, 0.9, 1.0):
            assert PC.kept(n, r) == _kept(n, r) == RC.kept(n, r), (n, r)


@pytest.mark.parametrize("n,itemsize", [(0, 8), (1, 4), (1000, 8),
                                        (1 << 20, 4)])
def test_bounds_and_ratios_match(n, itemsize):
    assert PC.wire_bytes_bound(n, itemsize) == RC.wire_bytes_bound(
        n, itemsize)
    if n:
        for codec in (PC.CODEC_NONE, PC.CODEC_F32):
            assert PC.wire_ratio(codec, n, itemsize) == RC.wire_ratio(
                codec, n, itemsize)


def test_decode_rejects_inconsistent_payloads():
    good = _wire(PC.encode(np.ones(8), PC.CODEC_TOPK, topk_ratio=0.5)[0])
    for codec, payload in ((PC.CODEC_NONE, b"x" * 7),
                           (PC.CODEC_F32, b"x" * 31),
                           (PC.CODEC_TOPK, b"x" * 3),
                           (PC.CODEC_TOPK, good[:-1]),
                           (7, b"")):
        with pytest.raises(ValueError):
            PC.decode(codec, memoryview(payload), 8, np.float64)
        with pytest.raises(ValueError):
            RC.decode(codec, memoryview(payload), 8, np.float64)

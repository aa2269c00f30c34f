"""The port's data pipeline against the JAX package's.

The host side is numpy on both sides and must give the same arrays bit for
bit: ``SyntheticClassificationSource`` items and ``DistributedLoader``
batches for two seeds and two epochs, ``Subset`` and ``ArraySource``
gathers.  The port's device side, on CPU tensors here, carries the same
values.  TFRecords: ``crc32c`` equal on edge lengths, example bytes equal,
and shards written by either side read back equal by the other.  Everything
is exact (no tolerance).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bluefog_tpu.data import loader as jload
from bluefog_tpu.data import tfrecord as jtf
import bluefog_tpu_torch as pbf
from bluefog_tpu_torch.data import loader as pload
from bluefog_tpu_torch.data import tfrecord as ptf

RANKS, BATCH = 4, 3


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_source_items_are_bit_equal(seed):
    kw = dict(shape=(6, 5, 3), num_classes=11, seed=seed, noise=0.25)
    want = jload.SyntheticClassificationSource(40, **kw)
    got = pload.SyntheticClassificationSource(40, **kw)
    assert len(got) == len(want) == 40
    idx = np.array([[0, 39, 5], [17, 5, 2]])
    for a, b in zip(got[idx], want[idx]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "ordered"])
def test_loader_batches_are_bit_equal(seed, shuffle):
    src_kw = dict(shape=(4, 4, 1), num_classes=5, seed=seed)
    n = RANKS * BATCH * 3 + 2  # a remainder to drop
    want_loader = jload.DistributedLoader(
        jload.SyntheticClassificationSource(n, **src_kw), BATCH,
        num_ranks=RANKS, shuffle=shuffle, seed=seed, device_put=False)
    host = pload.DistributedLoader(
        pload.SyntheticClassificationSource(n, **src_kw), BATCH,
        num_ranks=RANKS, shuffle=shuffle, seed=seed, device_put=False)
    pbf.init(size=RANKS, device="cpu")
    dev = pload.DistributedLoader(
        pload.SyntheticClassificationSource(n, **src_kw), BATCH,
        shuffle=shuffle, seed=seed)
    pbf.shutdown()
    assert host.steps_per_epoch == want_loader.steps_per_epoch == 3
    for epoch in (0, 1):
        want = list(want_loader.epoch(epoch))
        got_host = list(host.epoch(epoch))
        got_dev = list(dev.epoch(epoch))
        assert len(want) == len(got_host) == len(got_dev) == 3
        for w, h, d in zip(want, got_host, got_dev):
            for wa, ha, da in zip(w, h, d):
                np.testing.assert_array_equal(ha, wa)
                assert isinstance(da, torch.Tensor)
                np.testing.assert_array_equal(da.numpy(), wa)
    if shuffle:  # a fresh permutation each epoch
        e0, e1 = list(host.epoch(0))[0][1], list(host.epoch(1))[0][1]
        assert not np.array_equal(e0, e1)


def test_array_source_and_subset():
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((20, 2)), rng.integers(0, 3, 20)
    for mod in (jload, pload):
        with pytest.raises(ValueError):
            mod.ArraySource(x, y[:5])
    got = pload.Subset(pload.ArraySource(x, y), 5, 15)
    want = jload.Subset(jload.ArraySource(x, y), 5, 15)
    idx = np.array([0, 9, 3])
    for a, b in zip(got[idx], want[idx]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        got[np.array([10])]
    loader = pload.DistributedLoader(got, 2, num_ranks=2, device_put=False)
    (xb, yb), = list(loader.epoch(0))[:1]
    assert xb.shape == (2, 2, 2) and yb.shape == (2, 2)


def test_loader_needs_a_batch_per_rank_and_the_context():
    with pytest.raises(ValueError, match="one batch per rank"):
        pload.DistributedLoader(pload.ArraySource(np.zeros(5)), 2,
                                num_ranks=4, device_put=False)
    with pytest.raises(RuntimeError, match="init"):
        pload.DistributedLoader(pload.ArraySource(np.zeros(64)), 2)
    pbf.init(size=4, device="cpu")
    try:
        with pytest.raises(ValueError, match="context size"):
            pload.DistributedLoader(pload.ArraySource(np.zeros(64)), 2,
                                    num_ranks=2)
    finally:
        pbf.shutdown()


def test_prefetch_keeps_order_and_reraises():
    assert list(pload.prefetch_to_device(iter(range(10)), 3)) == list(
        range(10))

    def bad():
        yield 1
        raise KeyError("boom")

    it = pload.prefetch_to_device(bad(), 2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)


@pytest.mark.parametrize("length", [0, 1, 7, 8, 4097])
def test_crc32c_matches_reference(length):
    data = np.random.default_rng(length).integers(
        0, 256, length, dtype=np.uint8).tobytes()
    assert ptf.crc32c(data) == jtf.crc32c(data)
    assert ptf.native_loaded()


def test_crc32c_known_value():
    assert ptf.crc32c(b"123456789") == 0xE3069283


def test_example_codec_matches_reference():
    feats = {"image": b"\x00\x01\xff" * 7, "shape": np.array([1, 3, 7]),
             "label": np.array([-5], np.int64),
             "scores": np.array([1.5, -2.25], np.float32),
             "names": [b"a", b"bc"]}
    payload = ptf.encode_example(feats)
    assert payload == jtf.encode_example(feats)
    got, want = ptf.decode_example(payload), jtf.decode_example(payload)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], list):
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 6, 5, 3), dtype=np.uint8),
            rng.integers(0, 10, n))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_shards_read_back_by_the_other_side(writer, tmp_path):
    images, labels = _images(11, 4)
    write = (ptf.write_image_classification_shards if writer == "port"
             else jtf.write_image_classification_shards)
    paths = write(str(tmp_path), images, labels, shard_size=4,
                  prefix="train")
    assert len(paths) == 3
    other = jtf if writer == "port" else ptf
    # the same bytes on disk from either writer
    redo = (jtf if writer == "port" else ptf).write_image_classification_shards(
        str(tmp_path / "again"), images, labels, shard_size=4,
        prefix="train")
    for a, b in zip(paths, redo):
        assert open(a, "rb").read() == open(b, "rb").read()
    for mod in (ptf, other):
        src = mod.TFRecordSource(str(tmp_path / "train-*.tfrecord"),
                                 verify=True)
        assert len(src) == 11
        x, y = src[np.arange(11)]
        np.testing.assert_array_equal(x, images)
        np.testing.assert_array_equal(y, labels.astype(np.int32))
        records = list(mod.read_records(paths[0]))
        assert len(records) == 4
    pbf.init(size=2, device="cpu")
    try:
        x, y = next(iter(pload.DistributedLoader(
            ptf.TFRecordSource(paths), 2, shuffle=False).epoch(0)))
    finally:
        pbf.shutdown()
    assert x.dtype == torch.uint8 and tuple(x.shape) == (2, 2, 6, 5, 3)
    np.testing.assert_array_equal(x[1, 0].numpy(), images[1])


def test_reader_refuses_a_corrupt_shard(tmp_path):
    images, labels = _images(3, 5)
    (path,) = ptf.write_image_classification_shards(str(tmp_path), images,
                                                    labels)
    blob = bytearray(open(path, "rb").read())
    blob[40] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="checksum"):
        ptf.TFRecordSource(path, verify=True)
    open(path, "wb").write(bytes(blob[:-3]))
    with pytest.raises(ValueError, match="malformed"):
        ptf.TFRecordSource(path)


def test_native_library_builds_in_concurrent_processes(tmp_path):
    """Two processes building the host library at once from an empty build
    directory both load a whole library (the build is renamed into place)."""
    code = (
        "import sys, pathlib\n"
        "from bluefog_tpu_torch.data import tfrecord as t\n"
        f"t._BUILD_DIR = pathlib.Path({str(tmp_path)!r})\n"
        "assert t.crc32c(b'123456789') == 0xE3069283\n"
        "print(t._library_path().name)\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    names = {o[0].strip() for o in outs}
    assert len(names) == 1
    assert [p.name for p in tmp_path.iterdir()] == list(names)

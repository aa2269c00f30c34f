"""The port's round-over-round delta codec (``bluefog_tpu_torch/runtime/
delta.py``) against the JAX package's.

1. ``TestDeltaCodec`` of ``tests/test_relay.py`` on the port: dense deltas
   exact, error feedback that resyncs exactly at the anchors, a desync
   refused loudly, a geometry change forcing a full anchor, the config's
   validation.
2. Parity: on the same seeded sequence of rounds the port's
   ``DeltaEncoder`` makes the same frames as the reference's, byte for
   byte (kinds, base rounds, codec ids, wire sizes, payloads, and the
   op-10 leaf entries the servers put on the wire); the port's
   ``DeltaApplier`` reconstructs bit-equal to the reference's, and each
   package's applier reads the other's frames.
"""

import numpy as np
import pytest

from bluefog_tpu.runtime import delta as RD
from bluefog_tpu.runtime import window_server as RW
from bluefog_tpu.runtime import wire_status as RS
from bluefog_tpu_torch.runtime import delta as PD
from bluefog_tpu_torch.runtime import window_server as PW
from bluefog_tpu_torch.runtime import wire_status as PS


def _wire(items):
    """An encoder's items as the applier reads them off the wire."""
    return [(n, d, c, ne, memoryview(b"".join(bytes(v) for v in vs)))
            for (n, d, c, ne, vs, _w) in items]


# ---------------------------------------------------------------------------
# 1. the codec state machines
# ---------------------------------------------------------------------------

class TestDeltaCodec:
    def test_dense_delta_roundtrip_is_exact(self):
        cfg = PD.DeltaConfig(full_every=100, codec="topk",
                             min_delta_elems=10_000)  # every leaf dense
        enc, app = PD.DeltaEncoder(), PD.DeltaApplier("g")
        rng = np.random.default_rng(0)
        x = rng.standard_normal(64)
        kind, _, _ = enc.step(0, [("x", x)], cfg)
        assert kind == 0
        app.anchor(0, {"x": x})
        for rnd in range(1, 6):
            x = x + rng.standard_normal(64)
            kind, base, items = enc.step(rnd, [("x", x)], cfg)
            assert kind == 10 and base == rnd - 1
            leaves = app.apply(rnd, base, _wire(items))
            np.testing.assert_allclose(leaves["x"], x, rtol=0, atol=0)

    def test_error_feedback_resyncs_exactly_at_anchors(self):
        cfg = PD.DeltaConfig(full_every=4, codec="topk", topk_ratio=0.1,
                             min_delta_elems=1)  # lossy for everything
        enc, app = PD.DeltaEncoder(), PD.DeltaApplier("g")
        rng = np.random.default_rng(1)
        x = rng.standard_normal(512)
        errs = {}
        for rnd in range(12):
            kind, base, items = enc.step(rnd, [("x", x)], cfg)
            if kind == 0:
                app.anchor(rnd, {"x": x})
            else:
                app.apply(rnd, base, _wire(items))
            errs[rnd] = float(np.abs(app._recon["x"] - x).max())
            x = x + 0.01 * rng.standard_normal(512)
        # anchors (pushes 0, 4, 8) are bit-exact; deltas bounded-lossy
        assert errs[0] == 0.0 and errs[4] == 0.0 and errs[8] == 0.0
        assert 0 < max(errs.values()) < 0.2
        assert enc.full_frames == 3 and enc.delta_frames == 9

    def test_desync_refused_loudly(self):
        cfg = PD.DeltaConfig(full_every=100, min_delta_elems=10_000)
        enc, app = PD.DeltaEncoder(), PD.DeltaApplier("g")
        x = np.ones(8)
        enc.step(0, [("x", x)], cfg)
        app.anchor(0, {"x": x})
        _, base, items = enc.step(1, [("x", x * 2)], cfg)
        app.apply(1, base, _wire(items))
        # replaying the same delta against the moved cursor: refused
        with pytest.raises(PD.DeltaDesync) as ei:
            app.apply(1, base, _wire(items))
        assert ei.value.status == PS.ERR_DELTA_BASE == RS.ERR_DELTA_BASE
        assert PS.is_retriable(ei.value.status)
        assert str(ei.value) == str(RD.DeltaDesync("g", base, 1))

    def test_geometry_change_forces_full_anchor(self):
        cfg = PD.DeltaConfig(full_every=100, min_delta_elems=10_000)
        enc = PD.DeltaEncoder()
        assert enc.step(0, [("x", np.ones(8))], cfg)[0] == 0
        assert enc.step(1, [("x", np.ones(8))], cfg)[0] == 10
        # a new leaf set cannot diff against the old base: a full frame
        assert enc.step(2, [("x", np.ones(8)),
                            ("y", np.ones(4))], cfg)[0] == 0
        # nor can a reshaped leaf
        assert enc.step(3, [("x", np.ones(16)),
                            ("y", np.ones(4))], cfg)[0] == 0

    @pytest.mark.parametrize("kw,match", [
        (dict(full_every=0), "full_every"), (dict(codec="zstd"), "codec"),
        (dict(topk_ratio=0.0), "topk_ratio"),
        (dict(min_delta_elems=-1), "min_delta_elems")])
    def test_config_validation(self, kw, match):
        with pytest.raises(ValueError, match=match):
            PD.DeltaConfig(**kw)
        with pytest.raises(ValueError, match=match):
            RD.DeltaConfig(**kw)

    def test_defaults_are_the_reference_defaults(self):
        assert PD.DeltaConfig() == PD.DeltaConfig(
            **vars(RD.DeltaConfig()))


# ---------------------------------------------------------------------------
# 2. byte parity with the JAX package
# ---------------------------------------------------------------------------

CONFIGS = {
    "topk": dict(full_every=4, codec="topk", topk_ratio=0.05,
                 min_delta_elems=64),
    "topk_all_lossy": dict(full_every=5, codec="topk", topk_ratio=0.1,
                           min_delta_elems=1),
    "f32": dict(full_every=3, codec="f32", min_delta_elems=16),
    "none": dict(full_every=8, codec="none", min_delta_elems=0),
    "dense": dict(full_every=100, codec="topk", min_delta_elems=1 << 20),
    "deltas_off": dict(full_every=1),
}


def _sequence(seed, rounds=14, dim=1500):
    """Seeded dsgd-shaped snapshots: a drifting f64 ``x``, a scalar mass
    ``p``, the ``round`` stamp, and an f32 leaf."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(dim)
    w = rng.standard_normal(300).astype(np.float32)
    out = []
    for rnd in range(rounds):
        x = x + 0.01 * rng.standard_normal(dim)
        w = (w + 0.02 * rng.standard_normal(300)).astype(np.float32)
        out.append((rnd, [("p", np.array([1.0 + 0.1 * rnd])), ("w", w.copy()),
                          ("round", np.array([float(rnd)])), ("x", x.copy())]))
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_encoder_frames_are_byte_equal_to_the_reference(cfg_name, seed):
    pc, rc = PD.DeltaConfig(**CONFIGS[cfg_name]), RD.DeltaConfig(
        **CONFIGS[cfg_name])
    pe, re_ = PD.DeltaEncoder(), RD.DeltaEncoder()
    kinds = []
    for rnd, leaves in _sequence(seed):
        pk, pb, pitems = pe.step(rnd, leaves, pc)
        rk, rb, ritems = re_.step(rnd, leaves, rc)
        assert (pk, pb) == (rk, rb), rnd
        kinds.append(pk)
        if pk == 0:
            assert pitems is None and ritems is None
            # a full frame's leaf entries, as both servers frame them
            assert (b"".join(bytes(v) for v in PW._leaf_views(leaves))
                    == b"".join(bytes(v) for v in RW._leaf_views(leaves)))
            continue
        assert len(pitems) == len(ritems)
        for (pn, pd_, pcod, pne, pvs, pw), (rn, rd, rcod, rne, rvs, rw) in \
                zip(pitems, ritems):
            assert (pn, pd_, pcod, pne, pw) == (rn, rd, rcod, rne, rw)
            assert (b"".join(bytes(v) for v in pvs)
                    == b"".join(bytes(v) for v in rvs))
        assert (b"".join(bytes(v) for v in PW._delta_leaf_views(pitems))
                == b"".join(bytes(v) for v in RW._delta_leaf_views(ritems)))
    for attr in ("full_frames", "delta_frames", "wire_bytes", "dense_bytes"):
        assert getattr(pe, attr) == getattr(re_, attr), attr
    if cfg_name == "deltas_off":
        assert set(kinds) == {0}
    else:
        assert 10 in kinds and 0 in kinds


@pytest.mark.parametrize("cfg_name", ["topk", "topk_all_lossy", "f32", "none"])
def test_applier_reconstructions_are_bit_equal_across_packages(cfg_name):
    """One frame stream (the port's encoder) applied by the port's and the
    reference's appliers; the reference encoder's stream applied by the
    port's.  Every reconstruction is bit-equal to the others."""
    pc = PD.DeltaConfig(**CONFIGS[cfg_name])
    rc = RD.DeltaConfig(**CONFIGS[cfg_name])
    pe, re_ = PD.DeltaEncoder(), RD.DeltaEncoder()
    pa, ra, pa2 = PD.DeltaApplier("g"), RD.DeltaApplier("g"), \
        PD.DeltaApplier("g")
    deltas = 0
    for rnd, leaves in _sequence(7):
        pk, pb, pitems = pe.step(rnd, leaves, pc)
        rk, rb, ritems = re_.step(rnd, leaves, rc)
        if pk == 0:
            for a in (pa, ra, pa2):
                a.anchor(rnd, dict(leaves))
            continue
        deltas += 1
        got_p = pa.apply(rnd, pb, _wire(pitems))
        got_r = ra.apply(rnd, pb, _wire(pitems))
        got_x = pa2.apply(rnd, rb, _wire(ritems))
        assert sorted(got_p) == sorted(got_r) == sorted(got_x)
        for n in got_p:
            assert got_p[n].dtype == got_r[n].dtype
            assert got_p[n].tobytes() == got_r[n].tobytes() \
                == got_x[n].tobytes(), (rnd, n)
        if pc.min_delta_elems > 1:
            # the exactness floor: the stamp and the mass ride dense
            assert float(got_p["round"][0]) == rnd
            assert got_p["p"][0] == 1.0 + 0.1 * rnd
    assert deltas > 0


def test_desync_status_and_text_match_the_reference():
    for pkg in (PD, RD):
        app = pkg.DeltaApplier("grp")
        with pytest.raises(pkg.DeltaDesync) as ei:
            app.apply(3, 2, [])
        assert ei.value.status == -109
        assert (ei.value.group, ei.value.base_round, ei.value.cursor) == (
            "grp", 2, -1)
    assert str(PD.DeltaDesync("g", 4, 5)) == str(RD.DeltaDesync("g", 4, 5))


def test_wire_structs_of_the_read_path_are_the_reference_formats():
    for st in ("_SNAP_REQ", "_LEAF_NAME", "_SNAP_CNT", "_SNAP_LEAF",
               "_SUB_REQ", "_PUSH", "_DELTA_HDR", "_DELTA_LEAF"):
        assert getattr(PW, st).format == getattr(RW, st).format, st
    for c in ("_OP_SNAPSHOT", "_OP_SUBSCRIBE", "_OP_DELTA",
              "_SUB_KEEPALIVE_S", "_MAX_SNAP_LEAVES", "_MAX_LEAF_NAME",
              "_MAX_LEAF_BYTES"):
        assert getattr(PW, c) == getattr(RW, c), c


@pytest.mark.parametrize("ratio", [0.05, 0.5, 1.0])
def test_topk_state_is_bit_equal_with_signed_zeros_and_ties(ratio):
    """The port's top-k path against the reference's on data full of +0.0,
    -0.0 and ties: the frames, the sender's base and
    residual, and the receiver's reconstruction agree bit for bit every
    round (including the sign of every zero)."""
    cfg = dict(full_every=6, codec="topk", topk_ratio=ratio,
               min_delta_elems=1)
    pe, re_ = PD.DeltaEncoder(), RD.DeltaEncoder()
    pa, ra = PD.DeltaApplier("z"), RD.DeltaApplier("z")
    rng = np.random.default_rng(17)
    n = 400
    for rnd in range(14):
        x = rng.choice([0.0, -0.0, 1.0, -1.0, 0.5], size=n)
        x[rng.random(n) < 0.3] = -0.0
        leaves = [("x", x)]
        pk, pb, pitems = pe.step(rnd, leaves, PD.DeltaConfig(**cfg))
        rk, rb, ritems = re_.step(rnd, leaves, RD.DeltaConfig(**cfg))
        assert (pk, pb) == (rk, rb)
        if pk == 0:
            pa.anchor(rnd, {"x": x})
            ra.anchor(rnd, {"x": x})
        else:
            assert b"".join(bytes(v) for v in pitems[0][4]) == \
                b"".join(bytes(v) for v in ritems[0][4])
            got = pa.apply(rnd, pb, _wire(pitems))
            want = ra.apply(rnd, rb, _wire(ritems))
            assert got["x"].tobytes() == want["x"].tobytes(), rnd
        assert pe._base["x"].tobytes() == re_._base["x"].tobytes(), rnd
        if "x" in re_._resid:
            assert pe._resid["x"].tobytes() == re_._resid["x"].tobytes()


def test_applier_duplicate_indices_match_the_reference_decode():
    """A top-k payload that repeats an index (a misbehaving sender): the
    port's apply keeps the reference decode's last-one-wins."""
    import struct

    idx = np.array([3, 1, 3, 0], np.int32)
    vals = np.array([1.5, -2.0, 4.0, -0.0], np.float32)
    payload = memoryview(struct.pack("<q", 4) + idx.tobytes()
                         + vals.tobytes())
    base = np.array([-0.0, 2.0, 0.0, 1.0, -0.0, 5.0])
    outs = []
    for pkg in (PD, RD):
        app = pkg.DeltaApplier("d")
        app.anchor(0, {"x": base})
        outs.append(app.apply(1, 0, [("x", np.float64, 2, 6, payload)])["x"])
    assert outs[0].tobytes() == outs[1].tobytes()

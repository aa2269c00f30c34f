"""Round-over-round DELTA encoding for the subscription push channel.

Counterpart of ``bluefog_tpu/runtime/delta.py``: the same state machines
and the same bytes on the wire, so a port sender and a JAX-package
receiver (or the other way round) reconstruct the same model.

A model that moves a little every round is re-shipped whole every round,
to every subscriber, at every tier of a relay tree.  Wire op 10
(``DELTA``, :mod:`bluefog_tpu_torch.runtime.window_server`) ships the
round-over-round difference instead, compressed with the
:mod:`~bluefog_tpu_torch.runtime.wire_codec` codecs (``topk``/``f32``),
with an **error-feedback residual held sender-side** so the compression
error of one push is folded into the next (the CHOCO discipline, applied
to the read path).

The consistency contract:

- **The sender tracks the receiver.**  :class:`DeltaEncoder` keeps the
  exact reconstruction the receiver holds (``base``) plus the residual;
  a delta frame is always relative to the round the receiver last
  consumed (its cursor), even across skip-to-latest gaps: TCP is
  in-order, so the sender knows the receiver's state until the
  connection dies.
- **Full frames are the resync anchor.**  Every
  ``DeltaConfig.full_every``-th push is a full snapshot (exact, residual
  cleared), and so is the first push of every connection: a reconnect
  always resyncs on a full frame because the fresh sender has no base.
  A torn delta never advances the receiver's cursor, so after resume
  the round is re-promised and lands via the anchor.
- **Round stamps stay exact.**  Leaves smaller than ``min_delta_elems``
  (the ``round`` stamp, push-sum ``p`` mass) ride the delta frame dense
  (codec ``none`` over the diff, bit-exact); only bulk leaves pay the
  lossy codec, and those resync exactly at every anchor.
- **Desync is loud.**  :class:`DeltaApplier` refuses a delta whose base
  round is not its cursor (:class:`DeltaDesync`, wire status ``-109``):
  the receiver drops the connection and the resumed stream resyncs with
  a full frame, instead of compounding a wrong reconstruction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.runtime import wire_codec, wire_status

__all__ = ["DeltaConfig", "DeltaEncoder", "DeltaApplier", "DeltaDesync"]


@dataclasses.dataclass(frozen=True)
class DeltaConfig:
    """Knobs of one push channel's delta cadence.

    ``full_every <= 1`` disables deltas (every push is a full frame); the
    tree control plane (:mod:`bluefog_tpu_torch.control.tree`) actuates
    this field at round boundaries.  ``min_delta_elems`` is the exactness
    floor: leaves below it diff densely (bit-exact), so round stamps and
    scalar mass leaves never pay a lossy codec."""

    full_every: int = 8
    codec: str = "topk"
    topk_ratio: float = 0.05
    min_delta_elems: int = 1024

    def __post_init__(self):
        if self.full_every < 1:
            raise ValueError("full_every must be >= 1 (1 = deltas off)")
        if self.codec not in wire_codec.CODEC_IDS:
            raise ValueError(f"unknown delta codec {self.codec!r}; want "
                             f"one of {sorted(wire_codec.CODEC_IDS)}")
        if not (0.0 < self.topk_ratio <= 1.0):
            raise ValueError("topk_ratio must be in (0, 1]")
        if self.min_delta_elems < 0:
            raise ValueError("min_delta_elems must be >= 0")


class DeltaDesync(RuntimeError):
    """A delta frame's base round does not match the receiver's
    reconstruction cursor (wire status ``-109``): the receiver must drop
    the connection and resubscribe; the resumed stream resyncs with a
    full-frame anchor.  Retriable by construction."""

    status = wire_status.ERR_DELTA_BASE

    def __init__(self, group: str, base_round: int, cursor: int):
        super().__init__(
            f"delta desync for group {group!r}: frame base round "
            f"{base_round} != reconstruction cursor {cursor} ({self.status}: "
            + wire_status.err_text(self.status) + ")")
        self.group = group
        self.base_round = base_round
        self.cursor = cursor


#: one encoded delta leaf: (name, dtype, codec_id, n_elems, payload views
#: for sendmsg, wire_bytes)
DeltaItem = Tuple[str, np.dtype, int, int, List, int]


class DeltaEncoder:
    """Per-subscription sender state: the receiver's reconstruction twin
    (``base``), the error-feedback residual, and the anchor counter.  One
    encoder per push sender, living exactly as long as the connection (a
    fresh connection gets a fresh encoder, which is what forces the
    full-frame resync after every cursor gap)."""

    def __init__(self):
        self._base: Dict[str, np.ndarray] = {}
        self._resid: Dict[str, np.ndarray] = {}
        self._base_round = -1
        self._pushes = 0
        self.full_frames = 0
        self.delta_frames = 0
        self.wire_bytes = 0
        self.dense_bytes = 0

    def _geometry_matches(self, leaves: Sequence[Tuple[str, np.ndarray]]
                          ) -> bool:
        if {n for n, _ in leaves} != set(self._base):
            return False
        for name, arr in leaves:
            b = self._base[name]
            if b.shape != arr.reshape(-1).shape or b.dtype != arr.dtype:
                return False
        return True

    def _anchor(self, round_: int,
                leaves: Sequence[Tuple[str, np.ndarray]]) -> None:
        self._base = {n: np.ascontiguousarray(a).reshape(-1).copy()
                      for n, a in leaves}
        self._resid = {}
        self._base_round = int(round_)
        self.full_frames += 1

    def step(self, round_: int, leaves: Sequence[Tuple[str, np.ndarray]],
             cfg: DeltaConfig
             ) -> Tuple[int, int, Optional[List[DeltaItem]]]:
        """Encode one due push.  Returns ``(kind, base_round, items)``:
        ``kind`` 0 = full frame (send the leaves dense, ``items`` is None)
        or 10 = delta frame relative to ``base_round``.  The anchor
        cadence and codec come from ``cfg``, read fresh per push, so a
        TreePlan actuation changes cadence without touching the sender."""
        self._pushes += 1
        dense = sum(a.size * a.dtype.itemsize for _, a in leaves)
        self.dense_bytes += dense
        full_due = (cfg.full_every <= 1
                    or (self._pushes - 1) % cfg.full_every == 0)
        if (full_due or self._base_round < 0
                or not self._geometry_matches(leaves)):
            # the resync anchor: exact, residual cleared, and the only
            # frame kind a fresh sender can open with (it has no base)
            self._anchor(round_, leaves)
            self.wire_bytes += dense
            return 0, -1, None
        base_round = self._base_round
        items: List[DeltaItem] = []
        for name, arr in leaves:
            flat = np.ascontiguousarray(arr).reshape(-1)
            base = self._base[name]
            diff = flat - base
            resid = self._resid.get(name)
            if resid is not None:
                diff = diff + resid
            if flat.size < cfg.min_delta_elems:
                codec = wire_codec.CODEC_NONE
            else:
                codec = wire_codec.CODEC_IDS[cfg.codec]
            views, wire_b = wire_codec.encode(
                diff, codec, topk_ratio=cfg.topk_ratio)
            if codec == wire_codec.CODEC_NONE:
                dec = diff  # a dense diff is bit-exact
            else:
                payload = b"".join(bytes(v) for v in views)
                dec = wire_codec.decode(codec, memoryview(payload),
                                        flat.size, flat.dtype)
            self._resid[name] = diff - dec
            base += dec.astype(base.dtype, copy=False)
            items.append((name, flat.dtype, codec, flat.size, views,
                          wire_b))
            self.wire_bytes += wire_b
        self._base_round = int(round_)
        self.delta_frames += 1
        return 10, base_round, items


class DeltaApplier:
    """Receiver-side reconstruction: the exact mirror of the encoder's
    ``base``.  ``anchor`` installs a full frame; ``apply`` folds a delta
    in, refusing (:class:`DeltaDesync`) any frame whose base round is not
    the cursor."""

    def __init__(self, group: str = ""):
        self.group = group
        self._recon: Dict[str, np.ndarray] = {}
        self.base_round = -1
        self.deltas_applied = 0

    def anchor(self, round_: int, leaves: Dict[str, np.ndarray]) -> None:
        self._recon = {n: np.ascontiguousarray(a).reshape(-1).copy()
                       for n, a in leaves.items()}
        self.base_round = int(round_)

    def apply(self, round_: int, base_round: int,
              items: Sequence[Tuple[str, np.dtype, int, int, memoryview]]
              ) -> Dict[str, np.ndarray]:
        """Fold one delta frame (``(name, dtype, codec, n_elems,
        payload)`` per leaf) into the reconstruction; returns copies of
        the reconstructed leaves (the delivered snapshot: the caller may
        hold them while later deltas land)."""
        if base_round != self.base_round or not self._recon:
            raise DeltaDesync(self.group, base_round, self.base_round)
        names = {name for name, *_ in items}
        if names != set(self._recon):
            raise DeltaDesync(self.group, base_round, self.base_round)
        for name, dtype, codec, n_elems, payload in items:
            recon = self._recon[name]
            if recon.size != n_elems or recon.dtype != np.dtype(dtype):
                raise DeltaDesync(self.group, base_round, self.base_round)
            recon += wire_codec.decode(codec, payload, n_elems,
                                       recon.dtype)
        self.base_round = int(round_)
        self.deltas_applied += 1
        return {n: a.copy() for n, a in self._recon.items()}


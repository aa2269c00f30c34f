"""Transport autotune: the stripe-count / coalescing-cap plan family.

Counterpart of ``bluefog_tpu/control/transport.py``.  The striped TCP path
(:class:`bluefog_tpu_torch.runtime.window_server.StripedDepositStream`)
has two raw-speed knobs: the number of stripes (parallel per-peer TCP
streams; more buy line rate when the wire is the bottleneck) and each
stripe's coalescing cap (smaller frames deepen the pipeline, larger ones
amortize acks).  :func:`decide_transport_plan` is a pure, deterministic
function of the evidence the deposit streams collect (the ack-latency
EWMA, and the {net, queue, apply} phase EWMA once tracing grants it),
with enter/exit hysteresis and a cooldown, emitting a round-stamped
:class:`TransportPlan` with canonical bytes.  It is actuated only through
``StripedDepositStream.apply_plan`` at a round boundary.

The decision table:

- **widen** (stripes x2, coalesce /2) when the ack EWMA is above
  ``widen_enter_s`` and the phase split says the wire is the problem (net
  fraction >= ``net_frac_enter``, or no phase evidence at all: an
  untraced connection's slow acks are still slow);
- **narrow** (stripes /2, coalesce x2) when the ack EWMA is below
  ``widen_exit_s`` and more than the minimum stripes are open;
- anything between the bands, inside the cooldown or at the caps:
  ``prev`` unchanged (the same object, the same version).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

__all__ = ["TransportPlan", "TransportConfig", "decide_transport_plan"]


@dataclasses.dataclass(frozen=True)
class TransportPlan:
    """One round-stamped transport plan.

    Attributes:
      version: monotone plan number; 0 is the static launch config.
      round: the decision round — actuation at the first round boundary
        at or after it, never mid-round.
      stripes: parallel per-peer deposit streams to hold open.
      coalesce_bytes: per-stripe frame coalescing cap (bytes).
    """

    version: int = 0
    round: int = 0
    stripes: int = 1
    coalesce_bytes: int = 16 << 20

    def __post_init__(self):
        object.__setattr__(self, "stripes", max(1, int(self.stripes)))
        object.__setattr__(self, "coalesce_bytes",
                           max(1 << 16, int(self.coalesce_bytes)))

    def to_bytes(self) -> bytes:
        """Canonical encoding (sorted keys, normalized ints): two ranks
        that derived the same plan produce IDENTICAL bytes."""
        return json.dumps(
            {"version": int(self.version), "round": int(self.round),
             "stripes": int(self.stripes),
             "coalesce_bytes": int(self.coalesce_bytes)},
            sort_keys=True, separators=(",", ":")).encode()

    @staticmethod
    def from_bytes(blob: bytes) -> "TransportPlan":
        d = json.loads(blob.decode())
        return TransportPlan(version=int(d["version"]),
                             round=int(d["round"]),
                             stripes=int(d["stripes"]),
                             coalesce_bytes=int(d["coalesce_bytes"]))


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Hysteresis bands + caps for :func:`decide_transport_plan`.

    Every threshold is an enter/exit PAIR with enter strictly stronger
    than exit (validated here), so evidence oscillating around one
    threshold cannot flap the plan; ``cooldown_rounds`` additionally
    freezes a changed plan until the turbulence the change itself
    causes has settled.
    """

    stripes_min: int = 1
    stripes_max: int = 8
    coalesce_min_bytes: int = 1 << 18
    coalesce_max_bytes: int = 16 << 20
    #: widen when the peer's ack EWMA exceeds this ...
    widen_enter_s: float = 0.050
    #: ... narrow only once it is back below this (enter > exit)
    widen_exit_s: float = 0.020
    #: widen only when net's share of the ack latency is at least this
    net_frac_enter: float = 0.5
    #: a net share at or below this blocks widening outright even above
    #: widen_enter_s (the slow-HOST case; enter > exit keeps the gap)
    net_frac_exit: float = 0.3
    cooldown_rounds: int = 16

    def __post_init__(self):
        if not (1 <= self.stripes_min <= self.stripes_max):
            raise ValueError(
                f"need 1 <= stripes_min <= stripes_max, got "
                f"{self.stripes_min}/{self.stripes_max}")
        if not (0 < self.coalesce_min_bytes <= self.coalesce_max_bytes):
            raise ValueError(
                f"need 0 < coalesce_min <= coalesce_max, got "
                f"{self.coalesce_min_bytes}/{self.coalesce_max_bytes}")
        if not (self.widen_enter_s > self.widen_exit_s > 0):
            raise ValueError(
                f"hysteresis: need widen_enter_s > widen_exit_s > 0, "
                f"got {self.widen_enter_s}/{self.widen_exit_s}")
        if not (1 >= self.net_frac_enter > self.net_frac_exit >= 0):
            raise ValueError(
                f"hysteresis: need 1 >= net_frac_enter > net_frac_exit "
                f">= 0, got {self.net_frac_enter}/{self.net_frac_exit}")
        if self.cooldown_rounds < 0:
            raise ValueError("cooldown_rounds must be >= 0")


def _net_frac(phase_s: Optional[Dict[str, float]]) -> Optional[float]:
    if phase_s is None:
        return None
    total = (phase_s.get("net", 0.0) + phase_s.get("queue", 0.0)
             + phase_s.get("apply", 0.0))
    if total <= 0:
        return None
    return phase_s.get("net", 0.0) / total


def decide_transport_plan(prev: TransportPlan, round_: int, *,
                          ack_ewma_s: Optional[float],
                          phase_s: Optional[Dict[str, float]] = None,
                          cfg: TransportConfig = TransportConfig(),
                          ) -> TransportPlan:
    """PURE decision step: previous plan + this round's wire evidence ->
    the plan in effect from the next round boundary.  Returns ``prev``
    ITSELF (no version bump) whenever nothing crosses a band, the
    cooldown is running, or the knobs are already at their caps —
    byte-stability of the no-change case is part of the contract."""
    if ack_ewma_s is None:
        return prev  # no wire evidence yet: never tune blind
    if (prev.version > 0
            and round_ - prev.round < cfg.cooldown_rounds):
        return prev
    frac = _net_frac(phase_s)
    if ack_ewma_s > cfg.widen_enter_s and (frac is None
                                           or frac >= cfg.net_frac_enter):
        stripes = min(cfg.stripes_max, max(cfg.stripes_min,
                                           prev.stripes * 2))
        coalesce = max(cfg.coalesce_min_bytes, prev.coalesce_bytes // 2)
        if (stripes, coalesce) == (prev.stripes, prev.coalesce_bytes):
            return prev  # already at the caps: saturated, not flapping
        return TransportPlan(version=prev.version + 1, round=round_,
                             stripes=stripes, coalesce_bytes=coalesce)
    if ack_ewma_s < cfg.widen_exit_s:
        stripes = max(cfg.stripes_min, prev.stripes // 2)
        coalesce = min(cfg.coalesce_max_bytes, prev.coalesce_bytes * 2)
        if (stripes, coalesce) == (prev.stripes, prev.coalesce_bytes):
            return prev
        return TransportPlan(version=prev.version + 1, round=round_,
                             stripes=stripes, coalesce_bytes=coalesce)
    return prev

"""The communication plan: the controller's round-stamped output.

Counterpart of ``bluefog_tpu/control/plan.py``.  A :class:`CommPlan` is
everything the gossip loop actuates at a round boundary (the per-peer
degree penalties, the densify level, the local-SGD gossip cadence and the
wire-codec aggressiveness) plus the ``round`` stamp that says when it
takes effect and a monotone ``version``.  A plan is a pure function of the
disseminated evidence (:func:`bluefog_tpu_torch.control.controller.
decide_plan`), and :meth:`CommPlan.to_bytes` is a canonical encoding
(sorted keys, normalized fields), the JAX package's byte for byte, so
"every rank converges on the same plan" is checkable as byte equality.

:class:`ControlConfig` is the knob bag: every threshold is an enter/exit
pair (hysteresis), and plan changes are rate-limited by
``cooldown_rounds``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

from bluefog_tpu_torch.topology.graphs import MAX_DENSIFY

__all__ = ["CommPlan", "ControlConfig", "CODEC_LADDER"]

# wire-codec aggressiveness ladder: index 0 = uncompressed, rising =
# more aggressive (lossier).  The controller BACKS OFF (index down) when
# consensus distance grows — compression error is the first suspect —
# and steps back up only when consensus is contracting again.
CODEC_LADDER: Tuple[Optional[str], ...] = (None, "f32", "topk")


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """One round-stamped communication plan.

    Attributes:
      version: monotone plan number; 0 is the static launch config.
        Loops compare versions to detect "a new plan arrived".
      round: the decision round — actuation happens at the first round
        boundary at or after it (never mid-round).
      slow: sorted ranks whose edges the penalized rebuild reduces to
        the ring spine (see :func:`bluefog_tpu_torch.topology.graphs.
        replan_penalized`).
      densify: extra-edge level 0..MAX_DENSIFY when measured mixing
        lags the spectral-gap prediction.
      gossip_every: deposit/gossip every g-th step (the local-SGD
        cadence; 1 = every step).
      codec_level: index into :data:`CODEC_LADDER` (bounded by the
        caller's configured ceiling).
    """

    version: int = 0
    round: int = 0
    slow: Tuple[int, ...] = ()
    densify: int = 0
    gossip_every: int = 1
    codec_level: int = 0

    def __post_init__(self):
        object.__setattr__(self, "slow",
                           tuple(sorted(int(r) for r in self.slow)))
        object.__setattr__(self, "densify",
                           max(0, min(int(self.densify), MAX_DENSIFY)))
        object.__setattr__(self, "gossip_every",
                           max(1, int(self.gossip_every)))
        object.__setattr__(self, "codec_level",
                           max(0, min(int(self.codec_level),
                                      len(CODEC_LADDER) - 1)))

    @property
    def codec(self) -> Optional[str]:
        """The wire-codec name this plan selects (None = uncompressed)."""
        return CODEC_LADDER[self.codec_level]

    def to_bytes(self) -> bytes:
        """Canonical byte encoding: sorted keys, normalized field types.
        Two ranks that derived the same plan produce IDENTICAL bytes —
        the convergence property the tests assert literally."""
        return json.dumps(
            {"version": int(self.version), "round": int(self.round),
             "slow": list(self.slow), "densify": int(self.densify),
             "gossip_every": int(self.gossip_every),
             "codec_level": int(self.codec_level)},
            sort_keys=True, separators=(",", ":")).encode()

    @staticmethod
    def from_bytes(blob: bytes) -> "CommPlan":
        d = json.loads(blob.decode())
        return CommPlan(version=int(d["version"]), round=int(d["round"]),
                        slow=tuple(d["slow"]), densify=int(d["densify"]),
                        gossip_every=int(d["gossip_every"]),
                        codec_level=int(d["codec_level"]))


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Knobs for the self-tuning communication controller.

    Every decision threshold is an enter/exit pair with the enter side
    strictly stronger — hysteresis, so telemetry oscillating around one
    value cannot flap the plan — and ``cooldown_rounds`` rate-limits
    changes so one actuation's own turbulence cannot trigger the next.
    """

    # evidence cadence: publish local evidence + re-decide every K
    # gossip rounds (a multiple keeps the barrier-dir scan off the hot
    # path, same posture as the tombstone poll)
    evidence_every: int = 8
    # EWMA smoothing for the thread-mode staleness/lag signal
    ewma_alpha: float = 0.25
    # slow-peer detection: a peer enters the slow set when its observed
    # lag (wire: ack EWMA; thread: seconds since its last fresh deposit)
    # exceeds slow_enter x the fleet median, and leaves only below
    # slow_exit x the median — the hysteresis band.  min_lag_s is an
    # absolute floor: nobody is "slow" below it no matter the ratio
    # (sub-millisecond medians make ratios meaningless noise).
    slow_enter: float = 4.0
    slow_exit: float = 2.0
    min_lag_s: float = 0.01
    # a peer also enters the slow set on lossy-link evidence: at least
    # this many reconnect cycles observed against it across reporters
    # within one evidence window
    reconnects_enter: int = 2
    # densify ladder on mixing excess (measured minus predicted
    # contraction; persistently positive = gossip under-delivering)
    densify_enter: float = 0.15
    densify_exit: float = 0.02
    # size-aware ladder cap (the JAX package's fleet simulator found the
    # ladder blind to scale): the ladder's top rung is the one-step exact
    # averager — a million-edge plan at 1024 ranks.  Fully-connected
    # stays reachable only for fleets at or below this many live
    # reporters; larger fleets top out at the symmetric-exponential
    # rung (level 1, out-degree ~2·log2 m), so the ladder can stay
    # ENABLED at fleet scale instead of being configured off
    densify_full_max: int = 64
    # gossip-cadence band on the local consensus-growth ratio
    # (disagreement now / disagreement one evidence window ago):
    # > grow_hi -> gossip MORE (halve gossip_every) and back the codec
    # off one rung; < grow_lo with slow links present -> gossip LESS
    # (double gossip_every up to cadence_max) to take pressure off the
    # slow wire
    grow_hi: float = 1.05
    grow_lo: float = 0.7
    cadence_max: int = 4
    # codec ceiling: highest CODEC_LADDER index the controller may use
    # (0 keeps compression off — the right ceiling whenever the exact
    # mass audit matters)
    max_codec_level: int = 0
    # link-vs-host split on traced phase evidence: a peer ENTERING the
    # slow set on lag whose (net, queue, apply) decomposition is
    # net-dominated (net fraction >= this) is a slow LINK — when the
    # codec ladder has headroom the plan compresses harder instead of
    # ring-spining the peer (a thin wire wants fewer bytes; a slow HOST
    # wants fewer edges).  Ignored when no reporter carried phase
    # evidence (tracing off), so pre-tracing fleets decide identically.
    link_net_frac: float = 0.6
    # plan-change rate limit (rounds)
    cooldown_rounds: int = 16
    # never penalize more than this fraction of the member set (the
    # controller must degrade links, not dissolve the fleet)
    max_slow_frac: float = 0.5

    def __post_init__(self):
        if self.evidence_every < 1:
            raise ValueError("evidence_every must be >= 1")
        if not (self.slow_exit < self.slow_enter):
            raise ValueError(
                "hysteresis requires slow_exit < slow_enter "
                f"(got exit={self.slow_exit}, enter={self.slow_enter})")
        if not (self.densify_exit < self.densify_enter):
            raise ValueError(
                "hysteresis requires densify_exit < densify_enter")
        if self.densify_full_max < 1:
            raise ValueError("densify_full_max must be >= 1")
        if not (self.grow_lo < self.grow_hi):
            raise ValueError("hysteresis requires grow_lo < grow_hi")
        if not (0 <= self.max_codec_level < len(CODEC_LADDER)):
            raise ValueError(
                f"max_codec_level must be in [0, {len(CODEC_LADDER) - 1}]")
        if self.cooldown_rounds < 1:
            raise ValueError("cooldown_rounds must be >= 1")
        if not (0.0 < self.link_net_frac <= 1.0):
            raise ValueError("link_net_frac must be in (0, 1]")

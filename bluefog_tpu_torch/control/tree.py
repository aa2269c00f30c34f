"""The read tree's communication plan: degree, depth, delta cadence.

Counterpart of ``bluefog_tpu/control/tree.py``: the control plane's
discipline applied to the relay tree.  Telemetry becomes canonical
evidence, a pure deterministic function folds it into a round-stamped
:class:`TreePlan` (canonical bytes), and the plan is actuated only at
round boundaries, by the relay node that comes with the serve-while-
training read path.

The decision table (hysteresis pairs, cooldown-limited):

- **degree** (fan-out per node): the worst per-node skip rate above
  ``skip_enter`` halves it; below ``skip_exit`` it re-doubles toward
  ``degree_max``;
- **depth** (relay tiers): grown when subscriber demand exceeds
  ``fan_enter`` of what ``degree^(depth+1)`` leaves absorb, shrunk when
  the shallower tree absorbs it below ``fan_exit``;
- **full_every** (the delta anchor cadence): worst per-tier staleness
  above ``stale_enter`` rounds halves it; below ``stale_exit`` it doubles
  toward ``full_every_max``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Iterable, List

__all__ = ["TreePlan", "TreeConfig", "TreeEvidence", "decide_tree_plan",
           "tree_capacity"]


@dataclasses.dataclass(frozen=True)
class TreePlan:
    """One round-stamped read-tree plan.

    Attributes:
      version: monotone plan number; 0 is the static launch config.
      round: the decision round; actuation happens at the first round
        boundary at or after it.
      degree: max children (subscriptions) per node; the server-side
        fan-out admission limit.
      depth: relay tiers below the trainer (0 = direct fan-out).
      full_every: delta anchor cadence of every push channel (1 = every
        push full, deltas off).
    """

    version: int = 0
    round: int = 0
    degree: int = 8
    depth: int = 1
    full_every: int = 8

    def __post_init__(self):
        object.__setattr__(self, "degree", max(2, int(self.degree)))
        object.__setattr__(self, "depth", max(0, int(self.depth)))
        object.__setattr__(self, "full_every",
                           max(1, int(self.full_every)))

    def to_bytes(self) -> bytes:
        """Canonical byte encoding (sorted keys, normalized ints): two
        nodes that derived the same plan produce IDENTICAL bytes — the
        same literal-byte-equality convergence contract as
        :meth:`~bluefog_tpu_torch.control.plan.CommPlan.to_bytes`."""
        return json.dumps(
            {"version": int(self.version), "round": int(self.round),
             "degree": int(self.degree), "depth": int(self.depth),
             "full_every": int(self.full_every)},
            sort_keys=True, separators=(",", ":")).encode()

    @staticmethod
    def from_bytes(blob: bytes) -> "TreePlan":
        d = json.loads(blob.decode())
        return TreePlan(version=int(d["version"]), round=int(d["round"]),
                        degree=int(d["degree"]), depth=int(d["depth"]),
                        full_every=int(d["full_every"]))


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Knobs for the tree controller.  Every threshold is an enter/exit
    hysteresis pair (enter strictly stronger), and plan changes are
    rate-limited by ``cooldown_rounds`` — the
    :class:`~bluefog_tpu_torch.control.plan.ControlConfig` no-flap posture."""

    degree_max: int = 16
    degree_min: int = 2
    depth_max: int = 4
    # per-leaf-node subscriber load that grows/shrinks the tree
    fan_enter: float = 0.9   # fraction of degree capacity in use
    fan_exit: float = 0.3
    # per-node skip-rate band (skipped / due rounds)
    skip_enter: float = 0.25
    skip_exit: float = 0.05
    # per-tier staleness band (rounds)
    stale_enter: float = 4.0
    stale_exit: float = 1.0
    full_every_max: int = 32
    cooldown_rounds: int = 16

    def __post_init__(self):
        if not (2 <= self.degree_min <= self.degree_max):
            raise ValueError("need 2 <= degree_min <= degree_max")
        if self.depth_max < 0:
            raise ValueError("depth_max must be >= 0")
        if not (self.fan_exit < self.fan_enter):
            raise ValueError("hysteresis requires fan_exit < fan_enter")
        if not (self.skip_exit < self.skip_enter):
            raise ValueError(
                "hysteresis requires skip_exit < skip_enter")
        if not (self.stale_exit < self.stale_enter):
            raise ValueError(
                "hysteresis requires stale_exit < stale_enter")
        if self.full_every_max < 1:
            raise ValueError("full_every_max must be >= 1")
        if self.cooldown_rounds < 1:
            raise ValueError("cooldown_rounds must be >= 1")


@dataclasses.dataclass(frozen=True)
class TreeEvidence:
    """One node's disseminated read-path record.

    ``subscribers`` is the node's live subscription count
    (``bf_subscribers``); ``skip_rate`` its readers' skipped/due ratio
    over the window (``bf_sub_skipped_rounds_total`` differenced);
    ``staleness_rounds`` the worst ``bf_snapshot_age_rounds{tier=}`` it
    observed.  NaN = no evidence for that signal."""

    node: str
    tier: int = 0
    subscribers: int = 0
    skip_rate: float = float("nan")
    staleness_rounds: float = float("nan")


def canonicalize_tree(evidences: Iterable[TreeEvidence]
                      ) -> List[TreeEvidence]:
    """Sorted, deduplicated (newest-listed wins per node) evidence —
    the canonical input ordering that makes :func:`decide_tree_plan`
    order-independent."""
    by_node: Dict[str, TreeEvidence] = {}
    for ev in evidences:
        by_node[str(ev.node)] = ev
    return [by_node[k] for k in sorted(by_node)]


def tree_capacity(degree: int, depth: int) -> int:
    """Leaf-subscription capacity of a ``degree``-ary tree ``depth``
    tiers deep: ``degree ** (depth + 1)`` (every tier multiplies the
    trainer's direct fan-out)."""
    return int(degree) ** (int(depth) + 1)


def decide_tree_plan(prev: TreePlan, round_: int,
                     evidences: Iterable[TreeEvidence],
                     cfg: TreeConfig) -> TreePlan:
    """The deterministic tree decision table — a pure function of
    exactly ``(prev, round_, evidences, cfg)``; returns ``prev``
    unchanged when nothing crosses a threshold or the cooldown is still
    running, otherwise a new plan with ``version = prev.version + 1``
    stamped ``round_``."""
    evs = canonicalize_tree(evidences)
    if not evs:
        return prev
    if prev.version > 0 and round_ < prev.round + cfg.cooldown_rounds:
        return prev

    demand = sum(max(0, int(ev.subscribers)) for ev in evs)
    skips = [ev.skip_rate for ev in evs
             if math.isfinite(ev.skip_rate)]
    stales = [ev.staleness_rounds for ev in evs
              if math.isfinite(ev.staleness_rounds)]

    # ---- degree on the skip-rate band ----
    degree = prev.degree
    if skips:
        worst = max(skips)
        if worst > cfg.skip_enter:
            degree = max(cfg.degree_min, degree // 2)
        elif worst < cfg.skip_exit:
            degree = min(cfg.degree_max, degree * 2)
    degree = max(cfg.degree_min, min(cfg.degree_max, degree))

    # ---- depth on subscriber demand vs capacity ----
    depth = prev.depth
    if demand > cfg.fan_enter * tree_capacity(degree, depth):
        depth += 1
    elif depth > 0 and demand < cfg.fan_exit * tree_capacity(
            degree, depth - 1):
        # the SHALLOWER tree must already absorb the demand comfortably
        # before a tier is removed — a tier costs a hop of staleness,
        # but removing one under load would overload every survivor
        depth -= 1
    depth = max(0, min(cfg.depth_max, depth))

    # ---- delta anchor cadence on the staleness band ----
    full_every = prev.full_every
    if stales:
        worst = max(stales)
        if worst > cfg.stale_enter:
            full_every = max(1, full_every // 2)
        elif worst < cfg.stale_exit:
            full_every = min(cfg.full_every_max, full_every * 2)

    cand = TreePlan(version=prev.version + 1, round=round_,
                    degree=degree, depth=depth, full_every=full_every)
    if (cand.degree == prev.degree and cand.depth == prev.depth
            and cand.full_every == prev.full_every):
        return prev
    return cand

"""The per-rank communication controller: evidence in, CommPlan out.

Counterpart of ``bluefog_tpu/control/controller.py``.  Coordinator-free by
construction: :func:`decide_plan` is a pure function of ``(previous
plan, canonicalized evidence, config)``, with no clock, no RNG and no
rank identity, so every rank that has seen the same disseminated records
computes the byte-identical plan, and ranks whose record views diverge
for a while reconverge as the records propagate, as tombstones and
membership records do.

No-flap guarantees:

- **Hysteresis**: every condition that turns a knob on is strictly
  stronger than the one that turns it off (``slow_enter > slow_exit``,
  ``densify_enter > densify_exit``, ``grow_hi > grow_lo``), so telemetry
  oscillating around one threshold holds the plan steady.
- **Cooldown**: after a plan change, further changes are refused until
  ``cooldown_rounds`` rounds pass, so the turbulence an actuation causes
  cannot trigger the next one.
- **Round-boundary actuation**: :meth:`CommController.apply_plan` is the
  one actuation primitive, called by the runners only at a round
  boundary: weights, cadence and codec change between rounds, never
  inside one, which keeps the exact push-sum mass audit valid through
  every plan change (a plan moves edges; it never creates or destroys
  mass).

``note_alert`` (the fleet SLO engine's feed) comes with the fleet health
plane.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence

from bluefog_tpu_torch.control.evidence import Evidence, canonicalize
from bluefog_tpu_torch.control.plan import CommPlan, ControlConfig
from bluefog_tpu_torch.topology.graphs import Topology, replan_penalized

# the resilience health-state values SUSPECT/DEAD, spelled locally so
# this package stays import-leaf (bluefog_tpu_torch.runtime imports control's
# consumers; importing runtime back from here would be a cycle).  The
# pairing is asserted by a test against the canonical constants.
_ST_SUSPECT = 1
_ST_DEAD = 2

__all__ = ["CommController", "decide_plan", "plan_topology"]


def _median(vals: Sequence[float]) -> float:
    """The interpolating median of the JAX package's
    ``metrics/registry.py::median``, with this module's empty-input
    convention (0.0, not NaN: an empty lag table reads as "no lag
    evidence", never poisons the threshold arithmetic)."""
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return 0.0
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def _peer_lag(evidences: Sequence[Evidence]) -> Dict[int, float]:
    """Per-peer consensus lag over all reporters: the MEDIAN of what
    the ranks that actually touch the peer observed (median, not max —
    one confused reporter must not convict a healthy peer)."""
    seen: Dict[int, List[float]] = {}
    for ev in evidences:
        for j, v in ev.lag_s.items():
            if math.isfinite(v):
                seen.setdefault(int(j), []).append(float(v))
    return {j: _median(vs) for j, vs in seen.items()}


def _peer_net_frac(evidences: Sequence[Evidence]) -> Dict[int, float]:
    """Per-peer fraction of the traced lag spent on the WIRE (the
    ``net`` phase) rather than in the owner's queue/apply — median per
    phase over the reporters that carried phase evidence, then
    normalized.  Empty when tracing is off fleet-wide, so pre-tracing
    evidence decides exactly as before."""
    acc: Dict[int, Dict[str, List[float]]] = {}
    for ev in evidences:
        for j, m in ev.phase_s.items():
            per = acc.setdefault(int(j), {})
            for p, v in m.items():
                if math.isfinite(v):
                    per.setdefault(str(p), []).append(float(v))
    out: Dict[int, float] = {}
    for j, per in acc.items():
        med = {p: _median(vs) for p, vs in per.items()}
        total = sum(med.values())
        if total > 0:
            out[j] = med.get("net", 0.0) / total
    return out


def decide_plan(prev: CommPlan, round_: int,
                evidences: Iterable[Evidence],
                cfg: ControlConfig) -> CommPlan:
    """The deterministic decision table (the JAX package's
    ``docs/control.md``): a pure
    function of exactly ``(prev, round_, evidences, cfg)``; the live
    fleet size is derived from the reporter count the records
    themselves carry.

    Returns ``prev`` unchanged (same object, same version) when nothing
    crosses a threshold or the cooldown is still running; otherwise a
    new plan with ``version = prev.version + 1`` stamped ``round_``.
    """
    evs = canonicalize(evidences)
    if not evs:
        return prev
    # cooldown: a fresh plan is immune until it has had time to act
    if prev.version > 0 and round_ < prev.round + cfg.cooldown_rounds:
        return prev

    # ---- slow set (hysteresis band around the fleet-median lag) ----
    lag = _peer_lag(evs)
    fleet = _median(list(lag.values()))
    enter = max(cfg.min_lag_s, cfg.slow_enter * fleet)
    exit_ = max(cfg.min_lag_s, cfg.slow_exit * fleet)
    recon: Dict[int, int] = {}
    suspect_votes: Dict[int, int] = {}
    for ev in evs:
        for j, c in ev.reconnects.items():
            recon[j] = recon.get(j, 0) + int(c)
        for j, st in ev.states.items():
            if st in (_ST_SUSPECT, _ST_DEAD):
                suspect_votes[j] = suspect_votes.get(j, 0) + 1
    # traced phase evidence splits slow LINK from slow HOST: the codec
    # can only divert a link-slow peer while it has headroom below the
    # configured ceiling (otherwise the spine penalty is the fallback
    # remedy — a convicted peer always gets SOME remedy)
    net_frac = _peer_net_frac(evs)
    base_codec = min(prev.codec_level, cfg.max_codec_level)
    codec_headroom = base_codec < cfg.max_codec_level
    diverted: List[int] = []
    slow: List[int] = []
    for j in sorted(set(lag) | set(recon) | set(suspect_votes)):
        was = j in prev.slow
        lat = lag.get(j, 0.0)
        lossy = recon.get(j, 0) >= cfg.reconnects_enter
        # a MAJORITY of reporters holding the peer SUSPECT/DEAD is
        # entry evidence in its own right (a wedged peer can have an
        # unremarkable ack EWMA — the last ack before the wedge was
        # fast); ANY suspicion holds an already-penalized peer in
        suspected = (suspect_votes.get(j, 0) * 2
                     >= max(1, len(evs)))
        if was:
            # release only when EVERY signal cleared: lag below the
            # exit band, a quiet wire, and nobody suspicious
            if (lat >= exit_ or recon.get(j, 0) > 0
                    or suspect_votes.get(j, 0) > 0):
                slow.append(j)
        elif lat >= enter or lossy or suspected:
            # a pure-lag conviction whose traced decomposition says the
            # time is on the WIRE (net-dominated) is a slow LINK:
            # compress harder instead of ring-spining the peer — the
            # host is keeping up, the bytes are not.  Reconnect/
            # suspicion evidence stays spine territory (a flapping or
            # wedged peer is not fixed by a smaller payload).
            if (not lossy and not suspected and codec_headroom
                    and net_frac.get(j, 0.0) >= cfg.link_net_frac):
                diverted.append(j)
            else:
                slow.append(j)
    # degrade links, never dissolve the fleet: keep at most
    # max_slow_frac of the LIVE fleet penalized (reporter count is the
    # live-member proxy the records themselves carry — capacity would
    # let a shrunk elastic fleet be penalized wholesale), worst lag
    # first (rank breaks ties deterministically), always allowing one
    cap = max(1, int(len(evs) * cfg.max_slow_frac))
    if len(slow) > cap:
        slow = sorted(sorted(slow, key=lambda j: (-lag.get(j, 0.0), j))[:cap])

    # ---- densify ladder on mixing excess ----
    excesses = [ev.mixing_excess for ev in evs
                if math.isfinite(ev.mixing_excess)]
    densify = prev.densify
    if excesses:
        worst = max(excesses)
        if worst > cfg.densify_enter:
            densify += 1
        elif worst < cfg.densify_exit:
            densify -= 1
    densify = max(0, densify)
    # size-aware top rung: the reporter count is the live-member proxy
    # the records themselves carry; above cfg.densify_full_max the
    # one-step exact averager (a million-edge plan at 1024 ranks) is
    # capped away and sustained excess tops out at the
    # symmetric-exponential rung — which is what lets a fleet-scale run
    # keep the ladder ENABLED (the partition scenario used to have to
    # configure it off entirely)
    if len(evs) > cfg.densify_full_max:
        densify = min(densify, 1)

    # ---- cadence + codec on the consensus-growth band ----
    growths = [ev.consensus_growth for ev in evs
               if math.isfinite(ev.consensus_growth)]
    gossip_every = prev.gossip_every
    codec_level = min(prev.codec_level, cfg.max_codec_level)
    if growths:
        worst = max(growths)
        if worst > cfg.grow_hi:
            # consensus distance is GROWING: gossip more, compress less
            gossip_every = max(1, gossip_every // 2)
            codec_level = max(0, codec_level - 1)
        elif worst < cfg.grow_lo:
            # consensus is contracting comfortably: spend less wire —
            # stretch cadence only while links are actually under
            # pressure (a slow set exists), re-arm compression toward
            # the configured ceiling
            if slow:
                gossip_every = min(cfg.cadence_max, gossip_every * 2)
            codec_level = min(cfg.max_codec_level, codec_level + 1)
    if diverted:
        # the link-slow diversion must deliver an ACTUAL remedy: the
        # plan's codec has to end up above where it started.  When the
        # growth band just backed the codec off (compression error is
        # suspect), compressing harder would fight that decision —
        # the spine is the fallback, so a convicted peer always gets
        # SOME remedy either way.
        bumped = min(cfg.max_codec_level, codec_level + 1)
        if codec_level > base_codec:
            pass  # the grow_lo re-arm already raised it
        elif bumped > base_codec:
            codec_level = bumped
        else:
            slow = sorted(set(slow) | set(diverted))
            if len(slow) > cap:
                slow = sorted(sorted(
                    slow, key=lambda j: (-lag.get(j, 0.0), j))[:cap])

    cand = CommPlan(version=prev.version + 1, round=round_,
                    slow=tuple(slow), densify=densify,
                    gossip_every=gossip_every, codec_level=codec_level)
    if (cand.slow == prev.slow and cand.densify == prev.densify
            and cand.gossip_every == prev.gossip_every
            and cand.codec_level == prev.codec_level):
        return prev
    return cand


def plan_topology(base: Topology, members, plan: CommPlan) -> Topology:
    """The mixing graph a plan prescribes over the CURRENT member set:
    the penalized deterministic rebuild (slow peers reduced to the ring
    spine, densify ladder applied).  Pure and deterministic in
    ``(base.size, sorted(members), plan)`` — the topology half of the
    every-rank-converges contract."""
    mem = sorted(members)
    return replan_penalized(base, mem,
                            slow=[r for r in plan.slow if r in set(mem)],
                            densify=plan.densify)


class CommController:
    """Per-rank controller: accumulates local telemetry, snapshots it
    as an :class:`Evidence` record for dissemination, folds the
    disseminated records into a :class:`CommPlan` via
    :func:`decide_plan`, and actuates through :meth:`apply_plan`.

    The loop contract (both async dsgd runners):

    1. every round: feed per-peer observations (:meth:`note_peer`) and
       the round's local disagreement (:meth:`note_disagreement`);
    2. every ``cfg.evidence_every`` rounds, AT A ROUND BOUNDARY:
       publish :meth:`evidence`, collect the fleet's records, call
       :meth:`decide`; when the version advanced, actuate via
       :meth:`apply_plan` (new mixing topology back to the caller, plus
       cadence/codec for the caller to install) — all before the next
       round's deposits leave.
    """

    def __init__(self, rank: int, n_ranks: int, *,
                 config: Optional[ControlConfig] = None):
        self.rank = int(rank)
        self.n = int(n_ranks)
        self.cfg = config or ControlConfig()
        # version 0 IS the launch config: codec starts at the caller's
        # ceiling (the controller backs OFF from there), everything
        # else at the static defaults
        self.plan = CommPlan(codec_level=self.cfg.max_codec_level)
        self.plan_changes = 0
        self._lag: Dict[int, float] = {}
        self._states: Dict[int, int] = {}
        self._phase: Dict[int, Dict[str, float]] = {}
        self._recon_seen: Dict[int, int] = {}   # lifetime counts per peer
        self._recon_delta: Dict[int, int] = {}  # since last evidence()
        self._mixing_excess = float("nan")
        self._dis_now: Optional[float] = None
        self._dis_prev_window: Optional[float] = None

    # ------------------------------------------------------- local feeds
    def note_peer(self, peer: int, *, lag_s: Optional[float] = None,
                  state: Optional[int] = None,
                  reconnects_total: Optional[int] = None,
                  phase_s: Optional[Dict[str, float]] = None) -> None:
        """Fold one peer observation in.  ``lag_s`` is transport lag
        (wire ack EWMA / thread staleness age); ``reconnects_total`` is
        the stream's LIFETIME count — the controller differences it
        into the per-window delta the evidence record carries;
        ``phase_s`` is the traced wire-phase decomposition of that lag
        (``{"net": s, "queue": s, "apply": s}`` from
        :meth:`~bluefog_tpu_torch.runtime.window_server.DepositStream.
        phase_ewma`; None when tracing is off — the evidence then
        carries no breakdown and :func:`decide_plan` falls back to the
        phase-blind table)."""
        j = int(peer)
        if lag_s is not None and math.isfinite(lag_s):
            self._lag[j] = float(lag_s)
        if state is not None:
            self._states[j] = int(state)
        if phase_s:
            self._phase[j] = {str(p): float(v)
                              for p, v in phase_s.items()
                              if math.isfinite(float(v))}
        if reconnects_total is not None:
            seen = self._recon_seen.get(j, 0)
            if reconnects_total > seen:
                self._recon_delta[j] = (self._recon_delta.get(j, 0)
                                        + int(reconnects_total - seen))
                self._recon_seen[j] = int(reconnects_total)

    def forget_peer(self, peer: int) -> None:
        """Drop every sticky observation about ``peer`` — owed whenever
        the peer leaves this rank's observation surface (it died, it
        drained, or the plan dropped the edge this rank observed it
        through).  Without this, a frozen last observation would be
        republished in every future evidence record: a corpse's DEAD
        state keeps voting, and a recovered peer whose old reporters
        stopped refreshing could never be released by hysteresis."""
        j = int(peer)
        self._lag.pop(j, None)
        self._states.pop(j, None)
        self._phase.pop(j, None)
        self._recon_delta.pop(j, None)
        self._recon_seen.pop(j, None)

    def retain_peers(self, peers) -> None:
        """Keep observations only for ``peers`` (the current
        observation surface); forget everyone else."""
        keep = {int(j) for j in peers}
        for j in (set(self._lag) | set(self._states) | set(self._phase)
                  | set(self._recon_seen)) - keep:
            self.forget_peer(j)

    def note_disagreement(self, value: float) -> None:
        """This round's local disagreement (||z_in - z_self|| over the
        consumed neighbor mass): an EWMA feeds the consensus-growth
        signal."""
        if not math.isfinite(value):
            return
        a = self.cfg.ewma_alpha
        self._dis_now = (value if self._dis_now is None
                         else a * value + (1.0 - a) * self._dis_now)

    def note_mixing_excess(self, value: Optional[float]) -> None:
        self._mixing_excess = (float("nan") if value is None
                               else float(value))

    @property
    def disagreement(self) -> Optional[float]:
        """The current local-disagreement EWMA (what the loop feeds its
        MixingTracker each evidence window); None before the first
        fresh neighbor mass arrived."""
        return self._dis_now

    # ----------------------------------------------------- dissemination
    def evidence(self, round_: int) -> Evidence:
        """Snapshot local observations as this rank's record (and roll
        the consensus-growth window: growth compares the disagreement
        EWMA now against the previous evidence snapshot's)."""
        growth = float("nan")
        if (self._dis_now is not None
                and self._dis_prev_window is not None
                and self._dis_prev_window > 0):
            growth = self._dis_now / self._dis_prev_window
        ev = Evidence(rank=self.rank, round=int(round_),
                      lag_s=dict(self._lag), states=dict(self._states),
                      reconnects=dict(self._recon_delta),
                      mixing_excess=self._mixing_excess,
                      consensus_growth=growth,
                      phase_s={j: dict(m)
                               for j, m in self._phase.items()})
        self._dis_prev_window = self._dis_now
        self._recon_delta = {}
        return ev

    # ----------------------------------------------------------- decide
    def decide(self, round_: int,
               evidences: Iterable[Evidence]) -> CommPlan:
        """Fold the disseminated records into the current plan.  Pure
        delegation to :func:`decide_plan`; counts the change when the
        version advances."""
        plan = decide_plan(self.plan, int(round_), evidences, self.cfg)
        if plan.version != self.plan.version:
            # the plan-change counter and flight-recorder event of the JAX
            # package are ROADMAP item 11a-iii
            self.plan_changes += 1
        self.plan = plan
        return plan

    # ---------------------------------------------------------- actuate
    def apply_plan(self, *, topology: Topology, members) -> Topology:
        """The actuation primitive: call only from a round-boundary
        (quiesce) context, with nothing of this rank's in flight that the
        old plan's audit still counts on.  Returns the plan's mixing topology over
        ``members``; the caller installs it (out-neighbors, split
        fraction) together with the plan's cadence and codec before the
        next round's deposits leave."""
        return plan_topology(topology, members, self.plan)

"""A snapshot relay: subscribe upstream, re-publish downstream.

Counterpart of ``bluefog_tpu/relay/node.py``.  :class:`RelayNode` is one
node of the read tree.  Upstream it is an ordinary
:class:`~bluefog_tpu_torch.serving.subscriber.Subscriber` (cursor and
epoch resume, bounded reconnect, op-10 delta decode); downstream it is an
ordinary :class:`~bluefog_tpu_torch.runtime.window_server.WindowServer`
over its own :class:`~bluefog_tpu_torch.serving.snapshots.SnapshotTable`,
whose per-subscription push senders re-publish to children.  Relays
compose into trees of any depth with no new consistency machinery:

- **Round stamps propagate unchanged.**  A landed snapshot is
  re-published under the trainer's round number, so a leaf's staleness
  is ``trainer_round - leaf_round``: staleness adds per tier (each hop's
  skip-to-latest backlog), it never hides.
- **Delivered rounds stay strictly increasing at every tier.**  The land
  path drops any round at or below the table's cursor (an upstream resync
  can replay nothing newer than it promised), and the downstream senders'
  cursor discipline does the rest: the children of a killed relay
  re-parent (or resume) with their cursor preserved.
- **Delta encoding restarts per hop.**  Each tier's push senders hold
  their own error-feedback residual against their own children; a cursor
  gap at any hop resyncs on that hop's next full-frame anchor.

Degree and delta cadence come from the control plane's
:class:`~bluefog_tpu_torch.control.tree.TreePlan`, actuated through
:meth:`RelayNode.apply_plan` at round boundaries only.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from bluefog_tpu_torch import chaos as _chaos
from bluefog_tpu_torch.runtime import wire_status
from bluefog_tpu_torch.runtime.delta import DeltaConfig
from bluefog_tpu_torch.runtime.window_server import WindowServer
from bluefog_tpu_torch.serving.client import Snapshot
from bluefog_tpu_torch.serving.snapshots import SnapshotTable
from bluefog_tpu_torch.serving.subscriber import Subscriber
from bluefog_tpu_torch.tracing import recorder as _tr

__all__ = ["RelayNode"]


class RelayNode:
    """Subscribe to an upstream serving host; re-publish to children.

    Args:
      upstream: the parent's ``WindowServer`` address (a trainer or
        another relay).
      groups: snapshot groups to relay.
      tier: this node's depth in the tree (1 = children of the trainer).
      host/port: where to serve children (an ephemeral port by default).
      delta: the downstream push channels'
        :class:`~bluefog_tpu_torch.runtime.delta.DeltaConfig`; the upstream
        subscription asks for op-10 deltas too (``delta_up=False`` turns
        that off).
      every: upstream subscription stride.
      fallbacks: addresses to re-parent to (in rotation) when the upstream
        subscription's reconnect budget is exhausted; re-parenting keeps
        the cursor, so delivered rounds stay strictly increasing across
        the hand-off.  Bounded by ``reparent_budget``: a relay that can
        reach nobody latches its error instead of dialing forever.
      idle_ttl_s: when set, groups idle longer than this are swept from
        the relay's table.
    """

    def __init__(self, upstream: Tuple[str, int], groups: Sequence[str],
                 *, tier: int = 1, host: str = "127.0.0.1", port: int = 0,
                 delta: Optional[DeltaConfig] = None, delta_up: bool = True,
                 every: int = 1, fallbacks: Sequence[Tuple[str, int]] = (),
                 reparent_budget: int = 8, reconnect=True,
                 idle_timeout_s: float = 5.0, timeout_s: float = 10.0,
                 idle_ttl_s: Optional[float] = None):
        self.tier = int(tier)
        self.groups = list(groups)
        if not self.groups:
            raise ValueError("a relay needs at least one group to relay")
        self.table = SnapshotTable()
        self._delta_cfg = delta if delta is not None else DeltaConfig()
        self.server = WindowServer(snapshots=self.table,
                                   delta=self._delta_cfg)
        self.address = self.server.start(host, port)
        upstream = (upstream[0], int(upstream[1]))
        if upstream == self.address:
            # a self-subscription would close a cycle: refused in the
            # registry's words before any wire traffic
            self.server.stop()
            raise RuntimeError(
                f"relay at {self.address[0]}:{self.address[1]} refused "
                f"({wire_status.ERR_RELAY_LOOP}): "
                + wire_status.err_text(wire_status.ERR_RELAY_LOOP))
        self.upstream = upstream
        self._uplinks: List[Tuple[str, int]] = [upstream] + [
            (h, int(p)) for h, p in fallbacks]
        self._uplink_idx = 0
        self._reparent_budget = max(0, int(reparent_budget))
        self.reparents = 0
        self._every = max(1, int(every))
        self._delta_up = bool(delta_up)
        self._reconnect = reconnect
        self._idle_timeout_s = float(idle_timeout_s)
        self._timeout_s = float(timeout_s)
        self._idle_ttl_s = idle_ttl_s
        self._mu = threading.Lock()
        self._err: Optional[str] = None
        self.landed = 0
        self.dropped_rounds = 0
        self._closed = threading.Event()
        self._subs: Dict[str, Subscriber] = {
            g: self._subscribe(self.upstream, g, -1) for g in self.groups}
        self._watchdog = threading.Thread(
            target=self._watch, daemon=True, name=f"bf-relay:t{self.tier}")
        self._watchdog.start()

    # ----------------------------------------------------------- upstream
    def _subscribe(self, addr: Tuple[str, int], group: str,
                   cursor: int) -> Subscriber:
        return Subscriber(
            addr, group, every=self._every, cursor=cursor,
            on_snapshot=lambda s, g=group: self._land(g, s),
            reconnect=self._reconnect, delta=self._delta_up,
            idle_timeout_s=self._idle_timeout_s,
            timeout_s=self._timeout_s, queue_max=2)

    def _land(self, group: str, snap: Snapshot) -> None:
        """Land one upstream snapshot and re-publish it for children.

        A round at or below the table's cursor is a replay from an
        upstream resync: dropped here, so the children's delivered rounds
        stay strictly increasing.  A round above it re-publishes under the
        trainer's stamp, and the downstream delta senders place their own
        full-frame resync anchors against their own children."""
        cursor = self.table.current_round(group)
        if snap.round <= cursor:
            with self._mu:
                self.dropped_rounds += 1
            return
        act = _chaos.fire("relay", group=group, tier=self.tier)
        if act is not None:
            if act[0] in ("delay", "stall"):
                time.sleep(act[1])
            else:
                # an injected relay fault: this round is not re-published
                # (children see a skip, never a torn group); 'truncate'
                # also tears the upstream link, so the resumed
                # subscription resyncs through its anchor
                if act[0] == "truncate":
                    with self._mu:
                        target = self._uplinks[
                            self._uplink_idx % len(self._uplinks)]
                    self._subs[group].reparent(target)
                return
        psp = None
        trec = _tr.get()
        if trec is not None and snap.trace is not None:
            # the relay hop parents to the upstream push span, so the
            # analyzer walks trainer -> relay -> ... -> leaf
            psp = trec.begin_span(
                "relay", "relay", parent=snap.trace[1],
                trace_id=snap.trace[0], round_=max(0, snap.round),
                group=group, tier=self.tier)
        try:
            self.table.publish(group, snap.round, snap.leaves,
                               trace=(psp.tid, psp.sid)
                               if psp is not None else None)
        finally:
            if psp is not None:
                psp.finish()
        with self._mu:
            self.landed += 1

    # ----------------------------------------------------------- watchdog
    def _watch(self) -> None:
        """Re-parent dead uplinks (budgeted) and sweep idle groups."""
        last_sweep = time.monotonic()
        while not self._closed.wait(0.2):
            for g, sub in list(self._subs.items()):
                if sub.error is None:
                    continue
                # the subscription exhausted its reconnect budget: move to
                # the next uplink in rotation, cursor kept, bounded by the
                # relay's own re-parent budget
                with self._mu:
                    exhausted = (self.reparents >= self._reparent_budget
                                 or len(self._uplinks) == 0)
                    if exhausted:
                        if self._err is None:
                            self._err = (
                                f"uplink dead for group {g!r} and "
                                f"re-parent budget ({self._reparent_budget})"
                                f" exhausted: {sub.error}")
                    else:
                        self._uplink_idx = (self._uplink_idx + 1) \
                            % len(self._uplinks)
                        target = self._uplinks[self._uplink_idx]
                        self.reparents += 1
                if exhausted:
                    continue
                cursor = sub.cursor
                sub.close()
                self._subs[g] = self._subscribe(target, g, cursor)
            if self._idle_ttl_s is not None:
                nowm = time.monotonic()
                if nowm - last_sweep >= max(1.0, self._idle_ttl_s / 4):
                    last_sweep = nowm
                    self.table.sweep_idle(self._idle_ttl_s)

    # ------------------------------------------------------------- public
    @property
    def error(self) -> Optional[str]:
        with self._mu:
            if self._err is not None:
                return self._err
            budget_gone = self.reparents >= self._reparent_budget
        for sub in self._subs.values():
            if sub.error is not None and budget_gone:
                return sub.error
        return None

    def subscription(self, group: str) -> Subscriber:
        """The live upstream subscription of ``group`` (its counters:
        delivered, delta frames, resumes, skipped rounds)."""
        return self._subs[group]

    def rounds(self) -> Dict[str, int]:
        """Latest re-published round per group (-1 = nothing landed)."""
        return {g: self.table.current_round(g) for g in self.groups}

    def wait_ready(self, timeout_s: float = 30.0) -> Dict[str, int]:
        """Block until every group landed at least one round."""
        deadline = time.monotonic() + float(timeout_s)
        while True:
            rounds = self.rounds()
            if all(r >= 0 for r in rounds.values()):
                return rounds
            if self.error is not None:
                raise RuntimeError(
                    f"relay tier {self.tier} failed before its first "
                    f"round: {self.error}")
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"relay tier {self.tier} landed no round within "
                    f"{timeout_s}s (have {rounds})")
            time.sleep(0.02)

    def reparent(self, address: Tuple[str, int]) -> None:
        """Move every uplink to ``address`` (an operator- or plan-driven
        hand-off); the subscriptions keep their cursors."""
        addr = (address[0], int(address[1]))
        with self._mu:
            self._uplinks = [addr]
            self._uplink_idx = 0
        for sub in self._subs.values():
            sub.reparent(addr)

    def apply_plan(self, plan) -> None:
        """The tree-plan actuation: call it only at a round boundary (no
        child may see one round under two configs).  The delta cadence and
        the fan-out degree change between rounds, never inside one."""
        self._delta_cfg = DeltaConfig(
            full_every=int(plan.full_every),
            codec=self._delta_cfg.codec,
            topk_ratio=self._delta_cfg.topk_ratio,
            min_delta_elems=self._delta_cfg.min_delta_elems)
        self.server.set_delta(self._delta_cfg)
        self.server.set_fanout_limit(int(plan.degree))

    def close(self) -> None:
        self._closed.set()
        for sub in self._subs.values():
            sub.close()
        self._watchdog.join(timeout=5)
        self.server.stop()
        for g in self.groups:
            self.table.drop_group(g)

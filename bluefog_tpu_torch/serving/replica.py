"""A serving replica: subscribe to a training rank, serve its model.

Counterpart of ``bluefog_tpu/serving/replica.py``.  :class:`ServingReplica`
is the deployment shape the serving tier exists for: a prediction server
that follows a continuously training model with bounded staleness and no
coupling to the training loop.

- It rides a :class:`~bluefog_tpu_torch.serving.subscriber.Subscriber`
  (resumable, bounded reconnect, skip-to-latest), so a replica's death or
  slowness never perturbs training.
- Every adopted snapshot is round-stamped and round-consistent: the
  replica de-biases ``z = x / p`` (the push-sum estimate) and, given a
  ``template``, unpacks ``z`` into the model's parameter tree through the
  port's :class:`~bluefog_tpu_torch.runtime.async_windows.TreePacker`, so
  the parameters land on the template's device: a template on the card
  gives parameters on the card (one narrowing cast to f32 on the host, one
  copy to the card).
- :meth:`staleness_rounds` says how live the served model is: with a
  healthy link and ``every=N`` it stays within N plus the delivery lag.

Many replicas fan out from one trainer (one subscription each); point
replicas at different ranks of the fleet to scale reads out, or put
:class:`~bluefog_tpu_torch.relay.RelayNode` tiers between them.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import numpy as np

from bluefog_tpu_torch.serving.client import Snapshot
from bluefog_tpu_torch.serving.subscriber import Subscriber

__all__ = ["ServingReplica", "ShardedServingReplica"]


def _debias(snap: Snapshot) -> np.ndarray:
    """``z = x / p`` of a dsgd snapshot; ``x`` alone without a positive
    ``p``; the single leaf of any other publisher."""
    x = snap.leaves.get("x")
    p = snap.leaves.get("p")
    if x is not None and p is not None and float(p[0]) > 0.0:
        return x / float(p[0])
    if x is not None:
        return x
    return next(iter(snap.leaves.values()))


class ServingReplica:
    """Follow one training rank's published model with bounded staleness.

    Args:
      address: the rank's ``WindowServer`` address (or a relay's).
      group: its snapshot group (``f"{name}:{rank}"`` for the dsgd
        runners).
      template: optional model parameter tree (tensors or arrays); when
        given, :meth:`params` returns the de-biased snapshot unpacked to
        this structure, each leaf on its template leaf's device and in its
        dtype (otherwise the flat ``z`` vector).
      every: subscription stride, the freshness/traffic trade-off.
      cursor / reconnect / idle_timeout_s / timeout_s / delta: forwarded
        to the :class:`~bluefog_tpu_torch.serving.subscriber.Subscriber`.
    """

    def __init__(self, address: Tuple[str, int], group: str,
                 template=None, *, every: int = 1, cursor: int = -1,
                 reconnect=True, idle_timeout_s: float = 5.0,
                 timeout_s: float = 10.0, delta: bool = False):
        self.group = group
        self._packer = None
        if template is not None:
            from bluefog_tpu_torch.runtime.async_windows import TreePacker

            self._packer = TreePacker(template, np.float64)
        self._cv = threading.Condition()
        self._round = -1
        self._z: Optional[np.ndarray] = None
        self._adopted_at = 0.0
        self.adopted = 0
        self._sub = Subscriber(
            address, group, every=every, cursor=cursor,
            on_snapshot=self._adopt, reconnect=reconnect,
            idle_timeout_s=idle_timeout_s, timeout_s=timeout_s,
            queue_max=2, delta=delta)

    # ------------------------------------------------------------- intake
    def _adopt(self, snap: Snapshot) -> None:
        # adopt only forward, and de-bias from leaves that are
        # one-round-consistent by contract
        if snap.round <= self._round:
            return
        z = _debias(snap)
        with self._cv:
            self._z = z
            self._round = snap.round
            self._adopted_at = time.monotonic()
            self.adopted += 1
            self._cv.notify_all()

    # ------------------------------------------------------------ serving
    @property
    def round(self) -> int:
        """Round stamp of the weights currently served (-1 until the first
        snapshot lands)."""
        return self._round

    @property
    def subscriber(self) -> Subscriber:
        """The subscription this replica rides (its counters: delivered,
        delta frames, resumes, skipped rounds)."""
        return self._sub

    @property
    def error(self) -> Optional[str]:
        return self._sub.error

    def wait_ready(self, timeout_s: float = 30.0) -> int:
        """Block until the first snapshot is adopted; returns its round.
        A subscription failure (rejection, exhausted reconnect budget)
        surfaces as soon as it happens."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._round < 0 and self._sub.error is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"replica for {self.group!r} received no "
                        f"snapshot within {timeout_s}s")
                self._cv.wait(timeout=min(0.1, remaining))
            if self._round < 0:
                raise RuntimeError(
                    f"replica for {self.group!r} failed before its first "
                    f"snapshot: {self._sub.error}")
            return self._round

    def served(self) -> Tuple[int, np.ndarray]:
        """``(round, z)`` of the served model, read together."""
        with self._cv:
            if self._z is None:
                raise RuntimeError(
                    f"replica for {self.group!r} has no snapshot yet "
                    "(wait_ready() first)")
            return self._round, self._z

    def params(self, *, with_round: bool = False):
        """The served model: the de-biased snapshot, unpacked to the
        template's tree on the template's device when one was given.
        ``with_round=True`` returns ``(round, model)``, the round the
        model was served at."""
        rnd, z = self.served()
        tree = z if self._packer is None else self._packer.unpack(z)
        return (rnd, tree) if with_round else tree

    def staleness_rounds(self, current_round: int) -> int:
        """How many rounds behind ``current_round`` (the trainer's live
        round, from its snapshot table or a fresh SNAPSHOT read) the
        served weights are."""
        return max(0, int(current_round) - self._round)

    def close(self) -> None:
        self._sub.close()


class ShardedServingReplica:
    """Follow a gossip rank that is a whole mesh: one subscription per
    inner-mesh coordinate, reassembled into the full model at the read
    boundary.

    Under gossip of meshes each inner coordinate publishes its own
    shard-local snapshot group (``f"{group}:{ci}"``, ``ci`` the
    coordinate's index in :func:`~bluefog_tpu_torch.sharding.mesh.
    inner_coords` order).  This replica subscribes to all of them and
    serves the newest round for which every coordinate's snapshot has
    arrived: a round-consistent full tree, each coordinate unpacked by a
    spec-aware :class:`~bluefog_tpu_torch.runtime.async_windows.TreePacker`
    and gathered by :func:`~bluefog_tpu_torch.sharding.apply.gather_tree`
    (on the template's device).  A small per-coordinate round history
    bridges the skew; serving never mixes rounds across coordinates.

    Args:
      address / group / every / cursor / reconnect / idle_timeout_s /
        timeout_s: as :class:`ServingReplica`.
      template: the full (unsharded) model tree.
      rule_table: the :class:`~bluefog_tpu_torch.sharding.rules.RuleTable`
        (or a resolved spec tree) the trainer shards by.
      axes: inner-mesh ``{axis: size}``.
      history: per-coordinate rounds kept while waiting for stragglers.
    """

    def __init__(self, address: Tuple[str, int], group: str, template,
                 rule_table, axes, *, every: int = 1, cursor: int = -1,
                 reconnect=True, idle_timeout_s: float = 5.0,
                 timeout_s: float = 10.0, history: int = 4):
        from bluefog_tpu_torch.runtime.async_windows import TreePacker
        from bluefog_tpu_torch.sharding.mesh import ShardView, inner_coords
        from bluefog_tpu_torch.sharding.rules import RuleTable

        self.group = group
        self.template = template
        self.axes = dict(axes)
        if isinstance(rule_table, RuleTable):
            self.specs = rule_table.resolve_tree(template)
        else:
            self.specs = rule_table
        self._coords = inner_coords(self.axes)
        self._names = list(self.axes.keys())
        # the template, specs and axes are fixed for the replica's life,
        # so the per-coordinate spec-aware packers are built once
        self._packers = [
            TreePacker(template, np.float64,
                       sharding=ShardView(specs=self.specs, axes=self.axes,
                                          coord=c))
            for c in self._coords]
        self._history = max(int(history), 1)
        self._cv = threading.Condition()
        # per-coordinate {round: z}; the served state is the newest
        # complete round
        self._pending = [dict() for _ in self._coords]
        self._round = -1
        self._vectors = None  # {pos_tuple: z} of the served round
        self.adopted = 0
        self._subs = []
        try:
            for ci in range(len(self._coords)):
                self._subs.append(Subscriber(
                    address, f"{group}:{ci}", every=every, cursor=cursor,
                    on_snapshot=lambda s, ci=ci: self._adopt(ci, s),
                    reconnect=reconnect, idle_timeout_s=idle_timeout_s,
                    timeout_s=timeout_s, queue_max=2))
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------- intake
    def _adopt(self, ci: int, snap: Snapshot) -> None:
        if snap.round <= self._round:
            return
        z = _debias(snap)
        with self._cv:
            pend = self._pending[ci]
            pend[snap.round] = z
            while len(pend) > self._history:
                del pend[min(pend)]
            # the newest round every coordinate has is the new served one
            complete = set(self._pending[0])
            for other in self._pending[1:]:
                complete &= set(other)
            complete = {r for r in complete if r > self._round}
            if complete:
                rnd = max(complete)
                self._vectors = {
                    tuple(c[nm] for nm in self._names):
                        self._pending[i][rnd]
                    for i, c in enumerate(self._coords)}
                self._round = rnd
                self.adopted += 1
                for pend2 in self._pending:
                    for r in [r for r in pend2 if r <= rnd]:
                        del pend2[r]
            self._cv.notify_all()

    # ------------------------------------------------------------ serving
    @property
    def round(self) -> int:
        """Round stamp of the newest complete (all-coordinates) snapshot
        set (-1 until one exists)."""
        return self._round

    @property
    def subscribers(self) -> list:
        """The per-coordinate subscriptions, in coordinate order."""
        return list(self._subs)

    @property
    def error(self) -> Optional[str]:
        for sub in self._subs:
            if sub.error is not None:
                return sub.error
        return None

    def wait_ready(self, timeout_s: float = 30.0) -> int:
        """Block until a complete round is assembled; returns its round."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._round < 0 and self.error is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"sharded replica for {self.group!r} assembled no "
                        f"complete round within {timeout_s}s")
                self._cv.wait(timeout=min(0.1, remaining))
            if self._round < 0:
                raise RuntimeError(
                    f"sharded replica for {self.group!r} failed before "
                    f"its first complete round: {self.error}")
            return self._round

    def params(self):
        """The served model: every coordinate's shard-local vector of the
        same round, unpacked spec-aware and gathered to the full tree (the
        read boundary's only gather)."""
        from bluefog_tpu_torch.sharding.apply import gather_tree

        with self._cv:
            if self._vectors is None:
                raise RuntimeError(
                    f"sharded replica for {self.group!r} has no complete "
                    "round yet (wait_ready() first)")
            vectors = dict(self._vectors)
        shard_trees = {}
        for c, packer in zip(self._coords, self._packers):
            pos = tuple(c[nm] for nm in self._names)
            shard_trees[pos] = packer.unpack(np.asarray(vectors[pos]))
        return gather_tree(self.template, self.specs, self.axes, shard_trees)

    def staleness_rounds(self, current_round: int) -> int:
        return max(0, int(current_round) - self._round)

    def close(self) -> None:
        for sub in self._subs:
            sub.close()

"""Decentralization-specific health gauges.

Counterpart of ``bluefog_tpu/metrics/health.py``.  The paper's trade
(arXiv:2111.04287) is wall-clock speed against a bounded consensus error;
these gauges make both sides observable at runtime:

- **Consensus distance** ``||x_i - x_bar||_2``: how far ranks have drifted
  apart.  :func:`consensus_distance` is the device form over rank-stacked
  tensors (the JAX package's is the in-``shard_map`` form over a mesh
  axis): a ``(m,)`` tensor the caller fetches when it wants it.
  :func:`consensus_distance_stacked` is the host/numpy form.
- **Mixing contraction**: :class:`MixingTracker` compares the measured
  per-round contraction ``d_t / d_{t-1}`` against the spectral-gap
  prediction ``|lambda_2(W)|`` of the topology in effect.  A measured
  rate persistently above the prediction means gossip is not delivering
  the contraction the topology was provisioned for (skew, drops, a wedged
  transport); the control plane reads the difference as its densify
  evidence.
- **Heartbeat age**: seconds since the training loop last beat the
  :class:`~bluefog_tpu_torch.utils.failure.Heartbeat`, a callback gauge
  evaluated at snapshot time, so a scrape sees staleness grow during a
  hang, before the watchdog fires.

Values are the JAX package's, in numpy f64; the gauges
(``bf_consensus_distance``, ``bf_mixing_contraction_*``,
``bf_mixing_excess``, ``bf_heartbeat_age_seconds``) keep its names.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np

from bluefog_tpu_torch.metrics import registry as _reg

__all__ = [
    "consensus_distance",
    "consensus_distance_stacked",
    "record_consensus",
    "MixingTracker",
    "spectral_gap",
    "watch_heartbeat",
    "unwatch_heartbeat",
]

_PREDICTED_HELP = ("|lambda_2(W)|^rounds_per_update — static "
                   "spectral-gap bound at the feed cadence")


def spectral_gap(w) -> float:
    """``1 - |lambda_2|`` of the mixing matrix (second-largest eigenvalue
    modulus): 1.0 for a one-step exact averager (fully connected), 0.0
    when the matrix does not contract (disconnected or periodic).  The
    JAX package's ``analysis/topology_check.py::spectral_gap``, on a
    matrix or on anything with a ``weights`` matrix."""
    w = np.asarray(getattr(w, "weights", w), dtype=np.float64)
    if w.shape[0] <= 1:
        return 1.0
    mods = np.sort(np.abs(np.linalg.eigvals(w)))[::-1]
    return float(1.0 - mods[1])


def consensus_distance(x):
    """Per-rank consensus distance ``||x_i - x_bar||_2`` over a pytree of
    rank-stacked tensors (leading axis = the ranks), where ``x_bar`` is
    the mean over all ranks: a ``(m,)`` f32 tensor on the leaves' device,
    one entry per rank row the caller holds.  Over several processes the
    mean covers every process's ranks (the port's :func:`~bluefog_tpu_torch.
    ops.collectives.allreduce`, recorded by no metric or recorder hook, as
    the JAX package's ``pmean`` records none).  Nothing is fetched: the
    caller reads the result when it wants it and records it with
    :func:`record_consensus`."""
    import torch
    from torch.utils import _pytree as pytree

    from bluefog_tpu_torch.blackbox import recorder as _bb
    from bluefog_tpu_torch.metrics import comm as _mt
    from bluefog_tpu_torch.ops.collectives import allreduce

    sq = None
    for leaf in pytree.tree_leaves(x):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() < 1:
            continue
        lf = leaf.float()
        with _mt.suppress_comm_metrics(), _bb.suppress_blackbox():
            mean = allreduce(lf)
        d = (lf - mean).reshape(lf.shape[0], -1)
        contrib = (d * d).sum(dim=1)
        sq = contrib if sq is None else sq + contrib
    if sq is None:
        raise ValueError("consensus_distance needs at least one "
                         "rank-stacked tensor leaf")
    return sq.sqrt()


def consensus_distance_stacked(tree) -> float:
    """Host-side max-over-ranks consensus distance of a rank-stacked tree
    (every array leaf carries a leading rank axis), in numpy f64."""
    sq: Optional[np.ndarray] = None
    for leaf in _leaves(tree):
        arr = _as_numpy(leaf)
        if arr.ndim < 1:
            continue
        n = arr.shape[0]
        flat = arr.reshape(n, -1)
        d = flat - flat.mean(axis=0, keepdims=True)
        contrib = np.sum(d * d, axis=1)
        sq = contrib if sq is None else sq + contrib
    if sq is None:
        return 0.0
    return float(np.sqrt(sq).max())


def _leaves(tree):
    from torch.utils import _pytree as pytree

    return [l for l in pytree.tree_leaves(tree)
            if hasattr(l, "dtype") or isinstance(l, np.ndarray)]


def _as_numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu()
        if not leaf.dtype.is_floating_point or leaf.element_size() < 4:
            leaf = leaf.double()
        leaf = leaf.numpy()
    return np.asarray(leaf, dtype=np.float64)


def record_consensus(value: float, **labels) -> float:
    """Record a consensus-distance sample (the gauge holds the latest
    value; a histogram keeps the distribution for p50/p99).  Returns
    ``value`` so it chains inside expressions; no-op when metrics are
    off."""
    reg = _reg.current()
    v = float(value)
    if reg is not None:
        reg.gauge(
            "bf_consensus_distance",
            "max over ranks of ||x_i - mean(x)||_2").set(v, **labels)
        reg.histogram("bf_consensus_distance_hist").observe(v, **labels)
    return v


class MixingTracker:
    """Measured against predicted mixing contraction.

    Feed it the consensus distance once per evidence window
    (:meth:`update`); it keeps

    - ``predicted``: ``|lambda_2(W)| ** rounds_per_update`` of the mixing
      matrix in effect (:meth:`rebase` re-anchors it);
    - the measured ratio ``d_t / d_{t-1}`` that :meth:`update` returns;
    - ``measured - predicted``, the excess: persistently positive means
      consensus contracts slower than the topology's spectral gap
      promises.

    ``rounds_per_update`` is the feed cadence in gossip rounds: a caller
    that feeds every R rounds compares against ``|lambda_2|^R``, so
    measured and predicted stay on one scale.

    During training the gradient step re-injects disagreement every
    round, so the measured ratio hovers at the gossip/gradient
    equilibrium rather than decaying at ``|lambda_2|``; the predicted
    value is the floor, and measured far above it still means gossip is
    broken.
    """

    def __init__(self, schedule=None, *, rounds_per_update: int = 1,
                 **labels):
        self.labels = {str(k): str(v) for k, v in labels.items()}
        self.predicted: Optional[float] = None
        self._prev: Optional[float] = None
        if rounds_per_update < 1:
            raise ValueError(
                f"rounds_per_update must be >= 1, got {rounds_per_update}")
        self._rounds_per_update = int(rounds_per_update)
        if schedule is not None:
            self.rebase(schedule)

    def rebase(self, schedule, *,
               rounds_per_update: Optional[int] = None) -> Optional[float]:
        """Re-anchor the prediction to a new mixing schedule or matrix,
        as every membership or control-plan boundary owes this tracker:
        after a heal, a replan or a penalized rebuild the old matrix's
        eigenvalue is the wrong baseline.  ``rounds_per_update``
        re-anchors the feed-cadence exponent too (a controller that
        stretches the gossip cadence halves the gossip rounds per feed
        window).  Returns the new predicted contraction (None when the
        schedule cannot be analyzed; the previous baseline is kept)."""
        if rounds_per_update is not None:
            if rounds_per_update < 1:
                raise ValueError(
                    f"rounds_per_update must be >= 1, got "
                    f"{rounds_per_update}")
            self._rounds_per_update = int(rounds_per_update)
        per_round = self._predict(schedule)
        if per_round is not None:
            self.predicted = per_round ** self._rounds_per_update
        reg = _reg.current()
        if reg is not None and self.predicted is not None:
            reg.gauge("bf_mixing_contraction_predicted",
                      _PREDICTED_HELP).set(self.predicted, **self.labels)
        return self.predicted

    def reset_measurement(self) -> None:
        """Drop the previous consensus-distance sample so the next
        :meth:`update` yields no ratio, as every membership boundary
        owes: the previous distance was measured over another member set,
        and the cross-boundary ratio would read as a mixing failure or a
        miracle."""
        self._prev = None

    @staticmethod
    def _predict(schedule) -> Optional[float]:
        try:
            if hasattr(schedule, "mixing_matrix"):
                matrix = schedule.mixing_matrix()
            elif hasattr(schedule, "weights"):
                # a healed or replanned topology carries inert identity
                # rows for its inactive ranks, whose eigenvalue 1 would
                # swamp |lambda_2|: the live fleet's contraction is the
                # active submatrix's
                matrix = np.asarray(schedule.weights)
                inactive = getattr(schedule, "inactive", None)
                if inactive:
                    live = [r for r in range(matrix.shape[0])
                            if r not in inactive]
                    matrix = matrix[np.ix_(live, live)]
            else:
                matrix = schedule
            return float(1.0 - spectral_gap(matrix))
        except Exception:
            return None

    def update(self, distance: float) -> Optional[float]:
        """Record one window's consensus distance; returns the measured
        contraction ratio (None on the first sample or after a zero or
        non-finite predecessor)."""
        d = float(distance)
        record_consensus(d, **self.labels)
        measured: Optional[float] = None
        prev, self._prev = self._prev, d
        if prev is not None and prev > 0 and math.isfinite(prev):
            measured = d / prev
            reg = _reg.current()
            if reg is not None:
                reg.gauge(
                    "bf_mixing_contraction_measured",
                    "per-round consensus-distance ratio d_t / d_{t-1}",
                ).set(measured, **self.labels)
                if self.predicted is not None:
                    # re-export the baseline too: metrics may have been
                    # enabled after construction, and an excess alarm
                    # without its predicted companion reads as noise
                    reg.gauge("bf_mixing_contraction_predicted",
                              _PREDICTED_HELP).set(self.predicted,
                                                   **self.labels)
                    reg.gauge(
                        "bf_mixing_excess",
                        "measured minus predicted contraction",
                    ).set(measured - self.predicted, **self.labels)
        return measured


def watch_heartbeat(heartbeat, name: str = "train") -> None:
    """Export ``bf_heartbeat_age_seconds{thread=<name>}`` as a callback
    gauge reading the heartbeat's last-beat monotonic stamp at snapshot
    time.  No-op when metrics are off; safe to call again after a restart
    (the same label set re-registers the callback)."""
    reg = _reg.current()
    if reg is None:
        return
    reg.gauge_fn(
        "bf_heartbeat_age_seconds",
        lambda: time.monotonic() - heartbeat._last,
        help="seconds since the training loop last beat the watchdog",
        thread=name)


def unwatch_heartbeat(name: str = "train") -> None:
    reg = _reg.current()
    if reg is not None:
        reg.remove_gauge_fn("bf_heartbeat_age_seconds", thread=name)

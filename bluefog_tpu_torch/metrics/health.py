"""Measured against predicted mixing contraction.

Counterpart of ``bluefog_tpu/metrics/health.py::MixingTracker``.  The
paper's trade (arXiv:2111.04287) is wall-clock speed against a bounded
consensus error; :class:`MixingTracker` makes the gossip side observable:
it compares the measured per-round contraction ``d_t / d_{t-1}`` of the
consensus distance against the spectral-gap prediction ``|lambda_2(W)|``
of the topology in effect.  A measured rate persistently above the
prediction means gossip is not delivering the contraction the topology
was provisioned for (skew, drops, a wedged transport); the control plane
reads the difference as its densify evidence.

The tracker's gauges (``bf_mixing_contraction_*``, ``bf_mixing_excess``,
``bf_consensus_distance``) come with the port's metrics registry; the
values are the JAX package's, in numpy f64.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

__all__ = ["MixingTracker", "spectral_gap"]


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
        measured: Optional[float] = None
        prev, self._prev = self._prev, d
        if prev is not None and prev > 0 and math.isfinite(prev):
            measured = d / prev
        return measured

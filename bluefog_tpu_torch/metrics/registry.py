"""Thread-safe labelled metric registry: counters, gauges, histograms.

Counterpart of ``bluefog_tpu/metrics/registry.py``, with its data model,
series names and snapshot format unchanged, so an operator's tools and the
other package's readers take either package's output.  A *metric* is a
named family of *series*, one per distinct label set.  Counters
accumulate, gauges hold the last value, histograms keep streaming
aggregates (count/sum/min/max) plus a bounded sample reservoir for
p50/p99.

Everything is guarded by one reentrant lock: recorders include the window
server's daemon threads and the async rank loops, and a metric update is a
few arithmetic operations, so one lock beats per-series locks at every
realistic rate.

The registry is OFF by default.  :func:`metrics_start` (or the
``BLUEFOG_TPU_METRICS=<path>`` variable, read lazily like the timeline's
``BLUEFOG_TPU_TIMELINE``) installs the process-global registry that
:func:`current` hands to the hooks; a hook treats ``current() is None`` as
"do nothing", which keeps a disabled hook's cost to one attribute load.
"""

from __future__ import annotations

import collections
import math
import os
import threading

import time
from typing import Callable, Dict, List, Optional, Tuple

from bluefog_tpu_torch.utils import lockcheck as _lc

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "current",
    "metrics_active",
    "metrics_start",
    "metrics_stop",
]

# label sets are stored as sorted (key, value) tuples so the same labels
# in any kwarg order address the same series
_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


#: histogram snapshot expansions (one source of truth — export.py's
#: Prometheus family attribution imports this)
HIST_SUFFIXES = ("_count", "_sum", "_min", "_max", "_p50", "_p99")


def _escape_label(v: str) -> str:
    """Prometheus exposition-format label escaping (backslash, quote,
    newline) — an unescaped quote in a window/compressor name would make
    a scraper reject the WHOLE exposition, not just the bad series."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def format_series(name: str, key: _LabelKey) -> str:
    """Prometheus-style series name: ``name{k="v",...}`` (bare ``name``
    for the empty label set) — also the JSONL field name, so the dash CLI
    and a scrape see the same identifiers."""
    if not key:
        return name
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return f"{name}{{{inner}}}"


class _Metric:
    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str):
        self._registry = registry
        self.name = name
        self.help = help


class Counter(_Metric):
    """Monotonically accumulating value (bytes shipped, messages sent)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        reg = self._registry
        with reg._lock:
            series = reg._values.setdefault(self.name, {})
            key = _label_key(labels)
            series[key] = series.get(key, 0.0) + float(amount)


class Gauge(_Metric):
    """Last-value metric (consensus distance, mixing rate, bubble
    fraction)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        reg = self._registry
        with reg._lock:
            reg._values.setdefault(self.name, {})[_label_key(labels)] = \
                float(value)


class _HistState:
    __slots__ = ("count", "total", "min", "max", "samples")

    def __init__(self, reservoir: int):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        # deque(maxlen): O(1) sliding window — hot host paths observe per
        # consume while holding the registry lock, so a list.pop(0)
        # memmove per observation would be contended O(RESERVOIR) cost
        self.samples = collections.deque(maxlen=reservoir)


class Histogram(_Metric):
    """Streaming distribution: exact count/sum/min/max plus a bounded
    reservoir (last ``RESERVOIR`` observations) for p50/p99 — per-step
    JSONL lines carry the aggregates, so the dash CLI can reconstruct
    per-step behavior without the registry holding unbounded state."""

    kind = "histogram"
    RESERVOIR = 2048

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        reg = self._registry
        with reg._lock:
            series = reg._values.setdefault(self.name, {})
            key = _label_key(labels)
            st = series.get(key)
            if st is None:
                st = series[key] = _HistState(self.RESERVOIR)
            st.count += 1
            st.total += v
            st.min = min(st.min, v)
            st.max = max(st.max, v)
            # sliding window, not classic reservoir sampling: recent
            # behavior is what an operator's p99 question is about
            st.samples.append(v)


def quantile(sorted_samples: List[float], q: float) -> float:
    """Nearest-rank quantile over an already-sorted sample list."""
    if not sorted_samples:
        return math.nan
    idx = min(len(sorted_samples) - 1,
              max(0, math.ceil(q * len(sorted_samples)) - 1))
    return sorted_samples[idx]


def median(vals) -> float:
    """Plain interpolating median (NaN on empty) — the ONE shared
    implementation the control and fleet planes aggregate with."""
    s = sorted(vals)
    n = len(s)
    if n == 0:
        return math.nan
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


class MetricsRegistry:
    """Holds every metric family and its series; snapshot-able.

    ``gauge_fn`` registers a *callback gauge*: a zero-arg callable
    evaluated at snapshot time (e.g. heartbeat age — the value is a
    property of "now", not of any recording event).
    """

    def __init__(self):
        self._lock = _lc.rlock("metrics.registry.MetricsRegistry._lock")
        self._metrics: Dict[str, _Metric] = {}
        # name -> {label_key: float | _HistState}
        self._values: Dict[str, Dict[_LabelKey, object]] = {}
        # (name, label_key) -> callable
        self._gauge_fns: Dict[Tuple[str, _LabelKey], Callable[[], float]] = {}
        self.created_at = time.time()

    # ----------------------------------------------------------- factories
    def _get(self, cls, name: str, help: str) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self, name, help)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)  # type: ignore[return-value]

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)  # type: ignore[return-value]

    def gauge_fn(self, name: str, fn: Callable[[], float], *,
                 help: str = "", **labels) -> None:
        """Register a callback gauge evaluated at snapshot time."""
        self._get(Gauge, name, help)
        with self._lock:
            self._gauge_fns[(name, _label_key(labels))] = fn

    def remove_gauge_fn(self, name: str, **labels) -> None:
        with self._lock:
            key = _label_key(labels)
            self._gauge_fns.pop((name, key), None)
            # drop the last sampled value too: a retired callback gauge
            # frozen at its final reading would keep exporting it — a
            # heartbeat age that stops growing reads as HEALTHY, the
            # exact inversion the gauge exists to prevent
            series = self._values.get(name)
            if series is not None:
                series.pop(key, None)
                if not series:
                    self._values.pop(name, None)

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, float]:
        """Flat ``{series_name: value}`` view of every metric right now.

        Histograms expand into ``<name>_count`` / ``_sum`` / ``_min`` /
        ``_max`` / ``_p50`` / ``_p99`` series (reservoir quantiles).
        Callback gauges are evaluated here; a raising callback yields NaN
        rather than poisoning the whole snapshot.
        """
        out: Dict[str, float] = {}
        with self._lock:
            for (name, key), fn in list(self._gauge_fns.items()):
                try:
                    self._values.setdefault(name, {})[key] = float(fn())
                except Exception:
                    self._values.setdefault(name, {})[key] = math.nan
            for name, series in self._values.items():
                kind = self._metrics[name].kind if name in self._metrics \
                    else "untyped"
                for key, val in series.items():
                    if kind == "histogram":
                        st = val  # _HistState
                        samples = sorted(st.samples)
                        expand = {  # keys must mirror HIST_SUFFIXES
                            "_count": st.count, "_sum": st.total,
                            "_min": st.min, "_max": st.max,
                            "_p50": quantile(samples, 0.50),
                            "_p99": quantile(samples, 0.99),
                        }
                        for suffix in HIST_SUFFIXES:
                            out[format_series(name + suffix, key)] = \
                                expand[suffix]
                    else:
                        out[format_series(name, key)] = float(val)
        return out

    def counter_totals(self) -> Dict[str, float]:
        """Per-FAMILY totals of every counter (label sets summed away):
        the cheap aggregate the fleet telemetry publisher carries each
        round.  Unlike :meth:`snapshot` there is no series-name
        formatting, no histogram expansion, and no callback-gauge
        evaluation — one lock hold, one float sum per family."""
        out: Dict[str, float] = {}
        with self._lock:
            for name, series in self._values.items():
                m = self._metrics.get(name)
                if m is None or m.kind != "counter":
                    continue
                out[name] = float(sum(series.values()))
        return out

    def kinds(self) -> Dict[str, str]:
        """``{metric_name: kind}`` for export formatting."""
        with self._lock:
            return {n: m.kind for n, m in self._metrics.items()}

    def helps(self) -> Dict[str, str]:
        with self._lock:
            return {n: m.help for n, m in self._metrics.items() if m.help}


_REGISTRY: Optional[MetricsRegistry] = None
_state_lock = _lc.lock("metrics.registry._state_lock")
# set by metrics_stop(): an explicit stop must stick even when
# BLUEFOG_TPU_METRICS is set, or the next instrumented call would lazily
# resurrect the subsystem and re-attach the writer
_STOPPED = False


def metrics_start(path: Optional[str] = None) -> MetricsRegistry:
    """Install (or return) the process-global registry.

    ``path`` (or ``BLUEFOG_TPU_METRICS``) additionally attaches a JSONL
    writer — each :func:`bluefog_tpu_torch.metrics.export.step` call appends
    one snapshot line, and an atexit hook writes the final summary.
    Idempotent: a second call returns the live registry.
    """
    global _REGISTRY, _STOPPED
    with _state_lock:
        _STOPPED = False
        if _REGISTRY is None:
            _REGISTRY = MetricsRegistry()
        reg = _REGISTRY
    path = path or os.environ.get("BLUEFOG_TPU_METRICS")
    if path:
        from bluefog_tpu_torch.metrics import export

        export.attach_writer(path)
    return reg


def metrics_stop() -> None:
    """Tear down: flush and close the writer and drop the registry.  Sticky
    even under ``BLUEFOG_TPU_METRICS``: later instrumented calls do NOT
    lazily restart (which would re-attach the writer and truncate the
    just-finalized JSONL) — only an explicit :func:`metrics_start` does."""
    global _REGISTRY, _STOPPED
    from bluefog_tpu_torch.metrics import export

    export.detach_writer()
    with _state_lock:
        _REGISTRY = None
        _STOPPED = True


def current() -> Optional[MetricsRegistry]:
    """The active registry, or None when metrics are off.  Lazily honors
    ``BLUEFOG_TPU_METRICS`` exactly like the timeline env var: the first
    hook that runs after the env var is set activates the subsystem
    (unless :func:`metrics_stop` explicitly turned it off)."""
    global _REGISTRY
    if (_REGISTRY is None and not _STOPPED
            and os.environ.get("BLUEFOG_TPU_METRICS")):
        metrics_start()
    return _REGISTRY


def metrics_active() -> bool:
    return current() is not None

"""Metrics and health observability.

Counterpart of ``bluefog_tpu/metrics``: it answers **how much** at
runtime (bytes gossiped, messages per window op, achieved compression
ratio, consensus distance ``||x_i - x_bar||``, measured mixing
contraction against the spectral-gap prediction, deposit staleness,
heartbeat age), in the JAX package's series names, labels and file
formats, so an operator's tools read either package's output.

- **Off by default, one attribute load when off.**  Every hook checks
  :func:`current` (a None test) and returns at once with no registry.
- **Enable** with ``BLUEFOG_TPU_METRICS=<file.jsonl>`` (auto-start, JSONL
  per-step export, atexit summary) or with :func:`metrics_start`.
- **Host calls only.**  The JAX package's jitted hooks ride unordered
  device callbacks; the port runs eagerly, so each hook is a host call
  made once per collective call, with amounts from shapes and dtypes.
  No hook reads a device value or synchronizes.

Read the output with ``python -m bluefog_tpu_torch.metrics.dash
m.jsonl`` or scrape :func:`~bluefog_tpu_torch.metrics.export.
prometheus_text`.
"""

from bluefog_tpu_torch.metrics import comm, health
from bluefog_tpu_torch.metrics.health import MixingTracker, spectral_gap
from bluefog_tpu_torch.metrics.registry import (
    MetricsRegistry,
    current,
    metrics_active,
    metrics_start,
    metrics_stop,
)
from bluefog_tpu_torch.metrics.export import (
    MetricsWriter,
    prometheus_text,
    snapshot,
    step,
    write_prometheus,
)

__all__ = [
    "MetricsRegistry",
    "MetricsWriter",
    "MixingTracker",
    "current",
    "metrics_active",
    "metrics_start",
    "metrics_stop",
    "prometheus_text",
    "snapshot",
    "spectral_gap",
    "step",
    "write_prometheus",
]

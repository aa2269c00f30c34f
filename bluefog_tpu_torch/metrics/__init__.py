"""The port's metrics package.  So far it holds
:class:`~bluefog_tpu_torch.metrics.health.MixingTracker`, the piece the
control plane needs; the registry, its gauges and the exporters of the
JAX package's ``bluefog_tpu/metrics`` come later."""

from bluefog_tpu_torch.metrics.health import MixingTracker, spectral_gap

__all__ = ["MixingTracker", "spectral_gap"]

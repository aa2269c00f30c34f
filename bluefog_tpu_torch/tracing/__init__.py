"""Causal tracing across ranks: the wire-propagated trace context and the
critical path of each round.

Counterpart of ``bluefog_tpu/tracing/``.

- :mod:`bluefog_tpu_torch.tracing.recorder`: the span recorder of one
  process (``BLUEFOG_TPU_TRACE=<dir>``), the thread-local context, and
  the wire-encodable ``(trace_id, span_id, round)`` context the window
  server carries behind the ``FEATURE_TRACE`` HELLO bit;
- :mod:`bluefog_tpu_torch.tracing.analyze`: the analyzer (``python -m
  bluefog_tpu_torch.tracing DIR``): the causal graph across ranks, the
  phase split of each edge, the critical path of each round, the overlap
  fraction, a chrome-trace export.

The files are line for line the JAX package's format, so each package's
analyzer reads the other's trace directory.
"""

from bluefog_tpu_torch.tracing.recorder import (  # noqa: F401
    Span,
    SpanRecorder,
    configure,
    current_ctx,
    enabled,
    flush,
    get,
    reset,
    set_rank,
    span,
    trace_id_for,
    wire_ctx,
)
from bluefog_tpu_torch.tracing.analyze import (  # noqa: F401
    chrome_trace,
    critical_path,
    load_traces,
)
# the analyze() function is not re-exported: the name belongs to the
# submodule, and a package attribute shadowing its own submodule breaks
# `import bluefog_tpu_torch.tracing.analyze as ...`.  Call
# bluefog_tpu_torch.tracing.analyze.analyze(trace_dir) instead.

__all__ = [
    "Span",
    "SpanRecorder",
    "chrome_trace",
    "configure",
    "critical_path",
    "current_ctx",
    "enabled",
    "flush",
    "get",
    "load_traces",
    "reset",
    "set_rank",
    "span",
    "trace_id_for",
    "wire_ctx",
]

"""Communication instrumentation hooks.

Counterpart of ``bluefog_tpu/metrics/comm.py``, with its series names,
labels and byte convention.  The JAX package's jitted hooks ride an
unordered ``io_callback`` that fires once per local device per execution
of the compiled step.  The port runs eagerly, so every hook here is a
plain host call made once per collective call: the amounts come from the
tensors' shapes and dtypes (``numel() * element_size()``), never from a
device value, so a hook causes no ``.item()`` and no synchronize.  With
metrics off each hook costs one attribute load (:func:`current` returns
None) and returns its input unchanged.

Byte accounting convention (the JAX package's): ``bytes`` is what *one
rank* ships per round (payload bytes x out-slots), and the JAX callback
fires once per device, so a counter sums over the ranks the process
hosts.  Here one call covers the ``m`` rank rows this process holds, and
:func:`record_collective` takes ``ranks=m``: it adds ``m`` rounds and
``m`` times the per-rank bytes and messages, so a series reads the same
in both packages for the same schedule and tree.

``backend`` keeps the JAX package's vocabulary, so an operator's
dashboards read either package: the port's ``'kernel'`` route (K1, the
hand-written gossip kernel) is labelled ``"pallas"`` and its ``'plain'``
route ``"xla"`` (:func:`backend_label`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

from bluefog_tpu_torch.metrics import registry as _reg

__all__ = [
    "backend_label",
    "record_collective",
    "count",
    "inc",
    "observe",
    "set",
    "suppress_comm_metrics",
    "tree_bytes",
    "tree_leaf_count",
]

Number = Union[int, float]

#: the port's gossip routes -> the JAX package's ``backend`` label values
_BACKEND_LABELS = {"kernel": "pallas", "plain": "xla"}

_suppress = threading.local()


def backend_label(route: str) -> str:
    """The ``backend`` label of a port route: ``'kernel'`` -> ``"pallas"``,
    ``'plain'`` -> ``"xla"`` (other values pass through)."""
    return _BACKEND_LABELS.get(route, route)


@contextlib.contextmanager
def suppress_comm_metrics():
    """Hooks are the identity inside this block.  A wrapper that runs an
    inner collective (the dynamic gossip's taken schedule) uses it so the
    call records ONE round, with the outer call's labels."""
    prev = getattr(_suppress, "on", False)
    _suppress.on = True
    try:
        yield
    finally:
        _suppress.on = prev


def _suppressed() -> bool:
    return getattr(_suppress, "on", False)


def _leaves(x):
    # torch is imported here, not with the module: the launcher and the
    # supervisor record their counters without loading torch
    from torch.utils import _pytree as pytree

    return [l for l in pytree.tree_leaves(x)
            if hasattr(l, "element_size") or hasattr(l, "itemsize")]


def tree_bytes(x) -> int:
    """Payload size of a pytree of tensors (or numpy arrays), from shapes
    and dtypes only."""
    total = 0
    for leaf in _leaves(x):
        if hasattr(leaf, "element_size"):
            total += int(leaf.numel()) * int(leaf.element_size())
        else:
            total += int(leaf.size) * int(leaf.itemsize)
    return total


def tree_leaf_count(x) -> int:
    return len(_leaves(x))


def count(x, counters: Sequence[Tuple[str, Number]],
          labels: Optional[Dict[str, object]] = None):
    """Increment ``counters`` (``(name, amount)`` pairs) once, returning
    ``x`` unchanged; the identity when metrics are off or suppressed."""
    reg = _reg.current()
    if reg is None or _suppressed() or not counters:
        return x
    lbls = {str(k): str(v) for k, v in (labels or {}).items()}
    for name, amount in counters:
        reg.counter(name).inc(float(amount), **lbls)
    return x


def record_collective(x, *, op: str, bytes_per_round, messages_per_round,
                      schedule: str = "", backend: str = "",
                      chunks: int = 0, ranks: int = 1,
                      extra: Optional[Dict[str, object]] = None):
    """Record one communication round of each of ``ranks`` ranks:
    ``bf_comm_rounds_total`` += ``ranks``, ``bf_comm_bytes_total`` +=
    ``ranks * bytes_per_round``, ``bf_comm_messages_total`` += ``ranks *
    messages_per_round``, labelled by ``op``/``schedule``/``backend``.
    ``chunks`` (the kernel launches one rank's round takes) adds ``ranks *
    chunks`` to ``bf_comm_pallas_chunks_total``: the port's K1 route
    launches once per leaf and never splits a leaf, so a call's chunks
    are its leaves.  Returns ``x`` unchanged; the identity when metrics
    are off."""
    reg = _reg.current()
    if reg is None or _suppressed():
        return x
    counters = [
        ("bf_comm_rounds_total", ranks),
        ("bf_comm_bytes_total", ranks * bytes_per_round),
        ("bf_comm_messages_total", ranks * messages_per_round),
    ]
    if chunks:
        counters.append(("bf_comm_pallas_chunks_total", ranks * chunks))
    labels: Dict[str, object] = {"op": op}
    if schedule:
        labels["schedule"] = schedule
    if backend:
        labels["backend"] = backend
    if extra:
        labels.update(extra)
    return count(x, counters, labels)


# ---------------------------------------------------------------------------
# Host-path conveniences
# ---------------------------------------------------------------------------


def inc(name: str, amount: Number = 1.0, **labels) -> None:
    reg = _reg.current()
    if reg is not None:
        reg.counter(name).inc(amount, **labels)


def observe(name: str, value: Number, **labels) -> None:
    reg = _reg.current()
    if reg is not None:
        reg.histogram(name).observe(value, **labels)


def set(name: str, value: Number, **labels) -> None:  # noqa: A001: mirrors Gauge.set
    reg = _reg.current()
    if reg is not None:
        reg.gauge(name).set(value, **labels)

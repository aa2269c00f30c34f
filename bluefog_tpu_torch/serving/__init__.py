"""Serve-while-training read fabric (the window transport's read path).

Counterpart of ``bluefog_tpu/serving``.  The tier that serves a
continuously gossiping fleet's live model while it trains:

- :mod:`bluefog_tpu_torch.serving.snapshots`: the publish primitive, a
  process-global, double-buffered :class:`~bluefog_tpu_torch.serving.
  snapshots.SnapshotTable` the dsgd loops publish round-stamped ``(round,
  x, p)`` snapshots into, served over the wire by every
  :class:`~bluefog_tpu_torch.runtime.window_server.WindowServer` in the
  process (``SNAPSHOT`` / ``SUBSCRIBE`` ops).
- :mod:`bluefog_tpu_torch.serving.client`: :class:`SnapshotClient`, pull
  one round-consistent snapshot (bounded retries, round pinning, torn-read
  recovery).
- :mod:`bluefog_tpu_torch.serving.subscriber`: :class:`Subscriber`, "push
  me every Nth round", resumable across disconnects through a client-held
  cursor and the stream-epoch pattern.
- :mod:`bluefog_tpu_torch.serving.replica`: :class:`ServingReplica`, a
  subscriber that de-biases ``z = x / p`` into model parameters on the
  template's device and tracks its own staleness, the shape a prediction
  server embeds.

Consistency contract: every snapshot a reader ever holds is all of one
round, and every retriable failure (round rolled, torn frame, reconnect)
is loud and bounded.

This ``__init__`` loads only the snapshot table (the training side's
dependency); the client, subscriber and replica classes load lazily.
"""

from bluefog_tpu_torch.serving.snapshots import (RoundRolled, SnapshotTable,
                                                 SnapshotUnavailable, table)

__all__ = [
    "RoundRolled",
    "Snapshot",
    "SnapshotClient",
    "SnapshotTable",
    "SnapshotUnavailable",
    "ServingReplica",
    "ShardedServingReplica",
    "Subscriber",
    "table",
]

_LAZY = {
    "Snapshot": "bluefog_tpu_torch.serving.client",
    "SnapshotClient": "bluefog_tpu_torch.serving.client",
    "Subscriber": "bluefog_tpu_torch.serving.subscriber",
    "ServingReplica": "bluefog_tpu_torch.serving.replica",
    "ShardedServingReplica": "bluefog_tpu_torch.serving.replica",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)

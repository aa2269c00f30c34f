"""Snapshot relay trees with delta encoding: the read path at scale.

Counterpart of ``bluefog_tpu/relay``.  A
:class:`~bluefog_tpu_torch.relay.node.RelayNode` subscribes upstream like
any reader, lands frames into its own :class:`~bluefog_tpu_torch.serving.
snapshots.SnapshotTable`, and re-publishes to its own subscribers, so
read capacity multiplies per tier while the trainer pays for a few
readers only.  What the tree keeps, hop by hop:

- **round-stamped consistency**: a re-published snapshot keeps the
  trainer's round stamp; each hop is a full publish into a
  double-buffered table;
- **strictly increasing delivery**: each hop's cursor discipline plus the
  land path's forward guard; the children of a killed relay resume or
  re-parent with nothing missed or duplicated;
- **measured staleness**: it adds per tier (each hop's skip-to-latest
  backlog);
- **delta wire economy**: wire op 10 pushes round-over-round differences
  (:mod:`bluefog_tpu_torch.runtime.delta`), with a full snapshot every
  Nth round as the resync anchor and on every cursor gap.

Degree and delta cadence are the control plane's
:class:`~bluefog_tpu_torch.control.tree.TreePlan`, actuated through
:meth:`RelayNode.apply_plan` at round boundaries.  Run a standalone relay
with ``python -m bluefog_tpu_torch.relay``.
"""

from bluefog_tpu_torch.relay.node import RelayNode

__all__ = ["RelayNode"]

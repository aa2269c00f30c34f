"""Self-tuning communication control plane: telemetry in, behaviour out.

Counterpart of ``bluefog_tpu/control``.  It closes the loop from the
runtime's telemetry to its behaviour:

- :class:`~bluefog_tpu_torch.control.controller.CommController`: a
  per-rank controller fed by the telemetry the runtime already produces
  (the :class:`~bluefog_tpu_torch.metrics.health.MixingTracker`'s
  measured-against-predicted contraction, consensus disagreement, peer
  health states, the deposit streams' ack EWMA and reconnect counters),
  emitting a round-stamped :class:`~bluefog_tpu_torch.control.plan.
  CommPlan`;
- evidence is disseminated without a coordinator: barrier-directory
  ``ctlev.<rank>`` records across processes, an in-process
  :class:`~bluefog_tpu_torch.control.evidence.EvidenceBoard` across
  threads;
- decisions are deterministic functions of the disseminated evidence,
  with hysteresis and cooldowns, so every rank converges on the same plan
  (byte-identical) and oscillating telemetry cannot flap it;
- actuation happens only at round boundaries, so the exact push-sum mass
  audit holds through every plan change.

Wire the controller into a run with ``control=ControlConfig(...)`` of
:func:`~bluefog_tpu_torch.runtime.async_windows.run_async_dsgd` or
:func:`~bluefog_tpu_torch.runtime.async_windows.run_async_dsgd_rank`, and
the transport autotuner with ``stream_options=dict(transport_tuning=
True)`` of the latter.
"""

from bluefog_tpu_torch.control.controller import (CommController,
                                                  decide_plan,
                                                  plan_topology)
from bluefog_tpu_torch.control.evidence import (Evidence, EvidenceBoard,
                                                canonicalize,
                                                clear_evidence,
                                                read_evidence,
                                                write_evidence)
from bluefog_tpu_torch.control.plan import (CODEC_LADDER, CommPlan,
                                            ControlConfig)
from bluefog_tpu_torch.control.transport import (TransportConfig,
                                                 TransportPlan,
                                                 decide_transport_plan)
from bluefog_tpu_torch.control.tree import (TreeConfig, TreeEvidence,
                                            TreePlan, decide_tree_plan,
                                            tree_capacity)

__all__ = [
    "CODEC_LADDER",
    "CommController",
    "CommPlan",
    "ControlConfig",
    "Evidence",
    "EvidenceBoard",
    "TransportConfig",
    "TransportPlan",
    "TreeConfig",
    "TreeEvidence",
    "TreePlan",
    "canonicalize",
    "clear_evidence",
    "decide_plan",
    "decide_transport_plan",
    "decide_tree_plan",
    "plan_topology",
    "read_evidence",
    "tree_capacity",
    "write_evidence",
]

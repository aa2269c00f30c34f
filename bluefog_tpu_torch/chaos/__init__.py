"""Deterministic fault injection for peer-fault-tolerance tests.

Counterpart of ``bluefog_tpu/chaos``: a seedable, counter-driven fault
injector whose shims sit at the choke points the resilience layer
defends.

- **Socket faults** at the TCP window transport
  (:mod:`bluefog_tpu_torch.runtime.window_server`): drop or truncate a
  frame, delay or stall a connection, and drop the connection after a
  batch applied but before its ack left, the ambiguity the stream-epoch
  replay protocol exists to resolve (sites ``server``, ``ack``,
  ``client``); cut, tear or stall a sync-read reply (``read``).
- **Process faults** for multi-process runs: SIGKILL or SIGSTOP a rank
  at a deterministic step or wall-clock offset (a SIGSTOPped process
  arranges its own SIGCONT through a small helper child).
- **Thread faults** for the in-process rank loops
  (:func:`~bluefog_tpu_torch.runtime.async_windows.run_async_dsgd`):
  ``die`` raises :class:`ChaosKill` inside the rank loop (the thread
  analog of SIGKILL), ``stall`` freezes the loop for a fixed time, and
  ``leave``/``join`` drive membership churn.

Faults are configured with ``BLUEFOG_TPU_CHAOS=<spec>`` (read lazily, the
JAX package's variable, so one spec drives both runtimes in a mixed
job), with :func:`configure`, or by wrapping a command with ``python -m
bluefog_tpu_torch.chaos --spec SPEC -- cmd ...``.  Everything is
deterministic given the same traffic: triggers count frames and steps,
and probabilistic rules draw from a per-rule seeded RNG.  The grammar is
defined once, in :mod:`bluefog_tpu_torch.chaos.spec`.

Examples::

    server:drop:after_frames=40        # cut the connection at frame 40
    ack:drop:after_frames=3            # apply batch 3, drop before ack
    client:truncate:after_frames=5     # send half a frame, then cut
    server:delay:ms=20:prob=0.1:seed=7 # 10% of frames delayed 20 ms
    server:drop:rate=0.05:seed=3       # a 5%-loss lossy link (seeded)
    read:truncate:every=7              # tear every 7th read reply mid-frame
    sub:stall:s=1:every=13             # stall every 13th snapshot push 1 s
    rank2:sigkill:at_step=8            # rank 2 SIGKILLs itself at step 8
    rank1:sigstop:after_s=0.8:for_s=1  # freeze rank 1 for 1 s
    rank2:die:at_step=8                # thread-mode death (ChaosKill)
    rank1:stall:at_step=6:s=1.5        # thread-mode freeze/thaw
    rank1:leave:at_step=20             # graceful drain at step 20 (ChaosLeave)
    rank3:join:after_s=0.5             # rank 3 attaches to the job at t=0.5s
    rank3:join:after_s=0.5;rank3:leave:at_step=10;rank3:join:after_s=2
                                       # a flapping joiner: join, drain, rejoin
"""

from bluefog_tpu_torch.chaos.injector import (
    ChaosKill,
    ChaosLeave,
    ChaosSpecError,
    Injector,
    Rule,
    arm,
    check_step,
    configure,
    enabled,
    fire,
    get,
    join_times,
    parse_spec,
    reset,
)

__all__ = [
    "ChaosKill",
    "ChaosLeave",
    "ChaosSpecError",
    "Injector",
    "Rule",
    "arm",
    "check_step",
    "configure",
    "enabled",
    "fire",
    "get",
    "join_times",
    "parse_spec",
    "reset",
]

"""Host-side introspection: what a step communicated, and what it cost.

Counterpart of ``bluefog_tpu/utils/inspect.py``.  The JAX package answers
"what did my training step communicate?" by compiling the step and
counting the collective instructions in its optimized HLO.  The port runs
eagerly and has no compiled program to read, so :func:`collective_census`
runs the step once and counts what it did: the collective **calls** it
made, each hand-written kernel wrapper's **calls** and **launches**, and
the mesh-axis collectives' statistics.  It counts calls and kernel
launches, not HLO instructions: a fused gossip of three buffers is one
``neighbor_allreduce`` call and three K1 launches.

:func:`compiled_flops` counts the floating-point operations of one run
with ``torch.utils.flop_counter.FlopCounterMode`` (XLA's cost analysis in
the JAX package).

The JAX package's ``collective_overlap_report`` and
``parse_overlap_windows`` read the ``-start``/``-done`` windows of async
collectives in compiled HLO text.  They have no counterpart here: an eager
PyTorch step has no compiled schedule to read, and its overlap is a
property of CUDA streams, which ``torch.profiler`` shows.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["collective_census", "compiled_flops", "kernel_counters"]


def kernel_counters() -> Dict[str, Dict[str, int]]:
    """``{wrapper: {"calls": c, "launches": l}}`` of K1-K3's wrappers so
    far: ``calls`` counts every call, ``launches`` the CUDA launches (a
    CPU tensor's call runs the plain version and launches nothing)."""
    from bluefog_tpu_torch.ops import deliver_kernel as _k2
    from bluefog_tpu_torch.ops import flash_kernel as _k3
    from bluefog_tpu_torch.ops import gossip_kernel as _k1

    out = {}
    for mod in (_k1, _k2, _k3):
        for name, calls in mod.CALLS.items():
            out[name] = {"calls": int(calls),
                         "launches": int(getattr(mod, name).launches)}
    return out


def _axis_stats() -> Dict[str, Dict[str, float]]:
    from bluefog_tpu_torch.parallel.axes import COLLECTIVE_STATS

    return {k: dict(v) for k, v in COLLECTIVE_STATS.items()}


def collective_census(fn, *args, **kwargs) -> Dict[str, Dict]:
    """Run ``fn(*args, **kwargs)`` once and count what it communicated:

    - ``"calls"``: ``{op: n}``, the collectives and window ops it called
      (``neighbor_allreduce``, ``allreduce``, ``win_put``, ...);
    - ``"kernels"``: ``{wrapper: {"calls": c, "launches": l}}`` of K1-K3;
    - ``"axes"``: ``{collective: {stat: delta}}`` of the mesh-axis
      collectives (:data:`~bluefog_tpu_torch.parallel.axes.
      COLLECTIVE_STATS`: calls, bytes, host seconds).

    Zero entries are left out.  These are calls and launches counted on
    the host while ``fn`` runs, not instructions of a compiled program.
    Other threads' collectives in the same window would be counted too."""
    from bluefog_tpu_torch.blackbox import recorder as _bb

    calls0, k0, ax0 = _bb.collective_calls(), kernel_counters(), _axis_stats()
    fn(*args, **kwargs)
    calls1, k1, ax1 = _bb.collective_calls(), kernel_counters(), _axis_stats()
    calls = {op: n - calls0.get(op, 0) for op, n in calls1.items()
             if n - calls0.get(op, 0)}
    kernels = {}
    for name, c in k1.items():
        d = {key: c[key] - k0[name][key] for key in c}
        if any(d.values()):
            kernels[name] = d
    axes = {}
    for name, stats in ax1.items():
        before = ax0.get(name, {})
        d = {key: v - before.get(key, 0) for key, v in stats.items()}
        if any(d.values()):
            axes[name] = d
    return {"calls": calls, "kernels": kernels, "axes": axes}


def compiled_flops(fn, *args, **kwargs) -> float:
    """Floating-point operations of one run of ``fn(*args, **kwargs)``,
    counted by ``torch.utils.flop_counter.FlopCounterMode`` (a matmul of
    ``(m, k) @ (k, n)`` counts ``2 m n k``)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())

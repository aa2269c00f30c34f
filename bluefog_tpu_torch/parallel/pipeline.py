"""Pipeline parallelism over a mesh axis of virtual ranks: GPipe and 1F1B.

Counterpart of ``bluefog_tpu/parallel/pipeline.py``.  In the JAX package each
``pp`` device holds its stage's block of layers, a ``lax.scan`` runs the
ticks, and one ``lax.ppermute`` hop hands every stage's output to the next.
Here the stages are virtual (:mod:`bluefog_tpu_torch.parallel.axes`): the
stage axis is the **leading** dimension of the stage parameters and of the
activations (``(S, *rest, micro_batch, ...)``, where ``rest`` are the other
mesh axes of the group, e.g. ``tp``), a tick applies ``stage_fn`` to every
stage at once, and the hop is a :func:`~bluefog_tpu_torch.parallel.axes.
ppermute` along that dimension.

- **GPipe** (:func:`pipeline_apply` and autograd through it,
  :func:`pipeline_train_step_gpipe`): the backward is autograd through the
  ticks; every microbatch's activations live until its backward (with
  ``remat``, only each stage's inputs, the stage recomputed).
- **1F1B** (:func:`pipeline_train_step_1f1b`): stage ``s`` runs the forward
  of microbatch ``m`` at tick ``s + 2m`` and its backward at ``2S - 1 - s +
  2m``, recomputing the stage from a ``min(S, M)``-slot stash of its inputs.
  Each tick gathers the stages on the forward rail into one batch and those
  on the backward rail into another, so a stage runs only its own rail's
  work, as the reference's runtime ``lax.cond`` does.

Embedding and head sit at the rim, as in the reference: embed the
microbatches before injection (``collect_input_grads`` gives the cotangents
to chain into the embedding's backward) and fold the head into
``loss_fn(head_params, y, target)``.  Microbatches and targets are given
once, microbatch-major (``(M, *rest, micro_batch, ...)``), and only stage 0
reads them.  What the reference returns per device and valid on one stage
(the loss and head gradients on the last, the input gradients on the first)
is returned here as that stage's value.

Over processes (``bfrun``) the stage axis may span them
(:meth:`~bluefog_tpu_torch.parallel.axes.Mesh.axis`): each process runs the
ticks of the stages it holds, and the hops go through
:func:`~bluefog_tpu_torch.parallel.axes.ppermute` across the processes, as
``shard_map`` runs every stage's program: 1F1B hands each tick's messages
on both rails in one ``ppermute`` each way, zeros where a stage sends
nothing; GPipe's last-stage outputs are a stand-in row where the last stage
is not held, weighed by zero in the loss, so that every process runs the
backward of every hop.

The reference's ``bf_pipeline_bubble_fraction`` gauge comes with the port of
its metrics package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from bluefog_tpu_torch.parallel import axes as ax
from bluefog_tpu_torch.parallel.axes import Axis
from bluefog_tpu_torch.sharding.rules import PartitionSpec, named_tree_map

__all__ = [
    "stack_stage_params",
    "stage_param_specs",
    "pipeline_apply",
    "pipeline_spmd_axis_perm",
    "pipeline_train_step_1f1b",
    "pipeline_train_step_gpipe",
]


def stack_stage_params(per_layer_params, num_stages: int):
    """Regroup a tree of per-layer-stacked tensors (leading dimension ``L``)
    into per-stage blocks ``(num_stages, L // num_stages, ...)``."""

    def regroup(leaf):
        n_layers = leaf.shape[0]
        if n_layers % num_stages:
            raise ValueError(f"{n_layers} layers not divisible by "
                             f"{num_stages} stages")
        return leaf.reshape(num_stages, n_layers // num_stages,
                            *leaf.shape[1:])

    return pytree.tree_map(regroup, per_layer_params)


def stage_param_specs(rule_table, stacked_params, *, pp_axis: str = "pp"):
    """Each :func:`stack_stage_params` leaf's spec through the rule table:
    the stage dimension over ``pp_axis``, the layer dimension replicated,
    the rest as the table resolves the leaf's within-stage shape."""

    def spec_of(name, leaf):
        inner = rule_table.resolve(name, tuple(int(s)
                                               for s in leaf.shape[2:]))
        return PartitionSpec(pp_axis, None, *tuple(inner))

    return named_tree_map(spec_of, stacked_params)


def pipeline_spmd_axis_perm(num_stages: int):
    """The stage-to-next-stage edges (linear: the last stage's output falls
    off the end)."""
    return [(i, i + 1) for i in range(num_stages - 1)]


def _check_axis(axis: Axis) -> None:
    if axis.dim != 0:
        raise ValueError(f"the stage axis {axis.name!r} must lead (dim 0), "
                         f"got dim {axis.dim}")


def pipeline_apply(stage_fn: Callable, stage_params, microbatches, *,
                   axis: Axis, num_micro: Optional[int] = None
                   ) -> torch.Tensor:
    """Run microbatches through the pipeline (reference
    ``pipeline.py::pipeline_apply``): ``num_micro + S - 1`` ticks, stage 0
    injecting microbatch ``t`` at tick ``t``, every stage applying
    ``stage_fn(stage_params, x)`` to what it holds and handing the result
    to the next.  Returns the last stage's ``(num_micro, *rest, micro_batch,
    ...)`` outputs (it emits microbatch ``m`` at tick ``m + S - 1``)."""
    _check_axis(axis)
    if num_micro is None:
        num_micro = microbatches.shape[0]
    n_stages, held = axis.size, axis.local_ranks()
    perm = pipeline_spmd_axis_perm(n_stages)
    incoming = torch.zeros((axis.local, *microbatches.shape[1:]),
                           dtype=microbatches.dtype,
                           device=microbatches.device)
    # the last stage's row; a process without it emits its last row, which
    # the train step weighs by zero (every process runs the same hops)
    last = (n_stages - 1 - held.start if n_stages - 1 in held
            else axis.local - 1)
    outs = []
    for t in range(num_micro + n_stages - 1):
        inject = microbatches[min(t, num_micro - 1)]
        x = (torch.cat([inject[None].to(incoming.dtype), incoming[1:]])
             if held.start == 0 else incoming)
        y = stage_fn(stage_params, x)
        outs.append(y[last])
        incoming = ax.ppermute(y, axis, perm)
    return torch.stack(outs[n_stages - 1:])


def _hop(msgs, axis: Axis, step: int, like: torch.Tensor):
    """Over processes: each held stage's message ``msgs[s]`` (or zeros) to
    stage ``s + step``, through one ``ppermute`` every process makes;
    returns the messages the held stages received, by stage."""
    n, held = axis.size, axis.local_ranks()
    out = torch.zeros((axis.local, *like.shape), dtype=like.dtype,
                      device=like.device)
    for s in held:
        if msgs[s] is not None:
            out[s - held.start] = msgs[s]
    perm = [(i, i + step) for i in range(n) if 0 <= i + step < n]
    got = ax.ppermute(out, axis, perm)
    return [got[s - held.start] if s in held and 0 <= s - step < n else None
            for s in range(n)]


def _rows(leaves, rows):
    return [leaf.detach().index_select(0, rows).requires_grad_()
            for leaf in leaves]


def pipeline_train_step_1f1b(stage_fn: Callable, stage_params, microbatches,
                             targets, loss_fn: Callable, *, axis: Axis,
                             head_params=None,
                             collect_input_grads: bool = False):
    """One 1F1B training step (reference ``pipeline.py::
    pipeline_train_step_1f1b``; schedule in the module docstring).

    ``stage_params``: a tree of ``(S, ...)`` stage blocks; ``microbatches``
    ``(M, *rest, micro_batch, ...)``, already embedded; ``targets`` ``(M,
    ...)``; ``loss_fn(head_params, y, target) -> scalar`` runs on the last
    stage only.  Returns ``(loss_sum, stage_grads, head_grads,
    input_grads)``: the last stage's summed loss (f32), the ``(S, ...)``
    gradients of every stage's block (accumulated in f32, returned in the
    parameters' dtypes), the head's gradients, and with
    ``collect_input_grads`` the ``(M, ...)`` cotangents of the microbatches
    (stage 0's), else None."""
    _check_axis(axis)
    n_stages, n_micro = axis.size, microbatches.shape[0]
    held, crossing = axis.local_ranks(), axis.spans_processes
    slots = min(n_stages, n_micro)
    head_params = {} if head_params is None else head_params
    leaves, spec = pytree.tree_flatten(stage_params)
    h_leaves, h_spec = pytree.tree_flatten(head_params)
    h_vars = [h.detach().requires_grad_() for h in h_leaves]
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves]
    h_acc = [torch.zeros(h.shape, dtype=torch.float32, device=h.device)
             for h in h_leaves]
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=microbatches.device)
    stash = [[None] * slots for _ in range(n_stages)]
    fwd_msg, bwd_msg = [None] * n_stages, [None] * n_stages
    dx_buf = [None] * n_micro
    dev = microbatches.device
    for t in range(2 * (n_micro + n_stages - 1)):
        fwd, bwd = [], []
        for s in held:
            df, db = t - s, t - (2 * n_stages - 1 - s)
            if df >= 0 and df % 2 == 0 and df // 2 < n_micro:
                fwd.append((s, df // 2))
            if db >= 0 and db % 2 == 0 and db // 2 < n_micro:
                bwd.append((s, db // 2))
        new_fwd, new_bwd = [None] * n_stages, [None] * n_stages
        if fwd:
            rows = torch.tensor([s - held.start for s, _ in fwd], device=dev)
            x_in = torch.stack([microbatches[m] if s == 0 else fwd_msg[s]
                                for s, m in fwd])
            with torch.no_grad():
                y = stage_fn(pytree.tree_unflatten(
                    [p.index_select(0, rows) for p in leaves], spec), x_in)
            for i, (s, m) in enumerate(fwd):
                stash[s][m % slots] = x_in[i]
                if s + 1 < n_stages:
                    new_fwd[s + 1] = y[i]
        if bwd:
            rows = torch.tensor([s - held.start for s, _ in bwd], device=dev)
            p_vars = _rows(leaves, rows)
            x_saved = torch.stack([stash[s][m % slots]
                                   for s, m in bwd]).requires_grad_()
            with torch.enable_grad():
                y = stage_fn(pytree.tree_unflatten(p_vars, spec), x_saved)
                dy = []
                for i, (s, m) in enumerate(bwd):
                    if s != n_stages - 1:
                        dy.append(bwd_msg[s])
                        continue
                    y_last = y[i].detach().requires_grad_()
                    loss_m = loss_fn(pytree.tree_unflatten(h_vars, h_spec),
                                     y_last, targets[m])
                    *dh, dy_last = torch.autograd.grad(
                        loss_m, h_vars + [y_last], allow_unused=True)
                    for a, g in zip(h_acc, dh):
                        if g is not None:
                            a += g.float()
                    loss_acc = loss_acc + loss_m.detach().float()
                    dy.append(dy_last.to(y.dtype))
                grads = torch.autograd.grad(y, p_vars + [x_saved],
                                            torch.stack(dy),
                                            allow_unused=True)
            for a, g in zip(g_acc, grads[:-1]):
                if g is not None:
                    a.index_add_(0, rows, g.float())
            dx = grads[-1]
            for i, (s, m) in enumerate(bwd):
                if s > 0:
                    new_bwd[s - 1] = dx[i]
                elif collect_input_grads:
                    dx_buf[m] = dx[i]
        if crossing:
            # the hops between stages held by different processes (every
            # message travels the hop; a stage reads one only when due)
            like = microbatches[0]
            new_fwd = _hop([new_fwd[s + 1] if s + 1 < n_stages else None
                            for s in range(n_stages)], axis, 1, like)
            new_bwd = _hop([new_bwd[s - 1] if s > 0 else None
                            for s in range(n_stages)], axis, -1, like)
        fwd_msg, bwd_msg = new_fwd, new_bwd
    stage_grads = pytree.tree_unflatten(
        [a.to(p.dtype) for a, p in zip(g_acc, leaves)], spec)
    head_grads = pytree.tree_unflatten(
        [a.to(h.dtype) for a, h in zip(h_acc, h_leaves)], h_spec)
    dxs = None
    if collect_input_grads:
        dxs = (torch.stack(dx_buf) if 0 in held
               else torch.zeros_like(microbatches))
    return loss_acc, stage_grads, head_grads, dxs


def pipeline_train_step_gpipe(stage_fn: Callable, stage_params, microbatches,
                              targets, loss_fn: Callable, *, axis: Axis,
                              head_params=None,
                              collect_input_grads: bool = False,
                              remat: bool = False):
    """GPipe counterpart of :func:`pipeline_train_step_1f1b`, with its
    signature and return contract: the backward is autograd through
    :func:`pipeline_apply`; ``remat`` checkpoints ``stage_fn`` (with the
    stage parameters as explicit inputs), so only each stage's inputs stay
    live."""
    _check_axis(axis)
    head_params = {} if head_params is None else head_params
    leaves, spec = pytree.tree_flatten(stage_params)
    h_leaves, h_spec = pytree.tree_flatten(head_params)
    p_vars = [p.detach().requires_grad_() for p in leaves]
    h_vars = [h.detach().requires_grad_() for h in h_leaves]
    mb = microbatches.detach().requires_grad_(collect_input_grads)

    def sfn(sp, x):
        if not remat:
            return stage_fn(sp, x)
        flat = pytree.tree_leaves(sp)
        return checkpoint(
            lambda x, *flat: stage_fn(pytree.tree_unflatten(list(flat), spec),
                                      x),
            x, *flat, use_reentrant=False)

    with torch.enable_grad():
        outs = pipeline_apply(sfn, pytree.tree_unflatten(p_vars, spec), mb,
                              axis=axis)
        head = pytree.tree_unflatten(h_vars, h_spec)
        loss = sum(loss_fn(head, outs[m], targets[m]).float()
                   for m in range(outs.shape[0]))
        if axis.size - 1 not in axis.local_ranks():
            loss = loss * 0.0       # a stand-in row: see pipeline_apply
        wrt = p_vars + h_vars + ([mb] if collect_input_grads else [])
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for g, w in zip(grads, wrt)]
    n = len(p_vars)
    stage_grads = pytree.tree_unflatten(grads[:n], spec)
    head_grads = pytree.tree_unflatten(grads[n:n + len(h_vars)], h_spec)
    dxs = grads[-1] if collect_input_grads else None
    return loss.detach(), stage_grads, head_grads, dxs

"""Tensor (Megatron) parallelism over a mesh axis of virtual ranks.

Counterpart of ``bluefog_tpu/parallel/tensor.py``.  The JAX package runs a
tensor-parallel model inside ``shard_map``: each device holds its local block
of every parameter (a shard of a sharded leaf, a copy of a replicated one),
and the row-parallel layers ``psum`` over the ``'tp'`` axis.  Here the
devices are virtual (:mod:`bluefog_tpu_torch.parallel.axes`): every
parameter is one tensor ``(*mesh.shape, *local)`` holding each rank's block
on the mesh's leading dimensions, activations carry the same leading
dimensions, and the ``psum`` is a sum over the axis's dimension.  A
parameter's ``partition`` attribute (one entry per local dimension: an axis
name or ``None``; flax's ``names``, a word PyTorch's named tensors take)
plays the part of flax's ``nn.Partitioned`` box.  Names and
layouts are flax's (``block_0/qkv_kernel`` ``(in, 3, local)``,
``block_0/up/kernel`` ``(in, out)``, ``tok/embedding``), so the JAX
package's rule table resolves the port's parameters unchanged and
:mod:`bluefog_tpu_torch.convert` only splits the sharded dimension.

**Gradient convention.**  A JAX train step differentiates each device's loss
*inside* ``shard_map``: the transpose of the forward ``psum`` is a ``psum``,
so the raw gradient of a tp-sharded leaf is ``tp`` times the true one, and a
replicated leaf's raw gradient sees only its own shard's path.  The port's
raw gradients are the autograd gradients of the *sum over ranks* of the
per-rank losses with respect to the stacked parameters: the backward of
:func:`~bluefog_tpu_torch.parallel.axes.psum` is again a sum over the axis,
so they are, rank by rank, the JAX package's raw gradients.  The correction
is then the JAX package's (:func:`tp_correct_grads`):

    sharded leaf:    g / tp_size
    replicated leaf: pmean(g, tp_axis)

and :func:`tp_value_and_grad` applies it.  What it returns is each rank's
true gradient: the sharded leaves' true shard, the replicated leaves' full
gradient on every rank of the axis.

Over processes the stacked tensors hold the mesh positions this process
owns; when the ``tp`` axis spans processes (``Mesh.axis`` says so), the
``psum`` of the row-parallel layers and the correction's ``pmean`` go
through the transport (:mod:`~bluefog_tpu_torch.parallel.axes`), and the
parameters are placed from full leaves by
:func:`~bluefog_tpu_torch.sharding.make_shard_and_gather_fns` under
:func:`tp_param_rules`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch.models.transformer import GPTConfig, _TRUNC_STD
from bluefog_tpu_torch.ops.ring_attention import local_attention
from bluefog_tpu_torch.parallel import axes as ax
from bluefog_tpu_torch.parallel.axes import Axis, Mesh, make_hybrid_mesh
from bluefog_tpu_torch.parallel.rng import fold_axis_rng, sharded_init
from bluefog_tpu_torch.sharding.rules import (
    PartitionSpec as P, RuleTable, norm_spec, spec_mentions)

__all__ = [
    "make_hybrid_mesh",
    "fold_axis_rng",
    "column_parallel_dense",
    "row_parallel_dense",
    "ColumnParallelDense",
    "RowParallelDense",
    "TPBlock",
    "TPTransformerLM",
    "tp_value_and_grad",
    "tp_correct_grads",
    "tp_param_rules",
    "box_specs",
    "check_rule_agreement",
    "PartitionDisagreement",
    "gather_tp_params",
    "unbox_params",
]


# --- stacked-parameter arithmetic -------------------------------------------

def _matmul(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``x (*lead, ..., in) @ kernel (*lead, in, out)`` rank by rank."""
    nl = kernel.dim() - 2
    y = torch.matmul(x.flatten(nl, -2), kernel)
    return y.unflatten(nl, x.shape[nl:-1])


def _bias(b: torch.Tensor, like: torch.Tensor, local: int = 1
          ) -> torch.Tensor:
    """A stacked ``(*lead, *local)`` parameter viewed to broadcast against
    ``like (*lead, ..., *local)``."""
    nl = b.dim() - local
    return b.reshape(*b.shape[:nl], *([1] * (like.dim() - b.dim())),
                     *b.shape[nl:])


def _layer_norm(x, scale, bias, eps: float = 1e-6) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)`` with stacked scale and bias."""
    y = F.layer_norm(x.float(), x.shape[-1:], eps=eps)
    return y * _bias(scale, y) + _bias(bias, y)


def _embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of a stacked ``(*lead, V, C)`` table for ``(*lead, ...)`` ids."""
    nl = table.dim() - 2
    if nl == 0:
        return F.embedding(ids, table)
    g = math.prod(table.shape[:nl])
    flat = ids.reshape(g, -1)
    rows = torch.arange(g, device=ids.device)[:, None]
    out = table.reshape(g, *table.shape[nl:])[rows, flat]
    return out.reshape(*ids.shape, table.shape[-1])


def _trunc_normal(fan_in: int):
    """flax's ``lecun_normal``: truncated at two standard deviations, with
    variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD

    def init(gen, shape):
        return nn.init.trunc_normal_(torch.empty(shape), std=std,
                                     a=-2 * std, b=2 * std, generator=gen)
    return init


def _normal(std: float):
    return lambda gen, shape: torch.randn(shape, generator=gen) * std


def _zeros(gen, shape):
    return torch.zeros(shape)


def _ones(gen, shape):
    return torch.ones(shape)


class _Stacked(nn.Module):
    """A module whose parameters are stacked over a mesh: ``_param`` makes
    one, drawn per rank of ``axis`` when sharded (``partition`` mentions the
    axis), else one draw copied to every rank."""

    def __init__(self, mesh: Mesh, tp_axis: str, seed: int):
        super().__init__()
        self.lead = mesh.shape
        self.axis = mesh.axis(tp_axis)
        self.seed = seed
        self._count = 0

    def _param(self, name: str, shape: Sequence[int], init,
               partition: Optional[Sequence] = None) -> nn.Parameter:
        partition = (tuple(partition) if partition is not None
                     else (None,) * len(shape))
        sharded = self.axis.name in partition
        seed = self.seed * 1009 + self._count
        self._count += 1
        value = sharded_init(init, self.lead,
                             self.axis.dim if sharded else None)(seed, shape)
        p = nn.Parameter(value)
        p.partition = partition
        self.register_parameter(name, p)
        return p


# --- functional primitives ---------------------------------------------------

def column_parallel_dense(x, kernel, bias=None, *, axis: Axis,
                          gather_output: bool = False) -> torch.Tensor:
    """``y_local = x @ kernel_local``, the output features sharded over
    ``axis``; no forward collective.  ``gather_output`` all-gathers the
    shards onto the last dimension."""
    y = _matmul(x, kernel)
    if bias is not None:
        y = y + _bias(bias, y)
    if gather_output:
        y = ax.all_gather(y, axis, dim=-1)
    return y


def row_parallel_dense(x, kernel, bias=None, *, axis: Axis) -> torch.Tensor:
    """``y = psum_tp(x_local @ kernel_local)``, the input features sharded
    over ``axis``; the bias is added once, after the sum."""
    y = ax.psum(_matmul(x, kernel), axis)
    if bias is not None:
        y = y + _bias(bias, y)
    return y


# --- modules ------------------------------------------------------------------

class ColumnParallelDense(_Stacked):
    """Dense with the ``features`` (global) output features sharded over the
    axis: ``kernel (*lead, in, features / tp)`` and ``bias``."""

    def __init__(self, in_features: int, features: int, mesh: Mesh,
                 tp_axis: str = "tp", *, dtype=torch.bfloat16,
                 use_bias: bool = True, gather_output: bool = False,
                 seed: int = 0):
        super().__init__(mesh, tp_axis, seed)
        tp = self.axis.size
        if features % tp:
            raise ValueError(f"features {features} % tp {tp}")
        self.dtype, self.gather_output = dtype, gather_output
        self._param("kernel", (in_features, features // tp),
                    _trunc_normal(in_features), (None, tp_axis))
        self.bias = (self._param("bias", (features // tp,), _zeros,
                                 (tp_axis,)) if use_bias else None)

    def forward(self, x, *, axis: Optional[Axis] = None) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return column_parallel_dense(
            x.to(self.dtype), self.kernel.to(self.dtype), bias,
            axis=axis or self.axis, gather_output=self.gather_output)


class RowParallelDense(_Stacked):
    """Dense with the input features sharded over the axis (the Megatron
    pair of :class:`ColumnParallelDense`): ``kernel (*lead, in / tp,
    features)``, a replicated ``bias``, the output summed over the axis."""

    def __init__(self, in_features: int, features: int, mesh: Mesh,
                 tp_axis: str = "tp", *, dtype=torch.bfloat16,
                 use_bias: bool = True, seed: int = 0):
        super().__init__(mesh, tp_axis, seed)
        local = in_features // self.axis.size
        self.dtype = dtype
        # flax initialises inside shard_map, from the local shape's fan-in
        self._param("kernel", (local, features), _trunc_normal(local),
                    (tp_axis, None))
        self.bias = (self._param("bias", (features,), _zeros)
                     if use_bias else None)

    def forward(self, x, *, axis: Optional[Axis] = None) -> torch.Tensor:
        y = row_parallel_dense(x.to(self.dtype), self.kernel.to(self.dtype),
                               axis=axis or self.axis)
        if self.bias is not None:
            y = y + _bias(self.bias.to(self.dtype), y)
        return y


class _LayerNorm(_Stacked):
    def __init__(self, c: int, mesh: Mesh, tp_axis: str, seed: int):
        super().__init__(mesh, tp_axis, seed)
        self._param("scale", (c,), _ones)
        self._param("bias", (c,), _zeros)

    def forward(self, x):
        return _layer_norm(x, self.scale, self.bias)


class _Embed(_Stacked):
    def __init__(self, num: int, c: int, mesh: Mesh, tp_axis: str,
                 seed: int):
        super().__init__(mesh, tp_axis, seed)
        self._param("embedding", (num, c), _normal(math.sqrt(1.0 / c)))


class TPBlock(_Stacked):
    """Megatron tensor-parallel transformer block: the heads and the MLP's
    hidden width sharded over the axis, one ``psum`` per sublayer.  The
    fused qkv kernel is ``(in, 3, local)``, sharded on its last dimension,
    so gathered shards keep q, k and v apart.  The attention is pluggable as
    in :class:`~bluefog_tpu_torch.models.transformer.Block`."""

    def __init__(self, cfg: GPTConfig, mesh: Mesh, tp_axis: str = "tp",
                 seed: int = 0):
        super().__init__(mesh, tp_axis, seed)
        tp = self.axis.size
        if cfg.num_heads % tp:
            raise ValueError(f"heads {cfg.num_heads} % tp {tp}")
        self.cfg = cfg
        c = cfg.hidden_size
        local = c // tp
        sub = lambda i: seed * 31 + i  # noqa: E731
        self.ln1 = _LayerNorm(c, mesh, tp_axis, sub(1))
        self._param("qkv_kernel", (c, 3, local), _trunc_normal(c),
                    (None, None, tp_axis))
        self._param("qkv_bias", (3, local), _zeros, (None, tp_axis))
        self.proj = RowParallelDense(c, c, mesh, tp_axis, dtype=cfg.dtype,
                                     seed=sub(2))
        self.ln2 = _LayerNorm(c, mesh, tp_axis, sub(3))
        self.up = ColumnParallelDense(c, cfg.mlp_ratio * c, mesh, tp_axis,
                                      dtype=cfg.dtype, seed=sub(4))
        self.down = RowParallelDense(cfg.mlp_ratio * c, c, mesh, tp_axis,
                                     dtype=cfg.dtype, seed=sub(5))

    def forward(self, x, attn_fn, *, axis: Optional[Axis] = None):
        cfg, axis = self.cfg, axis or self.axis
        dt = cfg.dtype
        hd = cfg.hidden_size // cfg.num_heads
        y = self.ln1(x).to(dt)
        kernel = self.qkv_kernel.to(dt)
        qkv = _matmul(y, kernel.flatten(-2)).unflatten(-1, kernel.shape[-2:])
        qkv = qkv + _bias(self.qkv_bias.to(dt), qkv, local=2)
        q, k, v = (qkv[..., i, :].unflatten(-1, (-1, hd)) for i in range(3))
        a = attn_fn(q, k, v)
        x = x + self.proj(a.flatten(-2), axis=axis)
        y = self.ln2(x).to(dt)
        y = F.gelu(self.up(y, axis=axis), approximate="tanh")
        return x + self.down(y, axis=axis)


class TPTransformerLM(_Stacked):
    """Tensor-parallel :class:`~bluefog_tpu_torch.models.transformer.
    TransformerLM`: embeddings, layernorms and the head replicated on every
    rank of the axis, every block tensor-parallel.  Tokens ``(*lead, B, T)``
    (or ``(B, T)``, given to every rank) -> f32 logits ``(*lead, B, T,
    V)``.  ``axis`` in :meth:`forward` overrides the tp axis's dimension
    when the module runs (through ``functional_call``) on a slice of its
    stacked parameters, e.g. one gossip rank's ``params[r]``."""

    def __init__(self, cfg: GPTConfig, mesh: Mesh, tp_axis: str = "tp",
                 seed: int = 0):
        super().__init__(mesh, tp_axis, seed)
        self.cfg = cfg
        c = cfg.hidden_size
        self.tok = _Embed(cfg.vocab_size, c, mesh, tp_axis, seed * 7 + 1)
        self.pos = _Embed(cfg.max_position, c, mesh, tp_axis, seed * 7 + 2)
        self.blocks = []
        for i in range(cfg.num_layers):
            block = TPBlock(cfg, mesh, tp_axis, seed=seed * 7 + 10 + i)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        self.ln_f = _LayerNorm(c, mesh, tp_axis, seed * 7 + 3)
        self.lm_head = _Stacked(mesh, tp_axis, seed * 7 + 4)
        self.lm_head._param("kernel", (c, cfg.vocab_size), _trunc_normal(c))

    def forward(self, tokens, *, attn_fn=None, position_offset: int = 0,
                axis: Optional[Axis] = None) -> torch.Tensor:
        cfg = self.cfg
        table = self.tok.embedding
        nl = table.dim() - 2
        if axis is None:
            if nl != len(self.lead):
                raise ValueError(
                    f"parameters with {nl} leading rank dimensions, the mesh "
                    f"has {len(self.lead)}: pass axis= for a slice")
            axis = self.axis
        if attn_fn is None:
            attn_fn = lambda q, k, v: local_attention(  # noqa: E731
                q, k, v, causal=True, backend="auto")
        if tokens.dim() == 2 and nl:
            tokens = tokens.expand(*table.shape[:nl], *tokens.shape)
        positions = position_offset + torch.arange(tokens.shape[-1],
                                                   device=tokens.device)
        pos = self.pos.embedding.index_select(-2, positions)
        x = (_embed(table, tokens).to(cfg.dtype)
             + pos.unsqueeze(nl).to(cfg.dtype))
        for block in self.blocks:
            x = block(x, attn_fn, axis=axis)
        x = self.ln_f(x)
        return _matmul(x, self.lm_head.kernel)


# --- rule table and box metadata ---------------------------------------------

def tp_param_rules(tp_axis: str = "tp") -> RuleTable:
    """The rule table of :class:`TPTransformerLM`'s parameters (the JAX
    package's, under the same names): qkv and up column-sharded on the
    output features, proj and down row-sharded on the input features,
    everything else replicated."""
    return RuleTable([
        ("qkv_kernel$", P(None, None, tp_axis)),
        ("qkv_bias$", P(None, tp_axis)),
        (r"up/kernel$", P(None, tp_axis)),
        (r"up/bias$", P(tp_axis)),
        (r"(proj|down)/kernel$", P(tp_axis, None)),
        (".*", P()),
    ])


def _slash(name: str) -> str:
    return name.replace(".", "/")


def _template(template) -> Dict[str, torch.Tensor]:
    """``{name: parameter}`` of a module or a mapping of parameters; each
    parameter carries ``partition``."""
    if isinstance(template, nn.Module):
        return dict(template.named_parameters())
    return dict(template)


def box_specs(template) -> Dict[str, P]:
    """Each parameter's ``partition`` as a :class:`PartitionSpec` (the box
    metadata view); compare it with a rule table only
    (:func:`check_rule_agreement`)."""
    return {name: P(*p.partition)
            for name, p in _template(template).items()}


class PartitionDisagreement(ValueError):
    """A parameter's ``partition`` and the rule table disagree: the gradient
    correction would scale by one story while the wire shards by the
    other."""


def check_rule_agreement(template, rule_table: RuleTable):
    """``[(name, box_spec, table_spec)]`` for every parameter whose
    ``partition`` disagrees with the table's resolution of its local shape; an
    empty list when the two agree."""
    mismatches = []
    for name, p in _template(template).items():
        local = tuple(p.shape[p.dim() - len(p.partition):])
        boxed = P(*p.partition)
        resolved = rule_table.resolve(_slash(name), local)
        if norm_spec(boxed) != norm_spec(resolved):
            mismatches.append((name, boxed, resolved))
    return mismatches


# --- gradient correction and gather ------------------------------------------

def _specs(template, rule_table: Optional[RuleTable]) -> Dict[str, P]:
    tmpl = _template(template)
    if rule_table is None:
        return {name: P(*p.partition) for name, p in tmpl.items()}
    return {name: rule_table.resolve(
        _slash(name), tuple(p.shape[p.dim() - len(p.partition):]))
        for name, p in tmpl.items()}


def tp_correct_grads(grads: Mapping[str, torch.Tensor], template,
                     axis: Axis, *, rule_table: Optional[RuleTable] = None
                     ) -> Dict[str, torch.Tensor]:
    """Correct raw gradients (see the module docstring): a leaf sharded over
    ``axis`` divided by its size, a replicated one averaged over it.
    Shardedness comes from ``rule_table`` where one is given, else from each
    template parameter's ``partition``.  ``grads`` is keyed like the template's
    parameters and stacked like them (or like a slice of their leading
    dimensions, ``axis`` giving where the tp ranks are)."""
    specs = _specs(template, rule_table)
    out = {}
    for name, g in grads.items():
        if spec_mentions(specs[name], axis.name):
            out[name] = g / axis.size
        else:
            out[name] = ax.pmean(g, axis)
    return out


def tp_value_and_grad(loss_fn: Callable, template, axis: Axis, *,
                      rule_table: Optional[RuleTable] = None) -> Callable:
    """``wrapped(params, *args) -> (losses, grads)``: ``loss_fn(params,
    *args)`` returns each rank's loss (stacked ``(*lead,)``); the raw
    gradients of their sum with respect to ``params`` (a mapping of stacked
    tensors keyed like the template's parameters) are corrected by
    :func:`tp_correct_grads`.  With ``rule_table`` the table and the
    parameters' ``partition`` are compared once, here, and a disagreement raises
    :class:`PartitionDisagreement`."""
    if rule_table is not None:
        mismatches = check_rule_agreement(template, rule_table)
        if mismatches:
            lines = "; ".join(f"{name}: box={b} table={t}"
                              for name, b, t in mismatches)
            raise PartitionDisagreement(
                "parameter partitions disagree with the rule table on "
                f"{len(mismatches)} leaf(s): {lines}: fix the rule or the "
                "module annotation; the table is the single source of truth")

    def wrapped(params: Mapping[str, torch.Tensor], *args, **kwargs):
        losses = loss_fn(params, *args, **kwargs)
        raw = torch.autograd.grad(losses.sum(), list(params.values()))
        grads = tp_correct_grads(dict(zip(params, raw)), template, axis,
                                 rule_table=rule_table)
        return losses.detach(), grads

    return wrapped


def unbox_params(template) -> Dict[str, torch.Tensor]:
    """``{name: tensor}``: the parameters without their ``partition``."""
    return {name: p.detach() for name, p in _template(template).items()}


def gather_tp_params(params: Mapping[str, torch.Tensor], template,
                     axis: Axis) -> Dict[str, torch.Tensor]:
    """Gather every leaf sharded over ``axis`` to its full value on every
    rank (its shards reassembled along the sharded dimension by
    :func:`~bluefog_tpu_torch.sharding.gather_tree`), the others as they
    are: for a consolidated checkpoint, evaluation at ``tp = 1``, or the
    parity tests.  ``params`` is keyed like the template (a gradient
    mapping gathers the same way); over processes the shards of other
    processes arrive through the axis (collective).  No gradient."""
    from bluefog_tpu_torch.sharding.apply import _full_shape, gather_tree

    tmpl = _template(template)
    axes = {axis.name: axis.size}
    out = {}
    for name, x in params.items():
        part = tmpl[name].partition
        if axis.name not in part:
            out[name] = x
            continue
        shards = ax.blocks(x, axis)
        local = tuple(shards[0].shape)
        spec = P(*([None] * (len(local) - len(part))), *part)
        shape = _full_shape(local, spec, axes)
        full = gather_tree({name: torch.empty(shape, device="meta")},
                           {name: spec}, axes,
                           {(t,): {name: s} for t, s in enumerate(shards)}
                           )[name]
        out[name] = full.unsqueeze(axis.dim).expand(
            *full.shape[:axis.dim], axis.local, *full.shape[axis.dim:])
    return out

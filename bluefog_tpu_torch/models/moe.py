"""Switch-MoE transformer LM: the expert-parallel GPT.

Counterpart of ``bluefog_tpu/models/moe.py``: the
:class:`~bluefog_tpu_torch.models.transformer.TransformerLM` trunk with every
block's MLP replaced (``mlp=``) by a :class:`MoEMLP`, registered as the
block's ``mlp`` (flax's ``moe``).  With ``ep_size > 1`` the tokens carry the
``ep`` group's ranks on their leading dimension (``(ep, B, T)``), every
rank's tokens run through the trunk together (the attention folds the ranks
into K3's batch), and each MoE layer exchanges tokens with the experts of
the other ranks (:func:`~bluefog_tpu_torch.ops.moe.expert_parallel_ffn`).
The trunk and router are held once and shared by the ranks; the experts
``wi`` / ``wo`` are ``(ep, E / ep, ...)``, rank ``s`` holding experts ``s (E
/ ep) ...``.  See :mod:`bluefog_tpu_torch.ops.moe` for the gradient
convention: with each rank's loss normalised by the global token count, the
autograd gradients of their sum are the reference's after its ``psum`` over
``ep`` of the replicated leaves.

flax ``sow``\\ s each layer's aux loss and drop metrics into collections the
caller reads with ``mutable=``; here each :class:`MoEMLP` keeps its last
call's in ``last_aux`` and ``last_metrics``, and :func:`moe_aux_losses` /
:func:`moe_metrics` collect them in layer order.  The loss adds
``aux_loss_weight`` times their sum (:func:`moe_lm_loss`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch.models.transformer import (
    GPTConfig, TransformerLM, _TRUNC_STD)
from bluefog_tpu_torch.ops.moe import expert_parallel_ffn, moe_ffn_reference
from bluefog_tpu_torch.parallel.axes import Axis
from bluefog_tpu_torch.parallel.rng import sharded_init
from bluefog_tpu_torch.sharding.rules import (
    PartitionSpec as P, Rule, RuleTable)

__all__ = ["MoEConfig", "MoEMLP", "MoETransformerLM", "moe_param_rules",
           "moe_aux_losses", "moe_metrics", "moe_lm_loss", "set_ep_axis"]


def moe_param_rules(ep_axis: str = "ep",
                    tp_axis: Optional[str] = None) -> RuleTable:
    """The rule table of a :class:`MoETransformerLM`'s parameters (the
    reference's, under the port's names: the MoE layer is the block's
    ``mlp`` and Dense weights are ``weight``): the experts sharded over
    ``ep_axis`` on their expert dimension, the router replicated, and with
    ``tp_axis`` the attention trunk in Megatron placement on the port's
    ``(out, in)`` layout."""
    rules = [Rule(r"mlp/w[io]$", P(ep_axis)), Rule(r"mlp/router$", P())]
    if tp_axis is not None:
        rules.extend([
            Rule(r"qkv/weight$", P(tp_axis, None)),
            Rule(r"qkv/bias$", P(tp_axis)),
            Rule(r"proj/weight$", P(None, tp_axis)),
        ])
    rules.append(Rule(".*", P()))
    return RuleTable(rules)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Switch-MoE hyperparameters on top of a :class:`GPTConfig`."""

    gpt: GPTConfig
    num_experts: int = 8
    ep_size: int = 1
    ep_axis: str = "ep"
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router: str = "top1"  # 'top1' (Switch) or 'top2' (GShard)

    def __post_init__(self):
        if self.router not in ("top1", "top2"):
            raise ValueError(
                f"unknown router {self.router!r}; expected 'top1' or 'top2'")
        if self.router == "top2" and self.num_experts < 2:
            raise ValueError(
                f"router='top2' requires num_experts >= 2, got "
                f"{self.num_experts} (the second choice would duplicate the "
                "first and silently halve capacity)")

    @staticmethod
    def tiny(ep_size: int = 1, router: str = "top1") -> "MoEConfig":
        return MoEConfig(gpt=GPTConfig.tiny(), num_experts=4,
                         ep_size=ep_size, capacity_factor=2.0, router=router)

    def capacity(self, tokens_per_shard: int) -> int:
        # top-2 makes two assignments a token: capacity scales with k
        k = 2 if self.router == "top2" else 1
        return max(int(self.capacity_factor * k * tokens_per_shard
                       / self.num_experts), 1)


def _lecun(fan_in: int):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return lambda gen, shape: nn.init.trunc_normal_(
        torch.empty(shape), std=std, a=-2 * std, b=2 * std, generator=gen)


class MoEMLP(nn.Module):
    """Switch-MoE FFN.  ``ep_size == 1``: ``wi (E, D, H)``, ``wo (E, H, D)``
    and the dense reference path on ``(..., T, D)``; above 1, ``(ep, E / ep,
    ...)`` experts, each rank's drawn from its own stream, and the
    expert-parallel FFN on ``(ep, B, T, D)``.  The router ``(D, E)`` is
    replicated.  :attr:`axis` is the ``ep`` axis the FFN runs over; over
    processes set it to the mesh's (:func:`set_ep_axis`), and the leading
    dimension then holds the ranks this process owns."""

    def __init__(self, cfg: MoEConfig, seed: int = 0):
        super().__init__()
        gpt = cfg.gpt
        if cfg.num_experts % cfg.ep_size:
            raise ValueError(f"experts {cfg.num_experts} % ep {cfg.ep_size}")
        self.cfg = cfg
        c, hidden = gpt.hidden_size, gpt.mlp_ratio * gpt.hidden_size
        local_e = cfg.num_experts // cfg.ep_size
        lead = (cfg.ep_size,) if cfg.ep_size > 1 else ()
        fold = 0 if lead else None

        def draw(fan_in, shape, i, lead, fold):
            # flax's lecun_normal(in_axis=1, out_axis=2) on the experts
            return sharded_init(_lecun(fan_in), lead, fold)(seed * 3 + i,
                                                            shape)

        self.router = nn.Parameter(draw(c, (c, cfg.num_experts), 0, (), None))
        self.wi = nn.Parameter(draw(c, (local_e, c, hidden), 1, lead, fold))
        self.wo = nn.Parameter(draw(hidden, (local_e, hidden, c), 2, lead,
                                    fold))
        self.axis = Axis(cfg.ep_axis, cfg.ep_size, 0)
        self.last_aux: Optional[torch.Tensor] = None
        self.last_metrics: Dict[str, torch.Tensor] = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.gpt.dtype
        wi, wo = self.wi.to(dt), self.wo.to(dt)
        if cfg.ep_size == 1:
            flat = x.reshape(-1, x.shape[-1])
            y, aux, metrics = moe_ffn_reference(
                flat, self.router, wi, wo, num_experts=cfg.num_experts,
                capacity=cfg.capacity(flat.shape[0]), router=cfg.router)
        else:
            flat = x.reshape(self.axis.local, -1, x.shape[-1])
            y, aux, metrics = expert_parallel_ffn(
                flat, self.router, wi, wo, axis=self.axis,
                num_experts=cfg.num_experts,
                capacity=cfg.capacity(flat.shape[1]), router=cfg.router)
        self.last_aux, self.last_metrics = aux, metrics
        return y.reshape(x.shape)


def MoETransformerLM(cfg: MoEConfig,
                     generator: Optional[torch.Generator] = None
                     ) -> TransformerLM:
    """The Switch-MoE decoder LM: :class:`TransformerLM` with every block's
    MLP a :class:`MoEMLP` (layer ``i``'s experts from seed ``i``)."""
    layer = iter(range(cfg.gpt.num_layers))
    return TransformerLM(cfg.gpt, generator=generator,
                         mlp=lambda: MoEMLP(cfg, seed=next(layer)))


def _moe_layers(model: nn.Module) -> List[MoEMLP]:
    return [m for m in model.modules() if isinstance(m, MoEMLP)]


def set_ep_axis(model: nn.Module, axis: Axis) -> None:
    """Run every MoE layer of ``model`` over ``axis`` (dimension 0), e.g. a
    mesh's ``ep`` axis whose ranks span processes."""
    for m in _moe_layers(model):
        m.axis = axis.at(0)


def moe_aux_losses(model: nn.Module) -> List[torch.Tensor]:
    """Each MoE layer's aux loss from the last forward, in layer order (per
    rank of the ``ep`` group: ``(ep,)`` when expert-parallel)."""
    return [m.last_aux for m in _moe_layers(model)]


def moe_metrics(model: nn.Module) -> List[Dict[str, torch.Tensor]]:
    """Each MoE layer's router metrics from the last forward."""
    return [m.last_metrics for m in _moe_layers(model)]


def moe_lm_loss(model: nn.Module, logits: torch.Tensor,
                targets: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The reference benchmark's MoE loss, averaged over the ranks of the
    ``ep`` group: the mean next-token cross-entropy over every token of the
    group, plus ``aux_loss_weight`` times the sum over layers of the ranks'
    mean aux loss (with one rank, the benchmark's ``ce + w * sum(aux)``)."""
    ce = F.cross_entropy(logits.flatten(0, -2).float(), targets.flatten())
    aux = sum(a.mean() for a in moe_aux_losses(model))
    return ce + cfg.aux_loss_weight * aux

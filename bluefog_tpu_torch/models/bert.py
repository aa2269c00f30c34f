"""BERT-style transformer encoder, written by hand: the model of the
hierarchical fine-tune (BASELINE.json ``configs[4]``: BERT-large fine-tuned
with ``hierarchical_neighbor_allreduce``).

Counterpart of ``bluefog_tpu/models/bert.py`` (``BertConfig``,
``SelfAttention``, ``EncoderLayer``, ``BertEncoder``) with the flax submodule
names (``tok``, ``pos``, ``typ``, ``LayerNorm_0``, ``layer_<i>`` holding
``SelfAttention_0`` with ``qkv`` and ``out``, ``LayerNorm_0``, ``Dense_0``,
``Dense_1``, ``LayerNorm_1``; ``pooler``, ``cls``), so
:func:`bluefog_tpu_torch.convert.bert_from_flax` carries flax weights across
one to one.  It reuses the GPT's flax-semantics ``LayerNorm`` (f32, epsilon
1e-6), ``Dense`` and ``Embed``.  What it computes, step by step, as the flax
model does:

- The embeddings are looked up and cast to ``cfg.dtype`` (bf16) before they
  are summed, so ``tok + pos (+ typ)`` adds in bf16; the f32 LayerNorm reads
  the sum.
- The residual stream is f32: ``x`` leaves each LayerNorm in f32 and ``x +
  y`` promotes the bf16 ``y``.
- Attention is the dense einsum, not a kernel: the bf16 ``Q K^T``, cast to
  f32 and scaled by ``1 / sqrt(D)``, ``where(mask, logits, -1e9)`` with the
  ``(B, S)`` mask broadcast over heads and queries, an f32 softmax, a cast to
  bf16, then ``P V`` in bf16.
- GELU is the tanh approximation (flax's ``nn.gelu``).
- The pooler (``tanh``) and the classifier are f32 ``Dense`` layers on
  ``x[:, 0]``.
- Dropout (rate ``cfg.dropout_rate``) runs only when ``deterministic`` is
  False, drawing from an explicit ``torch.Generator``; every entry point of
  the reference trains deterministic.

flax creates the ``typ`` table only when the model is initialized with token
types; here ``token_types=True`` creates it, and without it a call that
passes ``token_type_ids`` raises, as the flax model's apply does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from bluefog_tpu_torch.models.transformer import Dense, Embed, LayerNorm

__all__ = ["BertConfig", "SelfAttention", "EncoderLayer", "BertEncoder"]

_MASKED = -1e9  # the reference's mask value


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024          # BERT-large
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False              # checkpoint each encoder layer

    @staticmethod
    def large() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig(hidden_size=768, num_layers=12, num_heads=12,
                          intermediate_size=3072)

    @staticmethod
    def tiny() -> "BertConfig":
        """For tests."""
        return BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                          num_heads=2, intermediate_size=256, max_position=128)


def _dropout(x: torch.Tensor, rate: float, deterministic: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


class SelfAttention(nn.Module):
    """Fused QKV projection, dense softmax attention, output projection."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_size
        self.qkv = Dense(c, 3 * c, cfg.dtype)
        self.out = Dense(c, c, cfg.dtype)

    def forward(self, x, mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        c, heads = cfg.hidden_size, cfg.num_heads
        d = c // heads
        # (B, S, H, D) views of the projection, heads moved in front of S
        q, k, v = (t.unflatten(-1, (heads, d)).transpose(1, 2)
                   for t in self.qkv(x).split(c, dim=-1))
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * (
            1.0 / math.sqrt(d))
        if mask is not None:
            logits = torch.where(mask.bool()[:, None, None, :], logits,
                                 _MASKED)
        probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
        probs = _dropout(probs, cfg.dropout_rate, deterministic, generator)
        out = torch.matmul(probs, v).transpose(1, 2).flatten(-2)
        return self.out(out)


class EncoderLayer(nn.Module):
    """Post-LN attention and MLP residual block, residuals in f32."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.hidden_size, cfg.dtype
        self.SelfAttention_0 = SelfAttention(cfg)
        self.LayerNorm_0 = LayerNorm(c)
        self.Dense_0 = Dense(c, cfg.intermediate_size, dt)
        self.Dense_1 = Dense(cfg.intermediate_size, c, dt)
        self.LayerNorm_1 = LayerNorm(c)

    def forward(self, x, mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.cfg.dropout_rate
        y = self.SelfAttention_0(x, mask, deterministic, generator)
        y = _dropout(y, rate, deterministic, generator)
        x = self.LayerNorm_0(x + y)
        y = F.gelu(self.Dense_0(x), approximate="tanh")
        y = self.Dense_1(y)
        y = _dropout(y, rate, deterministic, generator)
        return self.LayerNorm_1(x + y)


def _remat_layer(layer: EncoderLayer, x: torch.Tensor, mask, deterministic,
                 generator) -> torch.Tensor:
    """``layer(x, ...)`` under a non-reentrant checkpoint of a function of
    the layer's parameter tensors (whatever ``functional_call`` has swapped
    in now), as flax's ``nn.remat`` of each layer: only the layer's input
    stays for the backward, which recomputes the rest.  The recomputation
    draws the same dropout masks: checkpoint restores the default
    generators, and an explicit ``generator`` is set back to where the
    forward found it (and returned to where it stood after)."""
    names, tensors = zip(*layer.named_parameters())
    before = None if generator is None else generator.get_state()
    calls = [0]

    def run(x, *tensors):
        again = calls[0] > 0 and generator is not None
        calls[0] += 1
        now = generator.get_state() if again else None
        if again:
            generator.set_state(before)
        try:
            return functional_call(layer, dict(zip(names, tensors)),
                                   (x, mask, deterministic, generator))
        finally:
            if again:
                generator.set_state(now)

    return checkpoint(run, x, *tensors, use_reentrant=False)


class BertEncoder(nn.Module):
    """Embeddings, the encoder stack and, with ``num_classes``, the pooled
    classification head: ``(B, S)`` token ids -> ``(B, num_classes)`` f32
    logits (or the ``(B, S, hidden)`` f32 sequence without a head).
    Weights are initialized as flax initializes them, from ``generator``
    (default: seed 0)."""

    def __init__(self, cfg: BertConfig, num_classes: Optional[int] = None,
                 *, token_types: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.num_classes = num_classes
        c, dt = cfg.hidden_size, cfg.dtype
        self.tok = Embed(cfg.vocab_size, c, dt)
        self.pos = Embed(cfg.max_position, c, dt)
        self.typ = Embed(cfg.type_vocab_size, c, dt) if token_types else None
        self.LayerNorm_0 = LayerNorm(c)
        self.layers = []
        for i in range(cfg.num_layers):
            layer = EncoderLayer(cfg)
            self.add_module(f"layer_{i}", layer)
            self.layers.append(layer)
        if num_classes is not None:
            self.pooler = Dense(c, c, torch.float32)
            self.cls = Dense(c, num_classes, torch.float32)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (Dense, Embed)):
                    mod.reset_parameters(generator)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks when ``deterministic`` is
        False (default: the global generator of the ids' device)."""
        cfg = self.cfg
        pos_ids = torch.arange(input_ids.shape[1],
                               device=input_ids.device)[None, :]
        x = self.tok(input_ids) + self.pos(pos_ids)
        if token_type_ids is not None:
            if self.typ is None:
                raise ValueError("token_type_ids given to a BertEncoder "
                                 "built without token_types=True")
            x = x + self.typ(token_type_ids)
        x = self.LayerNorm_0(x)
        x = _dropout(x, cfg.dropout_rate, deterministic, generator)
        for layer in self.layers:
            if cfg.remat:
                x = _remat_layer(layer, x, attention_mask, deterministic,
                                 generator)
            else:
                x = layer(x, attention_mask, deterministic, generator)
        if self.num_classes is None:
            return x
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return self.cls(pooled)

"""Decoder-only transformer LM, written by hand.

Counterpart of ``bluefog_tpu/models/transformer.py`` (``GPTConfig``,
``Block``, ``TransformerLM``) with the flax submodule names (``tok``,
``pos``, ``block_<i>`` with ``ln1``, ``qkv``, ``proj``, ``ln2``, ``up``,
``down``; ``ln_f``, ``lm_head``), so :mod:`bluefog_tpu_torch.convert` carries
flax weights across one to one.  What differs from torch habit, to compute
what the flax model computes:

- Parameters are f32 and cast to ``cfg.dtype`` (bf16 by default) at use:
  ``Embed`` and ``Dense`` compute in ``cfg.dtype``, so the residual stream
  and its adds are bf16; ``Dense`` weights are ``(out, in)`` here and
  ``(in, out)`` in flax.
- ``LayerNorm`` normalises in f32 with epsilon 1e-6 (flax's, not torch's
  1e-5) and returns f32; each block casts it to ``cfg.dtype``, and ``ln_f``
  stays f32 into the f32 ``lm_head`` (no bias).
- GELU is the tanh approximation (flax's ``nn.gelu`` default).
- ``qkv`` splits into q, k, v of ``hidden_size`` columns each, heads
  contiguous inside each; q, k and v reach the attention as ``(B, T, H, D)``
  views of the projection, without a copy.
- The attention is pluggable, ``attn_fn(q, k, v) -> (B, T, H, D)``, and
  defaults to :func:`~bluefog_tpu_torch.ops.ring_attention.local_attention`
  with ``causal=True, backend="auto"``: K3 on the card wherever it is
  eligible.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch.ops.ring_attention import local_attention

__all__ = ["GPTConfig", "LayerNorm", "Dense", "Embed", "Block",
           "TransformerLM"]

AttnFn = Callable[..., torch.Tensor]  # (q, k, v) -> (B, T, H, D)

# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304          # 50257 padded up to a 128 multiple
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    max_position: int = 8192
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False              # not ported: TransformerLM raises

    @staticmethod
    def small() -> "GPTConfig":
        return GPTConfig()

    @staticmethod
    def large() -> "GPTConfig":
        return GPTConfig(hidden_size=1536, num_layers=24, num_heads=16)

    @staticmethod
    def tiny() -> "GPTConfig":
        """For tests."""
        return GPTConfig(vocab_size=512, hidden_size=64, num_layers=2,
                         num_heads=4, max_position=512, dtype=torch.float32)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 scale and bias, statistics
    and output in f32, epsilon 1e-6."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=...)``: an f32 ``(out, in)`` weight and bias,
    the input, weight and bias cast to ``dtype`` and multiplied there."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = math.sqrt(1.0 / self.weight.shape[1]) / _TRUNC_STD
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Embed(nn.Module):
    """flax ``nn.Embed(dtype=...)``: an f32 ``(num, features)`` table whose
    rows are looked up and cast to ``dtype``."""

    def __init__(self, num: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax's default: variance_scaling(1, 'fan_in', 'normal'), fan_in =
        # the feature width
        nn.init.normal_(self.weight, std=math.sqrt(1.0 / self.weight.shape[1]),
                        generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


class Block(nn.Module):
    """Pre-LN attention + MLP residual block."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.hidden_size, cfg.dtype
        self.ln1 = LayerNorm(c)
        self.qkv = Dense(c, 3 * c, dt)
        self.proj = Dense(c, c, dt)
        self.ln2 = LayerNorm(c)
        self.up = Dense(c, cfg.mlp_ratio * c, dt)
        self.down = Dense(cfg.mlp_ratio * c, c, dt)

    def forward(self, x: torch.Tensor, attn_fn: AttnFn) -> torch.Tensor:
        cfg = self.cfg
        c, heads = cfg.hidden_size, cfg.num_heads
        y = self.ln1(x).to(cfg.dtype)
        q, k, v = (t.unflatten(-1, (heads, c // heads))
                   for t in self.qkv(y).split(c, dim=-1))
        a = attn_fn(q, k, v)
        x = x + self.proj(a.flatten(-2))
        y = self.ln2(x).to(cfg.dtype)
        y = F.gelu(self.up(y), approximate="tanh")
        return x + self.down(y)


class TransformerLM(nn.Module):
    """Tokens -> f32 logits.  ``attn_fn(q, k, v) -> out`` defaults to causal
    :func:`local_attention` with ``backend="auto"``; ``position_offset`` or
    explicit ``positions`` give the tokens' global positions.  Weights are
    initialized as flax initializes them, from ``generator`` (default: seed
    0)."""

    def __init__(self, cfg: GPTConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.remat:
            # torch.utils.checkpoint would recompute a block outside the
            # trainer's functional_call, with the module's own parameters
            raise NotImplementedError("GPTConfig.remat is not ported yet")
        self.cfg = cfg
        c = cfg.hidden_size
        self.tok = Embed(cfg.vocab_size, c, cfg.dtype)
        self.pos = Embed(cfg.max_position, c, cfg.dtype)
        self.blocks = []
        for i in range(cfg.num_layers):
            block = Block(cfg)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        self.ln_f = LayerNorm(c)
        self.lm_head = Dense(c, cfg.vocab_size, torch.float32, bias=False)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (Dense, Embed)):
                    mod.reset_parameters(generator)

    def forward(self, tokens: torch.Tensor, *,
                attn_fn: Optional[AttnFn] = None, position_offset=0,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if attn_fn is None:
            attn_fn = functools.partial(local_attention, causal=True,
                                        backend="auto")
        if positions is None:
            positions = position_offset + torch.arange(
                tokens.shape[1], device=tokens.device)[None, :]
        x = self.tok(tokens) + self.pos(positions)
        for block in self.blocks:
            x = block(x, attn_fn)
        return self.lm_head(self.ln_f(x))

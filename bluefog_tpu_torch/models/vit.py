"""Vision Transformer, written by hand: attention on the image side.

Counterpart of ``bluefog_tpu/models/vit.py`` (``ViTConfig``, ``ViT``) with
the flax names (``patchify``, ``cls``, ``pos_embed``, ``block_<i>``,
``ln_f``, ``head``), so :func:`bluefog_tpu_torch.convert.vit_from_flax`
carries flax weights across one to one.  It is the GPT's pre-LN
:class:`~bluefog_tpu_torch.models.transformer.Block` with non-causal
attention, a patch embedding in place of the token embedding and a
classifier over the ``[CLS]`` position:

- The patchify is one strided conv computing in ``cfg.dtype`` on the NHWC
  image; its output is flattened row-major over the patch grid, as the flax
  model's ``reshape`` does.
- ``cls`` and ``pos_embed`` are f32 parameters cast to ``cfg.dtype``, so the
  residual stream is in ``cfg.dtype``, as the GPT's.
- Attention is :func:`~bluefog_tpu_torch.ops.ring_attention.local_attention`
  with ``causal=False, backend="auto"``.  At 224/16 the 197 tokens are not a
  multiple of 128, so it takes the dense path, as in the JAX package.
- ``ln_f`` and ``head`` are f32, on ``x[:, 0]``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch.models.resnet import _lecun_normal_
from bluefog_tpu_torch.models.transformer import (
    AttnFn, Block, Dense, GPTConfig, LayerNorm, TransformerLM)
from bluefog_tpu_torch.ops.ring_attention import local_attention

__all__ = ["ViTConfig", "ViT"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False              # checkpoint each block

    @staticmethod
    def base() -> "ViTConfig":
        return ViTConfig()  # ViT-B/16

    @staticmethod
    def tiny() -> "ViTConfig":
        """For tests."""
        return ViTConfig(image_size=32, patch_size=8, num_classes=10,
                         hidden_size=64, num_layers=2, num_heads=4,
                         dtype=torch.float32)

    def trunk(self) -> GPTConfig:
        """The transformer-block config this ViT shares with the LM trunk."""
        n_tokens = (self.image_size // self.patch_size) ** 2 + 1
        return GPTConfig(
            vocab_size=1,  # unused by Block
            hidden_size=self.hidden_size, num_layers=self.num_layers,
            num_heads=self.num_heads, mlp_ratio=self.mlp_ratio,
            max_position=n_tokens, dtype=self.dtype, remat=self.remat)


class ViT(nn.Module):
    """NHWC images ``(B, H, W, C)`` -> f32 logits ``(B, num_classes)``.
    Weights are initialized as flax initializes them, from ``generator``
    (default: seed 0)."""

    def __init__(self, cfg: ViTConfig, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        trunk = cfg.trunk()
        c, p = cfg.hidden_size, cfg.patch_size
        self.patchify = nn.Conv2d(in_channels, c, p, stride=p)
        self.cls = nn.Parameter(torch.zeros(1, 1, c))
        self.pos_embed = nn.Parameter(torch.empty(1, trunk.max_position, c))
        self.blocks = []
        for i in range(cfg.num_layers):
            block = Block(trunk)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        self.ln_f = LayerNorm(c)
        self.head = Dense(c, cfg.num_classes, torch.float32)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            w = self.patchify.weight
            _lecun_normal_(w, w[0].numel(), generator)
            nn.init.zeros_(self.patchify.bias)
            nn.init.zeros_(self.cls)
            nn.init.normal_(self.pos_embed, std=0.02, generator=generator)
            for mod in self.modules():
                if isinstance(mod, Dense):
                    mod.reset_parameters(generator)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
        """``train`` is accepted for the image models' common signature;
        nothing here depends on it."""
        del train
        cfg = self.cfg
        if attn_fn is None:
            attn_fn = functools.partial(local_attention, causal=False,
                                        backend="auto")
        dt, b, c = cfg.dtype, x.shape[0], cfg.hidden_size
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.patchify.weight.to(dt),
                     self.patchify.bias.to(dt), stride=cfg.patch_size)
        x = x.permute(0, 2, 3, 1).reshape(b, -1, c)  # (B, n_patches, D)
        x = torch.cat([self.cls.to(dt).expand(b, 1, c), x], dim=1)
        x = x + self.pos_embed.to(dt)
        for block in self.blocks:
            if cfg.remat:
                # flax's nn.remat of each block, as GPTConfig.remat
                x = TransformerLM._remat_block(block, x, attn_fn)
            else:
                x = block(x, attn_fn)
        return self.head(self.ln_f(x[:, 0]))

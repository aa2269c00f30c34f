"""ResNet v1.5, written by hand.

Counterpart of ``bluefog_tpu/models/resnet.py``, with the same function and
the same submodule names (``conv_init``, ``bn_init``, ``BottleneckBlock_3``,
``Conv_1``, ``norm_proj``, ``head``...), so :mod:`bluefog_tpu_torch.convert`
carries flax weights across one to one.  What differs from torch habit, to
compute what the flax model computes:

- ``forward`` takes NHWC input, as the JAX model does, and permutes inside.
- Convolutions pad as flax's ``'SAME'``: a stride-2 3x3 conv on an even
  input pads (0, 1), not torch's (1, 1).  The stems keep their explicit pads.
- Parameters and BatchNorm statistics are f32; convolutions and the block
  activations run in ``dtype`` (bf16 by default); the head is f32.
- BatchNorm normalizes with the biased batch variance and updates its running
  statistics as flax does: ``ra = 0.9 ra + 0.1 stat`` with the *biased*
  variance (torch's own BatchNorm uses the unbiased one).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "space_to_depth",
    "s2d_stem_kernel_from_7x7",
    "Conv",
    "BatchNorm",
    "ResNetBlock",
    "BottleneckBlock",
    "ResNet",
    "ResNet18",
    "ResNet50",
    "ResNet101",
]

Pads = Tuple[Tuple[int, int], Tuple[int, int]]

# flax's lecun_normal: a normal truncated at two standard deviations, scaled so
# that the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """Fold ``block x block`` spatial tiles into channels: [N,H,W,C] ->
    [N,H/b,W/b,C*b*b], channel order (row a, col b, channel c) ->
    (a*block + b)*C + c."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def s2d_stem_kernel_from_7x7(w7: torch.Tensor) -> torch.Tensor:
    """Embed a ``(K, C, 7, 7)`` stride-2 stem kernel (the ``"conv"`` stem's
    weight) as the ``(K, 4C, 4, 4)`` stride-1 kernel that computes the same
    function on :func:`space_to_depth` (2) input with padding (2, 1) (the
    ``"s2d"`` stem's weight; reference ``resnet.py::
    s2d_stem_kernel_from_7x7``, there in flax's ``(7, 7, C, K)`` layout).

    With ``z[p, (a 2 + b) C + c] = x[2p + a, 2q + b, c]``, tap ``dp`` of the
    s2d conv reads ``x[2i + 2dp + a - 4]`` where the stride-2 conv with
    padding 3 reads ``x[2i + di - 3]``: ``di = 2dp + a - 1``, a bijection
    from ``(dp, a)`` onto ``di`` in ``-1 .. 6``, whose one slot ``di = -1``
    stays zero."""
    k, c, kh, kw = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"a 7x7 stem kernel, got {tuple(w7.shape)}")
    w4 = w7.new_zeros(k, 4 * c, 4, 4)
    for dp in range(4):
        for a in range(2):
            di = 2 * dp + a - 1
            if not 0 <= di < 7:
                continue
            for dq in range(4):
                for b in range(2):
                    dj = 2 * dq + b - 1
                    if 0 <= dj < 7:
                        w4[:, (a * 2 + b) * c:(a * 2 + b + 1) * c, dp, dq] = (
                            w7[:, :, di, dj])
    return w4


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``'SAME'`` padding of one spatial dim: the odd pixel goes
    last."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)``: an f32 ``(O, I, kh, kw)`` weight,
    computed in ``dtype`` on NCHW input, with ``'SAME'`` or explicit
    ``((top, bottom), (left, right))`` padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: Union[str, Pads] = "SAME",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            (t, b), (l, r) = (_same_pads(x.shape[2], self.kernel, self.stride),
                              _same_pads(x.shape[3], self.kernel, self.stride))
        else:
            (t, b), (l, r) = self.padding
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if (t, l) == (b, r):
            return F.conv2d(x, w, stride=self.stride, padding=(t, l))
        return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW input:
    f32 scale/bias and running statistics, output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        del generator  # deterministic init
        nn.init.zeros_(self.weight) if self.zero_scale else nn.init.ones_(
            self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if train:
            # the native op hands back the f32 batch mean and 1/sqrt(biased
            # var + eps) it normalized with, so the running statistics cost
            # no second pass over x; unlike F.batch_norm it also takes a
            # batch of one value per channel (variance 0), as flax does
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            with torch.no_grad():
                var = (invstd.float().pow(-2) - self.eps).clamp_(min=0.0)
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, training=False,
                             eps=self.eps)
        return y.to(self.dtype)


class ResNetBlock(nn.Module):
    """Basic block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(in_ch, filters, 3, stride, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or in_ch != filters:
            self.conv_proj = Conv(in_ch, filters, 1, stride, dtype=dtype)
            self.norm_proj = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x), train)
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """Bottleneck block (ResNet-50/101/152); the stride sits on the 3x3
    conv (v1.5)."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_ch, filters, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self.Conv_2 = Conv(filters, out, 1, dtype=dtype)
        # zero-init the last norm's scale: the residual branch starts as
        # identity
        self.BatchNorm_2 = BatchNorm(out, dtype, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or in_ch != out:
            self.conv_proj = Conv(in_ch, out, 1, stride, dtype=dtype)
            self.norm_proj = BatchNorm(out, dtype)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x), train)
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 on NHWC input, returning f32 logits.

    ``stem``: ``"conv"`` = 7x7/s2 + 3x3/s2 max-pool (ImageNet); ``"s2d"`` =
    space-to-depth then 4x4/s1 (takes raw [N,H,W,3] or pre-folded
    [N,H/2,W/2,12] input); ``"cifar"`` = 3x3/s1, no max-pool.  Weights are
    initialized as flax initializes them, from ``generator`` (default: seed
    0)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, stem: str = "conv",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stem not in ("conv", "s2d", "cifar"):
            raise ValueError(f"unknown stem {stem!r}")
        self.dtype, self.stem = dtype, stem
        if stem == "s2d":
            self.conv_init = Conv(12, num_filters, 4, 1, ((2, 1), (2, 1)), dtype)
        elif stem == "cifar":
            self.conv_init = Conv(3, num_filters, 3, 1, ((1, 1), (1, 1)), dtype)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, ((3, 3), (3, 3)), dtype)
        self.bn_init = BatchNorm(num_filters, dtype)
        in_ch, idx = num_filters, 0
        self.blocks = []
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                stride = 2 if i > 0 and j == 0 else 1
                block = block_cls(in_ch, num_filters * 2**i, stride, dtype)
                self.add_module(f"{block_cls.__name__}_{idx}", block)
                self.blocks.append(block)
                in_ch, idx = num_filters * 2**i * block_cls.expansion, idx + 1
        self.head = nn.Linear(in_ch, num_classes)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (Conv, BatchNorm)):
                    mod.reset_parameters(generator)
            _lecun_normal_(self.head.weight, self.head.in_features, generator)
            nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem == "s2d":
            if x.shape[-1] == 3:
                if x.shape[1] % 2 or x.shape[2] % 2:
                    raise ValueError(
                        "s2d stem needs even H and W to fold 2x2 tiles; got "
                        f"{x.shape[1]}x{x.shape[2]}")
                x = space_to_depth(x, 2)
            elif x.shape[-1] != 12:
                raise ValueError(
                    "s2d stem accepts raw [N,H,W,3] or pre-folded "
                    f"[N,H/2,W/2,12] input; got C={x.shape[-1]}")
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (a channels-last view)
        x = F.relu(self.bn_init(self.conv_init(x), train))
        if self.stem != "cifar":
            x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x, train)
        x = x.mean(dim=(2, 3))
        return self.head(x.float())


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2],
                             block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3],
                             block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3],
                              block_cls=BottleneckBlock)

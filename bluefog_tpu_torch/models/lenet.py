"""LeNet-5, written by hand: the model of the reference's MNIST example.

Counterpart of ``bluefog_tpu/models/lenet.py`` (BASELINE.json ``configs[0]``:
LeNet on a ring topology), with flax's submodule names (``Conv_0``,
``Conv_1``, ``Dense_0`` ... ``Dense_2``), so
:func:`bluefog_tpu_torch.convert.load_flax` carries its flax weights across
one to one.  As there: NHWC input, a 5x5 ``'SAME'`` conv and a 5x5
``'VALID'`` conv, each with a bias, a ReLU and a 2x2 max-pool; three dense
layers, the last (the head) in f32.  The flatten runs in NHWC order, as the
flax model's ``reshape`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bluefog_tpu_torch.models.resnet import _lecun_normal_

__all__ = ["LeNet5"]


class LeNet5(nn.Module):
    """LeNet-5 for 28x28x1 NHWC inputs, returning f32 logits; the convs and
    the first two dense layers compute in ``dtype``.  Weights are initialized
    as flax initializes them (lecun-normal kernels, zero biases) from
    ``generator`` (default: seed 0)."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(1, 6, 5)
        self.Conv_1 = nn.Conv2d(6, 16, 5)
        self.Dense_0 = nn.Linear(16 * 5 * 5, 120)
        self.Dense_1 = nn.Linear(120, 84)
        self.Dense_2 = nn.Linear(84, num_classes)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for mod in self.children():
                _lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
                nn.init.zeros_(mod.bias)

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), layer.weight.to(self.dtype),
                        layer.bias.to(self.dtype))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """``train`` is accepted for the image models' common signature;
        LeNet has no layer that depends on it."""
        del train
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv, pad in ((self.Conv_0, 2), (self.Conv_1, 0)):
            x = F.conv2d(x, conv.weight.to(self.dtype),
                         conv.bias.to(self.dtype), padding=pad)
            x = F.max_pool2d(F.relu(x), 2, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flatten in NHWC order
        x = F.relu(self._dense(self.Dense_0, x))
        x = F.relu(self._dense(self.Dense_1, x))
        return F.linear(x.float(), self.Dense_2.weight, self.Dense_2.bias)

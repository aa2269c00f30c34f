"""Models, written by hand in PyTorch to compute what the flax ones do."""

from bluefog_tpu_torch.models.resnet import (  # noqa: F401
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet50,
    ResNet101,
    ResNetBlock,
    space_to_depth,
)

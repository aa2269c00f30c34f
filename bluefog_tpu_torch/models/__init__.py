"""Models, written by hand in PyTorch to compute what the flax ones do."""

from bluefog_tpu_torch.models.lenet import LeNet5  # noqa: F401
from bluefog_tpu_torch.models.resnet import (  # noqa: F401
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet50,
    ResNet101,
    ResNetBlock,
    space_to_depth,
)
from bluefog_tpu_torch.models.transformer import (  # noqa: F401
    Block,
    GPTConfig,
    TransformerLM,
)
from bluefog_tpu_torch.models.bert import (  # noqa: F401
    BertConfig,
    BertEncoder,
)
from bluefog_tpu_torch.models.vit import ViT, ViTConfig  # noqa: F401
from bluefog_tpu_torch.models.moe import (  # noqa: F401
    MoEConfig,
    MoEMLP,
    MoETransformerLM,
)

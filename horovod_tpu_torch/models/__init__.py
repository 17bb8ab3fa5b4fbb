"""Models of the port."""

from horovod_tpu_torch.models.inception import InceptionV3, VGG16  # noqa: F401
from horovod_tpu_torch.models.mlp import MLP, ConvNet   # noqa: F401
from horovod_tpu_torch.models.resnet import (   # noqa: F401
    BottleneckBlock, ResNet, ResNet50, ResNet101, ResNet152,
)
from horovod_tpu_torch.models.transformer import (   # noqa: F401
    Attention, Block, BlockStack, TransformerLM,
)

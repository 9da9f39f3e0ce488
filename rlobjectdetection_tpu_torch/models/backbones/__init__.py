from .resnet import FrozenBatchNorm, ResLayer, ResNetBase, ResNetHead
from .vgg import VGGBase, VGGHead

__all__ = ["FrozenBatchNorm", "ResLayer", "ResNetBase", "ResNetHead", "VGGBase", "VGGHead"]

from .resnet import FrozenBatchNorm, ResLayer, ResNetBase, ResNetHead

__all__ = ["FrozenBatchNorm", "ResLayer", "ResNetBase", "ResNetHead"]

"""Model families of the port (ResNet-50 so far)."""

from .resnet import (BatchNorm, BottleneckBlock, ResNet, ResNetConfig,
                     resnet50)

__all__ = ["BatchNorm", "BottleneckBlock", "ResNet", "ResNetConfig",
           "resnet50"]

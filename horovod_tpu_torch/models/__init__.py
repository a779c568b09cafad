"""Model families of the port (ResNet v1: ResNet-50 and the CIFAR
ResNet-20 family)."""

from .resnet import (BasicBlock, BatchNorm, BottleneckBlock, ResNet,
                     ResNetConfig, cifar_resnet_v1, resnet50)

__all__ = ["BasicBlock", "BatchNorm", "BottleneckBlock", "ResNet",
           "ResNetConfig", "cifar_resnet_v1", "resnet50"]

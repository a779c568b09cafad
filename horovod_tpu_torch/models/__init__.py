"""Model families of the port: the ResNets (v1: ResNet-50/101 and the
CIFAR ResNet v1 family; v2: the pre-activation CIFAR family), VGG and
Inception V3 — the JAX package's ``models`` but for the MNIST CNN and
word2vec (``ROADMAP.md`` item 15)."""

from .inception import InceptionV3, inception_v3
from .resnet import (BasicBlock, BatchNorm, BottleneckBlock, PreActBlock,
                     ResNet, ResNetConfig, cifar_resnet_v1, cifar_resnet_v2,
                     resnet50, resnet101)
from .vgg import VGG, vgg16, vgg19

__all__ = ["BasicBlock", "BatchNorm", "BottleneckBlock", "PreActBlock",
           "ResNet", "ResNetConfig", "cifar_resnet_v1", "cifar_resnet_v2",
           "resnet50", "resnet101", "VGG", "vgg16", "vgg19", "InceptionV3",
           "inception_v3"]

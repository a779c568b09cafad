"""VGG in PyTorch — the reference's third benchmark family.

Port of the JAX package's ``models/vgg.py`` (:24-70): VGG-D depths 11,
13, 16 and 19 — stages of 3x3 SAME convs WITH bias (filters
``min(64·2^s, 512)``), each conv followed by ReLU, each stage by a 2x2
VALID max-pool; the map flattened in NHWC order (h, w, c), so the rows of
``fc6.kernel`` are flax's; ``fc6``/``fc7`` (``dense_features``) in the
compute dtype, each followed by ReLU and dropout 0.5 in training; the
head in f32. Modules carry the flax names (``conv<stage>_<i>``,
``fc6``, ``fc7``, ``head``), so :func:`horovod_tpu_torch.convert.
conv_from_jax` is a name map.

flax builds ``fc6`` lazily from the first input; the port sizes it at
construction from ``image_size`` (the flattened map of an
``image_size``² input), and checks the depth there too (the JAX module
raises the same ``ValueError`` when it is first called).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .resnet import Conv, Dense, Dropout, max_pool_valid

# Convs per stage (filters double per stage up to 512).
_CFG = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


class VGG(nn.Module):
    """VGG-D family (11/13/16/19 layers) for ``image_size``² inputs
    (224 by default)."""

    def __init__(self, depth: int = 16, num_classes: int = 1000, *,
                 dtype: torch.dtype = torch.bfloat16,
                 dense_features: Sequence[int] = (4096, 4096),
                 dropout_rate: float = 0.5, image_size: int = 224,
                 dropout_seed: int = 0, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if depth not in _CFG:
            raise ValueError(
                f"VGG depth must be one of {sorted(_CFG)}; got {depth}")
        dev = resolve_device(device)
        self.depth, self.dtype = depth, dtype
        self.dense_features = tuple(dense_features)
        cin, filters, hw = 3, 64, image_size
        for stage, n_convs in enumerate(_CFG[depth]):
            for i in range(n_convs):
                name = f"conv{stage + 1}_{i + 1}"
                self.add_module(name, Conv(cin, min(filters, 512), 3, dev,
                                           bias=True))
                cin = min(filters, 512)
            hw //= 2
            filters *= 2
        if hw < 1:
            raise ValueError(f"image_size {image_size} pools to nothing "
                             f"after {len(_CFG[depth])} stages")
        feats = hw * hw * cin
        self.fc_names = []
        for i, width in enumerate(self.dense_features):
            name = f"fc{i + 6}"
            self.add_module(name, Dense(feats, width, dev, dtype=dtype))
            self.fc_names.append(name)
            feats = width
        self.dropout = Dropout(dropout_rate, dropout_seed, dev)
        self.head = Dense(feats, num_classes, dev)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's initializers (lecun-normal kernels, zero biases), drawn
        on the CPU from ``generator``."""
        for mod in self.modules():
            if isinstance(mod, (Conv, Dense)):
                mod.init(generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        for stage, n_convs in enumerate(_CFG[self.depth]):
            for i in range(n_convs):
                x = torch.relu(getattr(self, f"conv{stage + 1}_{i + 1}")
                               .same(x))
            x = max_pool_valid(x, 2, 2)
        x = x.reshape(x.shape[0], -1)
        for name in self.fc_names:
            x = self.dropout(torch.relu(getattr(self, name)(x)), train)
        return self.head(x)


def vgg16(num_classes: int = 1000, **kw) -> VGG:
    """VGG-16 (the reference's benchmark model)."""
    return VGG(depth=16, num_classes=num_classes, **kw)


def vgg19(num_classes: int = 1000, **kw) -> VGG:
    return VGG(depth=19, num_classes=num_classes, **kw)

"""Inception V3 in PyTorch — the reference's headline benchmark model.

Port of the JAX package's ``models/inception.py`` (:26-185): ``ConvBN``,
``InceptionA``, ``ReductionA``, ``InceptionB``, ``ReductionB``,
``InceptionC``, ``InceptionV3`` and ``inception_v3``, with flax's
auto-names (``ConvBN_<i>`` in creation order inside each block,
``InceptionA_<i>`` … inside the model, ``Conv_0``/``BatchNorm_0`` inside
each ``ConvBN``, ``head``), so :func:`horovod_tpu_torch.convert.
conv_from_jax` is a name map.

Semantics carried over (each a parity trap): BatchNorm with ε = 1e-3
(momentum 0.9); SAME or VALID padding conv by conv (flax's SAME split);
the asymmetric 1x7 / 7x1 / 1x3 / 3x1 kernels; the 3x3 stride-1 SAME
average pool counts the padding (flax's ``count_include_pad=True``: the
border windows divide by 9); VALID 3x3 stride-2 max-pools; the branches
concatenated on channels in the JAX order; dropout 0.2 before the f32
head in training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from .resnet import (BatchNorm, Conv, Dense, Dropout, global_avg_pool,
                     max_pool_valid)

EPSILON = 1e-3


class ConvBN(nn.Module):
    """conv (no bias) → BN (ε 1e-3) → ReLU, the slim ``conv2d`` unit."""

    def __init__(self, cin: int, features: int,
                 kernel: Tuple[int, int] = (1, 1), stride: int = 1,
                 padding: str = "SAME", *, device, axis_name=None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got "
                             f"{padding!r}")
        self.stride, self.padding = stride, padding
        self.features = features
        self.Conv_0 = Conv(cin, features, kernel, device)
        self.BatchNorm_0 = BatchNorm(features, device, epsilon=EPSILON,
                                     axis_name=axis_name)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.padding == "SAME":
            y = self.Conv_0.same(x, self.stride)
        else:
            y = self.Conv_0(x, self.stride)
        return torch.relu(self.BatchNorm_0(y, train))


class _Block(nn.Module):
    """A mixed block: ``ConvBN_<i>`` registered in creation order. The
    branches are tuples of those modules (a tuple attribute registers
    nothing, so each module keeps its one flax name)."""

    def __init__(self, device, axis_name):
        super().__init__()
        self._dev, self._axis = device, axis_name
        self._n = 0

    def cbn(self, cin, features, kernel=(1, 1), stride=1, padding="SAME"):
        mod = ConvBN(cin, features, kernel, stride, padding,
                     device=self._dev, axis_name=self._axis)
        self.add_module(f"ConvBN_{self._n}", mod)
        self._n += 1
        return mod


def _run(branch, x, train):
    for m in branch:
        x = m(x, train)
    return x


def avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``avg_pool(x, (3, 3), (1, 1), padding="SAME")`` on NHWC: the
    padded zeros count, so every window divides by 9. The pool runs on a
    contiguous NCHW copy: on the card (torch 2.11, CUDA 12.8) the
    channels-last ``avg_pool2d`` backward gave other gradients than the
    CPU's (1.08 of their size, f64); the NCHW one gives the CPU's."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, 1, padding=1,
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1).contiguous()


def _cat(*xs):
    return torch.cat(xs, dim=-1)


class InceptionA(_Block):
    """35×35 mixed block (slim Mixed_5b/5c/5d)."""

    def __init__(self, cin: int, pool_features: int, *, device,
                 axis_name=None):
        super().__init__(device, axis_name)
        self.b1 = (self.cbn(cin, 64),)
        self.b5 = (self.cbn(cin, 48), self.cbn(48, 64, (5, 5)))
        self.b3 = (self.cbn(cin, 64), self.cbn(64, 96, (3, 3)),
                   self.cbn(96, 96, (3, 3)))
        self.bp = (self.cbn(cin, pool_features),)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x, train):
        return _cat(_run(self.b1, x, train), _run(self.b5, x, train),
                    _run(self.b3, x, train),
                    _run(self.bp, avg_pool_3x3_same(x), train))


class ReductionA(_Block):
    """35→17 grid reduction (slim Mixed_6a)."""

    def __init__(self, cin: int, *, device, axis_name=None):
        super().__init__(device, axis_name)
        self.b3 = (self.cbn(cin, 384, (3, 3), 2, "VALID"),)
        self.bd = (self.cbn(cin, 64), self.cbn(64, 96, (3, 3)),
                   self.cbn(96, 96, (3, 3), 2, "VALID"))
        self.out_channels = 384 + 96 + cin

    def forward(self, x, train):
        return _cat(_run(self.b3, x, train), _run(self.bd, x, train),
                    max_pool_valid(x, 3, 2))


class InceptionB(_Block):
    """17×17 mixed block with factorized 7×7 (slim Mixed_6b..6e)."""

    def __init__(self, cin: int, channels_7x7: int, *, device,
                 axis_name=None):
        super().__init__(device, axis_name)
        c = channels_7x7
        self.b1 = (self.cbn(cin, 192),)
        self.b7 = (self.cbn(cin, c), self.cbn(c, c, (1, 7)),
                   self.cbn(c, 192, (7, 1)))
        self.bd = (self.cbn(cin, c), self.cbn(c, c, (7, 1)),
                   self.cbn(c, c, (1, 7)), self.cbn(c, c, (7, 1)),
                   self.cbn(c, 192, (1, 7)))
        self.bp = (self.cbn(cin, 192),)
        self.out_channels = 4 * 192

    def forward(self, x, train):
        return _cat(_run(self.b1, x, train), _run(self.b7, x, train),
                    _run(self.bd, x, train),
                    _run(self.bp, avg_pool_3x3_same(x), train))


class ReductionB(_Block):
    """17→8 grid reduction (slim Mixed_7a)."""

    def __init__(self, cin: int, *, device, axis_name=None):
        super().__init__(device, axis_name)
        self.b3 = (self.cbn(cin, 192), self.cbn(192, 320, (3, 3), 2,
                                                 "VALID"))
        self.b7 = (self.cbn(cin, 192), self.cbn(192, 192, (1, 7)),
                   self.cbn(192, 192, (7, 1)),
                   self.cbn(192, 192, (3, 3), 2, "VALID"))
        self.out_channels = 320 + 192 + cin

    def forward(self, x, train):
        return _cat(_run(self.b3, x, train), _run(self.b7, x, train),
                    max_pool_valid(x, 3, 2))


class InceptionC(_Block):
    """8×8 mixed block with expanded 3×3 splits (slim Mixed_7b/7c)."""

    def __init__(self, cin: int, *, device, axis_name=None):
        super().__init__(device, axis_name)
        self.b1 = (self.cbn(cin, 320),)
        self.b3 = (self.cbn(cin, 384),)
        self.b3_split = (self.cbn(384, 384, (1, 3)),
                         self.cbn(384, 384, (3, 1)))
        self.bd = (self.cbn(cin, 448), self.cbn(448, 384, (3, 3)))
        self.bd_split = (self.cbn(384, 384, (1, 3)),
                         self.cbn(384, 384, (3, 1)))
        self.bp = (self.cbn(cin, 192),)
        self.out_channels = 320 + 768 + 768 + 192

    def forward(self, x, train):
        b3 = _run(self.b3, x, train)
        bd = _run(self.bd, x, train)
        return _cat(_run(self.b1, x, train),
                    *(m(b3, train) for m in self.b3_split),
                    *(m(bd, train) for m in self.bd_split),
                    _run(self.bp, avg_pool_3x3_same(x), train))


class InceptionV3(nn.Module):
    """Inception V3 for 299×299 inputs (any size from 75² works: global
    pool). ``axis_name`` makes its BatchNorms cross-replica in
    training."""

    def __init__(self, num_classes: int = 1000, *,
                 dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.2, dropout_seed: int = 0,
                 axis_name=None, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        kw = dict(device=dev, axis_name=axis_name)
        stem = ((3, 32, (3, 3), 2, "VALID"), (32, 32, (3, 3), 1, "VALID"),
                (32, 64, (3, 3), 1, "SAME"), (64, 80, (1, 1), 1, "SAME"),
                (80, 192, (3, 3), 1, "VALID"))
        for i, (cin, f, k, s, pad) in enumerate(stem):
            self.add_module(f"ConvBN_{i}", ConvBN(cin, f, k, s, pad, **kw))
        blocks = []
        c = 192
        for i, pf in enumerate((32, 64, 64)):
            blocks.append((f"InceptionA_{i}", InceptionA(c, pf, **kw)))
            c = blocks[-1][1].out_channels
        blocks.append(("ReductionA_0", ReductionA(c, **kw)))
        c = blocks[-1][1].out_channels
        for i, c7 in enumerate((128, 160, 160, 192)):
            blocks.append((f"InceptionB_{i}", InceptionB(c, c7, **kw)))
            c = blocks[-1][1].out_channels
        blocks.append(("ReductionB_0", ReductionB(c, **kw)))
        c = blocks[-1][1].out_channels
        for i in range(2):
            blocks.append((f"InceptionC_{i}", InceptionC(c, **kw)))
            c = blocks[-1][1].out_channels
        self.block_names = []
        for name, mod in blocks:
            self.add_module(name, mod)
            self.block_names.append(name)
        self.dropout = Dropout(dropout_rate, dropout_seed, dev)
        self.head = Dense(c, num_classes, dev)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's initializers (lecun-normal kernels, BN scale 1, zero
        biases, running stats 0/1), drawn on the CPU from
        ``generator``."""
        for mod in self.modules():
            if isinstance(mod, (Conv, BatchNorm, Dense)):
                mod.init(generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        x = self.ConvBN_0(x, train)
        x = self.ConvBN_1(x, train)
        x = self.ConvBN_2(x, train)
        x = max_pool_valid(x, 3, 2)
        x = self.ConvBN_3(x, train)
        x = self.ConvBN_4(x, train)
        x = max_pool_valid(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = global_avg_pool(x)
        return self.head(self.dropout(x, train))


def inception_v3(num_classes: int = 1000, **kw) -> InceptionV3:
    """Inception V3 (the reference's headline benchmark model)."""
    return InceptionV3(num_classes=num_classes, **kw)

"""ResNet v1 in PyTorch (ResNet-50 and the CIFAR ResNet-20 family), with
the fused 1x1 conv + BatchNorm backend.

Port of the JAX package's ``models/resnet.py``: ``_FusedConv1x1`` and
``_FoldedBN`` (:35-119), ``BasicBlock`` (:122-143), ``BottleneckBlock``
(:146-279, with ``fused_parts``), ``ResNet`` (:310-401, with the CIFAR
stem), ``cifar_resnet_v1`` (:409) and ``resnet50`` (:431). Modules are
named after the flax scopes (``stem``, ``stem_bn``, ``BottleneckBlock_<i>``
or ``BasicBlock_<i>`` numbered across stages, ``Conv_0..2``,
``BatchNorm_0..2``, ``shortcut``, ``shortcut_bn``, ``head``), so
:mod:`horovod_tpu_torch.convert` is a name map. Conv kernels
are ``[Cout, Cin, kh, kw]`` (flax's ``[kh, kw, Cin, Cout]`` transposed);
the head kernel stays ``[in, out]``.

Activations are NHWC tensors ``[N, H, W, C]`` (channels last in memory),
so a 1x1 conv's input is ``x.reshape(-1, C)`` for free; the stock convs
see the same storage as an NCHW view in channels_last format.

Semantics carried over from flax (each a parity trap):

* SAME padding is flax's: the stride-2 3x3 conv and the stem max-pool
  pad ``(0, 1)`` on even inputs, not torch's ``(1, 1)``; the pool pads
  with -inf.
* :class:`BatchNorm`: f32 statistics, fast variance ``max(0, E[x²] −
  E[x]²)``, running update ``0.9·ra + 0.1·batch`` with the BIASED
  variance, normalisation in f32, output in the model's dtype.
  ``torch.nn.BatchNorm2d`` differs on both counts, so it is not used.
* :meth:`BatchNorm.fold` (``_FoldedBN``) computes ``var = mean2 − mu²``
  with NO clamp and returns the per-channel affine ``(a, b)``.
* The fused branch runs only in training, and only when the JAX model
  would take it: ``M % 128 == 0`` for the block's input rows and for
  ``M / (sh·sw)``, with the spatial dims divisible by the stride. Eval
  always takes the stock branch (BatchNorm on running averages).
* The global average pool of a bf16 map is rounded to bf16 before the
  f32 head.

BatchNorm here is local to each replica (the bench's ``axis_name=None``);
cross-replica BatchNorm is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.fused_conv_bn import (conv_bn_supported, fused_linear_bn_act,
                                 fused_linear_bn_act_reference)

MOMENTUM = 0.9
EPSILON = 1e-5
# The bottleneck block's 1x1 conv sites the fused kernels can take.
FUSED_PARTS = ("reduce", "expand", "shortcut")


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """What the JAX ``ResNet`` module's fields say about the network.

    ``stage_sizes`` counts blocks per stage; ``block`` is
    ``"bottleneck"`` (``BottleneckBlock``) or ``"basic"``
    (``BasicBlock``); ``cifar_stem`` takes the 3x3 stride-1 stem with no
    max-pool. ``conv_backend`` is ``"xla"`` (stock convs; the JAX name is
    kept) or ``"fused"`` (the training-mode 1x1 convs of the bottleneck
    blocks of ``fused_stages`` through
    :func:`~horovod_tpu_torch.ops.fused_conv_bn.fused_linear_bn_act`);
    ``fused_parts`` names which of a block's 1x1 convs (``reduce``,
    ``expand``, ``shortcut``) take the kernels — the others run stock
    convs inside the fused branch."""

    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    num_classes: int = 1000
    num_filters: int = 64
    dtype: torch.dtype = torch.bfloat16
    conv_backend: str = "xla"
    fused_stages: Tuple[int, ...] = (0, 1)
    fused_parts: Tuple[str, ...] = FUSED_PARTS
    block: str = "bottleneck"
    cifar_stem: bool = False

    def __post_init__(self):
        if self.conv_backend not in ("xla", "fused"):
            raise ValueError(f"conv_backend must be 'xla' or 'fused', got "
                             f"{self.conv_backend!r}")
        if self.block not in ("bottleneck", "basic"):
            raise ValueError(f"block must be 'bottleneck' or 'basic', got "
                             f"{self.block!r}")
        unknown = set(self.fused_parts) - set(FUSED_PARTS)
        if unknown:
            raise ValueError(f"fused_parts {sorted(unknown)} are not among "
                             f"{FUSED_PARTS}")


def jax_fusable(m: int) -> bool:
    """The JAX package's routing gate (``pallas_conv.fusable``): the fused
    branch needs ``M % 128 == 0``."""
    return m % 128 == 0


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``padding="SAME"``: ``(lo, hi)`` for one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _trunc_normal_(t: torch.Tensor, std: float,
                   gen: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, scaled so the
    variance is ``std²``."""
    with torch.no_grad():
        cpu = torch.empty(t.shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(cpu, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.copy_(cpu * (std / 0.87962566103423978))


class Conv(nn.Module):
    """A bias-free conv holding ``kernel [Cout, Cin, kh, kw]`` f32."""

    def __init__(self, cin: int, cout: int, k: int, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((cout, cin, k, k),
                                               dtype=torch.float32,
                                               device=device))

    def init(self, gen):
        cout, cin, kh, kw = self.kernel.shape
        _trunc_normal_(self.kernel, math.sqrt(1.0 / (cin * kh * kw)), gen)

    def forward(self, x: torch.Tensor, stride: int = 1,
                pads: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0),
                                                                  (0, 0))
                ) -> torch.Tensor:
        """NHWC in, NHWC out, in x's dtype (the kernel cast to it)."""
        (pt, pb), (pl, pr) = pads
        xc = x.permute(0, 3, 1, 2)
        w = self.kernel.to(x.dtype)
        if pt == pb and pl == pr:
            y = F.conv2d(xc, w, stride=stride, padding=(pt, pl))
        else:
            y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), w, stride=stride)
        return y.permute(0, 2, 3, 1).contiguous()

    def matrix(self) -> torch.Tensor:
        """A 1x1 kernel as ``[Cout, Cin]`` (a view, no copy)."""
        return self.kernel.view(self.kernel.shape[0], self.kernel.shape[1])


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NHWC input
    (statistics over every axis but the last), and — through
    :meth:`fold` — the JAX ``_FoldedBN`` over the same variables: params
    ``scale``/``bias``, batch_stats ``mean``/``var`` (buffers), all f32."""

    def __init__(self, features: int, device, zero_scale: bool = False):
        super().__init__()
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("mean", torch.empty(features, device=device))
        self.register_buffer("var", torch.empty(features, device=device))

    def init(self, gen=None):
        with torch.no_grad():
            self.scale.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = MOMENTUM
        with torch.no_grad():
            self.mean.copy_(m * self.mean + (1 - m) * mean.detach())
            self.var.copy_(m * self.var + (1 - m) * var.detach())

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.float()
        if train:
            mean, mean2 = _moments(xf)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            self._update(mean, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + EPSILON) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)

    def fold(self, s1=None, s2=None, count=None, x=None):
        """``_FoldedBN``: batch statistics from a producer kernel's sums
        (``s1``, ``s2``, ``count``) or from a raw tensor ``x``; variance
        ``mean2 − mean²`` with no clamp; running statistics updated.
        Returns the folded affine ``(a, b)``: ``a = scale·rsqrt(var +
        eps)``, ``b = bias − mean·a``."""
        if x is not None:
            mean, mean2 = _moments(x.float())
        else:
            mean, mean2 = s1 / count, s2 / count
        var = mean2 - mean * mean
        self._update(mean, var)
        a = self.scale * torch.rsqrt(var + EPSILON)
        return a, self.bias - mean * a


def _moments(xf: torch.Tensor):
    axes = tuple(range(xf.dim() - 1))
    return xf.mean(axes), (xf * xf).mean(axes)


def fused_conv1x1(conv: Conv, x2: torch.Tensor, a=None, b=None):
    """The JAX ``_FusedConv1x1``: ``(y, s1, s2, count)`` of a 1x1 conv on
    ``x2 [M, Cin]`` (in the block's ``cfg.dtype``) through the fused
    kernel, optionally behind the ``relu(a·x + b)`` prologue. Where the
    card's kernels do not take the model (an f32 model, channels that are
    not multiples of 64: :func:`~..ops.fused_conv_bn.conv_bn_supported`)
    the plain version runs under autograd, the same math the CPU runs."""
    w = conv.matrix()
    if conv_bn_supported(x2.device, x2.dtype, *x2.shape, w.shape[0]):
        y, s1, s2 = fused_linear_bn_act(x2, w, a, b)
    else:
        y, s1, s2 = fused_linear_bn_act_reference(x2, w, a, b)
    return y, s1, s2, x2.shape[0]


def _relu_affine(a, y, b, dtype):
    """``relu(a·y + b)`` in f32, rounded to ``dtype``."""
    return torch.relu(a * y.float() + b).to(dtype)


class BottleneckBlock(nn.Module):
    """ResNet v1 bottleneck: 1x1 reduce -> 3x3 (carries the stride) ->
    1x1 expand (x4), with a projection shortcut when the shape changes.
    One parameter per conv serves both branches."""

    def __init__(self, cin: int, filters: int, stride: int, fused: bool,
                 dtype: torch.dtype, device,
                 fused_parts: Sequence[str] = FUSED_PARTS):
        super().__init__()
        f = filters
        self.filters, self.stride, self.fused, self.dtype = (f, stride,
                                                             fused, dtype)
        self.fused_parts = tuple(fused_parts)
        self.Conv_0 = Conv(cin, f, 1, device)
        self.BatchNorm_0 = BatchNorm(f, device)
        self.Conv_1 = Conv(f, f, 3, device)
        self.BatchNorm_1 = BatchNorm(f, device)
        self.Conv_2 = Conv(f, 4 * f, 1, device)
        self.BatchNorm_2 = BatchNorm(4 * f, device, zero_scale=True)
        self.has_shortcut = cin != 4 * f or stride != 1
        if self.has_shortcut:
            self.shortcut = Conv(cin, 4 * f, 1, device)
            self.shortcut_bn = BatchNorm(4 * f, device)

    def takes_fused_branch(self, x: torch.Tensor, train: bool) -> bool:
        """The JAX block's rule (``resnet.py:253-263``): training, and both
        the input's and the strided output's row counts tile by 128."""
        if not (self.fused and train):
            return False
        n, h, w, _ = x.shape
        m, s = n * h * w, self.stride
        return (jax_fusable(m) and jax_fusable(m // (s * s))
                and h % s == 0 and w % s == 0)

    def _conv3x3(self, z: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = z.shape
        return self.Conv_1(z, self.stride, (same_pads(h, 3, self.stride),
                                            same_pads(w, 3, self.stride)))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.takes_fused_branch(x, train):
            return self._fused(x)
        return self._stock(x, train)

    def _stock(self, x, train):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = torch.relu(self.BatchNorm_1(self._conv3x3(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = x
        if self.has_shortcut:
            residual = self.shortcut_bn(self.shortcut(x, self.stride), train)
        return torch.relu(y + residual)

    def _fused(self, x):
        """The JAX ``_fused_call``: each 1x1 conv in ``fused_parts`` through
        the kernels (statistics from their epilogue), the others as stock
        convs with one statistics pass; BatchNorm folded into affines."""
        dtype, f, s, parts = self.dtype, self.filters, self.stride, \
            self.fused_parts
        n, h, w, cin = x.shape
        x2 = x.reshape(-1, cin).to(dtype)
        # 1x1 reduce: raw input, statistics epilogue.
        if "reduce" in parts:
            y, s1, s2, cnt = fused_conv1x1(self.Conv_0, x2)
            a1, b1 = self.BatchNorm_0.fold(s1, s2, cnt)
        else:
            y = self.Conv_0(x)
            a1, b1 = self.BatchNorm_0.fold(x=y)
        z = _relu_affine(a1, y, b1, dtype).view(n, h, w, f)
        # 3x3 (stock conv, carries the stride); its statistics are one
        # reduction pass, folded into the expand conv's prologue.
        y = self._conv3x3(z)
        a2, b2 = self.BatchNorm_1.fold(x=y)
        n2, h2, w2, _ = y.shape
        if "expand" in parts:
            y3, s1, s2, cnt = fused_conv1x1(self.Conv_2, y.reshape(-1, f),
                                            a2, b2)
            a3, b3 = self.BatchNorm_2.fold(s1, s2, cnt)
        else:
            y3 = self.Conv_2(_relu_affine(a2, y, b2, dtype))
            a3, b3 = self.BatchNorm_2.fold(x=y3)
            y3 = y3.reshape(-1, 4 * f)
        if self.has_shortcut:
            if "shortcut" in parts:
                # The strided input is copied to a contiguous [M/s², Cin].
                xs = x[:, ::s, ::s, :].contiguous() if s != 1 else x
                ys, s1, s2, cnt = fused_conv1x1(
                    self.shortcut, xs.reshape(-1, cin).to(dtype))
                a4, b4 = self.shortcut_bn.fold(s1, s2, cnt)
            else:
                ys = self.shortcut(x, s)
                a4, b4 = self.shortcut_bn.fold(x=ys)
                ys = ys.reshape(-1, 4 * f)
            residual = a4 * ys.float() + b4
        else:
            residual = x2.float()
        out = torch.relu(a3 * y3.float() + b3 + residual).to(dtype)
        return out.view(n2, h2, w2, 4 * f)


class BasicBlock(nn.Module):
    """ResNet v1 basic block (JAX ``BasicBlock``): 3x3 conv (carries the
    stride) -> BN -> ReLU -> 3x3 conv -> BN (scale initialised to 0), plus
    a projection shortcut when the shape changes, -> add -> ReLU. Stock
    convs only: the fused kernels take 1x1 convs."""

    def __init__(self, cin: int, filters: int, stride: int,
                 dtype: torch.dtype, device):
        super().__init__()
        f = filters
        self.stride = stride
        self.Conv_0 = Conv(cin, f, 3, device)
        self.BatchNorm_0 = BatchNorm(f, device)
        self.Conv_1 = Conv(f, f, 3, device)
        self.BatchNorm_1 = BatchNorm(f, device, zero_scale=True)
        self.has_shortcut = cin != f or stride != 1
        if self.has_shortcut:
            self.shortcut = Conv(cin, f, 1, device)
            self.shortcut_bn = BatchNorm(f, device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        _, h, w, _ = x.shape
        s = self.stride
        y = self.Conv_0(x, s, (same_pads(h, 3, s), same_pads(w, 3, s)))
        y = torch.relu(self.BatchNorm_0(y, train))
        _, h2, w2, _ = y.shape
        y = self.Conv_1(y, 1, (same_pads(h2, 3, 1), same_pads(w2, 3, 1)))
        y = self.BatchNorm_1(y, train)
        residual = x
        if self.has_shortcut:
            residual = self.shortcut_bn(self.shortcut(x, s), train)
        return torch.relu(y + residual)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=f32)``: ``kernel [in, out]``, ``bias``."""

    def __init__(self, cin: int, cout: int, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((cin, cout), device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def init(self, gen):
        _trunc_normal_(self.kernel, math.sqrt(1.0 / self.kernel.shape[0]),
                       gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return x.float() @ self.kernel + self.bias


class ResNet(nn.Module):
    """ResNet v1: the ImageNet stem (7x7/2 conv + 3x3/2 max-pool) or the
    CIFAR stem (3x3/1 conv, no pool), bottleneck or basic stages, global
    average pool, f32 head. Input: ``[N, H, W, 3]``."""

    def __init__(self, cfg: ResNetConfig, *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        nf = cfg.num_filters
        self.stem = Conv(3, nf, 3 if cfg.cifar_stem else 7, dev)
        self.stem_bn = BatchNorm(nf, dev)
        self.block_names = []
        basic = cfg.block == "basic"
        expansion = 1 if basic else 4
        cin, i = nf, 0
        for stage, count in enumerate(cfg.stage_sizes):
            fused = (cfg.conv_backend == "fused" and not basic
                     and stage in cfg.fused_stages)
            for j in range(count):
                stride = 2 if stage > 0 and j == 0 else 1
                filters = nf * 2 ** stage
                if basic:
                    name = f"BasicBlock_{i}"
                    block = BasicBlock(cin, filters, stride, cfg.dtype, dev)
                else:
                    name = f"BottleneckBlock_{i}"
                    block = BottleneckBlock(cin, filters, stride, fused,
                                            cfg.dtype, dev,
                                            cfg.fused_parts)
                self.add_module(name, block)
                self.block_names.append(name)
                cin, i = expansion * filters, i + 1
        self.head = Dense(cin, cfg.num_classes, dev)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's initializers (lecun-normal kernels, BN scale 1 — 0 for
        each block's last BN —, zero biases, running stats 0/1). Drawn on
        the CPU from ``generator``, so a seed gives the same weights on
        every device."""
        for mod in self.modules():
            if isinstance(mod, (Conv, BatchNorm, Dense)):
                mod.init(generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        dtype = self.cfg.dtype
        x = x.to(dtype)
        if self.cfg.cifar_stem:
            _, h, w, _ = x.shape
            x = self.stem(x, 1, (same_pads(h, 3, 1), same_pads(w, 3, 1)))
            x = torch.relu(self.stem_bn(x, train))
        else:
            x = self.stem(x, 2, ((3, 3), (3, 3)))
            x = torch.relu(self.stem_bn(x, train))
            _, h, w, _ = x.shape
            (pt, pb), (pl, pr) = same_pads(h, 3, 2), same_pads(w, 3, 2)
            xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb),
                       value=float("-inf"))
            x = F.max_pool2d(xc, 3, 2).permute(0, 2, 3, 1).contiguous()
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.float().mean(dim=(1, 2)).to(dtype)
        return self.head(x)


def resnet50(num_classes: int = 1000, *, dtype: torch.dtype = torch.bfloat16,
             conv_backend: str = "xla",
             fused_stages: Sequence[int] = (0, 1),
             fused_parts: Sequence[str] = FUSED_PARTS,
             device: DeviceLike = "cuda",
             generator: Optional[torch.Generator] = None) -> ResNet:
    """ImageNet ResNet-50: stages ``[3, 4, 6, 3]``, 64 base filters."""
    return ResNet(ResNetConfig(stage_sizes=(3, 4, 6, 3),
                               num_classes=num_classes, num_filters=64,
                               dtype=dtype, conv_backend=conv_backend,
                               fused_stages=tuple(fused_stages),
                               fused_parts=tuple(fused_parts)),
                  device=device, generator=generator)


def cifar_resnet_v1(depth: int = 20, num_classes: int = 10, *,
                    dtype: torch.dtype = torch.bfloat16,
                    device: DeviceLike = "cuda",
                    generator: Optional[torch.Generator] = None) -> ResNet:
    """ResNet v1 for CIFAR (``keras-cifar10-resnet.py`` resnet_v1): depth
    ``6n + 2`` (20, 56, 110), three stages of ``n`` basic blocks with 16,
    32 and 64 filters behind the CIFAR stem."""
    if (depth - 2) % 6:
        raise ValueError("v1 depth must be 6n+2 (e.g. 20, 56, 110)")
    n = (depth - 2) // 6
    return ResNet(ResNetConfig(stage_sizes=(n, n, n),
                               num_classes=num_classes, num_filters=16,
                               dtype=dtype, block="basic", cifar_stem=True),
                  device=device, generator=generator)

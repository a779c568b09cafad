"""The ResNet family in PyTorch (ResNet-50/101, the CIFAR ResNet v1 and
v2 families), with the fused 1x1 conv + BatchNorm backend and
cross-replica BatchNorm.

Port of the JAX package's ``models/resnet.py``: ``_FusedConv1x1`` and
``_FoldedBN`` (:35-119), ``BasicBlock`` (:122-143), ``BottleneckBlock``
(:146-279, with ``fused_parts``), ``PreActBlock`` (:282-307), ``ResNet``
(:310-401, with the CIFAR stem and the space-to-depth stem),
``cifar_resnet_v1`` (:409), ``cifar_resnet_v2`` (:420), ``resnet50``
(:431) and ``resnet101`` (:438). Modules are named after the flax scopes
(``stem`` or ``stem_s2d``, ``stem_bn``, ``BottleneckBlock_<i>``,
``BasicBlock_<i>`` or ``PreActBlock_<i>`` numbered across stages,
``Conv_0..2``, ``BatchNorm_0..2``, ``shortcut``, ``shortcut_bn``,
``final_bn``, ``head``), so :mod:`horovod_tpu_torch.convert` is a name
map. Conv kernels are ``[Cout, Cin, kh, kw]`` (flax's ``[kh, kw, Cin,
Cout]`` transposed); the head kernel stays ``[in, out]``.

Activations are NHWC tensors ``[N, H, W, C]`` (channels last in memory),
so a 1x1 conv's input is ``x.reshape(-1, C)`` for free; the stock convs
see the same storage as an NCHW view in channels_last format.

Semantics carried over from flax (each a parity trap):

* SAME padding is flax's: the stride-2 3x3 conv and the stem max-pool
  pad ``(0, 1)`` on even inputs, not torch's ``(1, 1)``; the pool pads
  with -inf.
* :class:`BatchNorm`: statistics in at least f32 (f64 stays f64), fast
  variance ``max(0, E[x²] − E[x]²)``, running update ``0.9·ra +
  0.1·batch`` with the BIASED variance, normalisation in the statistics'
  dtype, output in the model's dtype.
  ``torch.nn.BatchNorm2d`` differs on both counts, so it is not used.
* :meth:`BatchNorm.fold` (``_FoldedBN``) computes ``var = mean2 − mu²``
  with NO clamp and returns the per-channel affine ``(a, b)``.
* Cross-replica BatchNorm (``axis_name``, training only, as the JAX
  ``norm`` partial sets it): the stock path takes ONE mean over the
  group of the concatenated ``[mean, mean2]`` (flax's
  ``_compute_stats``), then clamps the variance; the fused path
  (``fold``) takes the group mean of ``mean`` and ``mean2`` with no
  clamp. The backward of the group mean is the group mean of the
  cotangent (:func:`~..parallel.comm.pmean`, the transpose of JAX's
  ``pmean`` in the world step's ``shard_map(check_vma=False)``), which
  makes the world-averaged gradient the gradient of the whole batch's
  loss. A group of one moves nothing.
* The fused branch runs only in training, and only when the JAX model
  would take it: ``M % 128 == 0`` for the block's input rows and for
  ``M / (sh·sw)``, with the spatial dims divisible by the stride. Eval
  always takes the stock branch (BatchNorm on running averages).
* ``PreActBlock``: BN → ReLU first (``BatchNorm_0`` over the block's
  INPUT channels), the projection shortcut (no BN) reads the
  pre-activated ``y``, no final ReLU, no zero-initialised scale; a
  PreAct model with the CIFAR stem has no ``stem_bn`` and ends in
  ``final_bn`` + ReLU before the pool.
* The space-to-depth stem folds 2x2 patches into 12 channels in JAX's
  ``reshape(n, h/2, 2, w/2, 2, c).transpose(0, 1, 3, 2, 4, 5)`` order
  and runs a 4x4 stride-1 conv ``stem_s2d`` padded ``(2, 1)`` both ways.
* The global average pool of a bf16 map is rounded to bf16 before the
  f32 head.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..runtime import AXIS
from ..ops.fused_conv_bn import (conv_bn_supported, fused_linear_bn_act,
                                 fused_linear_bn_act_reference)

MOMENTUM = 0.9
EPSILON = 1e-5      # the ResNets' BatchNorm epsilon (Inception's is 1e-3)
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
    convs inside the fused branch. ``block="preact"`` takes
    ``PreActBlock``; ``stem_space_to_depth`` the 2x2 space-to-depth
    ImageNet stem. ``axis_name`` makes every BatchNorm cross-replica in
    training (:func:`bn_group`: ``None``, ``AXIS`` or a process
    group)."""

    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    num_classes: int = 1000
    num_filters: int = 64
    dtype: torch.dtype = torch.bfloat16
    conv_backend: str = "xla"
    fused_stages: Tuple[int, ...] = (0, 1)
    fused_parts: Tuple[str, ...] = FUSED_PARTS
    block: str = "bottleneck"
    cifar_stem: bool = False
    stem_space_to_depth: bool = False
    axis_name: Any = None

    def __post_init__(self):
        if self.conv_backend not in ("xla", "fused"):
            raise ValueError(f"conv_backend must be 'xla' or 'fused', got "
                             f"{self.conv_backend!r}")
        if self.block not in ("bottleneck", "basic", "preact"):
            raise ValueError(f"block must be 'bottleneck', 'basic' or "
                             f"'preact', got {self.block!r}")
        check_axis_name(self.axis_name)
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


def check_axis_name(axis_name) -> None:
    """``axis_name`` must be None (local BatchNorm), :data:`AXIS` (the
    world) or a ``torch.distributed`` process group."""
    if axis_name is None or isinstance(axis_name, dist.ProcessGroup):
        return
    if isinstance(axis_name, str) and axis_name == AXIS:
        return
    raise ValueError(f"axis_name must be None, hvd.AXIS ({AXIS!r}) or a "
                     f"torch.distributed process group, got {axis_name!r}")


def bn_group(axis_name):
    """The process group a cross-replica BatchNorm reduces over, resolved
    when the forward runs: None for local BatchNorm, the world's group
    for :data:`AXIS` (``runtime.world()``: raises before ``init``), or
    the given group."""
    if axis_name is None:
        return None
    if isinstance(axis_name, dist.ProcessGroup):
        return axis_name
    from .. import runtime
    runtime.world()
    return dist.group.WORLD


def _group_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The group mean, whose backward is the group mean of the cotangent
    (``parallel.comm.pmean``)."""
    from ..parallel.comm import pmean
    return pmean(x, group)


def _trunc_normal_(t: torch.Tensor, std: float,
                   gen: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, scaled so the
    variance is ``std²``."""
    with torch.no_grad():
        cpu = torch.empty(t.shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(cpu, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.copy_(cpu * (std / 0.87962566103423978))


class Conv(nn.Module):
    """flax ``nn.Conv``: ``kernel [Cout, Cin, kh, kw]`` f32 (``k`` an int
    or ``(kh, kw)``), and with ``bias`` a zero-initialised ``bias [Cout]``
    added in the compute dtype."""

    def __init__(self, cin: int, cout: int, k: Union[int, Tuple[int, int]],
                 device, bias: bool = False):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.kernel = nn.Parameter(torch.empty((cout, cin, kh, kw),
                                               dtype=torch.float32,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(cout, dtype=torch.float32,
                                              device=device))
                     if bias else None)

    def init(self, gen):
        cout, cin, kh, kw = self.kernel.shape
        _trunc_normal_(self.kernel, math.sqrt(1.0 / (cin * kh * kw)), gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor, stride: int = 1,
                pads: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 0),
                                                                  (0, 0))
                ) -> torch.Tensor:
        """NHWC in, NHWC out, in x's dtype (the kernel cast to it)."""
        (pt, pb), (pl, pr) = pads
        xc = x.permute(0, 3, 1, 2)
        w = self.kernel.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if pt == pb and pl == pr:
            y = F.conv2d(xc, w, b, stride=stride, padding=(pt, pl))
        else:
            y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), w, b, stride=stride)
        return y.permute(0, 2, 3, 1).contiguous()

    def same(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        """The conv with flax's ``padding="SAME"`` for ``x``'s size."""
        _, h, w, _ = x.shape
        _, _, kh, kw = self.kernel.shape
        return self(x, stride, (same_pads(h, kh, stride),
                                same_pads(w, kw, stride)))

    def matrix(self) -> torch.Tensor:
        """A 1x1 kernel as ``[Cout, Cin]`` (a view, no copy)."""
        return self.kernel.view(self.kernel.shape[0], self.kernel.shape[1])


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=epsilon)`` over NHWC input
    (statistics over every axis but the last), and — through
    :meth:`fold` — the JAX ``_FoldedBN`` over the same variables: params
    ``scale``/``bias``, batch_stats ``mean``/``var`` (buffers), all f32.
    ``axis_name`` (None, :data:`AXIS` or a process group) takes the
    batch statistics over the group's ranks in training."""

    def __init__(self, features: int, device, zero_scale: bool = False,
                 epsilon: float = EPSILON, axis_name=None):
        super().__init__()
        check_axis_name(axis_name)
        self.zero_scale = zero_scale
        self.epsilon = epsilon
        self.axis_name = axis_name
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
        xf = x.to(stat_dtype(x.dtype))
        if train:
            mean, mean2 = _moments(xf)
            group = bn_group(self.axis_name)
            if group is not None:
                # One collective for both moments (flax stacks them).
                mean, mean2 = _group_mean(torch.stack([mean, mean2]),
                                          group).unbind(0)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            self._update(mean, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((xf - mean) * mul + self.bias).to(x.dtype)

    def fold(self, s1=None, s2=None, count=None, x=None):
        """``_FoldedBN``: batch statistics from a producer kernel's sums
        (``s1``, ``s2``, ``count``) or from a raw tensor ``x``; variance
        ``mean2 − mean²`` with no clamp; running statistics updated.
        Returns the folded affine ``(a, b)``: ``a = scale·rsqrt(var +
        eps)``, ``b = bias − mean·a``."""
        if x is not None:
            mean, mean2 = _moments(x.to(stat_dtype(x.dtype)))
        else:
            mean, mean2 = s1 / count, s2 / count
        group = bn_group(self.axis_name)
        if group is not None:
            mean, mean2 = _group_mean(torch.stack([mean, mean2]),
                                      group).unbind(0)
        var = mean2 - mean * mean
        self._update(mean, var)
        a = self.scale * torch.rsqrt(var + self.epsilon)
        return a, self.bias - mean * a


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """flax's statistics dtype: at least f32 (f64 stays f64)."""
    return torch.promote_types(dtype, torch.float32)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=(1, 2))`` of an NHWC map: summed in at least
    f32, rounded back to x's dtype."""
    return x.to(stat_dtype(x.dtype)).mean(dim=(1, 2)).to(x.dtype)


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
                 fused_parts: Sequence[str] = FUSED_PARTS, axis_name=None):
        super().__init__()
        f = filters
        bn = functools.partial(BatchNorm, device=device, axis_name=axis_name)
        self.filters, self.stride, self.fused, self.dtype = (f, stride,
                                                             fused, dtype)
        self.fused_parts = tuple(fused_parts)
        self.Conv_0 = Conv(cin, f, 1, device)
        self.BatchNorm_0 = bn(f)
        self.Conv_1 = Conv(f, f, 3, device)
        self.BatchNorm_1 = bn(f)
        self.Conv_2 = Conv(f, 4 * f, 1, device)
        self.BatchNorm_2 = bn(4 * f, zero_scale=True)
        self.has_shortcut = cin != 4 * f or stride != 1
        if self.has_shortcut:
            self.shortcut = Conv(cin, 4 * f, 1, device)
            self.shortcut_bn = bn(4 * f)

    def takes_fused_branch(self, x: torch.Tensor, train: bool) -> bool:
        """The JAX block's rule (``resnet.py:253-263``): training, and both
        the input's and the strided output's row counts tile by 128."""
        if not (self.fused and train):
            return False
        n, h, w, _ = x.shape
        m, s = n * h * w, self.stride
        return (jax_fusable(m) and jax_fusable(m // (s * s))
                and h % s == 0 and w % s == 0)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.takes_fused_branch(x, train):
            return self._fused(x)
        return self._stock(x, train)

    def _stock(self, x, train):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = torch.relu(self.BatchNorm_1(self.Conv_1.same(y, self.stride), train))
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
        y = self.Conv_1.same(z, self.stride)
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
                 dtype: torch.dtype, device, axis_name=None):
        super().__init__()
        f = filters
        bn = functools.partial(BatchNorm, device=device, axis_name=axis_name)
        self.stride = stride
        self.Conv_0 = Conv(cin, f, 3, device)
        self.BatchNorm_0 = bn(f)
        self.Conv_1 = Conv(f, f, 3, device)
        self.BatchNorm_1 = bn(f, zero_scale=True)
        self.has_shortcut = cin != f or stride != 1
        if self.has_shortcut:
            self.shortcut = Conv(cin, f, 1, device)
            self.shortcut_bn = bn(f)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        s = self.stride
        y = torch.relu(self.BatchNorm_0(self.Conv_0.same(x, s), train))
        y = self.BatchNorm_1(self.Conv_1.same(y), train)
        residual = x
        if self.has_shortcut:
            residual = self.shortcut_bn(self.shortcut(x, s), train)
        return torch.relu(y + residual)


class PreActBlock(nn.Module):
    """ResNet v2 pre-activation bottleneck (JAX ``PreActBlock``): BN over
    the input's channels -> ReLU, then 1x1 -> BN -> ReLU -> 3x3 (carries
    the stride) -> BN -> ReLU -> 1x1 (x4), plus the input — or, when the
    shape changes, a 1x1 projection (no BN) of the pre-activated input.
    No final ReLU; no zero-initialised scale. Stock convs only."""

    def __init__(self, cin: int, filters: int, stride: int, device,
                 axis_name=None):
        super().__init__()
        f = filters
        bn = functools.partial(BatchNorm, device=device, axis_name=axis_name)
        self.stride = stride
        self.BatchNorm_0 = bn(cin)
        self.has_shortcut = stride != 1 or cin != 4 * f
        if self.has_shortcut:
            self.shortcut = Conv(cin, 4 * f, 1, device)
        self.Conv_0 = Conv(cin, f, 1, device)
        self.BatchNorm_1 = bn(f)
        self.Conv_1 = Conv(f, f, 3, device)
        self.BatchNorm_2 = bn(f)
        self.Conv_2 = Conv(f, 4 * f, 1, device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(x, train))
        residual = self.shortcut(y, self.stride) if self.has_shortcut else x
        y = torch.relu(self.BatchNorm_1(self.Conv_0(y), train))
        y = torch.relu(self.BatchNorm_2(self.Conv_1.same(y, self.stride),
                                        train))
        return self.Conv_2(y) + residual


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=dtype)``: ``kernel [in, out]``, ``bias``, both
    f32; the product and the bias add in ``dtype`` (f32 by default: the
    heads, which stay f32 in a model cast to f64, as flax's do)."""

    def __init__(self, cin: int, cout: int, device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty((cin, cout), device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def init(self, gen):
        _trunc_normal_(self.kernel, math.sqrt(1.0 / self.kernel.shape[0]),
                       gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        if self.dtype == torch.float32:
            return x.float() @ self.kernel.float() + self.bias.float()
        d = self.dtype
        return x.to(d) @ self.kernel.to(d) + self.bias.to(d)


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in training each element is kept with
    probability ``1 - rate`` and divided by it, else zeroed; identity in
    eval and at rate 0. The masks come from an explicit
    ``torch.Generator`` on the activations' device, seeded with ``seed``
    (one is made on ``device`` at construction, and one with the same
    seed for any other device the module later runs on); the global RNG
    is never drawn. They cannot match JAX's PRNG draws."""

    def __init__(self, rate: float, seed: int, device):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dropout rate must be in [0, 1], got {rate}")
        self.rate, self.seed = float(rate), int(seed)
        self._gens = {}
        self.generator(torch.device(device))

    def generator(self, device: torch.device) -> torch.Generator:
        key = str(device)
        gen = self._gens.get(key)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(self.seed)
            self._gens[key] = gen
        return gen

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        if keep == 0.0:
            return torch.zeros_like(x)
        mask = torch.empty(x.shape, dtype=torch.float32,
                           device=x.device).bernoulli_(
            keep, generator=self.generator(x.device))
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


class ResNet(nn.Module):
    """The JAX ``ResNet``: the ImageNet stem (7x7/2 conv, or the 2x2
    space-to-depth fold and a 4x4/1 conv, + 3x3/2 max-pool) or the CIFAR
    stem (3x3/1 conv, no pool), bottleneck, basic or pre-activation
    stages, ``final_bn`` + ReLU for pre-activation stages, global average
    pool, f32 head. Input: ``[N, H, W, 3]``."""

    def __init__(self, cfg: ResNetConfig, *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        nf = cfg.num_filters
        bn = functools.partial(BatchNorm, device=dev,
                               axis_name=cfg.axis_name)
        preact = cfg.block == "preact"
        if cfg.cifar_stem:
            self.stem = Conv(3, nf, 3, dev)
        elif cfg.stem_space_to_depth:
            self.stem_s2d = Conv(12, nf, 4, dev)
        else:
            self.stem = Conv(3, nf, 7, dev)
        self.has_stem_bn = not (cfg.cifar_stem and preact)
        if self.has_stem_bn:
            self.stem_bn = bn(nf)
        self.block_names = []
        expansion = 1 if cfg.block == "basic" else 4
        cin, i = nf, 0
        for stage, count in enumerate(cfg.stage_sizes):
            fused = (cfg.conv_backend == "fused"
                     and cfg.block == "bottleneck"
                     and stage in cfg.fused_stages)
            for j in range(count):
                stride = 2 if stage > 0 and j == 0 else 1
                filters = nf * 2 ** stage
                if cfg.block == "basic":
                    name = f"BasicBlock_{i}"
                    block = BasicBlock(cin, filters, stride, cfg.dtype, dev,
                                       axis_name=cfg.axis_name)
                elif preact:
                    name = f"PreActBlock_{i}"
                    block = PreActBlock(cin, filters, stride, dev,
                                        axis_name=cfg.axis_name)
                else:
                    name = f"BottleneckBlock_{i}"
                    block = BottleneckBlock(cin, filters, stride, fused,
                                            cfg.dtype, dev,
                                            cfg.fused_parts,
                                            axis_name=cfg.axis_name)
                self.add_module(name, block)
                self.block_names.append(name)
                cin, i = expansion * filters, i + 1
        if preact:
            self.final_bn = bn(cin)
        self.head = Dense(cin, cfg.num_classes, dev)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """flax's initializers (lecun-normal kernels, BN scale 1 — 0 for
        each v1 block's last BN —, zero biases, running stats 0/1). Drawn
        on the CPU from ``generator``, so a seed gives the same weights on
        every device."""
        for mod in self.modules():
            if isinstance(mod, (Conv, BatchNorm, Dense)):
                mod.init(generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        dtype = self.cfg.dtype
        x = x.to(dtype)
        if self.cfg.cifar_stem:
            x = self.stem.same(x)
            if self.has_stem_bn:
                x = torch.relu(self.stem_bn(x, train))
        else:
            if self.cfg.stem_space_to_depth:
                x = self.stem_s2d(space_to_depth(x), 1, ((2, 1), (2, 1)))
            else:
                x = self.stem(x, 2, ((3, 3), (3, 3)))
            x = torch.relu(self.stem_bn(x, train))
            x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        if self.cfg.block == "preact":
            x = torch.relu(self.final_bn(x, train))
        x = global_avg_pool(x)
        return self.head(x)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """``[N, H, W, C]`` -> ``[N, H/2, W/2, 4C]``: each 2x2 patch folded into
    channels in the JAX stem's order (row offset, column offset,
    channel)."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(
            f"stem_space_to_depth folds 2x2 patches and needs "
            f"even spatial dims; got {h}x{w} (pad or resize "
            f"the input, or use the standard stem)")
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax ``max_pool(x, (k, k), (s, s), padding="SAME")`` on NHWC: pads
    of -inf, flax's (lo, hi) split."""
    _, h, w, _ = x.shape
    (pt, pb), (pl, pr) = same_pads(h, k, s), same_pads(w, k, s)
    xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(xc, k, s).permute(0, 2, 3, 1).contiguous()


def max_pool_valid(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax ``max_pool(x, (k, k), (s, s))`` (VALID) on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, s).permute(
        0, 2, 3, 1).contiguous()


def _imagenet(stage_sizes, num_classes, dtype, conv_backend, fused_stages,
              fused_parts, stem_space_to_depth, axis_name, device,
              generator) -> ResNet:
    return ResNet(ResNetConfig(stage_sizes=tuple(stage_sizes),
                               num_classes=num_classes, num_filters=64,
                               dtype=dtype, conv_backend=conv_backend,
                               fused_stages=tuple(fused_stages),
                               fused_parts=tuple(fused_parts),
                               stem_space_to_depth=stem_space_to_depth,
                               axis_name=axis_name),
                  device=device, generator=generator)


def resnet50(num_classes: int = 1000, *, dtype: torch.dtype = torch.bfloat16,
             conv_backend: str = "xla",
             fused_stages: Sequence[int] = (0, 1),
             fused_parts: Sequence[str] = FUSED_PARTS,
             stem_space_to_depth: bool = False, axis_name=None,
             device: DeviceLike = "cuda",
             generator: Optional[torch.Generator] = None) -> ResNet:
    """ImageNet ResNet-50: stages ``[3, 4, 6, 3]``, 64 base filters."""
    return _imagenet((3, 4, 6, 3), num_classes, dtype, conv_backend,
                     fused_stages, fused_parts, stem_space_to_depth,
                     axis_name, device, generator)


def resnet101(num_classes: int = 1000, *, dtype: torch.dtype = torch.bfloat16,
              conv_backend: str = "xla",
              fused_stages: Sequence[int] = (0, 1),
              fused_parts: Sequence[str] = FUSED_PARTS,
              stem_space_to_depth: bool = False, axis_name=None,
              device: DeviceLike = "cuda",
              generator: Optional[torch.Generator] = None) -> ResNet:
    """ResNet-101 (the reference's benchmark model): stages ``[3, 4, 23,
    3]``, 64 base filters."""
    return _imagenet((3, 4, 23, 3), num_classes, dtype, conv_backend,
                     fused_stages, fused_parts, stem_space_to_depth,
                     axis_name, device, generator)


def cifar_resnet_v1(depth: int = 20, num_classes: int = 10, *,
                    dtype: torch.dtype = torch.bfloat16, axis_name=None,
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
                               dtype=dtype, block="basic", cifar_stem=True,
                               axis_name=axis_name),
                  device=device, generator=generator)


def cifar_resnet_v2(depth: int = 56, num_classes: int = 10, *,
                    dtype: torch.dtype = torch.bfloat16, axis_name=None,
                    device: DeviceLike = "cuda",
                    generator: Optional[torch.Generator] = None) -> ResNet:
    """ResNet v2 (pre-activation) for CIFAR (``keras-cifar10-resnet.py``
    resnet_v2): depth ``9n + 2`` (56, 110), three stages of ``n``
    pre-activation bottlenecks with 16, 32 and 64 filters behind the
    CIFAR stem."""
    if (depth - 2) % 9:
        raise ValueError("v2 depth must be 9n+2 (e.g. 56, 110)")
    n = (depth - 2) // 9
    return ResNet(ResNetConfig(stage_sizes=(n, n, n),
                               num_classes=num_classes, num_filters=16,
                               dtype=dtype, block="preact", cifar_stem=True,
                               axis_name=axis_name),
                  device=device, generator=generator)

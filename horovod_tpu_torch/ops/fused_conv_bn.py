"""Fused 1x1 conv + BatchNorm statistics (+ affine/ReLU prologue): the
ResNet-50 bottleneck's hot path.

Port of the JAX package's ``ops/pallas_conv.py`` (``fused_linear_bn_act``
with its custom VJP). :func:`fused_linear_bn_act` is a
``torch.autograd.Function``:

* forward (K1, ``csrc/fused_conv_bn.cu`` ``hvd_conv_bn_fwd``):
  ``u = relu(a*x + b)`` rounded to x's dtype (optional prologue), ``y = u
  · Wᵀ`` with f32 accumulation stored in x's dtype, and the column sums
  ``s1 = Σ y``, ``s2 = Σ y²`` of the ROUNDED y in f32 — the statistics
  the consumer BatchNorm needs, without another pass over y;
* backward (K2, ``hvd_conv_bn_bwd``): the stats cotangents are folded
  into ``e = dy + ds1 + 2·y·ds2`` (rounded once), u is recomputed, and
  ``dW = eᵀ·u``, ``dx = mask(e·W)·a`` (mask: the prologue's ``pre > 0``
  under ReLU), ``da = Σ du·x``, ``db = Σ du``.

The weight is ``[Cout, Cin]`` — the ``[Cout, Cin, 1, 1]`` conv kernel of
the port read as a matrix — so ``y = u·Wᵀ`` needs no transpose copy. On a
CUDA tensor the wrappers launch the kernels (bf16 activations, f32
weight and affine, Cin and Cout multiples of 64, any M) and raise on
anything else; on a CPU tensor they run the plain versions
:func:`fused_linear_bn_act_reference` and
:func:`fused_linear_bn_act_bwd_reference`, the same math with the same
rounding points. The sums are taken in a fixed order on the card, so two
launches on the same input agree bitwise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

KERNEL_FWD = "fused_conv_bn_fwd"
KERNEL_BWD = "fused_conv_bn_bwd"

_BM = 128           # rows of M per CTA in the row kernels (the kernel's kBM)
_BK = 32            # rows per shared-memory stage (the kernel's kBK)
_WAVES = 2          # CTAs per SM the dW kernel's split aims at

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fusable(m: int, cin: int = 64, cout: int = 64) -> bool:
    """Whether the CUDA kernels take an ``[m, cin] x [cout, cin]``
    problem: any ``m >= 1``, channel counts multiples of 64. (The model
    routes by the JAX package's own rule, ``m % 128 == 0``; see
    :mod:`horovod_tpu_torch.models.resnet`.)"""
    return m >= 1 and cin > 0 and cout > 0 and cin % 64 == 0 \
        and cout % 64 == 0


def _prologue(x2: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              relu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pre, u): the f32 pre-activation and u rounded to x's dtype."""
    xf = x2.float()
    pre = a * xf + b
    u = torch.clamp_min(pre, 0.0) if relu else pre
    return pre, u.to(x2.dtype)


def fused_linear_bn_act_reference(x2: torch.Tensor, w: torch.Tensor,
                                  a: Optional[torch.Tensor] = None,
                                  b: Optional[torch.Tensor] = None,
                                  relu: bool = True) -> Stats:
    """Plain version of the forward. ``x2 [M, Cin]``, ``w [Cout, Cin]``,
    ``a, b [Cin]`` f32 or None. Returns ``(y [M, Cout], s1, s2 [Cout])``."""
    u = x2 if a is None else _prologue(x2, a, b, relu)[1]
    y = (u.float() @ w.to(x2.dtype).float().t()).to(x2.dtype)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def fused_linear_bn_act_bwd_reference(
        x2: torch.Tensor, w: torch.Tensor, a: Optional[torch.Tensor],
        b: Optional[torch.Tensor], y: torch.Tensor,
        dy: Optional[torch.Tensor], ds1: Optional[torch.Tensor],
        ds2: Optional[torch.Tensor], relu: bool = True):
    """Plain version of the backward (the TPU ``_bwd_kernel`` spelled
    out). ``None`` cotangents are zeros. Returns ``(dx [M, Cin], dw [Cout,
    Cin] f32, da, db [Cin] f32 — or None without a prologue)``."""
    cout = w.shape[0]
    zeros = torch.zeros(cout, dtype=torch.float32, device=x2.device)
    dyf = torch.zeros_like(y, dtype=torch.float32) if dy is None \
        else dy.float()
    ds1 = zeros if ds1 is None else ds1
    ds2 = zeros if ds2 is None else ds2
    e = (dyf + ds1 + 2.0 * y.float() * ds2).to(x2.dtype)
    if a is None:
        u, pre = x2, None
    else:
        pre, u = _prologue(x2, a, b, relu)
    dw = e.float().t() @ u.float()
    du = e.float() @ w.to(x2.dtype).float()
    if a is None:
        return du.to(x2.dtype), dw, None, None
    if relu:
        du = torch.where(pre > 0.0, du, torch.zeros_like(du))
    return ((du * a).to(x2.dtype), dw, (du * x2.float()).sum(0),
            du.sum(0))


def _check(name: str, t: Optional[torch.Tensor], dtype, shape, dev):
    if t is None:
        return
    if t.device != dev:
        raise ValueError(f"fused_linear_bn_act: {name} is on {t.device}, "
                         f"x on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"fused_linear_bn_act's CUDA kernel takes {name} "
                        f"as {dtype}; got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_linear_bn_act: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_linear_bn_act: {name} must be contiguous "
                         f"and 16-byte aligned")


def _check_cuda(x2, w, a, b):
    if x2.dim() != 2 or w.dim() != 2:
        raise ValueError(f"fused_linear_bn_act needs x2 [M, Cin] and w "
                         f"[Cout, Cin]; got {tuple(x2.shape)}, "
                         f"{tuple(w.shape)}")
    m, cin = x2.shape
    cout = w.shape[0]
    if not fusable(m, cin, cout):
        raise ValueError(f"fused_linear_bn_act's CUDA kernels take M >= 1 "
                         f"and channel counts that are multiples of 64; "
                         f"got M={m}, Cin={cin}, Cout={cout}")
    dev = x2.device
    _check("x2", x2, torch.bfloat16, (m, cin), dev)
    _check("w", w, torch.float32, (cout, cin), dev)
    _check("a", a, torch.float32, (cin,), dev)
    _check("b", b, torch.float32, (cin,), dev)
    return m, cin, cout


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _fwd_cuda(x2, w, a, b, relu) -> Stats:
    m, cin, cout = _check_cuda(x2, w, a, b)
    n_mt = -(-m // _BM)
    y = torch.empty((m, cout), dtype=x2.dtype, device=x2.device)
    part = torch.empty((2, n_mt, cout), dtype=torch.float32,
                       device=x2.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x2.device)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        err = lib.hvd_conv_bn_fwd(
            x2.data_ptr(), w.data_ptr(), _ptr(a), _ptr(b), y.data_ptr(),
            part.data_ptr(), stats.data_ptr(), m, cin, cout,
            int(a is not None), int(bool(relu)),
            _build.current_stream(x2.device))
    _build.check_launch(err, "fused_linear_bn_act (K1)")
    _build.LAUNCHES.add(KERNEL_FWD)
    return y, stats[0], stats[1]


def dw_split(m: int, cin: int, cout: int, sms: int) -> Tuple[int, int]:
    """(n_splits, rows_per_split) of the dW kernel: enough CTAs for
    ``_WAVES`` per SM, each split a multiple of the 32-row stage."""
    tiles = (cout // (128 if cout % 128 == 0 else 64)) * (cin // 64)
    want = max(1, -(-(_WAVES * sms) // tiles))
    rows = -(-m // want)
    rows = max(_BK, -(-rows // _BK) * _BK)
    return -(-m // rows), rows


def _bwd_cuda(x2, w, a, b, y, dy, ds1, ds2, relu):
    m, cin, cout = _check_cuda(x2, w, a, b)
    dev = x2.device
    dy = torch.zeros_like(y) if dy is None else dy.contiguous()
    _check("y", y, torch.bfloat16, (m, cout), dev)
    _check("dy", dy, torch.bfloat16, (m, cout), dev)
    ds1 = None if ds1 is None else ds1.contiguous()
    ds2 = None if ds2 is None else ds2.contiguous()
    _check("ds1", ds1, torch.float32, (cout,), dev)
    _check("ds2", ds2, torch.float32, (cout,), dev)
    prologue = a is not None
    n_mt = -(-m // _BM)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_splits, rows = dw_split(m, cin, cout, sms)
    dx = torch.empty((m, cin), dtype=x2.dtype, device=dev)
    dw = torch.empty((cout, cin), dtype=torch.float32, device=dev)
    dab = torch.empty((2, cin), dtype=torch.float32, device=dev) \
        if prologue else None
    part_ab = torch.empty((2, n_mt, cin), dtype=torch.float32, device=dev) \
        if prologue else None
    part_w = torch.empty((n_splits, cout, cin), dtype=torch.float32,
                         device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.hvd_conv_bn_bwd(
            x2.data_ptr(), y.data_ptr(), dy.data_ptr(), w.data_ptr(),
            _ptr(a), _ptr(b), _ptr(ds1), _ptr(ds2), dx.data_ptr(),
            dw.data_ptr(), _ptr(dab), _ptr(part_ab), part_w.data_ptr(), m,
            cin, cout, int(prologue), int(bool(relu)), n_splits, rows,
            _build.current_stream(dev))
    _build.check_launch(err, "fused_linear_bn_act backward (K2)")
    _build.LAUNCHES.add(KERNEL_BWD)
    if not prologue:
        return dx, dw, None, None
    return dx, dw, dab[0], dab[1]


def _dispatch(x2: torch.Tensor):
    if x2.device.type == "cpu":
        return False
    if x2.device.type != "cuda":
        raise ValueError(f"fused_linear_bn_act: unsupported device "
                         f"{x2.device}")
    return True


def fused_linear_bn_act_fwd(x2, w, a=None, b=None, relu=True) -> Stats:
    """The forward alone: K1 on a CUDA tensor, the plain version on a CPU
    one. No autograd."""
    if _dispatch(x2):
        return _fwd_cuda(x2, w, a, b, relu)
    return fused_linear_bn_act_reference(x2, w, a, b, relu)


def fused_linear_bn_act_bwd(x2, w, a, b, y, dy, ds1, ds2, relu=True):
    """The backward alone: K2 on a CUDA tensor, the plain version on a
    CPU one."""
    if _dispatch(x2):
        return _bwd_cuda(x2, w, a, b, y, dy, ds1, ds2, relu)
    return fused_linear_bn_act_bwd_reference(x2, w, a, b, y, dy, ds1, ds2,
                                             relu)


class _FusedLinearBNAct(torch.autograd.Function):
    """Saves x, w, a, b and y (as ``_fused_core_fwd`` does); the backward
    recomputes u from them."""

    @staticmethod
    def forward(ctx, x2, w, a, b, relu):
        y, s1, s2 = fused_linear_bn_act_fwd(x2, w, a, b, relu)
        ctx.save_for_backward(x2, w, a, b, y)
        ctx.relu = relu
        ctx.set_materialize_grads(False)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x2, w, a, b, y = ctx.saved_tensors
        dx, dw, da, db = fused_linear_bn_act_bwd(x2, w, a, b, y, dy, ds1,
                                                 ds2, ctx.relu)
        return dx, dw, da, db, None


def fused_linear_bn_act(x2: torch.Tensor, w: torch.Tensor,
                        a: Optional[torch.Tensor] = None,
                        b: Optional[torch.Tensor] = None,
                        relu: bool = True) -> Stats:
    """Fused [prologue-affine+ReLU] -> 1x1 conv -> statistics, with the
    fused backward.

    ``x2 [M, Cin]`` (an NHWC map reshaped), ``w [Cout, Cin]`` f32, ``a,
    b [Cin]`` f32 (both or neither; ``relu`` applies to the prologue).
    Returns ``(y [M, Cout] in x2's dtype, s1 [Cout], s2 [Cout])`` f32."""
    if (a is None) != (b is None):
        raise ValueError("fused_linear_bn_act: pass both a and b, or "
                         "neither")
    return _FusedLinearBNAct.apply(x2, w, a, b, relu)

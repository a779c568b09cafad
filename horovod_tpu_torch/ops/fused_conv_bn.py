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
launches on the same input agree bitwise. The model routes before it
calls (:func:`conv_bn_supported`): on the card, a model whose activations or
channels the kernels do not take runs the plain versions.

:func:`fwd_plan` and :func:`bwd_plan` are the kernels' host-side
planners: persistent CTAs (one per SM) over contiguous runs of row tiles
(:func:`tile_runs`), one partial per CTA, and for K2 the choice between
the one-pass kernel and the dx kernel plus dW windows, with the scratch
each needs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import _build

KERNEL_FWD = "fused_conv_bn_fwd"
KERNEL_BWD = "fused_conv_bn_bwd"

# The kernels' shared-memory budget and layouts (``csrc/fused_conv_bn.cu``:
# FwdSmem, BwdSmem, DxSmem; the kernel file is the authority, the planner
# only asks whether a ring of two stages fits).
SMEM_LIMIT = 232448
_BOX = 64 * 128     # one [64 rows, 64] bf16 box, bytes
_MAX_DW_BLOCKS = 8  # 64x64 dW blocks a CTA keeps in registers

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fusable(m: int, cin: int = 64, cout: int = 64) -> bool:
    """Whether the CUDA kernels take an ``[m, cin] x [cout, cin]``
    problem: any ``m >= 1``, channel counts multiples of 64. (The model
    routes by the JAX package's own rule, ``m % 128 == 0``; see
    :mod:`horovod_tpu_torch.models.resnet`.)"""
    return m >= 1 and cin > 0 and cout > 0 and cin % 64 == 0 \
        and cout % 64 == 0


def conv_bn_supported(device, dtype: torch.dtype, m: int, cin: int,
                      cout: int) -> bool:
    """The conv family's routing predicate: whether its wrappers take a
    ``dtype`` ``[m, cin]`` activation against a ``[cout, cin]`` weight
    on ``device``. On the CPU every input (the plain versions); on the
    card a bf16 activation of :func:`fusable` shape (K1/K2);
    ``ValueError`` on another device."""
    return (not _build.on_card(device, "fused_linear_bn_act")
            or (fusable(m, cin, cout) and dtype == torch.bfloat16))


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


def tile_runs(n_tiles: int, n_parts: int) -> List[Tuple[int, int]]:
    """The kernels' row partition (``tile_run``): part ``p`` of
    ``n_parts`` owns the contiguous tiles ``[p*n//P, (p+1)*n//P)``."""
    return [(p * n_tiles // n_parts, (p + 1) * n_tiles // n_parts)
            for p in range(n_parts)]


def _fwd_smem(np_: int, cin: int, stream: bool, pro: bool,
              stages: int) -> int:
    stage = 2 * _BOX + (np_ * _BOX if stream else 0)
    resident = 0 if stream else np_ * _BOX * (cin // 64)
    return (stage * stages + resident + 2 * _BOX + (8 * cin if pro else 0)
            + 16 * stages + 1024)


def _bwd_smem(cin: int, cout: int, bci: int, bco: int, dx: bool,
              pro: bool, stages: int) -> int:
    stage = 128 * (bci + 2 * bco) + (128 * bci if dx and pro and bci > bco
                                     else 0)
    o = stage * stages
    if dx:
        o += 2 * cin * cout + 2 * _BOX + (32 * cin if pro else 0)
    return o + (8 * bci if pro else 0) + 8 * bco + 16 * stages + 1024


def _dx_smem(nch: int, cout: int, pro: bool, stages: int) -> int:
    return ((4 + nch) * _BOX * stages + 2 * _BOX
            + (8 * 64 * nch if pro else 0) + 8 * cout + 16 * stages + 1024)


class FwdPlan(NamedTuple):
    """K1's launch: Cout in slices of ``bn`` columns, each over
    ``n_runs`` row runs of 128-row tiles (one CTA per slice and run);
    ``stream_w``: W's boxes come through the ring from a bf16 copy
    (``w_bf16`` scratch) instead of staying resident in each CTA."""
    bn: int
    stream_w: bool
    n_runs: int
    part: Tuple[int, ...]               # [2, n_runs, Cout] f32
    w_bf16: Optional[Tuple[int, int]]   # [Cout, Cin] bf16, or None


@functools.lru_cache(maxsize=256)
def fwd_plan(m: int, cin: int, cout: int, prologue: bool,
             sms: int) -> FwdPlan:
    widths = [bn for bn in (256, 128, 64) if cout % bn == 0]
    fits = [bn for bn in widths
            if _fwd_smem(bn // 64, cin, False, prologue, 2) <= SMEM_LIMIT]
    stream = not fits
    bn = widths[0] if stream else fits[0]
    n_runs = max(1, min(-(-m // 128), sms // (cout // bn)))
    return FwdPlan(bn, stream, n_runs, (2, n_runs, cout),
                   (cout, cin) if stream else None)


class BwdPlan(NamedTuple):
    """K2's launch. ``one_pass``: one CTA per row run (``n_parts`` runs
    of 64-row tiles) computes dx, its dW partial over the whole ``[Cout,
    Cin]`` and its da/db partial. Otherwise the dx kernel (``n_runs`` runs
    of 128-row tiles times ``Cin / (64 nch)`` slices) and the dW kernel
    over ``[bco, bci]`` windows, each window's rows in ``n_parts``
    runs."""
    one_pass: bool
    n_parts: int
    bco: int
    bci: int
    n_runs: int
    nch: int
    part_w: Tuple[int, int, int]                 # [n_parts, Cout, Cin]
    part_ab: Optional[Tuple[int, int, int]]      # [2, P, Cin] (prologue)
    w_bf16: Optional[Tuple[int, int]]            # [Cout, Cin] bf16

    def ints(self) -> List[int]:
        """The kernel's ``plan`` argument."""
        return [int(self.one_pass), self.n_parts, self.bco, self.bci,
                self.n_runs, self.nch]


def _window(cin: int, cout: int, pro: bool) -> Tuple[int, int]:
    """The dW window [bco, bci] (<= 8 blocks of 64x64, a 2-stage ring
    that fits) that reads the fewest bytes a row: y and dy once per
    window of Cin, x once per window of Cout."""
    best = None
    for bco in range(64, cout + 1, 64):
        for bci in range(64, cin + 1, 64):
            if (cout % bco or cin % bci
                    or (bco // 64) * (bci // 64) > _MAX_DW_BLOCKS
                    or _bwd_smem(cin, cout, bci, bco, False, pro, 2)
                    > SMEM_LIMIT):
                continue
            key = ((cin // bci) * 2 * cout + (cout // bco) * cin,
                   -bco * bci, -bci)
            if best is None or key < best[0]:
                best = (key, bco, bci)
    return best[1], best[2]


@functools.lru_cache(maxsize=256)
def bwd_plan(m: int, cin: int, cout: int, prologue: bool,
             sms: int) -> BwdPlan:
    tiles = -(-m // 64)
    if ((cin // 64) * (cout // 64) <= _MAX_DW_BLOCKS
            and _bwd_smem(cin, cout, cin, cout, True, prologue, 2)
            <= SMEM_LIMIT):
        n_parts = min(sms, tiles)
        return BwdPlan(True, n_parts, cout, cin, 0, 0,
                       (n_parts, cout, cin),
                       (2, n_parts, cin) if prologue else None, None)
    bco, bci = _window(cin, cout, prologue)
    n_windows = (cout // bco) * (cin // bci)
    n_parts = max(1, min(tiles, sms // n_windows))
    nch = next(n for n in (4, 2, 1) if cin % (64 * n) == 0
               and _dx_smem(n, cout, prologue, 2) <= SMEM_LIMIT)
    n_runs = max(1, min(-(-m // 128), sms // (cin // (64 * nch))))
    return BwdPlan(False, n_parts, bco, bci, n_runs, nch,
                   (n_parts, cout, cin),
                   (2, n_runs, cin) if prologue else None, (cout, cin))


@functools.lru_cache(maxsize=256)
def _c_plan(plan: BwdPlan):
    """``plan.ints()`` as the C array the kernel takes (read-only there)."""
    return (ctypes.c_int * 6)(*plan.ints())


def _fwd_cuda(x2, w, a, b, relu) -> Stats:
    m, cin, cout = _check_cuda(x2, w, a, b)
    dev = x2.device
    plan = fwd_plan(m, cin, cout, a is not None, _build.sm_count(dev))
    y = torch.empty((m, cout), dtype=x2.dtype, device=dev)
    part = torch.empty(plan.part, dtype=torch.float32, device=dev)
    stats = torch.empty((2, cout), dtype=torch.float32, device=dev)
    w_bf16 = None if plan.w_bf16 is None else torch.empty(
        plan.w_bf16, dtype=torch.bfloat16, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.hvd_conv_bn_fwd(
            x2.data_ptr(), w.data_ptr(), _ptr(a), _ptr(b), y.data_ptr(),
            part.data_ptr(), stats.data_ptr(), _ptr(w_bf16), m, cin, cout,
            int(a is not None), int(bool(relu)), plan.bn, plan.n_runs,
            _build.current_stream(dev))
    _build.check_launch(err, "fused_linear_bn_act (K1)")
    _build.LAUNCHES.add(KERNEL_FWD)
    return y, stats[0], stats[1]


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
    plan = bwd_plan(m, cin, cout, prologue, _build.sm_count(dev))
    dx = torch.empty((m, cin), dtype=x2.dtype, device=dev)
    dw = torch.empty((cout, cin), dtype=torch.float32, device=dev)
    empty = lambda shape, dt=torch.float32: None if shape is None \
        else torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    dab = empty((2, cin) if prologue else None)
    part_ab = empty(plan.part_ab)
    part_w = empty(plan.part_w)
    w_bf16 = empty(plan.w_bf16, torch.bfloat16)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.hvd_conv_bn_bwd(
            x2.data_ptr(), y.data_ptr(), dy.data_ptr(), w.data_ptr(),
            _ptr(a), _ptr(b), _ptr(ds1), _ptr(ds2), dx.data_ptr(),
            dw.data_ptr(), _ptr(dab), _ptr(part_ab), part_w.data_ptr(),
            _ptr(w_bf16), m, cin, cout, int(prologue), int(bool(relu)),
            _c_plan(plan), _build.current_stream(dev))
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

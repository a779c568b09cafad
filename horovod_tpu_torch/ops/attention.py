"""Causal flash attention: the prefill kernel and the differentiable
packed-qkv kernels of LM training.

Port of the JAX package's ``ops/pallas_attention.py``:

* :func:`flash_attention` — the forward over ``[B, T, H, D]`` q/k/v
  (``flash_attention`` → ``_flash_bhtd`` → ``_fwd_pallas`` →
  ``_attn_kernel``, no lse), what every prefill layer runs.
* :func:`flash_attention_qkv` — attention straight from the packed,
  head-major projection output ``[B, T, H·3·D]`` (``flash_attention_qkv``
  → ``_flash_qkv_core``), differentiable: the forward saves the row
  log2-sum-exp2 (``_fwd_pallas_qkv``), and the backward recomputes the
  probabilities from it in two kernels, dq and dk/dv, that write the
  packed gradient ``[B, T, H·3·D]`` directly (``_flash_qkv_core_bwd``'s
  ``_dqkv_packed_kernel``, or its split ``_dq_kernel`` + ``_dkv_kernel``).
* :func:`xla_attention` — the dense f32 attention (``_xla_attention``)
  that the model routes untilable shapes to, as the JAX package does.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``); on a CPU
tensor it runs the plain PyTorch version with the same rounding points
(:func:`flash_attention_reference`, :func:`flash_attention_qkv_reference`,
:func:`flash_attention_qkv_bwd_reference`). There is no other path and
no fallback: a CUDA input the kernels do not take (anything but bf16 with
d_head 128) raises.

The kernels mask the ragged edge themselves, so they take every length;
the JAX package's tilability gate (:func:`qkv_flash_tilable`) stays a
routing rule of the model, not a limit of the kernels. The TPU backward
chooses between its fused single pass and the split pair by a VMEM budget
(``_fused_bwd_fits``); the port's pair needs shared memory that does not
grow with T, so it always runs the pair and has no such gate.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

#: log2(e): the kernels work in the log2 domain (q pre-scaled, exp2).
LOG2E = 1.4426950408889634

_KERNEL = "flash_attention"
_KERNEL_QKV = "flash_attention_qkv_fwd"
_KERNEL_DQ = "flash_bwd_dq"
_KERNEL_DKV = "flash_bwd_dkv"
_D = 128
_MASKED = -1e30


def _causal_mask(T: int, device) -> torch.Tensor:
    pos = torch.arange(T, device=device)
    return pos[None, :] > pos[:, None]              # [q, k]: masked


def _attention_reference(q, k, v, causal: bool, sm_scale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward's math on ``[B, T, H, D]`` q/k/v: returns
    ``o [B, T, H, D]`` in q's dtype and ``lse2 [B, H, T]`` f32."""
    T = q.shape[1]
    qs = (q.float() * (sm_scale * LOG2E)).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        s = s.masked_fill(_causal_mask(T, q.device), _MASKED)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    denom = p.sum(dim=-1, keepdim=True)                 # [B, H, T, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    lse2 = torch.where(denom == 0.0, torch.full_like(denom, _MASKED),
                       m + torch.log2(safe))[..., 0]
    return (o / safe.permute(0, 2, 1, 3)).to(q.dtype), lse2


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = False,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Dense attention with the flash kernel's rounding points.

    q, k, v: ``[B, T, H, D]``. q is multiplied by ``sm_scale·log2(e)`` in
    f32 and rounded to the input dtype; scores are input-dtype products
    accumulated in f32; the softmax is exp2 with a -1e30 mask; P is
    rounded to v's dtype before P·V, accumulated in f32; a row whose sum
    is 0 divides by 1. Returns ``[B, T, H, D]`` in q's dtype."""
    if sm_scale is None:
        sm_scale = float(q.shape[3]) ** -0.5
    return _attention_reference(q, k, v, causal, sm_scale)[0]


def _check_operand(name: str, x: torch.Tensor, like: torch.Tensor) -> None:
    if x.device != like.device:
        raise ValueError(f"flash attention: {name} is on {x.device}, "
                         f"not {like.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash attention's CUDA kernels take bfloat16; "
                        f"{name} is {x.dtype}")
    if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:-1]):
        raise ValueError(
            f"flash attention: {name} needs unit stride on D and the other "
            f"strides a multiple of 8 elements; got {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"flash attention: {name} is not 16-byte aligned")


def _check_cuda_inputs(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention needs q, k, v of one [B, T, H, D] "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q)
    if q.shape[3] != _D:
        raise ValueError(f"flash_attention's CUDA kernel takes d_head {_D}; "
                         f"got {q.shape[3]}")


def _launch_fwd(q, k, v, out, lse, causal: bool, sm_scale: float) -> None:
    """The forward kernel on ``[B, T, H, D]`` views; ``lse`` is None or a
    contiguous ``[B·H, T]`` f32 output."""
    B, T, H, D = q.shape
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, T, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(sm_scale * LOG2E), int(bool(causal)),
            _build.current_stream(q.device))
    _build.check_launch(err, "flash attention forward")


def _device_of(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention ``[B, T, H, D]`` → ``[B, T, H, D]``.

    CUDA tensors run the flash kernel (bf16, d_head 128, any T; q/k/v
    may be strided views such as slices of a packed qkv projection, as long
    as D has unit stride). CPU tensors run
    :func:`flash_attention_reference`. Forward only."""
    B, T, H, D = q.shape
    if sm_scale is None:
        sm_scale = float(D) ** -0.5
    if _device_of(q, "flash_attention") == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=sm_scale)
    _check_cuda_inputs(q, k, v)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    _launch_fwd(q, k, v, out, None, causal, sm_scale)
    _build.LAUNCHES.add(_KERNEL)
    return out


# -- packed qkv: the training path --------------------------------------------

def qkv_flash_tilable(T: int, d_head: int) -> bool:
    """The JAX package's rule for routing a layer to the packed flash
    path (``T % 128 == 0 and d_head % 128 == 0``); other shapes go to
    :func:`xla_attention`."""
    return T % 128 == 0 and d_head % 128 == 0


def _split_qkv(qkv: torch.Tensor, n_heads: int):
    """``[B, T, H·3·D]`` (head-major columns) → q, k, v ``[B, T, H, D]``
    views."""
    B, T, cols = qkv.shape
    if cols % (3 * n_heads):
        raise ValueError(f"qkv has {cols} columns, not a multiple of "
                         f"3 x {n_heads} heads")
    r = qkv.view(B, T, n_heads, 3, cols // (3 * n_heads))
    return r[..., 0, :], r[..., 1, :], r[..., 2, :]


def flash_attention_qkv_reference(qkv: torch.Tensor, n_heads: int, *,
                                  causal: bool = False,
                                  sm_scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed forward's math: ``qkv [B, T, H·3·D]`` → ``(o [B, T,
    H·D]`` in qkv's dtype, ``lse2 [B·H, T]`` f32), with the rounding
    points of :func:`flash_attention_reference`; ``lse2 = m + log2(l)``
    per row (``-1e30`` where ``l = 0``)."""
    q, k, v = _split_qkv(qkv, n_heads)
    B, T, H, D = q.shape
    if sm_scale is None:
        sm_scale = float(D) ** -0.5
    o, lse2 = _attention_reference(q, k, v, causal, sm_scale)
    return o.reshape(B, T, H * D), lse2.reshape(B * H, T)


def _bwd_reference(qkv, lse2, do, delta, n_heads: int, causal: bool,
                   sm_scale: float) -> torch.Tensor:
    q, k, v = _split_qkv(qkv, n_heads)
    B, T, H, D = q.shape
    dt = qkv.dtype
    do4 = do.reshape(B, T, H, D).float()
    qs = (q.float() * (sm_scale * LOG2E)).to(dt)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        s = s.masked_fill(_causal_mask(T, q.device), _MASKED)
    p = torch.exp2(s - lse2.reshape(B, H, T, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do4, v.float())
    ds = (p * (dp - delta.reshape(B, H, T, 1))).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do4)
    return torch.stack([dq.to(dt), dk.to(dt), dv.to(dt)],
                       dim=3).reshape(B, T, H * 3 * D)


def flash_attention_qkv_bwd_reference(qkv: torch.Tensor, o: torch.Tensor,
                                      lse2: torch.Tensor, do: torch.Tensor,
                                      n_heads: int, *, causal: bool = False,
                                      sm_scale: Optional[float] = None
                                      ) -> torch.Tensor:
    """The packed backward's math, dense, with the TPU kernels' rounding
    points (``_dqkv_packed_kernel``): ``qs = (q·c)`` rounded to the input
    dtype feeds only the score recompute (c = sm_scale·log2(e)); ``p =
    exp2(s − lse2)`` and ``dp = dO·Vᵀ`` in f32; ``ds = p·(dp − Δ)`` with
    ``Δ = Σ_d dO∘O`` in f32, rounded once for both dq and dk; p rounded
    before ``Pᵀ·dO``; ``dq = sm_scale·ds·K`` and ``dk = sm_scale·dsᵀ·q``
    (raw q) scaled in f32. Returns ``d_qkv [B, T, H·3·D]`` in qkv's
    dtype. (Autograd through the dense forward rounds elsewhere.)"""
    if sm_scale is None:
        sm_scale = float(qkv.shape[-1] // (3 * n_heads)) ** -0.5
    return _bwd_reference(qkv, lse2, do, attention_delta(do, o, n_heads),
                          n_heads, causal, sm_scale)


def _check_qkv_cuda(qkv: torch.Tensor, n_heads: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * n_heads * _D:
        raise ValueError(
            f"flash_attention_qkv's CUDA kernels take qkv [B, T, "
            f"{n_heads} x 3 x {_D}] (d_head {_D}); got {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError("flash_attention_qkv: qkv must be contiguous")
    _check_operand("qkv", qkv, qkv)


def flash_attention_qkv_fwd(qkv: torch.Tensor, n_heads: int, *,
                            causal: bool = False,
                            sm_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with lse (K3-qkv): ``qkv [B, T, H·3·D]`` → ``(o [B,
    T, H·D], lse2 [B·H, T] f32)``. CUDA tensors launch the kernel (bf16,
    contiguous, d_head 128, any T); CPU tensors run
    :func:`flash_attention_qkv_reference`."""
    if sm_scale is None:
        sm_scale = float(qkv.shape[-1] // (3 * n_heads)) ** -0.5
    if _device_of(qkv, "flash_attention_qkv") == "cpu":
        return flash_attention_qkv_reference(qkv, n_heads, causal=causal,
                                             sm_scale=sm_scale)
    _check_qkv_cuda(qkv, n_heads)
    B, T, _ = qkv.shape
    q, k, v = _split_qkv(qkv, n_heads)
    o = torch.empty((B, T, n_heads, _D), dtype=qkv.dtype, device=qkv.device)
    lse2 = torch.empty((B * n_heads, T), dtype=torch.float32,
                       device=qkv.device)
    _launch_fwd(q, k, v, o, lse2, causal, sm_scale)
    _build.LAUNCHES.add(_KERNEL_QKV)
    return o.view(B, T, n_heads * _D), lse2


def attention_delta(do: torch.Tensor, o: torch.Tensor, n_heads: int
                    ) -> torch.Tensor:
    """``Δ = Σ_d dO∘O`` per (batch, head, row) in f32, ``[B·H, T]``: the
    backward's row statistic, computed outside the kernels as in JAX."""
    B, T, HD = do.shape
    delta = (do.float() * o.float()).view(B, T, n_heads, HD // n_heads)
    return delta.sum(-1).transpose(1, 2).contiguous().view(B * n_heads, T)


def _check_bwd_cuda(qkv, do, lse2, delta, d_qkv, n_heads):
    _check_qkv_cuda(qkv, n_heads)
    B, T, _ = qkv.shape
    if do.shape != (B, T, n_heads * _D) or not do.is_contiguous():
        raise ValueError(f"flash attention backward: dO must be a "
                         f"contiguous [{B}, {T}, {n_heads * _D}]; got "
                         f"{tuple(do.shape)}")
    _check_operand("dO", do, qkv)
    if d_qkv.shape != qkv.shape or not d_qkv.is_contiguous():
        raise ValueError("flash attention backward: d_qkv must be a "
                         "contiguous tensor of qkv's shape")
    _check_operand("d_qkv", d_qkv, qkv)
    for name, x in (("lse2", lse2), ("delta", delta)):
        if (x.shape != (B * n_heads, T) or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != qkv.device):
            raise ValueError(f"flash attention backward: {name} must be a "
                             f"contiguous f32 [{B * n_heads}, {T}] on "
                             f"{qkv.device}")


def _launch_bwd(entry: str, counter: str, qkv, do, lse2, delta, d_qkv,
                n_heads: int, causal: bool, sm_scale: Optional[float]):
    if sm_scale is None:
        sm_scale = float(qkv.shape[-1] // (3 * n_heads)) ** -0.5
    if _device_of(qkv, "flash attention backward") == "cpu":
        ref = _bwd_reference(qkv, lse2, do, delta, n_heads, causal,
                             sm_scale)
        parts = slice(0, 1) if counter == _KERNEL_DQ else slice(1, 3)
        shape = (*qkv.shape[:2], n_heads, 3, -1)
        d_qkv.view(shape)[..., parts, :] = ref.view(shape)[..., parts, :]
        return
    _check_bwd_cuda(qkv, do, lse2, delta, d_qkv, n_heads)
    B, T, _ = qkv.shape
    q, k, v = _split_qkv(qkv, n_heads)
    dq, dk, dv = _split_qkv(d_qkv, n_heads)
    do4 = do.view(B, T, n_heads, _D)
    vals = [st for x in (q, k, v, do4, dq, dk, dv) for st in x.stride()[:3]]
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do4.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, T, n_heads, _D,
            (ctypes.c_longlong * len(vals))(*vals), float(sm_scale * LOG2E),
            float(sm_scale), int(bool(causal)),
            _build.current_stream(qkv.device))
    _build.check_launch(err, f"flash attention backward ({counter})")
    _build.LAUNCHES.add(counter)


def flash_bwd_dq(qkv: torch.Tensor, do: torch.Tensor, lse2: torch.Tensor,
                 delta: torch.Tensor, d_qkv: torch.Tensor, n_heads: int, *,
                 causal: bool = False,
                 sm_scale: Optional[float] = None) -> None:
    """The dq kernel (K4's function): writes the dq columns of the packed
    gradient ``d_qkv [B, T, H·3·D]`` in place. CUDA tensors launch the
    kernel; CPU tensors take those columns of the plain version."""
    _launch_bwd("hvd_flash_bwd_dq", _KERNEL_DQ, qkv, do, lse2, delta, d_qkv,
                n_heads, causal, sm_scale)


def flash_bwd_dkv(qkv: torch.Tensor, do: torch.Tensor, lse2: torch.Tensor,
                  delta: torch.Tensor, d_qkv: torch.Tensor, n_heads: int, *,
                  causal: bool = False,
                  sm_scale: Optional[float] = None) -> None:
    """The dk/dv kernel (K5's function): writes the dk and dv columns of
    the packed gradient ``d_qkv`` in place. CUDA tensors launch the
    kernel; CPU tensors take those columns of the plain version."""
    _launch_bwd("hvd_flash_bwd_dkv", _KERNEL_DKV, qkv, do, lse2, delta,
                d_qkv, n_heads, causal, sm_scale)


def flash_attention_qkv_bwd(qkv: torch.Tensor, o: torch.Tensor,
                            lse2: torch.Tensor, do: torch.Tensor,
                            n_heads: int, *, causal: bool = False,
                            sm_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """The backward (K7's function, as the dq and dk/dv kernels): from
    the forward's ``o`` and ``lse2`` and the cotangent ``do [B, T, H·D]``
    → ``d_qkv [B, T, H·3·D]``. CUDA tensors launch the two kernels; CPU
    tensors run :func:`flash_attention_qkv_bwd_reference`."""
    if sm_scale is None:
        sm_scale = float(qkv.shape[-1] // (3 * n_heads)) ** -0.5
    if _device_of(qkv, "flash_attention_qkv") == "cpu":
        return flash_attention_qkv_bwd_reference(
            qkv, o, lse2, do, n_heads, causal=causal, sm_scale=sm_scale)
    delta = attention_delta(do, o, n_heads)
    d_qkv = torch.empty_like(qkv)
    for launch in (flash_bwd_dq, flash_bwd_dkv):
        launch(qkv, do, lse2, delta, d_qkv, n_heads, causal=causal,
               sm_scale=sm_scale)
    return d_qkv


class _FlashAttentionQKV(torch.autograd.Function):
    """The custom VJP of ``_flash_qkv_core``: the forward saves
    ``(qkv, o, lse2)``, the backward runs the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, qkv, n_heads, causal, sm_scale):
        o, lse2 = flash_attention_qkv_fwd(qkv, n_heads, causal=causal,
                                          sm_scale=sm_scale)
        ctx.save_for_backward(qkv, o, lse2)
        ctx.args = (n_heads, causal, sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse2 = ctx.saved_tensors
        n_heads, causal, sm_scale = ctx.args
        return (flash_attention_qkv_bwd(qkv, o, lse2, do.contiguous(),
                                        n_heads, causal=causal,
                                        sm_scale=sm_scale), None, None, None)


def flash_attention_qkv(qkv: torch.Tensor, n_heads: int, *,
                        causal: bool = False,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention straight from the packed projection output.

    ``qkv``: ``[B, T, n_heads·3·d_head]`` with head-major columns (it
    reshapes to ``[B, T, n_heads, 3, d_head]``). Returns ``[B, T,
    n_heads·d_head]``, the output projection's input. Differentiable: the
    gradient is ``d_qkv`` in the same packed layout. CUDA tensors run the
    kernels (bf16, contiguous, d_head 128, any T); CPU tensors the plain
    versions."""
    if sm_scale is None:
        sm_scale = float(qkv.shape[-1] // (3 * n_heads)) ** -0.5
    return _FlashAttentionQKV.apply(qkv, n_heads, bool(causal),
                                    float(sm_scale))


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, sm_scale: float) -> torch.Tensor:
    """Dense attention over ``[B, T, H, D]``, the JAX package's
    ``_xla_attention``: f32 scores scaled by ``sm_scale``, a -1e30
    causal mask, f32 softmax and P·V, the result cast back to q's dtype.
    Plain PyTorch (differentiable by autograd) on every device."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        s = s.masked_fill(_causal_mask(q.shape[1], q.device), _MASKED)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)

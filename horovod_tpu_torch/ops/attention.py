"""Flash attention: the prefill kernel, the differentiable ``[B, T, H, D]``
flash path of the pipelined LM, and the packed-qkv kernels of LM training.

Port of the JAX package's ``ops/pallas_attention.py``:

* :func:`flash_attention` — multi-head attention over ``[B, T, H, D]``
  q/k/v with the JAX routing (``backend`` "auto", "pallas" or "xla";
  ``_SCORE_BYTES_CUTOVER``) and, on the kernel route, ``_flash_bhtd`` →
  the custom VJP ``_flash_core``: q is prescaled by ``sm_scale·log2(e)``
  in PyTorch (autograd differentiates that multiply, as JAX's chain rule
  does), the forward with a gradient saves the row log2-sum-exp2
  (:func:`flash_attention_lse`, ``_fwd_pallas`` with lse), and the
  backward recomputes the probabilities in a dq kernel and a dk/dv
  kernel (:func:`flash_bwd_dq_bhtd`, :func:`flash_bwd_dkv_bhtd`: K6
  ``_dqkv_kernel``'s function, and that of the split ``_dq_kernel`` +
  ``_dkv_kernel`` it falls back to). Without a gradient it runs the
  forward without lse, as the ``_flash_core`` primal does.
* :func:`flash_attention_prefill` — the forward without lse over ``[B, T,
  H, D]`` at every length (``_fwd_pallas`` → ``_attn_kernel``, no lse),
  what every prefill layer runs. Unlike :func:`flash_attention` it takes
  the kernel for untilable lengths too (the kernel masks the ragged
  edge).
* :func:`flash_attention_qkv` — attention straight from the packed,
  head-major projection output ``[B, T, H·3·D]`` (``flash_attention_qkv``
  → ``_flash_qkv_core``), differentiable: the forward saves lse2
  (``_fwd_pallas_qkv``), and the backward's dq and dk/dv kernels write the
  packed gradient ``[B, T, H·3·D]`` directly (``_flash_qkv_core_bwd``'s
  ``_dqkv_packed_kernel``, or its split ``_dq_kernel`` + ``_dkv_kernel``).
* :func:`xla_attention` — the dense f32 attention (``_xla_attention``)
  that untilable shapes and ``backend="xla"`` take, as in the JAX package.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``); on a CPU
tensor it runs the plain PyTorch version with the same rounding points
(:func:`flash_attention_reference`, :func:`flash_attention_lse_reference`,
:func:`flash_attention_bwd_reference`,
:func:`flash_attention_qkv_reference`,
:func:`flash_attention_qkv_bwd_reference`). There is no other path and
no fallback: a CUDA input the kernels do not take (anything but bf16 with
d_head 128) raises. A model routes before it calls: :func:`flash_supported`
says from its device, dtype and head width whether the wrappers take it,
and the transformer takes the plain versions on the card for a model the
kernels do not take (an f32 or fp16 model, another head width), as the
JAX package routes by shape and ``_SCORE_BYTES_CUTOVER``.

The two backward flavours differ only in constants, which the kernels
take as arguments: the ``[B, T, H, D]`` path hands them the prescaled q,
so the score scale is 1 and dq and dk are scaled by ln 2 (dk from the
prescaled q, as K6 does with ``q_scale=None``); the packed path hands
them the raw q, scaled on load by ``sm_scale·log2(e)``, with dq and dk
scaled by ``sm_scale`` (dk from the raw q, as K7 does). The TPU backward
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
#: ln(2): d exp2(x)/dx = ln 2 · exp2(x), the gradient scale of the
#: prescaled path (the JAX package's ``_LN2``).
LN2 = 0.6931471805599453

_KERNEL = "flash_attention"              # forward without lse (K3-fwd)
_KERNEL_LSE = "flash_attention_lse"      # [B,T,H,D] forward with lse
_KERNEL_QKV = "flash_attention_qkv_fwd"  # packed forward with lse
_KERNEL_DQ = "flash_bwd_dq"
_KERNEL_DKV = "flash_bwd_dkv"
_KERNEL_DQ_BHTD = "flash_bwd_dq_bhtd"
_KERNEL_DKV_BHTD = "flash_bwd_dkv_bhtd"
_D = 128
_MASKED = -1e30
# backend="auto" takes the kernel only above this many bytes of [B, H, T,
# T] f32 scores (the JAX package's _SCORE_BYTES_CUTOVER): it switches for
# memory, not speed.
_SCORE_BYTES_CUTOVER = 4 * 1024 ** 3


def _causal_mask(T: int, device) -> torch.Tensor:
    pos = torch.arange(T, device=device)
    return pos[None, :] > pos[:, None]              # [q, k]: masked


def _attention_reference(q, k, v, causal: bool, qscale: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash forward's math on ``[B, T, H, D]`` q/k/v, q multiplied
    by ``qscale`` in f32 and rounded to its dtype: returns ``o [B, T, H,
    D]`` in q's dtype and ``lse2 [B, H, T]`` f32."""
    T = q.shape[1]
    qs = (q.float() * qscale).to(q.dtype)
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
    return _attention_reference(q, k, v, causal, sm_scale * LOG2E)[0]


def _bwd_reference(q, k, v, do, lse2, delta, causal: bool, qscale: float,
                   grad_scale: float):
    """The backward kernels' math on ``[B, T, H, D]`` q/k/v/dO (lse2 and
    Δ ``[B·H, T]`` f32): ``qs = bf16(q·qscale)`` feeds only the score
    recompute; ``p = exp2(s − lse2)`` and ``dp = dO·Vᵀ`` in f32; ``ds =
    p·(dp − Δ)`` rounded once for dq and dk; p rounded before ``Pᵀ·dO``;
    ``dq = grad_scale·ds·K`` and ``dk = grad_scale·dsᵀ·q`` (the q given,
    not qs) scaled in f32. Returns dq, dk, dv in q's dtype."""
    B, T, H, D = q.shape
    dt = q.dtype
    qs = (q.float() * qscale).to(dt)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        s = s.masked_fill(_causal_mask(T, q.device), _MASKED)
    p = torch.exp2(s - lse2.reshape(B, H, T, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta.reshape(B, H, T, 1))).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * grad_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * grad_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_supported(device, dtype: torch.dtype, d_head: int) -> bool:
    """The flash family's routing predicate: whether its wrappers take
    inputs of ``dtype`` and ``d_head`` on ``device``. On the CPU every
    input (the plain versions); on the card bf16 with d_head 128, any T,
    batch and head count (the kernels); ``ValueError`` on another
    device."""
    return (not _build.on_card(device, "flash attention")
            or (d_head == _D and dtype == torch.bfloat16))


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


def _check_stat(name: str, x: torch.Tensor, q: torch.Tensor) -> None:
    B, T, H, _ = q.shape
    if (x.shape != (B * H, T) or x.dtype != torch.float32
            or not x.is_contiguous() or x.device != q.device):
        raise ValueError(f"flash attention backward: {name} must be a "
                         f"contiguous f32 [{B * H}, {T}] on {q.device}")


def _launch_fwd(q, k, v, out, lse, causal: bool, qscale: float) -> None:
    """The forward kernel on ``[B, T, H, D]`` views, q scaled by
    ``qscale`` on load; ``lse`` is None or a contiguous ``[B·H, T]`` f32
    output."""
    B, T, H, D = q.shape
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, T, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(qscale), int(bool(causal)),
            _build.current_stream(q.device))
    _build.check_launch(err, "flash attention forward")


def _launch_bwd(entry: str, counter: str, q, k, v, do, lse2, delta,
                dq, dk, dv, causal: bool, qscale: float,
                grad_scale: float) -> None:
    """One backward kernel on ``[B, T, H, D]`` views; the gradients the
    kernel does not write may be None."""
    B, T, H, _ = q.shape
    vals = [st for x in (q, k, v, do, dq, dk, dv)
            for st in (x.stride()[:3] if x is not None else (0, 0, 0))]
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(),
            *(None if x is None else x.data_ptr() for x in (dq, dk, dv)),
            B, T, H, _D, (ctypes.c_longlong * len(vals))(*vals),
            float(qscale), float(grad_scale), int(bool(causal)),
            _build.current_stream(q.device))
    _build.check_launch(err, f"flash attention backward ({counter})")
    _build.LAUNCHES.add(counter)


def _device_of(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type


def flash_attention_prefill(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = False,
                            sm_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """The forward without lse (K3-fwd): ``[B, T, H, D]`` → ``[B, T, H,
    D]`` at every length.

    CUDA tensors run the flash kernel (bf16, d_head 128, any T; q/k/v
    may be strided views such as slices of a packed qkv projection, as long
    as D has unit stride), q scaled on load. CPU tensors run
    :func:`flash_attention_reference`. Forward only."""
    B, T, H, D = q.shape
    if sm_scale is None:
        sm_scale = float(D) ** -0.5
    if _device_of(q, "flash_attention_prefill") == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=sm_scale)
    _check_cuda_inputs(q, k, v)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    _launch_fwd(q, k, v, out, None, causal, sm_scale * LOG2E)
    _build.LAUNCHES.add(_KERNEL)
    return out


# -- [B, T, H, D] with a gradient: the pipelined LM's path --------------------

def flash_attention_lse_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, causal: bool = False
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with lse on a prescaled q (``_fwd_pallas`` with lse):
    ``(o [B, T, H, D]`` in q's dtype, ``lse2 [B·H, T]`` f32), the
    rounding points of :func:`flash_attention_reference` with no further
    scaling of q."""
    B, T, H, _ = q.shape
    o, lse2 = _attention_reference(q, k, v, causal, 1.0)
    return o, lse2.reshape(B * H, T)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with lse (K3 as ``_fwd_pallas`` launches it for the
    custom VJP): q ``[B, T, H, D]`` already multiplied by
    ``sm_scale·log2(e)``, k and v ``[B, T, H, D]`` (strided views
    allowed) → ``(o [B, T, H, D], lse2 [B·H, T] f32)``. CUDA tensors
    launch the kernel with a score scale of 1; CPU tensors run
    :func:`flash_attention_lse_reference`."""
    if _device_of(q, "flash_attention_lse") == "cpu":
        return flash_attention_lse_reference(q, k, v, causal=causal)
    _check_cuda_inputs(q, k, v)
    B, T, H, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse2 = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    _launch_fwd(q, k, v, o, lse2, causal, 1.0)
    _build.LAUNCHES.add(_KERNEL_LSE)
    return o, lse2


def attention_delta_bhtd(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``Δ = Σ_d dO∘O`` per (batch, head, row) in f32, ``[B·H, T]``, for
    ``[B, T, H, D]`` dO and O."""
    B, T, H, _ = do.shape
    delta = (do.float() * o.float()).sum(-1)                  # [B, T, H]
    return delta.transpose(1, 2).contiguous().view(B * H, T)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse2: torch.Tensor, do: torch.Tensor, *,
                                  causal: bool = False
                                  ) -> Tuple[torch.Tensor, ...]:
    """The ``[B, T, H, D]`` backward's math, dense, with K6's
    (``_dqkv_kernel``'s) rounding points, on the prescaled q the forward
    saw: ``p = exp2(q·Kᵀ − lse2)`` and ``dp = dO·Vᵀ`` in f32, ``ds = p·(dp
    − Δ)`` (``Δ = Σ_d dO∘O``) rounded once, ``dq = ln2·ds·K`` and ``dk =
    ln2·dsᵀ·q`` scaled in f32, ``dv = bf16(p)ᵀ·dO``. Returns ``(dq, dk,
    dv)`` in q's dtype; dq is the gradient of the prescaled q (autograd
    through the prescale gives the gradient of the raw q)."""
    return _bwd_reference(q, k, v, do, lse2, attention_delta_bhtd(do, o),
                          causal, 1.0, LN2)


def _check_bwd_bhtd(q, k, v, do, lse2, delta):
    _check_cuda_inputs(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"flash attention backward: dO must be "
                         f"{tuple(q.shape)}; got {tuple(do.shape)}")
    _check_operand("dO", do, q)
    _check_stat("lse2", lse2, q)
    _check_stat("delta", delta, q)


def flash_bwd_dq_bhtd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, lse2: torch.Tensor,
                      delta: torch.Tensor, *, causal: bool = False
                      ) -> torch.Tensor:
    """The dq kernel on ``[B, T, H, D]`` operands with K6's constants
    (score scale 1 on the prescaled q, gradient scale ln 2): returns dq
    of the prescaled q, ``[B, T, H, D]``. CUDA tensors launch the kernel;
    CPU tensors take dq of the plain version."""
    if _device_of(q, "flash_bwd_dq_bhtd") == "cpu":
        return _bwd_reference(q, k, v, do, lse2, delta, causal, 1.0, LN2)[0]
    _check_bwd_bhtd(q, k, v, do, lse2, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("hvd_flash_bwd_dq", _KERNEL_DQ_BHTD, q, k, v, do, lse2,
                delta, dq, None, None, causal, 1.0, LN2)
    return dq


def flash_bwd_dkv_bhtd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse2: torch.Tensor,
                       delta: torch.Tensor, *, causal: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel on ``[B, T, H, D]`` operands with K6's constants
    (dk from the prescaled q, scaled by ln 2): returns ``(dk, dv)``, each
    ``[B, T, H, D]``. CUDA tensors launch the kernel; CPU tensors take dk
    and dv of the plain version."""
    if _device_of(q, "flash_bwd_dkv_bhtd") == "cpu":
        return _bwd_reference(q, k, v, do, lse2, delta, causal, 1.0,
                              LN2)[1:]
    _check_bwd_bhtd(q, k, v, do, lse2, delta)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("hvd_flash_bwd_dkv", _KERNEL_DKV_BHTD, q, k, v, do, lse2,
                delta, None, dk, dv, causal, 1.0, LN2)
    return dk, dv


class _FlashCore(torch.autograd.Function):
    """The custom VJP of ``_flash_core``: q arrives prescaled; the forward
    saves ``(q, k, v, o, lse2)`` (``_flash_core_fwd``), the backward
    computes Δ outside the kernels and runs the dq and dk/dv kernels
    (``_flash_core_bwd``). dq is returned in the scaled domain, and
    autograd through the caller's prescale restores the true dq."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse2 = flash_attention_lse(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse2)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse2 = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta_bhtd(do, o)
        dq = flash_bwd_dq_bhtd(q, k, v, do, lse2, delta, causal=ctx.causal)
        dk, dv = flash_bwd_dkv_bhtd(q, k, v, do, lse2, delta,
                                    causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    backend: str = "auto") -> torch.Tensor:
    """Multi-head attention ``[B, T, H, D]`` → ``[B, T, H, D]``, routed
    as the JAX function routes it.

    ``backend``: "auto" takes the flash kernels only where the shape is
    tilable (:func:`qkv_flash_tilable`) and the ``[B, H, T, T]`` f32
    scores would exceed 4 GiB, else :func:`xla_attention`; "pallas" (the
    JAX name, kept so configurations carry over) takes the kernels
    wherever the shape is tilable; "xla" always takes
    :func:`xla_attention`. Differentiable on every route: on the kernel
    route q is prescaled by ``sm_scale·log2(e)`` and the forward with lse
    and the dq and dk/dv kernels carry the gradient; without a gradient
    the forward without lse runs (:func:`flash_attention_prefill`, which
    scales q on load to the same bf16 values). q/k/v may be strided
    views, e.g. slices of a packed ``[B, T, H, 3, D]`` projection."""
    B, T, H, D = q.shape
    if sm_scale is None:
        sm_scale = float(D) ** -0.5
    tilable = qkv_flash_tilable(T, D)
    if backend == "auto":
        backend = ("pallas" if tilable
                   and 4 * B * H * T * T > _SCORE_BYTES_CUTOVER else "xla")
    elif backend not in ("pallas", "xla"):
        raise ValueError(f"unknown attention backend {backend!r}: expected "
                         f"'auto', 'pallas' or 'xla'")
    if backend == "xla" or not tilable:
        return xla_attention(q, k, v, causal, sm_scale)
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in (q, k, v))):
        return flash_attention_prefill(q, k, v, causal=causal,
                                       sm_scale=sm_scale)
    q_pre = (q.float() * (sm_scale * LOG2E)).to(q.dtype)
    return _FlashCore.apply(q_pre, k, v, bool(causal))


# -- packed qkv: the data-parallel LM's path ----------------------------------

def qkv_flash_tilable(T: int, d_head: int) -> bool:
    """The JAX package's rule for routing a layer to the flash kernels
    (``T % 128 == 0 and d_head % 128 == 0``); other shapes go to
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
    o, lse2 = _attention_reference(q, k, v, causal, sm_scale * LOG2E)
    return o.reshape(B, T, H * D), lse2.reshape(B * H, T)


def _packed_bwd_reference(qkv, lse2, do, delta, n_heads: int, causal: bool,
                          sm_scale: float) -> torch.Tensor:
    q, k, v = _split_qkv(qkv, n_heads)
    B, T, H, D = q.shape
    grads = _bwd_reference(q, k, v, do.reshape(B, T, H, D), lse2, delta,
                           causal, sm_scale * LOG2E, sm_scale)
    return torch.stack(grads, dim=3).reshape(B, T, H * 3 * D)


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
    return _packed_bwd_reference(qkv, lse2, do,
                                 attention_delta(do, o, n_heads), n_heads,
                                 causal, sm_scale)


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
    _launch_fwd(q, k, v, o, lse2, causal, sm_scale * LOG2E)
    _build.LAUNCHES.add(_KERNEL_QKV)
    return o.view(B, T, n_heads * _D), lse2


def attention_delta(do: torch.Tensor, o: torch.Tensor, n_heads: int
                    ) -> torch.Tensor:
    """``Δ = Σ_d dO∘O`` per (batch, head, row) in f32, ``[B·H, T]``: the
    backward's row statistic, computed outside the kernels as in JAX."""
    B, T, HD = do.shape
    return attention_delta_bhtd(do.reshape(B, T, n_heads, HD // n_heads),
                                o.reshape(B, T, n_heads, HD // n_heads))


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
    q = _split_qkv(qkv, n_heads)[0]
    _check_stat("lse2", lse2, q)
    _check_stat("delta", delta, q)


def _launch_packed_bwd(entry: str, counter: str, qkv, do, lse2, delta,
                       d_qkv, n_heads: int, causal: bool,
                       sm_scale: Optional[float]):
    if sm_scale is None:
        sm_scale = float(qkv.shape[-1] // (3 * n_heads)) ** -0.5
    if _device_of(qkv, "flash attention backward") == "cpu":
        ref = _packed_bwd_reference(qkv, lse2, do, delta, n_heads, causal,
                                    sm_scale)
        parts = slice(0, 1) if counter == _KERNEL_DQ else slice(1, 3)
        shape = (*qkv.shape[:2], n_heads, 3, -1)
        d_qkv.view(shape)[..., parts, :] = ref.view(shape)[..., parts, :]
        return
    _check_bwd_cuda(qkv, do, lse2, delta, d_qkv, n_heads)
    B, T, _ = qkv.shape
    q, k, v = _split_qkv(qkv, n_heads)
    dq, dk, dv = _split_qkv(d_qkv, n_heads)
    _launch_bwd(entry, counter, q, k, v, do.view(B, T, n_heads, _D), lse2,
                delta, dq, dk, dv, causal, sm_scale * LOG2E, sm_scale)


def flash_bwd_dq(qkv: torch.Tensor, do: torch.Tensor, lse2: torch.Tensor,
                 delta: torch.Tensor, d_qkv: torch.Tensor, n_heads: int, *,
                 causal: bool = False,
                 sm_scale: Optional[float] = None) -> None:
    """The dq kernel (K4's function): writes the dq columns of the packed
    gradient ``d_qkv [B, T, H·3·D]`` in place. CUDA tensors launch the
    kernel; CPU tensors take those columns of the plain version."""
    _launch_packed_bwd("hvd_flash_bwd_dq", _KERNEL_DQ, qkv, do, lse2, delta,
                       d_qkv, n_heads, causal, sm_scale)


def flash_bwd_dkv(qkv: torch.Tensor, do: torch.Tensor, lse2: torch.Tensor,
                  delta: torch.Tensor, d_qkv: torch.Tensor, n_heads: int, *,
                  causal: bool = False,
                  sm_scale: Optional[float] = None) -> None:
    """The dk/dv kernel (K5's function): writes the dk and dv columns of
    the packed gradient ``d_qkv`` in place. CUDA tensors launch the
    kernel; CPU tensors take those columns of the plain version."""
    _launch_packed_bwd("hvd_flash_bwd_dkv", _KERNEL_DKV, qkv, do, lse2,
                       delta, d_qkv, n_heads, causal, sm_scale)


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

"""Causal flash attention, forward only: the prefill kernel of the port.

Port of the JAX package's ``ops/pallas_attention.py`` forward path
(``flash_attention`` → ``_flash_bhtd`` → ``_fwd_pallas`` →
``_attn_kernel``). On a CUDA tensor :func:`flash_attention` launches the
hand-written Hopper kernel in ``csrc/flash_attention.cu``; on a CPU tensor
it runs :func:`flash_attention_reference`, the dense math with the same
rounding points. There is no other path and no fallback: a CUDA input the
kernel does not take raises.

The JAX package sends shapes its TPU kernel cannot tile (T not a multiple
of 128, d_head not a multiple of 128) to a dense XLA attention. The CUDA
kernel masks the ragged edge itself, so every prompt length runs it and
neither a tilability gate nor a dense fallback is needed.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

#: log2(e): the kernel works in the log2 domain (q pre-scaled, exp2).
LOG2E = 1.4426950408889634

_KERNEL = "flash_attention"
_D = 128


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
    B, T, H, D = q.shape
    if sm_scale is None:
        sm_scale = float(D) ** -0.5
    qs = (q.float() * (sm_scale * LOG2E)).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        pos = torch.arange(T, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    denom = p.sum(dim=-1, keepdim=True)                 # [B, H, T, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return (o / safe.permute(0, 2, 1, 3)).to(q.dtype)


def _check_cuda_inputs(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention needs q, k, v of one [B, T, H, D] "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {x.device}, "
                             f"q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention's CUDA kernel takes bfloat16; "
                            f"{name} is {x.dtype}")
        if x.stride(3) != 1 or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(
                f"flash_attention: {name} needs unit stride on D and the "
                f"other strides a multiple of 8 elements; got {x.stride()}")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")
    if q.shape[3] != _D:
        raise ValueError(f"flash_attention's CUDA kernel takes d_head {_D}; "
                         f"got {q.shape[3]}")


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
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda_inputs(q, k, v)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.hvd_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(sm_scale * LOG2E), int(bool(causal)),
            _build.current_stream(q.device))
    _build.check_launch(err, "flash_attention")
    _build.LAUNCHES.add(_KERNEL)
    return out

"""Paged decode attention: the decode kernel of the port.

Port of the JAX package's ``ops/pallas_paged_attention.py``. One query
token per slot attends over that slot's KV blocks, read straight from the
paged pool through its block-table row. On a CUDA tensor
:func:`paged_decode_attention` launches the hand-written Hopper kernel in
``csrc/paged_attention.cu``; on a CPU tensor it runs
:func:`paged_attention_reference`, which gathers each slot's blocks into
a contiguous view and runs the dense math. There is no fallback: a CUDA
input the kernel does not take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_KERNEL = "paged_decode_attention"
_D = 128


def paged_attention_supported(d_head: int, block_size: int,
                              dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the CUDA kernel takes these shapes: d_head 128, a bf16
    query and pool, any block size."""
    return d_head == _D and dtype == torch.bfloat16 and block_size >= 1


def paged_attention_reference(q, k_pool, v_pool, block_tables, positions,
                              sm_scale: Optional[float] = None):
    """Gather each slot's blocks into the contiguous ``[S, M, H, d]`` view
    and run dense attention (f32 scores, -1e30 mask, f32 softmax), as
    the JAX package's gather path does. Rows with ``positions < 0`` are
    zeros. Returns ``[S, H, d]`` in q's dtype."""
    S, H, d = q.shape
    nb = block_tables.shape[1]
    bs = k_pool.shape[1]
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    tbl = block_tables.long()
    kg = k_pool[tbl].reshape(S, nb * bs, H, d)
    vg = v_pool[tbl].reshape(S, nb * bs, H, d)
    s = torch.einsum("shd,smhd->shm", q.float(), kg.float()) * sm_scale
    pos = positions.long()
    m = torch.arange(nb * bs, device=q.device)
    s = s.masked_fill(m[None, None, :] > pos[:, None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("shm,smhd->shd", p, vg.float())
    out = torch.where(pos[:, None, None] >= 0, out, torch.zeros_like(out))
    return out.to(q.dtype)


def _check_cuda_inputs(q, k_pool, v_pool, block_tables, positions):
    S, H, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape[2:] != (H, d) \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_decode_attention: pools must be "
                         f"[n_blocks, bs, {H}, {d}]; got "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != S \
            or positions.shape != (S,):
        raise ValueError(f"paged_decode_attention: block_tables must be "
                         f"[{S}, max_blocks] and positions [{S}]; got "
                         f"{tuple(block_tables.shape)}, "
                         f"{tuple(positions.shape)}")
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables),
                    ("positions", positions)):
        if x.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} is on "
                             f"{x.device}, q on {q.device}")
    if not q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16:
        raise TypeError(f"paged_decode_attention's CUDA kernel takes a bf16 "
                        f"query and pools; got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and positions "
                        "must be int32")
    if d != _D:
        raise ValueError(f"paged_decode_attention's CUDA kernel takes d_head "
                         f"{_D}; got {d}")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables),
                    ("positions", positions)):
        if not x.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"contiguous")
        if name != "positions" and x.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} is not "
                             f"16-byte aligned")


def paged_decode_attention(q, k_pool, v_pool, block_tables, positions, *,
                           sm_scale: Optional[float] = None):
    """Decode attention straight from the paged pool.

    Args:
      q: ``[S, H, d]`` — one query token per slot.
      k_pool, v_pool: ``[n_blocks, block_size, H, d]`` — ONE layer's view
        of the pool.
      block_tables: ``[S, max_blocks]`` int32 physical block per logical
        block.
      positions: ``[S]`` int32 — attend keys ``0..positions[s]``
        inclusive; ``< 0`` = inactive row (output zeros).
      sm_scale: softmax scale (default ``1/sqrt(d)``).

    Returns ``[S, H, d]`` in q's dtype. CUDA tensors run the kernel (bf16,
    d_head 128); CPU tensors run :func:`paged_attention_reference`."""
    S, H, d = q.shape
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         positions, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    _check_cuda_inputs(q, k_pool, v_pool, block_tables, positions)
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.hvd_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            S, H, d, k_pool.shape[1], block_tables.shape[1],
            k_pool.shape[0], float(sm_scale),
            _build.current_stream(q.device))
    _build.check_launch(err, "paged_decode_attention")
    _build.LAUNCHES.add(_KERNEL)
    return out

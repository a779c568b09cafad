"""Paged decode attention: the decode kernel of the port.

Port of the JAX package's ``ops/pallas_paged_attention.py``. One query
token per slot attends over that slot's KV blocks, read straight from the
paged pool through its block-table row. On a CUDA tensor
:func:`paged_decode_attention` launches the hand-written Hopper kernel in
``csrc/paged_attention.cu``; on a CPU tensor it runs
:func:`paged_attention_reference`, which gathers each slot's blocks into
a contiguous view and runs the dense math. There is no fallback: a CUDA
input the kernel does not take raises.

The kernel splits each slot's keys into chunks, one CTA per (slot, head,
chunk), and merges the chunks' partial softmax states in a fixed order.
:func:`split_plan` fixes the chunks on the host from the shapes alone;
:func:`paged_attention_split_reference` is the same split-and-merge
algorithm in plain PyTorch.
"""

from __future__ import annotations

import collections
import functools
import math
import threading
from typing import NamedTuple, Optional

import torch

from . import _build

_KERNEL = "paged_decode_attention"
_D = 128
_TILE_ROWS = 16        # keys of one ring stage (kTileRows)
_MAX_TILES_PER_CHUNK = 8   # kMaxTilesPerChunk
_CTAS_PER_SM = 2           # fewest CTAs an SM a full table's split gives
_LOG2E = 1.4426950408889634


class SplitPlan(NamedTuple):
    """How the kernel cuts a slot's keys. A box is ``box_rows`` rows of one
    block (the largest divisor of the block size up to 16); a tile, one ring
    stage, is ``boxes_per_tile`` boxes, so ``tile_keys`` consecutive keys;
    a chunk, one CTA's work, is ``tiles_per_chunk`` tiles; ``n_splits``
    chunks cover the table's ``max_blocks * block_size`` keys."""
    box_rows: int
    boxes_per_tile: int
    tiles_per_chunk: int
    n_splits: int

    @property
    def tile_keys(self) -> int:
        return self.box_rows * self.boxes_per_tile

    @property
    def chunk_keys(self) -> int:
        return self.tile_keys * self.tiles_per_chunk


@functools.lru_cache(maxsize=256)
def split_plan(S: int, H: int, max_blocks: int, block_size: int,
               n_sm: int) -> SplitPlan:
    """The kernel's split, from shapes alone (never from positions, which
    live on the card): chunks of up to 8 tiles, fewer where the table's
    tiles over all (slot, head) pairs would give fewer than two CTAs a
    streaming multiprocessor."""
    box = max(r for r in range(1, min(block_size, _TILE_ROWS) + 1)
              if block_size % r == 0)
    per_tile = _TILE_ROWS // box
    n_tiles = -(-max_blocks * block_size // (box * per_tile))
    tpc = max(1, min(_MAX_TILES_PER_CHUNK,
                     S * H * n_tiles // (_CTAS_PER_SM * n_sm)))
    return SplitPlan(box, per_tile, tpc, -(-n_tiles // tpc))


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


def paged_attention_split_reference(q, k_pool, v_pool, block_tables,
                                    positions, chunk_keys: int,
                                    sm_scale: Optional[float] = None):
    """The kernel's algorithm in plain PyTorch: each slot's keys cut into
    chunks of ``chunk_keys``, each chunk's f32 softmax state (m, l, acc)
    in the log2 domain (q scaled by ``sm_scale * log2 e``, exp2), then the
    chunks merged in chunk order. An empty chunk (m = -1e30, l = 0) adds
    exactly nothing. Table entries are clamped into the pool; rows with
    ``positions < 0`` are zeros. Returns ``[S, H, d]`` in q's dtype."""
    S, H, d = q.shape
    nb = block_tables.shape[1]
    bs = k_pool.shape[1]
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    cap = nb * bs
    n = -(-cap // chunk_keys)
    tbl = block_tables.long().clamp(0, k_pool.shape[0] - 1)
    pad = torch.zeros((S, n * chunk_keys - cap, H, d), device=q.device)
    kg = torch.cat([k_pool[tbl].reshape(S, cap, H, d).float(), pad], 1)
    vg = torch.cat([v_pool[tbl].reshape(S, cap, H, d).float(), pad], 1)
    s = torch.einsum("shd,smhd->shm", q.float() * (sm_scale * _LOG2E), kg)
    key = torch.arange(n * chunk_keys, device=q.device)
    pos = positions.long()
    valid = (key[None, :] <= pos[:, None]) & (key[None, :] < cap)
    s = s.masked_fill(~valid[:, None, :], -math.inf)
    s = s.reshape(S, H, n, chunk_keys)
    m = s.amax(-1)
    m = torch.where(torch.isinf(m), torch.full_like(m, -1e30), m)
    p = torch.exp2(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("shcm,scmhd->shcd", p,
                       vg.reshape(S, n, chunk_keys, H, d))
    w = torch.exp2(m - m.amax(-1, keepdim=True))
    L = torch.zeros((S, H), device=q.device)
    out = torch.zeros((S, H, d), device=q.device)
    for c in range(n):
        L = L + l[..., c] * w[..., c]
        out = out + acc[..., c, :] * w[..., c, None]
    out = out / torch.where(L == 0, torch.ones_like(L), L)[..., None]
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


# Scratch of the split kernel by (device, stream, S * H, n_splits), for
# the process (like the kernels' tensor-map cache).
_WORKSPACES: "collections.OrderedDict[tuple, tuple]" = \
    collections.OrderedDict()
_WORKSPACES_LOCK = threading.Lock()
_MAX_WORKSPACES = 8


def _workspace(device, stream: int, pairs: int, n_splits: int) -> tuple:
    """The kernel's scratch, allocated once per key through the caching
    allocator and zeroed: the tickets ``[pairs]`` u32 (each launch leaves
    them zero), then the partials (m, l) ``[pairs, n_splits]`` and acc
    ``[pairs, n_splits, 128]`` f32. Launches on one stream run in order,
    so they share it. Returns the tensor and the three addresses."""
    key = (device, stream, pairs, n_splits)
    ws = _WORKSPACES.get(key)
    if ws is not None:
        return ws
    with _WORKSPACES_LOCK:
        ws = _WORKSPACES.get(key)
        if ws is not None:
            return ws
        n_tick = -(-pairs // 64) * 64          # partials 256-byte aligned
        n_ml = 2 * pairs * n_splits
        buf = torch.zeros(n_tick + n_ml + pairs * n_splits * _D,
                          dtype=torch.float32, device=device)
        ptr = buf.data_ptr()
        ws = (buf, ptr, ptr + 4 * n_tick, ptr + 4 * (n_tick + n_ml))
        _WORKSPACES[key] = ws
        if len(_WORKSPACES) > _MAX_WORKSPACES:
            _WORKSPACES.popitem(last=False)
        return ws


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
    dev = q.device
    n_blocks, bs = k_pool.shape[:2]
    max_blocks = block_tables.shape[1]
    plan = split_plan(S, H, max_blocks, bs, _build.sm_count(dev))
    stream = _build.current_stream(dev)
    _, tickets, part_ml, part_acc = _workspace(dev, stream, S * H,
                                               plan.n_splits)
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.hvd_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            tickets, part_ml, part_acc, S, H, d, bs, max_blocks, n_blocks,
            *plan, float(sm_scale), stream)
    _build.check_launch(err, "paged_decode_attention")
    _build.LAUNCHES.add(_KERNEL)
    return out

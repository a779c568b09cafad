"""Paged KV cache: a fixed pool of blocks plus per-slot block tables.

Port of the JAX package's ``parallel/kv_blocks.py`` (the paged prefill
and decode step, and the core of ``BlockManager``; the prefix registry,
the host tier, tenant budgets and chunked prefill belong to later slices).

The pool is ``{"k", "v": [n_layers, n_blocks, block_size, n_heads,
d_head], "lengths": [max_slots] int32}``; a slot owns a list of blocks
(its block-table row), so short requests hold only the blocks they fill.
Physical block 0 is the **trash block**: never allocated, the padding
entry of every table row and the target of every padding or
inactive-slot write, masked out of every attention by the per-slot
positions.

Unlike the JAX functions, which return a new pool, :func:`paged_prefill`
and :func:`paged_decode_step` write the pool **in place** (a full-width
pool is a gigabyte; copying it per step would double the memory and
the traffic) and return the same dict.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.paged_attention import paged_decode_attention
from .transformer import (TransformerConfig, check_dense, prompt_forward,
                          step_forward)

#: Physical block 0 — reserved, never allocated; see module docstring.
TRASH_BLOCK = 0


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache positions."""
    return -(-int(n_tokens) // int(block_size))


def init_paged_kv_cache(cfg: TransformerConfig, n_blocks: int,
                        block_size: int, max_slots: int,
                        dtype: Optional[torch.dtype] = None, *,
                        device: DeviceLike = "cuda") -> Dict:
    """Fresh (zeroed) paged K/V pool on ``device``. ``n_blocks`` includes
    the reserved trash block, so ``n_blocks - 1`` blocks are usable."""
    check_dense(cfg, "init_paged_kv_cache")
    dev = resolve_device(device)
    if n_blocks < 2:
        raise ValueError(
            f"n_blocks must be >= 2 (block 0 is the reserved trash "
            f"block), got {n_blocks}")
    if block_size < 1 or (block_size & (block_size - 1)):
        raise ValueError(
            f"block_size must be a power of two (prefill buckets are "
            f"powers of two and chunk the prompt by block), got "
            f"{block_size}")
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_heads, cfg.d_head)
    kv_dtype = cfg.dtype if dtype is None else dtype
    return {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
            "v": torch.zeros(shape, dtype=kv_dtype, device=dev),
            "lengths": torch.zeros((max_slots,), dtype=torch.int32,
                                   device=dev)}


def paged_prefill(w: Dict, tokens: torch.Tensor, cache: Dict, slot: int,
                  write_row: torch.Tensor, cfg: TransformerConfig,
                  length: Optional[int] = None) -> Tuple[Dict, torch.Tensor]:
    """Full-prompt forward writing every position's K/V through
    ``write_row`` into the pool.

    Args:
      w: the weights from :func:`~.transformer.gen_weights`.
      tokens: ``[T]`` int prompt at a bucket width, on the pool's device.
      slot: which ``lengths`` row this stream owns.
      write_row: ``[max_blocks]`` int32 physical block for each logical
        block; padding past the slot's allocation points at
        :data:`TRASH_BLOCK`.
      length: true prompt length (defaults to ``T``).

    Returns ``(cache, logits [T, vocab] f32)``. The attention is the
    self-contained causal flash attention over the prompt: the logits
    read nothing from the pool."""
    check_dense(cfg, "paged_prefill")
    T = tokens.shape[0]
    bs = cache["k"].shape[2]
    max_blocks = write_row.shape[0]
    if T > max_blocks * bs:
        raise ValueError(
            f"prompt bucket {T} exceeds the table depth "
            f"{max_blocks} blocks × {bs}")
    n_full, rem = divmod(T, bs)
    wr = write_row.to(device=cache["k"].device, dtype=torch.long)

    def store(li, k, v):
        for pool, x in ((cache["k"][li], k), (cache["v"][li], v)):
            x = x.to(pool.dtype)
            if n_full:
                pool[wr[:n_full]] = x[:n_full * bs].reshape(
                    n_full, bs, *x.shape[1:])
            if rem:     # the last block is partial: write its rows only
                pool[wr[n_full], :rem] = x[n_full * bs:]

    logits = prompt_forward(w, tokens, cfg, store)
    cache["lengths"][slot] = T if length is None else int(length)
    return cache, logits


def paged_decode_step(w: Dict, last_tokens: torch.Tensor, cache: Dict,
                      positions: torch.Tensor, block_tables: torch.Tensor,
                      cfg: TransformerConfig) -> Tuple[Dict, torch.Tensor]:
    """One autoregressive step for every slot, through the block table.

    Args:
      last_tokens: ``[S]`` int per-slot previous token.
      positions: ``[S]`` int32 write index; ``-1`` = inactive (its
        scratch write lands in whatever ``block_tables[s, 0]`` names —
        the trash block for an unoccupied slot — and its output row is
        garbage to be ignored).
      block_tables: ``[S, max_blocks]`` int32, trash-padded.

    Each layer writes the new K/V at ``positions`` and runs
    :func:`~..ops.paged_attention.paged_decode_attention` over keys
    ``0..pos``, with inactive slots' positions clamped to 0 as the JAX
    step does. Returns ``(cache, logits [S, vocab] f32)``; every slot's
    row depends only on that slot's token, position and blocks."""
    check_dense(cfg, "paged_decode_step")
    S = last_tokens.shape[0]
    bs = cache["k"].shape[2]
    active = positions >= 0
    pos = torch.where(active, positions,
                      torch.zeros_like(positions)).to(torch.int32)
    rows = torch.arange(S, device=positions.device)
    phys = block_tables[rows, (pos // bs).long()].long()
    off = (pos % bs).long()

    def mix(li, q, k, v):
        k_pool, v_pool = cache["k"][li], cache["v"][li]
        k_pool[phys, off] = k.to(k_pool.dtype)
        v_pool[phys, off] = v.to(v_pool.dtype)
        return paged_decode_attention(q.contiguous(), k_pool, v_pool,
                                      block_tables, pos).to(q.dtype)

    logits = step_forward(w, last_tokens, cfg, mix)
    cache["lengths"].copy_(torch.where(active, pos + 1, cache["lengths"]))
    return cache, logits


class BlockManager:
    """Host-side allocator for the paged pool: a free list and per-block
    refcounts. An allocated block starts at refcount 1 (its stream) and
    returns to the free list at refcount 0. Thread-safe; the engine loop
    is the only allocating thread, concurrent readers see consistent
    gauges."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError(
                f"n_blocks must be >= 2 (block 0 is reserved), got "
                f"{n_blocks}")
        self._n = int(n_blocks)
        self._bs = int(block_size)
        self._ref = np.zeros(self._n, np.int64)
        self._ref[TRASH_BLOCK] = 1          # never allocated, never freed
        self._free: List[int] = list(range(self._n - 1, 0, -1))
        self._lock = threading.Lock()

    @property
    def block_size(self) -> int:
        return self._bs

    @property
    def usable(self) -> int:
        """Allocatable blocks (the pool minus the trash block)."""
        return self._n - 1

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_count(self) -> int:
        with self._lock:
            return self.usable - len(self._free)

    def gauges(self) -> Dict:
        """The /stats block-pool block: plain ints, json-ready."""
        with self._lock:
            free = len(self._free)
            return {"total": self.usable, "free": free,
                    "used": self.usable - free}

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` fresh blocks (refcount 1 each). Callers check
        :attr:`free_count` first; an empty pool here is a bookkeeping
        bug, not backpressure."""
        with self._lock:
            if n > len(self._free):
                raise RuntimeError(
                    f"block pool exhausted: asked {n}, free "
                    f"{len(self._free)} — admission must check "
                    f"free_count first")
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
            return out

    def retain(self, blocks: List[int]) -> None:
        """One more reference on each of ``blocks``."""
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise RuntimeError(
                        f"retain of unallocated block {b}")
                self._ref[b] += 1

    def release(self, blocks: List[int]) -> None:
        """Drop one reference per block; blocks at refcount 0 return to
        the free list. The trash block is silently skipped (table rows
        are padded with it)."""
        with self._lock:
            for b in blocks:
                if b == TRASH_BLOCK:
                    continue
                self._ref[b] -= 1
                if self._ref[b] < 0:
                    raise RuntimeError(f"double free of block {b}")
                if self._ref[b] == 0:
                    self._free.append(b)

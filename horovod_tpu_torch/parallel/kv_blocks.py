"""Paged KV cache: a fixed pool of blocks plus per-slot block tables.

Port of the JAX package's ``parallel/kv_blocks.py``: the paged prefill,
the chunked prefill that reads a shared prefix back out of the pool, the
decode and speculative verify steps, and the host-side
:class:`BlockManager` with its copy-on-write prefix registry and host
tier.

The pool is ``{"k", "v": [n_layers, n_blocks, block_size, n_heads,
d_head], "lengths": [max_slots] int32}``; a slot owns a list of blocks
(its block-table row), so short requests hold only the blocks they fill.
Physical block 0 is the **trash block**: never allocated, the padding
entry of every table row and the target of every padding or
inactive-slot write, masked out of every attention by the per-slot
positions.

Unlike the JAX functions, which return a new pool, the device functions
write the pool **in place** (a full-width pool is a gigabyte; copying it
per step would double the memory and the traffic) and return the same
dict. Both paged steps, decode and verify, take JAX's ``kernel`` flag:
``kernel=False`` (the default, the engine's ``paged_kernel=False``)
gathers each slot's blocks into its contiguous view and runs the same
:func:`~.transformer.cached_attention` the contiguous step runs, so the
paged engine is bitwise the contiguous one; ``kernel=True`` reads the
pool through the paged decode-attention kernel. Under ``kernel=True``
the verify runs the kernel too, so a speculated stream never mixes two
attention numerics; the JAX engine refuses speculation with the kernel
(``ROADMAP.md`` Queue 3 logs the difference). Every entry point takes
the LoRA hook's ``adapters``/``adapter_idx``/``lora`` (:mod:`.lora`).

On a tp mesh (the model's, carried in the weights) every function runs
this rank's ``n_heads / tp`` heads against a pool of those heads
(:func:`paged_kv_cache_specs`), with the row-parallel sums of
:func:`~.transformer.prompt_forward` and
:func:`~.transformer.step_forward`; K8 then runs at ``H / tp`` heads.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.paged_attention import paged_decode_attention
from .lora import make_delta
from .transformer import (TransformerConfig, _clamped, cached_attention,
                          check_dense, local_heads, prompt_forward,
                          step_forward)

#: Physical block 0 — reserved, never allocated; see module docstring.
TRASH_BLOCK = 0


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache positions."""
    return -(-int(n_tokens) // int(block_size))


def paged_kv_cache_specs(cfg: TransformerConfig, mesh) -> Dict:
    """The spec tree matching :func:`init_paged_kv_cache` (JAX
    ``paged_kv_cache_specs``): the head axis (axis 3 of ``[L, N, bs, H,
    dh]``) shards over ``tp``, as the contiguous
    :func:`~.transformer.kv_cache_specs`; blocks and positions are
    replicated."""
    tp = "tp" if mesh is not None and "tp" in mesh.axis_names else None
    kv = (None, None, None, tp, None)
    return {"k": kv, "v": kv, "lengths": ()}


def init_paged_kv_cache(cfg: TransformerConfig, n_blocks: int,
                        block_size: int, max_slots: int,
                        dtype: Optional[torch.dtype] = None, *,
                        device: DeviceLike = "cuda", mesh=None) -> Dict:
    """Fresh (zeroed) paged K/V pool on ``device``. ``n_blocks`` includes
    the reserved trash block, so ``n_blocks - 1`` blocks are usable. On
    a tp ``mesh`` the pool holds this rank's ``n_heads / tp`` heads
    (:func:`paged_kv_cache_specs`); the block ids are the same on every
    rank, so one host :class:`BlockManager` (the leader's) names every
    rank's blocks."""
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
    shape = (cfg.n_layers, n_blocks, block_size, local_heads(cfg, mesh),
             cfg.d_head)
    kv_dtype = cfg.dtype if dtype is None else dtype
    return {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
            "v": torch.zeros(shape, dtype=kv_dtype, device=dev),
            "lengths": torch.zeros((max_slots,), dtype=torch.int32,
                                   device=dev)}


def paged_prefill(w: Dict, tokens: torch.Tensor, cache: Dict, slot: int,
                  write_row: torch.Tensor, cfg: TransformerConfig,
                  length: Optional[int] = None, *, adapters=None,
                  adapter_idx=None, lora=None) -> Tuple[Dict, torch.Tensor]:
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
    read nothing from the pool. ``adapters``/``adapter_idx``/``lora``:
    the LoRA table, this prompt's row (``-1`` = base), its config."""
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

    logits = prompt_forward(w, tokens, cfg, store, delta=make_delta(
        "prompt", adapters, adapter_idx, lora, cfg))
    cache["lengths"][slot] = T if length is None else int(length)
    return cache, logits


def paged_chunked_prefill(w: Dict, tokens: torch.Tensor, cache: Dict,
                          slot: int, write_rows: torch.Tensor,
                          read_row: torch.Tensor, start: int,
                          cfg: TransformerConfig,
                          length: Optional[int] = None,
                          chunk_blocks: int = 1, *, adapters=None,
                          adapter_idx=None, lora=None
                          ) -> Tuple[Dict, torch.Tensor]:
    """Chunked prefill: chunks of ``C = chunk_blocks · block_size`` tokens,
    one after the other, whose attention reads K/V back out of the pool
    through ``read_row``. A prefix-hit admission runs only the suffix's
    chunks (the shared blocks are never recomputed); a cold admission is
    the same loop started at block 0.

    Args:
      tokens: ``[B]`` int at a chunked bucket (``B % C == 0`` and
        ``B >= 2·C``, the JAX function's rules).
      write_rows: ``[B // C, chunk_blocks]`` int32 physical block per
        chunk position; shared-prefix and padding entries point at
        :data:`TRASH_BLOCK`.
      read_row: ``[max_blocks]`` int32, the slot's whole chain (hit
        blocks, then the fresh blocks ``write_rows`` names),
        trash-padded.
      start: absolute position of ``tokens[0]`` (``hits · block_size``,
        a whole number of chunks; 0 for a cold admission).
      length: the true total sequence length (prefix + suffix; default
        ``B``).

    Returns ``(cache, logits [B, vocab] f32)``; row ``i`` scores
    absolute position ``start + i``. Each chunk stores its K/V, then
    attends (f32 scores, -1e30 mask, f32 softmax, as JAX's scan body)
    over the gathered ``[max_blocks · block_size]`` view of the pool at
    the same shapes whatever the hit depth, so a hit's suffix logits and
    the pool bytes it writes are bitwise those of the cold loop. The LoRA
    arguments are :func:`paged_prefill`'s."""
    check_dense(cfg, "paged_chunked_prefill")
    B = tokens.shape[0]
    bs = cache["k"].shape[2]
    C = int(chunk_blocks) * bs
    if B % C or B < 2 * C:
        raise ValueError(
            f"chunked bucket {B} must be a multiple of chunk size {C} "
            f"and at least 2 chunks (the reference's one-trip rule, which "
            f"the engine's chunked buckets keep)")
    max_blocks = read_row.shape[0]
    if B > max_blocks * bs:
        raise ValueError(
            f"chunked bucket {B} exceeds the table depth "
            f"{max_blocks} blocks × {bs}")
    M = max_blocks * bs
    H, dh = cache["k"].shape[3:]        # this rank's heads on a tp mesh
    sm_scale = float(dh) ** -0.5
    dev = cache["k"].device
    rr = read_row.to(device=dev, dtype=torch.long)
    wr = write_rows.to(device=dev, dtype=torch.long)
    kpos = torch.arange(M, device=dev)
    delta = make_delta("prompt", adapters, adapter_idx, lora, cfg)
    outs = []
    for c in range(B // C):
        wblocks = wr[c]
        qpos = int(start) + c * C + torch.arange(C, device=dev)
        hidden = (qpos[:, None] < kpos[None, :])[None, None]

        def store(li, k, v, wblocks=wblocks):
            for pool, x in ((cache["k"][li], k), (cache["v"][li], v)):
                pool[wblocks] = x.to(pool.dtype).reshape(
                    chunk_blocks, bs, H, dh)

        def attend(li, q, hidden=hidden):
            # Gathers after store: the chunk attends everything written
            # so far (hit blocks included) and itself.
            kg = cache["k"][li][rr].reshape(M, H, dh)[None]
            vg = cache["v"][li][rr].reshape(M, H, dh)[None]
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                             kg.float()) * sm_scale
            p = torch.softmax(s.masked_fill(hidden, -1e30), dim=-1)
            return torch.einsum("bhqk,bkhd->bqhd", p, vg.float())

        outs.append(prompt_forward(w, tokens[c * C:(c + 1) * C], cfg,
                                   store, attend=attend, delta=delta))
    cache["lengths"][slot] = B if length is None else int(length)
    return cache, torch.cat(outs)


def _gathered(pool: torch.Tensor, block_tables: torch.Tensor
              ) -> torch.Tensor:
    """Each slot's blocks of one layer's pool as its contiguous ``[S,
    max_blocks·block_size, H, d]`` view (JAX's gather path)."""
    S, nb = block_tables.shape
    return pool[block_tables.long()].reshape(S, nb * pool.shape[1],
                                              *pool.shape[2:])


def paged_decode_step(w: Dict, last_tokens: torch.Tensor, cache: Dict,
                      positions: torch.Tensor, block_tables: torch.Tensor,
                      cfg: TransformerConfig, *, kernel: bool = False,
                      adapters=None, adapter_idx=None, lora=None
                      ) -> Tuple[Dict, torch.Tensor]:
    """One autoregressive step for every slot, through the block table.

    Args:
      last_tokens: ``[S]`` int per-slot previous token.
      positions: ``[S]`` int32 write index; ``-1`` = inactive (its
        scratch write lands in whatever ``block_tables[s, 0]`` names —
        the trash block for an unoccupied slot — and its output row is
        garbage to be ignored).
      block_tables: ``[S, max_blocks]`` int32, trash-padded.
      kernel: read the pool through
        :func:`~..ops.paged_attention.paged_decode_attention` (the K8
        kernel on the card where it takes the input) instead of gathering
        each slot's blocks into its contiguous view for
        :func:`~.transformer.cached_attention`. The gather is the
        reference: the contiguous cache's own attention over the same
        view, so paged and contiguous streams are bitwise equal.
      adapters, adapter_idx, lora: the per-slot LoRA hook
        (``adapter_idx [S]``, ``-1`` = base), as in
        :func:`~.transformer.decode_step`.

    Each layer writes the new K/V at ``positions`` and attends keys
    ``0..pos``, with inactive slots' positions clamped to 0 as the JAX
    step does. Returns ``(cache, logits [S, vocab] f32)``; every slot's
    row depends only on that slot's token, position and blocks."""
    check_dense(cfg, "paged_decode_step")
    S = last_tokens.shape[0]
    bs = cache["k"].shape[2]
    active, pos = _clamped(positions)
    rows = torch.arange(S, device=positions.device)
    phys = block_tables[rows, (pos // bs).long()].long()
    off = (pos % bs).long()

    def mix(li, q, k, v):
        k_pool, v_pool = cache["k"][li], cache["v"][li]
        k_pool[phys, off] = k.to(k_pool.dtype)
        v_pool[phys, off] = v.to(v_pool.dtype)
        if kernel:
            return paged_decode_attention(q.contiguous(), k_pool, v_pool,
                                          block_tables, pos).to(q.dtype)
        return cached_attention(q, _gathered(k_pool, block_tables),
                                _gathered(v_pool, block_tables), pos)

    logits = step_forward(w, last_tokens, cfg, mix, delta=make_delta(
        "step", adapters, adapter_idx, lora, cfg, rows=S,
        device=positions.device))
    cache["lengths"].copy_(torch.where(active, pos + 1, cache["lengths"]))
    return cache, logits


def paged_verify_step(w: Dict, draft_tokens: torch.Tensor, cache: Dict,
                      positions: torch.Tensor, block_tables: torch.Tensor,
                      cfg: TransformerConfig, *, kernel: bool = False,
                      adapters=None, adapter_idx=None, lora=None
                      ) -> Tuple[Dict, torch.Tensor]:
    """Paged speculative verify: score ``W = k + 1`` positions per slot
    in one forward against the pool (the paged sibling of
    :func:`~.transformer.verify_step`).

    Column ``j`` writes its K/V at logical position ``positions[s] + j``
    through the slot's table; positions at or past the table's capacity
    go to :data:`TRASH_BLOCK`. Speculated writes land in the slot's
    private blocks only (admission reserves every position a stream may
    write, and shared prefix blocks cover whole prompt blocks), so a
    rejected draft needs no rollback. The ``S·W`` flattened rows attend
    the slot's gathered view repeated ``W`` times with
    :func:`~.transformer.cached_attention` (JAX's path), or with
    ``kernel=True`` run :func:`~..ops.paged_attention.
    paged_decode_attention` over the slot's table repeated ``W`` times
    with the decode step's split plan (``plan_rows=S``): on the card each
    row then sums its keys in the decode step's chunks and order. The
    LoRA hook repeats each slot's ``adapter_idx`` over its ``W`` rows.
    Returns ``(cache, logits [S, W, vocab] f32)``."""
    check_dense(cfg, "paged_verify_step")
    S, W = draft_tokens.shape
    bs = cache["k"].shape[2]
    max_blocks = block_tables.shape[1]
    active, pos = _clamped(positions)
    wpos = pos[:, None] + torch.arange(W, dtype=torch.int32,
                                       device=pos.device)[None, :]
    valid = wpos < max_blocks * bs
    bidx = torch.clamp(wpos // bs, max=max_blocks - 1).long()
    rows = torch.arange(S, device=pos.device)[:, None]
    phys = torch.where(valid, block_tables[rows, bidx],
                       torch.full_like(bidx, TRASH_BLOCK,
                                       dtype=block_tables.dtype)).long()
    off = (wpos % bs).long()
    flat_pos = wpos.reshape(S * W).contiguous()
    tables_w = block_tables.repeat_interleave(W, dim=0)

    def mix(li, q, k, v):
        k_pool, v_pool = cache["k"][li], cache["v"][li]
        k_pool[phys, off] = k.reshape(S, W, *k.shape[1:]).to(k_pool.dtype)
        v_pool[phys, off] = v.reshape(S, W, *v.shape[1:]).to(v_pool.dtype)
        if kernel:
            return paged_decode_attention(q.contiguous(), k_pool, v_pool,
                                          tables_w, flat_pos,
                                          plan_rows=S).to(q.dtype)
        return cached_attention(
            q, _gathered(k_pool, block_tables).repeat_interleave(W, dim=0),
            _gathered(v_pool, block_tables).repeat_interleave(W, dim=0),
            flat_pos)

    logits = step_forward(w, draft_tokens.reshape(S * W), cfg, mix,
                          delta=make_delta("step", adapters, adapter_idx,
                                           lora, cfg, rows=S, repeat=W,
                                           device=pos.device))
    cache["lengths"].copy_(torch.where(active, pos + 1, cache["lengths"]))
    return cache, logits.reshape(S, W, -1)


# -- host-side block accounting: free list, refcounts, prefix registry --------


def prefix_route_digest(tokens, block_size: int,
                        adapter: Optional[str] = None) -> Optional[str]:
    """Stable 16-hex digest of a prompt's first full block under the
    tenant frame (``\\x00`` for base, ``"{adapter}\\x00"`` for a tenant):
    the prefix-affine routing key, the JAX function's exact strings.
    ``None`` when the prompt has no full first block."""
    if len(tokens) < block_size:
        return None
    frame = b"\x00" if adapter is None else f"{adapter}\x00".encode()
    blk = np.ascontiguousarray(tokens[:block_size], dtype=np.int32)
    return hashlib.sha256(frame + blk.tobytes()).hexdigest()[:16]


class BlockManager:
    """Host-side allocator for the paged pool: free list + per-block
    refcounts + a prefix registry for copy-on-write prompt sharing (the
    JAX class, host-side numpy, ported whole).

    Refcount semantics: an allocated block starts at 1 (its owning
    stream); sharing a prefix block retains it (+1 per sharing stream);
    registering a block in the prefix registry pins it with one more
    ref, so a registered prefix survives its streams and serves future
    hits. A block returns to the free list only at refcount 0;
    :meth:`reclaim` evicts LRU registry entries (dropping their pin)
    when the pool runs dry. All methods are thread-safe, but the
    allocate/lookup/register flow assumes a single admitting thread (the
    engine loop) — concurrent readers only see consistent gauges.

    The registry keys are the raw token bytes of each block-aligned
    prefix (``tokens[:j·block_size].tobytes()``), so a hit requires the
    ENTIRE preceding prefix to match — exactly the condition under which
    the cached K/V (a causal function of the preceding tokens) is valid
    for the new stream. ``salt`` extends that condition to everything
    else the K/V is a function of: a multi-tenant engine passes the
    request's (adapter, load-generation) identity, because a LoRA
    delta changes the K/V a prompt writes — two tenants' identical
    token prefixes are NOT interchangeable bytes, and neither are one
    tenant's before/after a hot-reload.

    **Per-tenant ownership and budgets.** Every allocated block can
    carry an ``owner`` (the allocating tenant); the tenant salt already
    makes prefix sharing tenant-scoped, so a block has exactly ONE
    owner for its whole allocated life — shared-prefix retains are
    always same-tenant. :meth:`set_budget` caps a tenant's owned
    blocks; enforcement belongs to the engine's admission path
    (``GenerationEngine``: rejection at the door, starvation of that
    tenant alone, its own blocks reclaimed first). The manager only does
    the ledger: :meth:`owned_count`, owner-filtered
    :meth:`offload_candidates` (a tenant over budget offloads its OWN
    coldest blocks first) and owner-filtered :meth:`reclaim` (it
    evicts its own registry residue, never another tenant's cache).
    """

    def __init__(self, n_blocks: int, block_size: int,
                 host_blocks: int = 0):
        if n_blocks < 2:
            raise ValueError(
                f"n_blocks must be >= 2 (block 0 is reserved), got "
                f"{n_blocks}")
        self._n = int(n_blocks)
        self._bs = int(block_size)
        self._ref = np.zeros(self._n, np.int64)
        self._ref[TRASH_BLOCK] = 1          # never allocated, never freed
        self._free: List[int] = list(range(self._n - 1, 0, -1))
        self._registry: "OrderedDict[bytes, int]" = OrderedDict()
        # Host tier: registry key -> opaque payload (the engine stages
        # the block's K/V bytes; the manager only does LRU accounting).
        self._host_cap = int(host_blocks)
        self._host: "OrderedDict[bytes, Any]" = OrderedDict()
        # First-block registry key -> advisory routing digest; kept
        # while the chain head lives in EITHER tier.
        self._route: Dict[bytes, str] = {}
        # Tenant ownership ledger: block -> owning tenant for the
        # block's allocated lifetime (registry pins included — a
        # tenant's cache residue counts against its budget), plus the
        # per-tenant owned counts and budgets the engine enforces.
        self._owner: Dict[int, str] = {}
        self._owned: Dict[str, int] = {}
        self._budgets: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- gauges ------------------------------------------------------------

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

    @property
    def registry_size(self) -> int:
        with self._lock:
            return len(self._registry)

    def gauges(self) -> Dict:
        """The /stats block-pool block: plain ints, json-ready (the
        router sums these across replicas, so every value stays
        numeric). Host-tier keys are present even at ``host_blocks=0``
        so the exposition is stable across configurations."""
        with self._lock:
            free = len(self._free)
            host_used = len(self._host)
            return {"total": self.usable, "free": free,
                    "used": self.usable - free,
                    "registered_prefix_blocks": len(self._registry),
                    "host_total": self._host_cap,
                    "host_used": host_used,
                    "host_free": max(0, self._host_cap - host_used)}

    def tenant_gauges(self) -> Dict:
        """Per-tenant ownership view, SEPARATE from :meth:`gauges`
        (whose values the fleet router sums across replicas — they must
        stay scalar): owned device blocks and configured budgets by
        tenant, json-ready."""
        with self._lock:
            return {"owned": dict(sorted(self._owned.items())),
                    "budgets": dict(sorted(self._budgets.items()))}

    # -- tenant ownership / budgets -----------------------------------------

    def _own(self, b: int, owner: Optional[str]) -> None:
        """Stamp ``owner`` on block ``b`` (caller holds the lock)."""
        if owner is None:
            return
        self._owner[b] = owner
        self._owned[owner] = self._owned.get(owner, 0) + 1

    def _disown(self, b: int) -> None:
        """Clear block ``b``'s owner as it frees (caller holds the
        lock)."""
        owner = self._owner.pop(b, None)
        if owner is None:
            return
        n = self._owned.get(owner, 1) - 1
        if n > 0:
            self._owned[owner] = n
        else:
            self._owned.pop(owner, None)

    def set_budget(self, tenant: str, budget: Optional[int]) -> None:
        """Cap ``tenant``'s owned device blocks (``None`` = unlimited).
        Budget vs quota: a quota caps in-flight STREAMS, a budget caps
        the tenant's slice of the device pool — the resource that one
        long-context tenant can exhaust for everyone with a handful of
        streams."""
        if budget is not None and budget < 1:
            raise ValueError(
                f"block budget must be >= 1 or None, got {budget}")
        with self._lock:
            if budget is None:
                self._budgets.pop(tenant, None)
            else:
                self._budgets[tenant] = int(budget)

    def budget(self, tenant: str) -> Optional[int]:
        with self._lock:
            return self._budgets.get(tenant)

    def owned_count(self, tenant: str) -> int:
        """Device blocks currently owned by ``tenant`` — live stream
        allocations AND its registry-pinned prefix residue."""
        with self._lock:
            return self._owned.get(tenant, 0)

    # -- allocation --------------------------------------------------------

    def alloc(self, n: int, owner: Optional[str] = None) -> List[int]:
        """Take ``n`` fresh blocks (refcount 1 each), owned by
        ``owner`` when given. Callers check :attr:`free_count` (and
        :meth:`reclaim`) first; an empty pool here is a bookkeeping
        bug, not backpressure."""
        with self._lock:
            if n > len(self._free):
                raise RuntimeError(
                    f"block pool exhausted: asked {n}, free "
                    f"{len(self._free)} — admission must check "
                    f"free_count/reclaim first")
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
                self._own(b, owner)
            return out

    def retain(self, blocks: List[int]) -> None:
        """One more stream reference on each of ``blocks`` (prefix hit)."""
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
                    self._disown(b)
                    self._free.append(b)

    # -- prefix registry ---------------------------------------------------

    def _key(self, tokens: np.ndarray, j: int, salt: bytes) -> bytes:
        return salt + np.ascontiguousarray(
            tokens[:(j + 1) * self._bs], dtype=np.int32).tobytes()

    def lookup_prefix(self, tokens: np.ndarray,
                      salt: bytes = b"") -> List[int]:
        """Longest chain of registered full blocks matching the prompt's
        block-aligned prefix UNDER ``salt`` (the writer-identity key —
        see class docstring); touches hits MRU so reclaim evicts cold
        prefixes first."""
        with self._lock:
            hits: List[int] = []
            for j in range(len(tokens) // self._bs):
                key = self._key(tokens, j, salt)
                blk = self._registry.get(key)
                if blk is None:
                    break
                self._registry.move_to_end(key)
                hits.append(blk)
            return hits

    def register_prefix(self, tokens: np.ndarray, blocks: List[int],
                        n_full: int, salt: bytes = b"",
                        route_digest: Optional[str] = None) -> None:
        """Pin the prompt's first ``n_full`` blocks in the registry
        under ``salt`` (idempotent for already-registered chains).
        ``route_digest`` tags the chain's FIRST block key for
        prefix-affine routing. A cold re-registration supersedes any
        host-tier copy of the same key (bitwise-identical bytes by the
        chunked-prefill contract, so the device copy wins and the host
        slot frees up)."""
        with self._lock:
            for j in range(n_full):
                key = self._key(tokens, j, salt)
                if j == 0 and route_digest:
                    self._route[key] = route_digest
                self._host.pop(key, None)
                if key in self._registry:
                    self._registry.move_to_end(key)
                    continue
                self._registry[key] = blocks[j]
                self._ref[blocks[j]] += 1

    def reclaim(self, need_free: int,
                owner: Optional[str] = None) -> bool:
        """Evict registered prefixes, LRU-first, until ``need_free``
        blocks are free. Only entries whose block's SOLE reference is
        the registry pin are evicted — popping a stream-referenced entry
        frees nothing and would just wipe the cache for future
        admissions (a transiently starved request must not disable
        prefix reuse for everyone else). ``owner`` restricts the sweep
        to blocks that tenant owns: an over-budget tenant reclaims its
        OWN cache residue, never another tenant's. Returns whether the
        target was met; entries skipped here free up for a later sweep
        when their streams end."""
        with self._lock:
            if len(self._free) >= need_free:
                return True
            for key in list(self._registry):        # LRU → MRU order
                if len(self._free) >= need_free:
                    break
                blk = self._registry[key]
                if owner is not None and self._owner.get(blk) != owner:
                    continue
                if self._ref[blk] == 1:
                    del self._registry[key]
                    if key not in self._host:
                        self._route.pop(key, None)
                    self._ref[blk] = 0
                    self._disown(blk)
                    self._free.append(blk)
            return len(self._free) >= need_free

    # -- host tier ---------------------------------------------------------

    def host_lookup(self, tokens: np.ndarray, start_block: int,
                    salt: bytes = b"") -> List[Tuple[bytes, Any]]:
        """Contiguous run of host-tier entries continuing the device
        chain from logical block ``start_block`` — ``[(key, payload),
        ...]`` in chain order, touched MRU. The engine kicks an async
        prefetch for these; they are NOT readable by this admission."""
        with self._lock:
            out: List[Tuple[bytes, Any]] = []
            for j in range(int(start_block), len(tokens) // self._bs):
                key = self._key(tokens, j, salt)
                payload = self._host.get(key)
                if payload is None:
                    break
                self._host.move_to_end(key)
                out.append((key, payload))
            return out

    def offload_candidates(self, n: int,
                           owner: Optional[str] = None
                           ) -> List[Tuple[bytes, int]]:
        """Up to ``n`` coldest registry entries whose block's SOLE
        reference is the registry pin — the only ones whose device bytes
        are stable to copy (no stream can be writing them) and whose
        eviction frees a block. ``owner`` restricts the sweep to that
        tenant's blocks (the over-budget path: a tenant offloads its
        OWN coldest blocks first). Read-only: the engine snapshots the
        bytes, then :meth:`offload_commit` re-validates under the lock,
        so a hit that lands mid-copy simply cancels the offload."""
        if self._host_cap <= 0 or n <= 0:
            return []
        with self._lock:
            out: List[Tuple[bytes, int]] = []
            for key, blk in self._registry.items():     # LRU → MRU
                if len(out) >= n:
                    break
                if owner is not None and self._owner.get(blk) != owner:
                    continue
                if self._ref[blk] == 1:
                    out.append((key, blk))
            return out

    def offload_commit(self, key: bytes, payload: Any) -> bool:
        """Move a candidate to the host tier: drop the registry pin,
        free the device block, stage ``payload`` LRU-tracked. Refuses
        (returns False) if the entry was hit or evicted since
        :meth:`offload_candidates` — the payload would be stale
        bookkeeping, never a stale read, but we don't keep it."""
        with self._lock:
            blk = self._registry.get(key)
            if blk is None or self._ref[blk] != 1 or self._host_cap <= 0:
                return False
            del self._registry[key]
            self._ref[blk] = 0
            self._disown(blk)
            self._free.append(blk)
            self._host[key] = payload
            self._host.move_to_end(key)
            while len(self._host) > self._host_cap:
                old, _ = self._host.popitem(last=False)
                if old not in self._registry:
                    self._route.pop(old, None)
            return True

    def promote(self, key: bytes, blk: int) -> bool:
        """Install a prefetched payload's freshly written device block
        back into the registry, transferring the caller's alloc ref to
        the registry pin (the block arrives at refcount 1 from
        :meth:`alloc` and stays at 1 — registry-pinned, stream-free).
        Idempotent against the admission race: if the key was re-
        registered cold while the prefetch was in flight, the new block
        is freed and False returned — both copies hold bitwise-identical
        bytes, so either outcome is correct and no reader ever sees a
        stale row."""
        with self._lock:
            self._host.pop(key, None)
            if key in self._registry:
                self._ref[blk] = 0
                self._disown(blk)
                self._free.append(blk)
                return False
            self._registry[key] = blk
            return True

    def route_digests(self) -> Tuple[str, ...]:
        """Sorted unique advisory routing digests of every prefix chain
        resident in EITHER tier — what the replica advertises through
        /stats for prefix-affine dispatch."""
        with self._lock:
            return tuple(sorted(set(self._route.values())))

"""Sequence parallelism over ``sp``: ring attention and Ulysses.

Port of the JAX package's ``parallel/ring.py``: ``_block_attn`` (:30),
``ring_attention`` (:45) and ``ulysses_attention`` (:103). The sequence
is split along the mesh's ``sp`` axis; each rank holds a ``[B, T/S, H,
D]`` shard of q, k and v.

* :func:`ring_attention` rotates K/V one hop around the ring per step
  (:func:`~.comm.rotate`: the send and the receive posted together, the
  backward rotating the cotangent the other way) while each rank folds
  every block into its queries' online softmax, with the JAX function's
  arithmetic: f32 block scores, a ``-1e30`` mask on GLOBAL positions,
  the running max/sum rescaled in its order and the final ``l == 0``
  guard. The last rotation of the JAX loop, whose blocks nothing reads,
  is not sent.
* :func:`ulysses_attention` re-shards from sequence-split to head-split
  with one all-to-all, attends over the full sequence with ``H/S`` heads
  and restores sequence sharding with a second all-to-all
  (:func:`~.comm.all_to_all`, differentiable).

Both are plain PyTorch: the JAX functions are XLA code with no Pallas
kernel behind them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .comm import all_to_all, rotate

_MASKED = -1e30


def _block_attn(q, k, v, mask, sm_scale: float):
    """One (q-block, kv-block) partial: ``(m_blk, l_blk, pv)``. q ``[B,
    Tq, H, D]``, k/v ``[B, Tk, H, D]`` (f32), mask ``[Tq, Tk]`` bool
    (True = keep) or None."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm_scale
    if mask is not None:
        scores = scores.masked_fill(~mask, _MASKED)
    m_blk = scores.amax(-1)                               # [B, H, Tq]
    p = torch.exp(scores - m_blk[..., None])
    l_blk = p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)            # [B, Tq, H, D]
    return m_blk, l_blk, pv


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis_name: str = "sp", causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact multi-head attention with K/V ring rotation over
    ``axis_name`` of ``mesh``.

    q, k, v: ``[B, T_local, H, D]``, this rank's sequence shard (rows
    ``[i·T_local, (i+1)·T_local)`` of the sequence at sp index i).
    ``causal`` masks with global positions. Returns ``[B, T_local, H,
    D]`` in q's dtype: this rank's rows of the attention over the whole
    sequence. Differentiable."""
    B, T, H, D = q.shape
    S = mesh.shape[axis_name]
    rank = mesh.coords[axis_name]
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    q32 = q.float()
    dev = q.device
    rows = rank * T + torch.arange(T, device=dev)
    o = torch.zeros((B, T, H, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, T), _MASKED, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for s in range(S):
        # Block s arrived from sp index (rank - s) mod S.
        src = (rank - s) % S
        mask = None
        if causal:
            cols = src * T + torch.arange(T, device=dev)
            mask = rows[:, None] >= cols[None, :]
        m_blk, l_blk, pv = _block_attn(q32, k_cur.float(), v_cur.float(),
                                       mask, sm_scale)
        m_new = torch.maximum(m, m_blk)
        alpha = torch.exp(m - m_new)                      # old accum
        beta = torch.exp(m_blk - m_new)                   # new block
        l = l * alpha + l_blk * beta
        o = (o * alpha.transpose(1, 2)[..., None]
             + pv * beta.transpose(1, 2)[..., None])
        m = m_new
        if s < S - 1:
            k_cur = rotate(k_cur, mesh, axis_name)
            v_cur = rotate(v_cur, mesh, axis_name)
    # A row with no visible key would have l == 0 (causal self-attention
    # always sees itself); guard the division as the JAX function does.
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh, axis_name: str = "sp", causal: bool = False,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses-style) sequence parallelism: one
    all-to-all re-shards from sequence-split to head-split, attention
    runs over the whole sequence with ``H/S`` heads (f32 scores, a
    ``-1e30`` causal mask, f32 softmax and P·V, cast back to q's dtype)
    and a second all-to-all restores sequence sharding. Shapes as
    :func:`ring_attention`; H must divide by the axis size."""
    B, T, H, D = q.shape
    S = mesh.shape[axis_name]
    group = mesh.groups[axis_name]
    if H % S:
        raise ValueError(f"heads {H} not divisible by sp axis {S}")

    def seq_to_heads(x):                  # [B, T/S, H, D] -> [B, T, H/S, D]
        x = x.reshape(B, T, S, H // S, D).permute(2, 0, 1, 3, 4)
        x = all_to_all(x, group)              # [src, B, T/S, H/S, D]
        return x.permute(1, 0, 2, 3, 4).reshape(B, S * T, H // S, D)

    def heads_to_seq(y):                  # [B, T, H/S, D] -> [B, T/S, H, D]
        y = y.reshape(B, S, T, H // S, D).permute(1, 0, 2, 3, 4)
        y = all_to_all(y, group)              # [head chunk, B, T/S, H/S, D]
        return y.permute(1, 2, 0, 3, 4).reshape(B, T, H, D)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    scores = scores * (sm_scale if sm_scale is not None else 1.0 / (D ** 0.5))
    if causal:
        pos = torch.arange(T * S, device=q.device)
        scores = scores.masked_fill(~(pos[:, None] >= pos[None, :]),
                                    _MASKED)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh.float())
    return heads_to_seq(out.to(q.dtype))

"""Port parity: the split-and-merge paged decode attention on the CPU.

The CUDA kernel (``ops/csrc/paged_attention.cu``) cuts each slot's keys
into chunks fixed on the host by ``split_plan`` and merges the chunks'
softmax states in a fixed order. Here, without a card:

* the planner: for every position of a table, the chunks the kernel runs
  and the boxes their tiles load (``active_splits`` and ``tile_boxes``
  below: the kernel's own arithmetic, ``n_active`` and ``load_tile``)
  cover each key ``0..pos`` exactly once and read no block past pos's;
  the plan takes no positions; the grid fills a 132-SM card at one slot;
* ``paged_attention_split_reference``, the same algorithm in plain
  PyTorch, against the JAX Pallas kernel in interpret mode and the JAX
  gather reference on the numpy inputs of
  ``tests/test_torch_paged_attention.py``, at several chunk sizes: split
  edges, empty splits, pos -1 and 0, a position past the table's keys and
  a table that repeats a physical block.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_paged_attention import \
    paged_attention_reference as jax_reference
from horovod_tpu.ops.pallas_paged_attention import \
    paged_decode_attention as jax_paged_decode_attention
from horovod_tpu_torch.ops.paged_attention import (
    _workspace, paged_attention_split_reference, split_plan)

H_PLAN, SMS = 16, 132       # the bench LM's heads, an H100's SMs


def active_splits(plan, n_keys):
    """The kernel's ``n_active``: chunks holding any of a slot's first
    ``n_keys`` keys (the other CTAs exit at once)."""
    n_tiles = -(-n_keys // plan.tile_keys)
    return -(-n_tiles // plan.tiles_per_chunk)


def tile_boxes(plan, block_size, t, n_keys):
    """The kernel's ``load_tile``: the ``(logical block, first row)`` of
    each box tile ``t`` loads for a slot holding ``n_keys`` keys (those
    whose first key is below ``n_keys``), box ``j`` into stage rows
    ``j * box_rows``."""
    per_block = block_size // plan.box_rows
    n_box = min(plan.boxes_per_tile,
                -(-(n_keys - t * plan.tile_keys) // plan.box_rows))
    return [((t * plan.boxes_per_tile + j) // per_block,
             (t * plan.boxes_per_tile + j) % per_block * plan.box_rows)
            for j in range(n_box)]


@pytest.mark.parametrize("S", [1, 2, 8])
@pytest.mark.parametrize("max_blocks", [1, 3, 128])
@pytest.mark.parametrize("bs", [1, 8, 16])
def test_chunks_cover_each_key_once(S, max_blocks, bs):
    plan = split_plan(S, H_PLAN, max_blocks, bs, SMS)
    cap = max_blocks * bs
    assert bs % plan.box_rows == 0 and plan.tile_keys <= 16
    # The splits cover the table's keys and none starts past them.
    assert plan.n_splits * plan.chunk_keys >= cap
    assert (plan.n_splits - 1) * plan.chunk_keys < cap
    for pos in range(cap):
        n_keys = pos + 1
        n_active = active_splits(plan, n_keys)
        assert 1 <= n_active <= plan.n_splits
        seen = np.zeros(n_keys, np.int64)
        for c in range(plan.n_splits):
            key0 = c * plan.chunk_keys
            assert (key0 < n_keys) == (c < n_active)   # others exit at once
            if c >= n_active:
                continue
            blk0 = key0 // bs
            t0 = c * plan.tiles_per_chunk
            for t in range(t0, t0 + plan.tiles_per_chunk):
                if t * plan.tile_keys >= n_keys:
                    break
                for j, (b, row0) in enumerate(
                        tile_boxes(plan, bs, t, n_keys)):
                    assert b <= pos // bs, "a block past pos's is read"
                    assert 0 <= b - blk0 <= 128, "outside the table window"
                    for r in range(plan.box_rows):
                        key = b * bs + row0 + r
                        # stage row j * box_rows + r holds this key
                        assert key == (t * plan.tile_keys
                                       + j * plan.box_rows + r)
                        if key < n_keys:
                            seen[key] += 1
        assert (seen == 1).all(), (pos, np.flatnonzero(seen != 1)[:8])


def test_plan_takes_no_positions():
    assert list(inspect.signature(split_plan).parameters) == [
        "S", "H", "max_blocks", "block_size", "n_sm"]


@pytest.mark.parametrize("bs", [8, 16])
def test_one_slot_fills_the_card(bs):
    """S=1, H=16, a full 2048-or-1024-key table: at least one CTA an SM
    (at bs 1 the 128-block table holds 128 keys, 8 tiles a head)."""
    plan = split_plan(1, 16, 128, bs, SMS)
    assert 16 * plan.n_splits >= SMS


def test_engine_plan_spreads_the_long_slot():
    """The engine's table (8 slots, 128 blocks of 16): chunks of 128
    keys, so a 1516-key slot runs on 12 CTAs a head."""
    plan = split_plan(8, 16, 128, 16, SMS)
    assert plan.chunk_keys == 128 and plan.n_splits == 16
    assert active_splits(plan, 1517) == 12


def test_workspace_layout_and_cache():
    """Tickets zero, partials 256-byte aligned behind them, one buffer
    per (device, stream, shape), the oldest of nine evicted."""
    dev = torch.device("cpu")
    buf, tick, ml, acc = _workspace(dev, 1, 5, 3)
    assert tick == buf.data_ptr() and (ml - tick) % 256 == 0
    assert acc - ml == 4 * 2 * 5 * 3
    assert buf.numel() * 4 == (ml - tick) + 4 * 5 * 3 * (2 + 128)
    assert not buf.any()
    assert _workspace(dev, 1, 5, 3)[0] is buf
    assert _workspace(dev, 2, 5, 3)[0] is not buf
    for stream in range(3, 11):
        _workspace(dev, stream, 5, 3)
    assert _workspace(dev, 1, 5, 3)[0] is not buf


# -- the split-and-merge algorithm against the JAX package ------------------

S, H, D, BS, N, NB = 5, 2, 128, 16, 7, 3
CHUNKS = [1, 8, 16, 32, 48]


def _positions(chunk):
    """-1, 0, both sides of the first split edge (later splits empty for
    the first three), and 37 or, at one chunk of 48, a position past the
    table's 48 keys."""
    return np.array([-1, 0, chunk - 1, chunk, 37 if chunk < 48 else 60],
                    np.int32)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H, D).astype(np.float32)
    kp = rng.randn(N, BS, H, D).astype(np.float32)
    vp = rng.randn(N, BS, H, D).astype(np.float32)
    tbl = rng.randint(0, N, (S, NB)).astype(np.int32)
    tbl[4] = [2, 5, 2]              # a table that repeats a physical block
    return q, kp, vp, tbl


def _jax(q, kp, vp, tbl, pos, dtype):
    return (jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
            jnp.asarray(vp, dtype), jnp.asarray(tbl, jnp.int32),
            jnp.asarray(pos, jnp.int32))


def _split(q, kp, vp, tbl, pos, chunk, dtype):
    return paged_attention_split_reference(
        torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
        torch.from_numpy(vp).to(dtype), torch.from_numpy(tbl),
        torch.from_numpy(pos), chunk)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_split_matches_pallas_kernel_f32(chunk):
    """f32 against the interpret-mode Pallas kernel: per-chunk states
    merged in order vs the kernel's per-block online softmax, summation
    order and exp2 vs exp only -- the JAX package's own tolerance, rtol
    1e-5 / atol 1e-6."""
    q, kp, vp, tbl = _inputs(0)
    pos = _positions(chunk)
    want = jax_paged_decode_attention(*_jax(q, kp, vp, tbl, pos,
                                            jnp.float32), interpret=True)
    got = _split(q, kp, vp, tbl, pos, chunk, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert not got[0].any()         # the inactive row is exactly zero


@pytest.mark.parametrize("chunk", CHUNKS)
def test_split_matches_jax_reference_f32(chunk):
    """Against the JAX gather reference (one dense softmax): rtol 1e-5 /
    atol 1e-6."""
    q, kp, vp, tbl = _inputs(1)
    pos = _positions(chunk)
    want = jax_reference(*_jax(q, kp, vp, tbl, pos, jnp.float32))
    got = _split(q, kp, vp, tbl, pos, chunk, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_split_matches_pallas_kernel_bf16(chunk):
    """bf16 pool and query: both sides compute in f32 from the same bf16
    values and round the output once: atol 1e-2 of an O(1) output."""
    q, kp, vp, tbl = _inputs(2)
    pos = _positions(chunk)
    want = jax_paged_decode_attention(*_jax(q, kp, vp, tbl, pos,
                                            jnp.bfloat16), interpret=True)
    got = _split(q, kp, vp, tbl, pos, chunk, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)

"""Port parity: paged decode attention against the JAX package.

The port's ``paged_attention_reference`` (the plain PyTorch version of
the CUDA paged kernel, and what ``paged_decode_attention`` runs on CPU
tensors) is held against the JAX Pallas ``paged_decode_attention`` in
interpret mode and against the JAX gather reference, on the same numpy
inputs — mirroring the JAX package's own kernel-vs-reference test:
inactive (-1) slots, position 0, a block edge, a partial block, and a
table that repeats a physical block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas_paged_attention import \
    paged_attention_reference as jax_reference
from horovod_tpu.ops.pallas_paged_attention import \
    paged_decode_attention as jax_paged_decode_attention
from horovod_tpu_torch.ops import LAUNCHES
from horovod_tpu_torch.ops.paged_attention import (
    paged_attention_reference, paged_attention_supported,
    paged_decode_attention)

S, H, D, BS, N, NB = 5, 2, 128, 16, 7, 3
# -1 inactive, 0 first key, 15 block edge, 16 first key of block 1,
# 37 partial third block.
POSITIONS = np.array([-1, 0, 15, 16, 37], np.int32)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H, D).astype(np.float32)
    kp = rng.randn(N, BS, H, D).astype(np.float32)
    vp = rng.randn(N, BS, H, D).astype(np.float32)
    tbl = rng.randint(0, N, (S, NB)).astype(np.int32)
    tbl[4] = [2, 5, 2]              # a table that repeats a physical block
    return q, kp, vp, tbl


def _jax(q, kp, vp, tbl, dtype):
    return (jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
            jnp.asarray(vp, dtype), jnp.asarray(tbl, jnp.int32),
            jnp.asarray(POSITIONS, jnp.int32))


def _torch(q, kp, vp, tbl, dtype):
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
            torch.from_numpy(vp).to(dtype), torch.from_numpy(tbl),
            torch.from_numpy(POSITIONS))


def test_reference_matches_pallas_kernel_f32():
    """f32 against the interpret-mode Pallas kernel: the kernel's online
    softmax over blocks vs one dense softmax, summation order only — the
    JAX package's own kernel-vs-reference tolerance, rtol 1e-5 /
    atol 1e-6."""
    arrs = _inputs(0)
    want = jax_paged_decode_attention(*_jax(*arrs, jnp.float32),
                                      interpret=True)
    got = paged_attention_reference(*_torch(*arrs, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert not got[0].any()         # the inactive row is exactly zero


def test_reference_matches_jax_reference_f32():
    """Against the JAX gather reference: the same dense math, so only
    einsum summation order differs — rtol 1e-5 / atol 1e-6."""
    arrs = _inputs(1)
    want = jax_reference(*_jax(*arrs, jnp.float32))
    got = paged_attention_reference(*_torch(*arrs, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_reference_matches_pallas_kernel_bf16():
    """bf16 pool and query: both sides compute in f32 from the same bf16
    values and round the output once, so they agree to one bf16 ulp of
    an O(1) output: atol 1e-2."""
    arrs = _inputs(2)
    want = jax_paged_decode_attention(*_jax(*arrs, jnp.bfloat16),
                                      interpret=True)
    got = paged_attention_reference(*_torch(*arrs, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_position_zero_returns_first_value_row():
    """Key 0 alone: softmax weight 1, the output is v at (table[s,0], 0)."""
    q, kp, vp, tbl, pos = _torch(*_inputs(3), torch.float32)
    out = paged_attention_reference(q, kp, vp, tbl, pos)
    torch.testing.assert_close(out[1], vp[tbl[1, 0], 0], rtol=0, atol=1e-6)


def test_cpu_wrapper_is_reference_and_launches_nothing():
    """On CPU tensors the wrapper is the reference, bitwise, and the
    kernel's launch counter does not move."""
    args = _torch(*_inputs(4), torch.float32)
    before = LAUNCHES.get("paged_decode_attention")
    assert torch.equal(paged_decode_attention(*args),
                       paged_attention_reference(*args))
    assert LAUNCHES.get("paged_decode_attention") == before


@pytest.mark.parametrize("d_head,dtype,ok", [
    (128, torch.bfloat16, True), (64, torch.bfloat16, False),
    (128, torch.float32, False), (128, torch.float16, False)])
def test_supported_gate(d_head, dtype, ok):
    assert paged_attention_supported(d_head, 16, dtype) is ok

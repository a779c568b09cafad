"""Port parity: the packed-qkv flash attention of LM training against the
JAX package.

The port's plain versions — ``flash_attention_qkv_reference`` (o and
lse2) and ``flash_attention_qkv_bwd_reference`` (the packed gradient),
what the CUDA kernels are held to on the card and what the wrappers run
on CPU tensors — are held against the JAX packed path with its Pallas
kernels in interpret mode, on the same numpy inputs: the forward with
lse (``_fwd_pallas_qkv``) and ``jax.grad`` of ``flash_attention_qkv``
along both of its backward branches, the fused ``_dqkv_packed_kernel``
and the split ``_dq_kernel`` + ``_dkv_kernel`` (forced by a zero VMEM
budget). d_head is 128, so the JAX side tiles.

Tolerances: f32 rtol 1e-5 / atol 1e-6 on outputs and gradients (as
``tests/test_pallas_attention.py`` pins the packed path's forward: the
same math up to summation order); lse2 (f32 on both sides) rtol 1e-5 /
atol 1e-5; bf16 outputs and gradients within 2 bf16 ulps of the largest
value (both sides round at the same points, but an f32 sum in another
order can flip one rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.ops.pallas_attention as pa
from horovod_tpu_torch.ops import LAUNCHES
from horovod_tpu_torch.ops import attention as ta

H, D = 2, 128
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, T, seed, dtype):
    """qkv [B, T, H*3*D] and a cotangent [B, T, H*D], as JAX arrays of
    ``dtype`` and as torch tensors holding the same values."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(seed)
    qkv = jnp.asarray(rng.randn(B, T, H * 3 * D) * 0.5, jdt)
    cot = jnp.asarray(rng.randn(B, T, H * D), jdt)
    return qkv, cot, _torch(qkv, tdt), _torch(cot, tdt)


def _torch(x, tdt):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)


def _assert_close(got, want, dtype, rtol=1e-5, atol=1e-6, what=""):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, what
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)
        return
    top = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    err = np.abs(got - want).max()
    assert err <= 2 * ulp, f"{what}: {err} > 2 bf16 ulps ({2 * ulp})"


def _jax_fwd(qkv, causal):
    o, lse = pa._fwd_pallas_qkv(qkv, H, D, causal, D ** -0.5, True)
    return o, lse[..., 0]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_lse_match_pallas(dtype, causal):
    qkv, _, tq, _ = _inputs(2, 256, seed=1, dtype=dtype)
    o, lse = _jax_fwd(qkv, causal)
    got_o, got_lse = ta.flash_attention_qkv_reference(tq, H, causal=causal)
    assert got_o.dtype == DTYPES[dtype][1] and got_lse.dtype == torch.float32
    _assert_close(got_o, o, dtype, what="o")
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=1e-5,
                               atol=1e-5, err_msg="lse2")


def _jax_grad(qkv, cot, causal):
    def loss(x):
        o = pa.flash_attention_qkv(x, H, causal=causal, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * cot.astype(jnp.float32))
    return jax.grad(loss)(qkv)


@pytest.mark.parametrize("dtype,causal", [("f32", True), ("bf16", True),
                                          ("f32", False)])
@pytest.mark.parametrize("branch", ["fused", "split"])
def test_backward_matches_pallas_both_branches(branch, dtype, causal,
                                               monkeypatch):
    """The backward reference, from the JAX forward's o and lse2, against
    the JAX gradient along the fused K7 branch and the split K4+K5
    branch (both compute the same d_qkv)."""
    if branch == "split":
        monkeypatch.setattr(pa, "_VMEM_BUDGET_BYTES", 0)
    assert pa._fused_bwd_fits(256, D, 4, bq=256, bk=256, packed=True) == \
        (branch == "fused")
    qkv, cot, tq, tcot = _inputs(1, 256, seed=2, dtype=dtype)
    want = _jax_grad(qkv, cot, causal)
    o, lse = _jax_fwd(qkv, causal)
    tdt = DTYPES[dtype][1]
    got = ta.flash_attention_qkv_bwd_reference(
        tq, _torch(o, tdt), torch.from_numpy(np.array(lse)), tcot, H,
        causal=causal)
    assert got.dtype == tdt
    _assert_close(got, want, dtype, rtol=1e-5, atol=1e-6, what="d_qkv")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_autograd_function_on_cpu_is_the_references(dtype):
    """On CPU tensors ``flash_attention_qkv`` (the autograd Function) IS
    the two plain versions, bitwise, and launches no kernel; its
    gradient is the JAX gradient within the stated tolerance."""
    qkv, cot, tq, tcot = _inputs(2, 128, seed=3, dtype=dtype)
    before = LAUNCHES.snapshot()
    x = tq.clone().requires_grad_()
    out = ta.flash_attention_qkv(x, H, causal=True)
    out.backward(tcot)
    o, lse = ta.flash_attention_qkv_reference(tq, H, causal=True)
    assert torch.equal(out.detach(), o)
    want = ta.flash_attention_qkv_bwd_reference(tq, o, lse, tcot, H,
                                                causal=True)
    assert torch.equal(x.grad, want)
    assert LAUNCHES.snapshot() == before
    # The dq and dk/dv wrappers write their columns of the same gradient.
    split = torch.full_like(tq, float("nan"))
    delta = ta.attention_delta(tcot, o, H)
    ta.flash_bwd_dq(tq, tcot, lse, delta, split, H, causal=True)
    ta.flash_bwd_dkv(tq, tcot, lse, delta, split, H, causal=True)
    assert torch.equal(split, want)
    _assert_close(x.grad, _jax_grad(qkv, cot, True), dtype,
                  what="autograd d_qkv")


@pytest.mark.parametrize("T", [256, 1, 65, 191])
def test_f32_gradient_agrees_with_autograd_through_dense_attention(T):
    """A sanity check independent of the JAX package: at f32 the flash
    rounding points are identities, so the custom backward equals
    autograd through ``xla_attention`` up to exp2-vs-exp and summation
    order. Besides a tilable length, lengths that the card kernels' 64-
    and 128-row tiles cut raggedly (the plain version is the yardstick of
    the card parity at those lengths)."""
    _, _, tq, tcot = _inputs(1, T, seed=4, dtype="f32")
    a = tq.clone().requires_grad_()
    ta.flash_attention_qkv(a, H, causal=True).backward(tcot)
    b = tq.clone().requires_grad_()
    q, k, v = ta._split_qkv(b, H)
    ta.xla_attention(q, k, v, True, D ** -0.5).flatten(-2).backward(tcot)
    torch.testing.assert_close(a.grad, b.grad, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_xla_attention_matches_jax(dtype):
    """The dense route of untilable shapes (T=96, d_head 64): f32 math on
    both sides, one cast back at the end — f32 1e-5, bf16 2 ulps."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(5)
    q, k, v = (jnp.asarray(rng.randn(2, 96, 3, 64), jdt) for _ in range(3))
    want = pa._xla_attention(q, k, v, True, 64 ** -0.5)
    got = ta.xla_attention(*(_torch(x, tdt) for x in (q, k, v)), True,
                           64 ** -0.5)
    _assert_close(got, want, dtype, rtol=1e-5, atol=1e-5, what="xla")


@pytest.mark.parametrize("T,d", [(128, 128), (256, 128), (96, 128),
                                 (128, 64), (2048, 128), (100, 256)])
def test_tilability_rule_matches_jax(T, d):
    assert ta.qkv_flash_tilable(T, d) == pa.qkv_flash_tilable(T, d)


def test_first_row_attends_only_itself():
    """Causality pinned directly: row 0 of every head is its v row 0,
    and the ragged length T=40 runs the plain version."""
    _, _, tq, _ = _inputs(1, 40, seed=6, dtype="f32")
    o, lse = ta.flash_attention_qkv_reference(tq, H, causal=True)
    _, _, v = ta._split_qkv(tq, H)
    torch.testing.assert_close(o.view(1, 40, H, D)[:, 0], v[:, 0], rtol=0,
                               atol=1e-6)
    assert lse.shape == (H, 40)

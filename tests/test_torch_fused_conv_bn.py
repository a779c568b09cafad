"""Port parity: the fused 1x1 conv + BatchNorm-statistics op against the
JAX package's Pallas kernels (interpret mode), on the same numpy inputs.

The port's plain versions (what a CPU tensor runs, and what the CUDA
kernels are held to on the card) must compute the TPU kernels' function
with their rounding points: forward ``(y, s1, s2)``, and the VJP — dx,
dW, and the prologue's da/db, with the statistics cotangents ds1/ds2
folded in. The port's weight is ``[Cout, Cin]``, the JAX one ``[Cin,
Cout]``; the stats come back as ``[Cout]`` vectors, not the TPU's ``[8,
Cout]`` wire layout.

Tolerances: f32 — y rtol/atol 1e-5, stats rtol 1e-4 / atol 1e-3 (sums of
a few hundred O(1) terms in another order), grads rtol/atol 2e-4 (the
JAX package's own test of this VJP); bf16 — outputs within two bf16 ulps
(rtol 2**-6), since a different f32 summation order can flip a rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_conv
from horovod_tpu_torch.ops import fused_conv_bn as fcb

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_RTOL = 2.0 ** -6


def _inputs(seed, m, cin, cout, prologue):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, cin).astype(np.float32)
    w = (rng.randn(cin, cout) * 0.2).astype(np.float32)      # JAX layout
    ab = rng.randn(2, cin).astype(np.float32) if prologue else None
    return x, w, ab


def _jax_fwd(x, w, ab, jdt, relu=True):
    y, s1, s2 = pallas_conv.fused_linear_bn_act(
        jnp.asarray(x, jdt), jnp.asarray(w),
        None if ab is None else jnp.asarray(ab), relu=relu, interpret=True)
    return (np.asarray(y.astype(jnp.float32)), np.asarray(s1[0]),
            np.asarray(s2[0]))


def _torch_args(x, w, ab, tdt):
    a = b = None
    if ab is not None:
        a, b = torch.tensor(ab[0]), torch.tensor(ab[1])
    return (torch.tensor(x).to(tdt), torch.tensor(np.ascontiguousarray(w.T)),
            a, b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("prologue", [False, True])
def test_forward_matches_pallas(prologue, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, ab = _inputs(0, 384, 16, 24, prologue)
    jy, js1, js2 = _jax_fwd(x, w, ab, jdt)
    y, s1, s2 = fcb.fused_linear_bn_act(*_torch_args(x, w, ab, tdt))
    assert y.dtype == tdt and s1.dtype == s2.dtype == torch.float32
    assert tuple(y.shape) == (384, 24) and tuple(s1.shape) == (24,)
    if dtype == "f32":
        np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s1.numpy(), js1, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(s2.numpy(), js2, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_allclose(y.float().numpy(), jy, rtol=BF16_RTOL,
                                   atol=1e-2)
        np.testing.assert_allclose(s1.numpy(), js1, rtol=BF16_RTOL, atol=0.5)
        np.testing.assert_allclose(s2.numpy(), js2, rtol=BF16_RTOL, atol=0.5)


def test_forward_without_relu_matches_pallas():
    x, w, ab = _inputs(1, 256, 8, 16, True)
    jy, js1, js2 = _jax_fwd(x, w, ab, jnp.float32, relu=False)
    y, s1, s2 = fcb.fused_linear_bn_act(*_torch_args(x, w, ab,
                                                     torch.float32),
                                        relu=False)
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), js2, rtol=1e-4, atol=1e-3)


def _jax_vjp(x, w, ab, dy, ds1, ds2, jdt, relu):
    prologue = ab is not None

    def f(x, w, ab):
        return pallas_conv.fused_linear_bn_act(
            x, w, ab if prologue else None, relu=relu, interpret=True)

    abj = jnp.asarray(ab if prologue else np.zeros((2, x.shape[1]),
                                                   np.float32))
    _, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(w), abj)
    def pad(v):     # the TPU's [8, Cout] stats layout, data in row 0
        return jnp.zeros((8, v.shape[0]), jnp.float32).at[0].set(v)
    dx, dw, dab = vjp((jnp.asarray(dy, jdt), pad(jnp.asarray(ds1)),
                       pad(jnp.asarray(ds2))))
    return (np.asarray(dx.astype(jnp.float32)), np.asarray(dw).T,
            np.asarray(dab))


@pytest.mark.parametrize("dtype,prologue,relu", [
    ("f32", False, True), ("f32", True, True), ("f32", True, False),
    ("bf16", True, True)])
def test_vjp_matches_pallas(dtype, prologue, relu):
    """The backward alone, with explicit cotangents dy, ds1, ds2 (the
    stats cotangents must be folded into dy_eff)."""
    jdt, tdt = DTYPES[dtype]
    m, cin, cout = 256, 16, 24
    x, w, ab = _inputs(2, m, cin, cout, prologue)
    rng = np.random.RandomState(3)
    dy = rng.randn(m, cout).astype(np.float32)
    ds1 = (rng.randn(cout) * 0.1).astype(np.float32)
    ds2 = (rng.randn(cout) * 0.01).astype(np.float32)
    jdx, jdw, jdab = _jax_vjp(x, w, ab, dy, ds1, ds2, jdt, relu)

    xt, wt, a, b = _torch_args(x, w, ab, tdt)
    leaves = [xt, wt] + ([a, b] if prologue else [])
    for t in leaves:
        t.requires_grad_(True)
    y, s1, s2 = fcb.fused_linear_bn_act(xt, wt, a, b, relu=relu)
    grads = torch.autograd.grad(
        (y, s1, s2), leaves,
        (torch.tensor(dy).to(tdt), torch.tensor(ds1), torch.tensor(ds2)))
    dx, dw = grads[0].float().numpy(), grads[1].numpy()
    if dtype == "f32":
        tol = dict(rtol=2e-4, atol=2e-4)
    else:
        tol = dict(rtol=BF16_RTOL, atol=5e-2 * np.abs(jdw).max())
    np.testing.assert_allclose(dw, jdw, **tol)
    np.testing.assert_allclose(dx, jdx, **(tol if dtype == "f32" else
                                           dict(rtol=BF16_RTOL, atol=5e-2)))
    if prologue:
        np.testing.assert_allclose(grads[2].numpy(), jdab[0], **tol)
        np.testing.assert_allclose(grads[3].numpy(), jdab[1], **tol)


def test_vjp_of_the_bwd_reference_is_the_autograd_backward():
    """``fused_linear_bn_act_bwd_reference`` is what the autograd
    backward runs on the CPU; a None cotangent counts as zero."""
    x, w, ab = _inputs(4, 128, 8, 8, True)
    xt, wt, a, b = _torch_args(x, w, ab, torch.float32)
    y, _, _ = fcb.fused_linear_bn_act_reference(xt, wt, a, b)
    dy = torch.randn(128, 8, generator=torch.Generator().manual_seed(0))
    full = fcb.fused_linear_bn_act_bwd_reference(
        xt, wt, a, b, y, dy, torch.zeros(8), torch.zeros(8))
    none = fcb.fused_linear_bn_act_bwd_reference(xt, wt, a, b, y, dy, None,
                                                 None)
    for p, q in zip(full, none):
        assert torch.equal(p, q)
    dx, dw, da, db = fcb.fused_linear_bn_act_bwd_reference(
        xt, wt, None, None, y, dy, None, None)
    assert da is None and db is None and tuple(dw.shape) == (8, 8)


@pytest.mark.parametrize("prologue", [False, True])
def test_grads_through_a_batchnorm_like_loss_match_jax(prologue):
    """jax.grad vs torch.autograd.grad of a loss that consumes y AND a
    BatchNorm-like function of (s1, s2), so ds1/ds2 carry real cotangents
    (the JAX package's ``test_fused_grads_match_reference`` setup)."""
    m, cin, cout = 256, 12, 20
    x, w, ab = _inputs(5, m, cin, cout, True)
    cot = np.random.RandomState(6).randn(m, cout).astype(np.float32)

    def jloss(x, w, ab):
        y, s1, s2 = pallas_conv.fused_linear_bn_act(
            x, w, ab if prologue else None, interpret=True)
        mu = s1[0] / m
        a = jax.lax.rsqrt(s2[0] / m - mu * mu + 1e-5)
        return jnp.sum((y - mu[None, :]) * a[None, :] * cot)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(ab))
    xt, wt, a, b = _torch_args(x, w, ab, torch.float32)
    leaves = [xt, wt] + ([a, b] if prologue else [])
    for t in leaves:
        t.requires_grad_(True)
    y, s1, s2 = fcb.fused_linear_bn_act(xt, wt, *(leaves[2:] or [None,
                                                                   None]))
    mu = s1 / m
    sa = torch.rsqrt(s2 / m - mu * mu + 1e-5)
    loss = ((y - mu) * sa * torch.tensor(cot)).sum()
    tg = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[0]), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(tg[1].numpy(), np.asarray(jg[1]).T,
                               rtol=2e-4, atol=2e-4)
    if prologue:
        np.testing.assert_allclose(
            np.stack([tg[2].numpy(), tg[3].numpy()]), np.asarray(jg[2]),
            rtol=2e-4, atol=2e-4)


def test_cuda_gate_and_counts_are_cpu_free():
    """The kernels' gate is looser than the model's routing rule (any M,
    channels multiples of 64), and a CPU call launches nothing."""
    from horovod_tpu_torch.ops import LAUNCHES
    assert fcb.fusable(1000, 64, 256) and fcb.fusable(1, 512, 128)
    assert not fcb.fusable(0, 64, 64) and not fcb.fusable(128, 16, 64)
    LAUNCHES.reset()
    x, w, ab = _inputs(7, 128, 8, 8, False)
    fcb.fused_linear_bn_act(*_torch_args(x, w, ab, torch.float32))
    assert LAUNCHES.snapshot() == {}
    # dW split: about two waves of CTAs, rows a multiple of 32.
    splits, rows = fcb.dw_split(401408, 64, 256, 132)
    assert rows % 32 == 0 and splits * rows >= 401408
    tiles = (256 // 128) * (64 // 64)
    assert 132 <= splits * tiles <= 2 * 132

"""Port parity: the differentiable ``[B, T, H, D]`` flash attention of the
pipelined LM against the JAX package.

The port's ``flash_attention`` — routing by ``backend`` as the JAX
function does, and on the kernel route the prescaled forward with lse and
the dq and dk/dv backward with K6's (``_dqkv_kernel``'s) constants,
which on CPU tensors run their plain versions — is held against JAX's
``flash_attention`` with its Pallas kernels in interpret mode, on the
same numpy inputs: the output and the gradients of q, k and v for a
numpy cotangent (``jax.vjp``). At B=2, H=2, D=128 and T in {128, 256}
the JAX backward takes the fused K6 (``_fused_bwd_fits``).

Tolerances: f32 rtol 1e-5 / atol 1e-6 on outputs and gradients (the
same math up to summation order, as tests/test_torch_flash_qkv.py holds
the packed path); bf16 within 2 bf16 ulps of the largest value (both
sides round at the same points, but an f32 sum in another order can flip
one rounding, and dq goes through the prescale's chain rule once more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.ops.pallas_attention as pa
from horovod_tpu_torch.ops import LAUNCHES
from horovod_tpu_torch.ops import attention as ta

B, H, D = 2, 2, 128
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(T, seed, dtype, d=D):
    """q, k, v and a cotangent, ``[B, T, H, d]``, as JAX arrays of
    ``dtype`` and as torch tensors holding the same values."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(seed)
    jx = [jnp.asarray(rng.randn(B, T, H, d), jdt) for _ in range(4)]
    return jx, [_torch(x, tdt) for x in jx]


def _torch(x, tdt):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)


def _assert_close(got, want, dtype, what=""):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, what
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=what)
        return
    top = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    err = np.abs(got - want).max()
    assert err <= 2 * ulp, f"{what}: {err} > 2 bf16 ulps ({2 * ulp})"


def _jax_vjp(jx, causal, backend):
    q, k, v, cot = jx
    out, vjp = jax.vjp(lambda a, b, c: pa.flash_attention(
        a, b, c, causal=causal, backend=backend, interpret=True), q, k, v)
    return out, vjp(cot)


def _port(tx, causal, backend):
    q, k, v, cot = (x.clone().requires_grad_(i < 3)
                    for i, x in enumerate(tx))
    out = ta.flash_attention(q, k, v, causal=causal, backend=backend)
    out.backward(cot)
    return out.detach(), (q.grad, k.grad, v.grad)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [128, 256])
def test_kernel_route_matches_pallas(T, causal, dtype):
    """``backend="pallas"`` at tilable shapes: the output and the three
    gradients, with no kernel launched on the CPU."""
    assert pa._fused_bwd_fits(T, D, 4, bq=T, bk=T, packed=False)
    jx, tx = _inputs(T, seed=T + causal, dtype=dtype)
    want_o, want_g = _jax_vjp(jx, causal, "pallas")
    before = LAUNCHES.snapshot()
    got_o, got_g = _port(tx, causal, "pallas")
    assert LAUNCHES.snapshot() == before
    assert got_o.dtype == DTYPES[dtype][1]
    _assert_close(got_o, want_o, dtype, what="o")
    for name, g, w in zip("qkv", got_g, want_g):
        assert g.dtype == DTYPES[dtype][1]
        _assert_close(g, w, dtype, what=f"d{name}")


@pytest.mark.parametrize("backend,T,d", [("xla", 128, D), ("auto", 128, D),
                                         ("pallas", 96, D),
                                         ("pallas", 128, 64)])
def test_dense_routes_match_jax(backend, T, d):
    """"xla", "auto" below the 4 GiB cutover, and untilable shapes under
    "pallas" all take the dense f32 attention, on both sides: f32 output
    and gradients rtol 1e-5."""
    jx, tx = _inputs(T, seed=7, dtype="f32", d=d)
    want_o, want_g = _jax_vjp(jx, True, backend)
    got_o, got_g = _port(tx, True, backend)
    _assert_close(got_o, want_o, "f32", what="o")
    for name, g, w in zip("qkv", got_g, want_g):
        _assert_close(g, w, "f32", what=f"d{name}")


def test_routing_rule_matches_jax(monkeypatch):
    """Which route each backend takes: the kernel route runs
    ``flash_attention_lse`` under a gradient and the forward without lse
    without one; "auto" crosses over at 4 GiB of f32 scores (shrunk here
    so a small input crosses it)."""
    taken = []
    monkeypatch.setattr(ta, "xla_attention",
                        lambda *a: taken.append("xla") or a[0])
    monkeypatch.setattr(ta, "flash_attention_prefill",
                        lambda *a, **k: taken.append("nolse") or a[0])
    real_lse = ta.flash_attention_lse
    monkeypatch.setattr(ta, "flash_attention_lse",
                        lambda *a, **k: taken.append("lse")
                        or real_lse(*a, **k))
    _, (q, k, v, _) = _inputs(128, seed=8, dtype="f32")
    ta.flash_attention(q, k, v, backend="auto")
    ta.flash_attention(q, k, v, backend="pallas")
    qg = q.clone().requires_grad_()
    ta.flash_attention(qg, k, v, backend="pallas")
    with torch.no_grad():
        ta.flash_attention(qg, k, v, backend="pallas")
    monkeypatch.setattr(ta, "_SCORE_BYTES_CUTOVER", 4 * B * H * 128 * 128 - 1)
    ta.flash_attention(q, k, v, backend="auto")
    assert taken == ["xla", "nolse", "lse", "nolse", "nolse"]
    with pytest.raises(ValueError, match="backend"):
        ta.flash_attention(q, k, v, backend="cudnn")


def test_plain_backward_is_autograd_through_its_forward():
    """Independent of the JAX package: at f32 the rounding points are
    identities, so the plain backward (K6's constants, prescaled q) equals
    autograd through the plain forward with lse on the same prescaled q:
    rtol 1e-4 / atol 1e-5 (summation order through exp2 and ln 2)."""
    _, (q, k, v, cot) = _inputs(128, seed=9, dtype="f32")
    q_pre = (q * (D ** -0.5 * ta.LOG2E)).requires_grad_()
    kk, vv = k.clone().requires_grad_(), v.clone().requires_grad_()
    o, lse2 = ta.flash_attention_lse_reference(q_pre, kk, vv, causal=True)
    o.backward(cot)
    got = ta.flash_attention_bwd_reference(q_pre.detach(), k, v, o.detach(),
                                           lse2.detach(), cot, causal=True)
    for g, w in zip(got, (q_pre.grad, kk.grad, vv.grad)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_cpu_wrappers_are_the_plain_versions_on_strided_views():
    """On CPU tensors the three wrappers ARE the plain versions
    (bitwise), on q/k/v views of a packed ``[B, T, H, 3, D]`` projection
    as the pipelined block hands them over, and they launch nothing."""
    rng = np.random.RandomState(10)
    qkv = torch.from_numpy(rng.randn(B, 128, H, 3, D).astype(np.float32))
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    q = (q * (D ** -0.5 * ta.LOG2E)).to(torch.bfloat16)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    do = torch.from_numpy(rng.randn(B, 128, H, D).astype(
        np.float32)).to(torch.bfloat16)
    before = LAUNCHES.snapshot()
    o, lse2 = ta.flash_attention_lse(q, k, v, causal=True)
    ro, rl = ta.flash_attention_lse_reference(q, k, v, causal=True)
    assert torch.equal(o, ro) and torch.equal(lse2, rl)
    assert lse2.shape == (B * H, 128) and lse2.dtype == torch.float32
    delta = ta.attention_delta_bhtd(do, o)
    dq = ta.flash_bwd_dq_bhtd(q, k, v, do, lse2, delta, causal=True)
    dk, dv = ta.flash_bwd_dkv_bhtd(q, k, v, do, lse2, delta, causal=True)
    want = ta.flash_attention_bwd_reference(q, k, v, o, lse2, do,
                                            causal=True)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)
    assert LAUNCHES.snapshot() == before

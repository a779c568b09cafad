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
    # The kernels' planner: one persistent CTA per SM (no more CTAs than
    # row tiles), one partial per CTA, rows covered once and in order.
    plan = fcb.bwd_plan(401408, 64, 256, True, 132)
    assert plan.one_pass and plan.n_parts == 132
    assert plan.part_w == (132, 256, 64) and plan.part_ab == (2, 132, 64)
    runs = fcb.tile_runs(-(-401408 // 64), plan.n_parts)
    assert runs[0][0] == 0 and runs[-1][1] == 6272
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(runs, runs[1:]))


# The eight distinct (M, Cin, Cout, prologue) of the fused ResNet-50 sites
# at batch 128, and ragged M both ways.
SITES = [(401408, 64, 64, False), (401408, 64, 256, True),
         (401408, 64, 256, False), (401408, 256, 64, False),
         (401408, 256, 128, False), (100352, 128, 512, True),
         (100352, 256, 512, False), (100352, 512, 128, False),
         (1000, 64, 128, True), (1000, 128, 64, False),
         (1000, 64, 256, True), (1, 512, 128, False)]


def _covers(n_tiles, n_parts):
    runs = fcb.tile_runs(n_tiles, n_parts)
    assert len(runs) == n_parts
    assert runs[0][0] == 0 and runs[-1][1] == n_tiles
    for (a, b), (c, _) in zip(runs, runs[1:]):
        assert a < b == c          # non-empty, contiguous, in order
    assert sum(b - a for a, b in runs) == n_tiles


@pytest.mark.parametrize("m,cin,cout,prologue", SITES)
def test_fwd_plan_partitions_rows_and_sizes_scratch(m, cin, cout, prologue):
    """K1's plan: Cout in slices that the resident bf16 W fits beside a
    ring of two stages, at most one CTA per SM, every 128-row tile in
    exactly one run of each slice, one statistics partial per run."""
    sms = 132
    plan = fcb.fwd_plan(m, cin, cout, prologue, sms)
    assert plan.bn in (64, 128, 256) and cout % plan.bn == 0
    n_slices = cout // plan.bn
    assert 1 <= plan.n_runs <= -(-m // 128)
    assert n_slices * plan.n_runs <= max(sms, n_slices)
    _covers(-(-m // 128), plan.n_runs)
    assert plan.part == (2, plan.n_runs, cout)
    assert not plan.stream_w and plan.w_bf16 is None
    assert fcb._fwd_smem(plan.bn // 64, cin, False, prologue, 2) \
        <= fcb.SMEM_LIMIT


@pytest.mark.parametrize("m,cin,cout,prologue", SITES)
def test_bwd_plan_partitions_rows_and_sizes_scratch(m, cin, cout, prologue):
    """K2's plan: the one pass wherever the whole dW fits in a CTA's
    registers (<= 8 blocks of 64x64) and its ring in shared memory — every
    M = 401408 site — else the dx kernel plus dW windows. Partials: one
    per CTA (one pass) or per row split of a window; da/db partials only
    with the prologue; a bf16 copy of W only where W streams."""
    sms = 132
    plan = fcb.bwd_plan(m, cin, cout, prologue, sms)
    tiles = -(-m // 64)
    blocks = (cin // 64) * (cout // 64)
    assert plan.one_pass == (blocks <= 8 and fcb._bwd_smem(
        cin, cout, cin, cout, True, prologue, 2) <= fcb.SMEM_LIMIT)
    if m == 401408:
        assert plan.one_pass
    assert plan.part_w == (plan.n_parts, cout, cin)
    _covers(tiles, plan.n_parts)
    if plan.one_pass:
        assert (plan.bco, plan.bci) == (cout, cin)
        assert plan.n_parts == min(sms, tiles) and plan.w_bf16 is None
        assert plan.part_ab == ((2, plan.n_parts, cin) if prologue
                                else None)
    else:
        assert cout % plan.bco == 0 and cin % plan.bci == 0
        assert (plan.bco // 64) * (plan.bci // 64) <= 8
        n_windows = (cout // plan.bco) * (cin // plan.bci)
        assert n_windows * plan.n_parts <= max(sms, n_windows)
        assert fcb._bwd_smem(cin, cout, plan.bci, plan.bco, False, prologue,
                             2) <= fcb.SMEM_LIMIT
        assert plan.nch in (1, 2, 4) and cin % (64 * plan.nch) == 0
        _covers(-(-m // 128), plan.n_runs)
        assert plan.part_ab == ((2, plan.n_runs, cin) if prologue
                                else None)
        assert plan.w_bf16 == (cout, cin)
    assert len(plan.ints()) == 6


def test_plans_stream_w_and_window_dw_for_wide_channels():
    """Channels past the resident limits: K1 streams W's boxes from a
    bf16 copy (Cin 2048), K2 windows dW (512 x 2048 is 256 blocks)."""
    fplan = fcb.fwd_plan(4096, 2048, 512, False, 132)
    assert fplan.stream_w and fplan.w_bf16 == (512, 2048)
    bplan = fcb.bwd_plan(4096, 2048, 512, False, 132)
    assert not bplan.one_pass and bplan.w_bf16 == (512, 2048)
    assert (bplan.bco // 64) * (bplan.bci // 64) == 8


def _phantom_shift(o1):
    """How far rows past M, as a kernel that did not mask them would see
    them (x, y, dy zero: u = relu(b), e = bf16(ds1)), move s1, s2, dW,
    da and db relative to their largest values, for M = 1000, 64->256
    with the prologue padded to the 64-row tile (1024): the plain
    versions with and without the padded rows."""
    g = torch.Generator().manual_seed(1)
    m, cin, cout, pad = 1000, 64, 256, 1024
    scale = 1.0 if o1 else 1e-3
    x = torch.randn((m, cin), generator=g).to(torch.bfloat16)
    w = torch.randn((cout, cin), generator=g) * cin ** -0.5
    a = torch.rand((cin,), generator=g) + 0.5
    b = torch.randn((cin,), generator=g) * (1.0 if o1 else 0.5)
    dy = torch.randn((m, cout), generator=g).to(torch.bfloat16)
    ds1 = torch.randn((cout,), generator=g) * scale
    ds2 = torch.randn((cout,), generator=g) * 1e-4
    y, s1, s2 = fcb.fused_linear_bn_act_reference(x, w, a, b)
    good = fcb.fused_linear_bn_act_bwd_reference(x, w, a, b, y, dy, ds1,
                                                 ds2)

    def padded(t):
        return torch.cat([t, torch.zeros((pad - m, t.shape[1]),
                                         dtype=t.dtype)])
    _, s1p, s2p = fcb.fused_linear_bn_act_reference(padded(x), w, a, b)
    bad = fcb.fused_linear_bn_act_bwd_reference(
        padded(x), w, a, b, padded(y), padded(dy), ds1, ds2)

    def rel(p, q):
        return ((p - q).abs().max() / q.abs().max()).item()
    return {"s1": rel(s1p, s1), "s2": rel(s2p, s2), "dw": rel(bad[1], good[1]),
            "da": rel(bad[2], good[2]), "db": rel(bad[3], good[3])}


def test_o1_ragged_case_sees_rows_past_m():
    """chip_smoke.py's O(1)-cotangent ragged case (CONV_RAGGED_O1) is the
    one where rows past M would fail TOL_CONV (1e-3) in s1, s2, dW and
    db: with ds1 ~ 1e-3 (the other cases) dW would move by less than the
    tolerance. da cannot move at all: x is zero past M."""
    o1, small = _phantom_shift(True), _phantom_shift(False)
    for key in ("s1", "s2", "dw", "db"):
        assert o1[key] > 1e-2, (key, o1)
    assert small["dw"] < 1e-3 and o1["da"] == 0.0

"""Port parity: flash attention (prefill) against the JAX package, and
the training forward's attention routing.

The port's ``flash_attention_reference`` (the plain PyTorch version of the
CUDA flash kernel, and what ``flash_attention_prefill`` runs on CPU
tensors) is held against the JAX ``flash_attention`` with the Pallas
kernel in interpret mode — the same kernel program a TPU runs — on the
same numpy inputs, and against the JAX dense XLA attention for lengths
the Pallas kernel does not tile (the port's CUDA kernel tiles every
length). ``forward_hidden`` routes each layer's attention by
``attn_backend`` as the JAX function does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu.ops.pallas_attention as pa
from horovod_tpu.ops.pallas_attention import _xla_attention
from horovod_tpu.ops.pallas_attention import \
    flash_attention as jax_flash_attention
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.parallel.mesh import create_hybrid_mesh
from horovod_tpu_torch import convert
from horovod_tpu_torch.ops import LAUNCHES
from horovod_tpu_torch.ops.attention import (flash_attention_prefill,
                                             flash_attention_reference)
from horovod_tpu_torch.parallel import transformer as ttr

D = 128


def _qkv(T, seed, B=1, H=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) for _ in range(3)]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("T", [128, 256])
def test_reference_matches_pallas_f32(T):
    """f32: same math up to summation order (one tile at these lengths,
    so the running max is the final max) — rtol/atol 1e-5."""
    arrs = _qkv(T, seed=T)
    want = jax_flash_attention(*(jnp.asarray(a, jnp.float32) for a in arrs),
                               causal=True, backend="pallas",
                               interpret=True)
    got = flash_attention_reference(*_torch(arrs, torch.float32),
                                    causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [128, 256])
def test_reference_matches_pallas_bf16(T):
    """bf16: both round q·scale, P and the output to bf16 at the same
    points, but JAX's bf16 ops and torch's differ in their internal
    precision, so a value may land one bf16 ulp apart; outputs are
    O(1), so atol 2e-2 (about two ulps at 2) with rtol 2e-2."""
    arrs = _qkv(T, seed=T + 1)
    want = jax_flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in arrs),
                               causal=True, backend="pallas",
                               interpret=True)
    got = flash_attention_reference(*_torch(arrs, torch.bfloat16),
                                    causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("T", [16, 100, 127, 129, 1000])
def test_reference_matches_dense_untiled_lengths(T):
    """Lengths the Pallas kernel does not tile run JAX's dense f32
    attention; at f32 the flash rounding points are identities, so the
    port's reference agrees to summation order (exp2 vs exp): 1e-5."""
    arrs = _qkv(T, seed=T + 2)
    want = _xla_attention(*(jnp.asarray(a, jnp.float32) for a in arrs),
                          True, float(D) ** -0.5)
    got = flash_attention_reference(*_torch(arrs, torch.float32),
                                    causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_non_causal_matches_pallas():
    """causal=False through the same reference (the kernel takes both)."""
    arrs = _qkv(128, seed=7)
    want = jax_flash_attention(*(jnp.asarray(a, jnp.float32) for a in arrs),
                               causal=False, backend="pallas",
                               interpret=True)
    got = flash_attention_reference(*_torch(arrs, torch.float32),
                                    causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_runs_reference_on_strided_views():
    """On CPU tensors the wrapper IS the reference (bitwise), strided
    q/k/v views of a packed [B,T,H,3,D] projection included, and it
    launches no kernel (the launch counter does not move)."""
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(1, 40, 2, 3, D).astype(np.float32))
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    before = LAUNCHES.get("flash_attention")
    got = flash_attention_prefill(q, k, v, causal=True)
    want = flash_attention_reference(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True)
    assert torch.equal(got, want)
    assert LAUNCHES.get("flash_attention") == before


def test_first_row_attends_only_itself():
    """Causality pinned directly: row 0 of the output is v's row 0."""
    q, k, v = _torch(_qkv(8, seed=4), torch.float32)
    out = flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(out[:, 0], v[:, 0], rtol=0, atol=1e-6)


def _recorder(calls, tag, fn):
    def wrapped(*args, **kw):
        calls.append((tag, kw.get("backend")))
        return fn(*args, **kw)
    return wrapped


@pytest.mark.parametrize("backend", ["pallas", "xla", "auto"])
@pytest.mark.parametrize("T", [128, 96])
def test_attn_backend_routes_forward_hidden_as_jax(backend, T,
                                                   monkeypatch):
    """Each layer of ``forward_hidden`` takes the route the JAX function
    takes for ``attn_backend`` and T: the packed kernels only for
    "pallas" at a tilable length, ``flash_attention`` with the backend
    otherwise; the f32 hidden states agree (rtol/atol 1e-5: summation
    order)."""
    dims = dict(vocab=128, d_model=256, n_heads=2, n_layers=2, d_ff=256)
    jcfg = jtr.TransformerConfig(**dims, dtype=jnp.float32,
                                 attn_backend=backend)
    tcfg = ttr.TransformerConfig(**dims, dtype=torch.float32,
                                 attn_backend=backend)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jtr.init_params(jax.random.PRNGKey(0), jcfg))
    toks = np.random.RandomState(11).randint(0, 128, (2, T)).astype(
        np.int32)
    jcalls, tcalls = [], []
    for mod, calls in ((pa, jcalls), (ttr, tcalls)):
        for name in ("flash_attention", "flash_attention_qkv"):
            monkeypatch.setattr(mod, name,
                                _recorder(calls, name, getattr(mod, name)))
    mesh = create_hybrid_mesh(dp=1, devices=jax.devices()[:1])
    want = jax.jit(jax.shard_map(
        lambda p, t: jtr.forward_hidden(p, t, jcfg, mesh)[0], mesh=mesh,
        in_specs=(P(), P()), out_specs=P(), check_vma=False))(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(toks))
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    with torch.no_grad():
        got = ttr.forward_hidden(model, torch.from_numpy(toks))
    assert tcalls == jcalls and len(tcalls) == dims["n_layers"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

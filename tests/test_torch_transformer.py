"""Port parity: the transformer and its paged prefill/decode against the
JAX package, from the same weights.

A tiny config whose d_head is 128, so the JAX side runs its Pallas flash
and paged-decode kernels (interpret mode) rather than a dense fallback:
vocab 64, d_model 256, 2 heads, 2 layers, d_ff 256. Weights come from
the JAX ``init_params`` as f32 numpy and are carried into the port with
``params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu.parallel import kv_blocks as jkv
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.parallel.mesh import create_hybrid_mesh
from horovod_tpu_torch.convert import params_from_jax
from horovod_tpu_torch.parallel import kv_blocks as tkv
from horovod_tpu_torch.parallel import transformer as ttr

DIMS = dict(vocab=64, d_model=256, n_heads=2, n_layers=2, d_ff=256)
MAX_LEN, BS, S = 256, 16, 2
PROMPT_LEN = 130          # bucket 256: the Pallas flash path on the JAX side


def _configs(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jtr.TransformerConfig(**DIMS, dtype=jdt,
                                  unembed_dtype=jnp.float32),
            ttr.TransformerConfig(**DIMS, dtype=tdt,
                                  unembed_dtype=torch.float32))


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = _configs("f32")
    params = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  params)


def test_params_from_jax_round_trip(tree):
    _, tcfg = _configs("f32")
    model = params_from_jax(tree, tcfg, device="cpu")
    carried = {"embed": model.embed, "lnf": model.lnf,
               "layers": [{k: getattr(b, k) for k in layer}
                          for b, layer in zip(model.layers, tree["layers"])]}
    flat_a, tdef_a = jax.tree_util.tree_flatten(tree)
    flat_b, tdef_b = jax.tree_util.tree_flatten(
        carried, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b.detach().numpy())
    # no transposes: the projection is used as h @ W on both sides
    assert tuple(model.layers[0].wqkv.shape) == (256, 768)


def test_params_from_jax_rejects_wrong_shapes(tree):
    _, tcfg = _configs("f32")
    bad = dict(tree, embed=tree["embed"][:, :128])
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(bad, tcfg, device="cpu")


def test_params_from_jax_refuses_int8_leaves(tree):
    """The JAX int8 inference format (quantize → (q, scale) pairs) is not
    carried yet: a clear NotImplementedError, not a silent cast."""
    from horovod_tpu.ops.quant import quantize
    _, tcfg = _configs("f32")
    layers = [dict(layer) for layer in tree["layers"]]
    layers[0]["wqkv"] = quantize(layers[0]["wqkv"])
    with pytest.raises(NotImplementedError, match="int8"):
        params_from_jax(dict(tree, layers=layers), tcfg, device="cpu")
    layers[0]["wqkv"] = layers[0]["wqkv"].q          # a bare int8 array
    with pytest.raises(NotImplementedError, match="int8"):
        params_from_jax(dict(tree, layers=layers), tcfg, device="cpu")


def test_forward_matches_jax_forward(tree):
    """One-shot forward logits at T=128 (the JAX training path: packed-qkv
    Pallas flash kernel, interpret mode) vs the port's forward (flash
    reference on CPU), f32: summation order only — rtol/atol 1e-4."""
    jcfg, tcfg = _configs("f32")
    rng = np.random.RandomState(0)
    toks = rng.randint(0, DIMS["vocab"], (2, 128)).astype(np.int32)
    mesh = create_hybrid_mesh(dp=1, devices=jax.devices()[:1])
    f = jax.jit(jax.shard_map(
        lambda p, t: jtr.forward(p, t, jcfg, mesh)[0], mesh=mesh,
        in_specs=(P(), P()), out_specs=P(), check_vma=False))
    want = np.asarray(f(jax.tree_util.tree_map(jnp.asarray, tree),
                        jnp.asarray(toks)))
    model = params_from_jax(tree, tcfg, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _run_paged(tree, dtype):
    """Prefill a 130-token prompt into slot 0 (bucket 256) and take three
    decode steps (slot 1 inactive) on both sides, feeding both the
    JAX side's greedy tokens. Returns per-side logits lists and pools."""
    jcfg, tcfg = _configs(dtype)
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, DIMS["vocab"], (PROMPT_LEN,)).astype(np.int32)
    toks = np.zeros((MAX_LEN,), np.int32)
    toks[:PROMPT_LEN] = prompt
    max_blocks = MAX_LEN // BS
    n_blocks = S * max_blocks + 1
    n_own = jkv.blocks_for(PROMPT_LEN + 3, BS)
    row = np.full((max_blocks,), jkv.TRASH_BLOCK, np.int32)
    row[:n_own] = np.arange(1, n_own + 1)
    tables = np.full((S, max_blocks), jkv.TRASH_BLOCK, np.int32)
    tables[0] = row

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jcache = jkv.init_paged_kv_cache(jcfg, n_blocks, BS, S)
    jpre = jax.jit(lambda p, t, c, w, n: jkv.paged_prefill(
        p, t, c, 0, w, jcfg, length=n))
    jdec = jax.jit(lambda p, t, c, q, tb: jkv.paged_decode_step(
        p, t, c, q, tb, jcfg, kernel=True, interpret=True))
    model = params_from_jax(tree, tcfg, device="cpu")
    w = ttr.gen_weights(model)
    tcache = tkv.init_paged_kv_cache(tcfg, n_blocks, BS, S, device="cpu")

    jlog, tlog = [], []
    with torch.no_grad():
        jcache, jl = jpre(params, jnp.asarray(toks), jcache,
                          jnp.asarray(row), jnp.int32(PROMPT_LEN))
        tcache, tl = tkv.paged_prefill(w, torch.from_numpy(toks), tcache,
                                       0, torch.from_numpy(row), tcfg,
                                       length=PROMPT_LEN)
        jlog.append(np.asarray(jl)[PROMPT_LEN - 1])
        tlog.append(tl[PROMPT_LEN - 1].numpy())
        last = np.zeros((S,), np.int32)
        pos = np.array([PROMPT_LEN, -1], np.int32)
        for _ in range(3):
            last[0] = int(np.argmax(jlog[-1]))
            jcache, jl = jdec(params, jnp.asarray(last), jcache,
                              jnp.asarray(pos), jnp.asarray(tables))
            tcache, tl = tkv.paged_decode_step(
                w, torch.from_numpy(last), tcache, torch.from_numpy(pos),
                torch.from_numpy(tables), tcfg)
            jlog.append(np.asarray(jl)[0])
            tlog.append(tl[0].numpy())
            pos[0] += 1
    own = slice(1, n_own + 1)
    pools = {n: (np.asarray(jcache[n][:, own].astype(jnp.float32)),
                 tcache[n][:, own].float().numpy()) for n in ("k", "v")}
    lengths = (np.asarray(jcache["lengths"]), tcache["lengths"].numpy())
    return jlog, tlog, pools, lengths


def test_paged_prefill_and_decode_match_jax_f32(tree):
    """f32: prefill logits, the pool bytes of the slot's blocks, and
    three decode steps' logits (JAX Pallas paged kernel, interpret mode)
    agree to summation order — rtol/atol 1e-4; the per-slot lengths
    agree exactly."""
    jlog, tlog, pools, lengths = _run_paged(tree, "f32")
    for j, t in zip(jlog, tlog):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
        assert int(np.argmax(t)) == int(np.argmax(j))
    for name, (j, t) in pools.items():
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5,
                                   err_msg=f"pool {name}")
    np.testing.assert_array_equal(lengths[0], lengths[1])


def test_paged_prefill_and_decode_match_jax_bf16(tree):
    """bf16 compute (f32 unembed): both sides round every projection,
    residual and P to bf16, but at different internal precisions (JAX's
    bf16 GELU and matmul outputs vs torch's f32-internal ones), so
    values drift by a few bf16 ulps through two layers (measured 8e-3
    on logits of magnitude < 1): atol 0.03. The pools are one
    projection deep and may differ by one bf16 ulp, 0.03 for values
    in [4, 8): atol 0.05."""
    jlog, tlog, pools, _ = _run_paged(tree, "bf16")
    for j, t in zip(jlog, tlog):
        np.testing.assert_allclose(t, j, rtol=0, atol=0.03)
    for name, (j, t) in pools.items():
        np.testing.assert_allclose(t, j, rtol=0, atol=0.05,
                                   err_msg=f"pool {name}")


def test_block_manager_accounting():
    bm = tkv.BlockManager(5, BS)
    assert (bm.usable, bm.free_count, bm.used_count) == (4, 4, 0)
    a = bm.alloc(3)
    assert tkv.TRASH_BLOCK not in a and bm.used_count == 3
    bm.retain(a[:1])
    bm.release(a + [tkv.TRASH_BLOCK])     # trash padding is skipped
    assert bm.used_count == 1             # the retained block survives
    bm.release(a[:1])
    assert bm.gauges() == {"total": 4, "free": 4, "used": 0}
    with pytest.raises(RuntimeError, match="double free"):
        bm.release(a[:1])
    with pytest.raises(RuntimeError, match="exhausted"):
        bm.alloc(5)

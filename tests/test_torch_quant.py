"""Port parity: int8 serving weights (``ops/quant.py``, the int8 model of
``convert.params_from_jax``/``quantize_model``, the generation forwards'
per-layer dequant, ``restore_for_inference(dtype="int8")``) against the
JAX package's.

``quantize``/``quantize_tree`` are host numpy with the reference's
operations in its order: ``q`` and ``scale`` are held bitwise. The int8
forwards are held to JAX's ``prefill``/``decode_step`` on JAX's
``quantize_tree`` of the same f32 weights (f32 compute: summation order
only), and the int8 engine's greedy and seeded streams — contiguous,
paged, with speculation (k = 4) and with one LoRA tenant — to the JAX
engine's on the same quantized tree, token for token.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker
import torch_serve_common as common
from horovod_tpu import serve as jserve
from horovod_tpu.ops import quant as jquant
from horovod_tpu.parallel import lora as jlora
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.serve import spec as jspec
from horovod_tpu_torch import convert
from horovod_tpu_torch.ops import quant as tquant
from horovod_tpu_torch.parallel import checkpoint as tckpt
from horovod_tpu_torch.parallel import transformer as ttr
from horovod_tpu_torch.parallel.lora import LoraConfig
from horovod_tpu_torch.serve import (AdapterRegistry, GenerationConfig,
                                     GenerationEngine, SamplingParams,
                                     SpecConfig)

TOL = dict(rtol=1e-5, atol=1e-5)
S, L, MAX_LEN = 2, 5, 32
PROMPTS = ([1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 7, 8], [9, 9, 9, 9, 9])
ENGINE = dict(max_slots=2, max_len=32, default_max_new_tokens=8)
SAMPLED = dict(temperature=0.8, top_k=8, seed=5)
RANK = 2


@pytest.fixture(scope="module")
def tree():
    return common.make_tree()


@pytest.fixture(scope="module")
def qtree(tree):
    """JAX's int8 inference tree of the tiny model (numpy pairs)."""
    return jquant.quantize_tree(tree)


@pytest.fixture(scope="module")
def qmodel(qtree):
    return convert.params_from_jax(qtree, common.torch_config(),
                                   device="cpu")


def _arrays(rng):
    w = rng.randn(12, 10).astype(np.float32)
    w[:, 3] = 0.0                                   # an all-zero channel
    w[0, 7] = 1e-30                                  # a tiny channel
    return {"zero_channel": w,
            "3d": rng.randn(2, 6, 5).astype(np.float32) * 40,
            "1d": rng.randn(9).astype(np.float32),
            "f64": rng.randn(7, 4),
            "halfway": np.array([[0.5, 1.5, -2.5, 127.0],
                                 [-127.0, 2.5, 0.0, 1.0]], np.float32)}


@pytest.mark.parametrize("name", ["zero_channel", "3d", "1d", "f64",
                                  "halfway"])
def test_quantize_bitwise_jax(name):
    arr = _arrays(np.random.RandomState(0))[name]
    want = jquant.quantize(arr)
    got = tquant.quantize(arr)
    assert got.q.dtype == np.int8 and got.scale.dtype == np.float32
    assert got.q.tobytes() == want.q.tobytes()
    assert got.scale.tobytes() == want.scale.tobytes()
    assert got.shape == want.shape
    # a torch tensor quantizes the same
    again = tquant.quantize(torch.from_numpy(np.asarray(arr, np.float32)))
    assert again.q.tobytes() == want.q.tobytes()
    if name == "zero_channel":
        assert got.scale[3] == 1.0 and not got.q[:, 3].any()


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_dequantize_matches_jax(dtype):
    qt = tquant.quantize(_arrays(np.random.RandomState(1))["3d"])
    want = jquant.dequantize(jquant.QuantizedTensor(*qt),
                             None if dtype is None else jnp.bfloat16)
    got = tquant.dequantize(qt, None if dtype is None else torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_quantize_tree_bitwise_jax(tree):
    mixed = {"params": tree, "step": np.int64(3),
             "stats": [np.ones(4, np.float64), np.arange(3)]}
    want = jquant.quantize_tree(mixed)
    got = tquant.quantize_tree(mixed)
    w_leaves = jax.tree_util.tree_leaves(want)
    g_leaves = jax.tree_util.tree_leaves(got)
    assert len(w_leaves) == len(g_leaves)
    for w, g in zip(w_leaves, g_leaves):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    assert tquant.is_quantized(got["params"]["embed"])
    assert got["params"]["lnf"].dtype == np.float32
    back = tquant.dequantize_tree(got["params"])
    ref = jquant.dequantize_tree(want["params"])
    for w, g in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_int8_model_holds_no_float_copy(qmodel, qtree, tree):
    """Projections and the embedding are int8 buffers with f32 scales;
    the only float parameters are the norm scales; gen_weights hands the
    forwards the model's own buffers (no copy)."""
    assert qmodel.quantized
    assert sorted(n.rsplit(".", 1)[-1] for n, _ in
                  qmodel.named_parameters()) == ["ln1", "ln1", "ln2",
                                                 "ln2", "lnf"]
    w = common.torch_weights(qmodel)
    for li, layer in enumerate(w["layers"]):
        for k in ("wqkv", "wo", "w1", "w2"):
            assert tquant.is_quantized(layer[k])
            blk = getattr(qmodel.layers[li], k)
            assert layer[k].q.data_ptr() == blk.q.data_ptr()
            assert layer[k].q.numpy().tobytes() == \
                qtree["layers"][li][k].q.tobytes()
    assert w["unembed"].q.data_ptr() == qmodel.embed.q.data_ptr()
    back = convert.params_to_numpy(qmodel)
    assert back["embed"].scale.tobytes() == qtree["embed"].scale.tobytes()
    # quantize_model of the f32 model is the same int8 model
    again = convert.quantize_model(common.torch_model(tree))
    for (n, a), (m, b) in zip(again.named_buffers(),
                              qmodel.named_buffers()):
        assert n == m and torch.equal(a, b)


def test_int8_embedding_gathers_before_scaling(qmodel):
    w = common.torch_weights(qmodel)
    toks = torch.tensor([3, 0, 31, 3, 7])
    cfg = qmodel.cfg
    got = ttr._embed(w, toks, cfg)
    full = tquant.dequantize(w["embed"]).to(cfg.dtype)[toks]
    assert torch.equal(got, full)


@pytest.fixture(scope="module")
def runs(qtree, qmodel):
    """Both sides on the int8 tree: 8-token prompts (true length 5)
    prefilled into slots 0 and 1, then 3 greedy decode steps (the JAX
    side's tokens feed both)."""
    jcfg, tcfg = common.jax_config(), common.torch_config()
    params = common.jax_params(qtree)
    w = common.torch_weights(qmodel)
    jc = jtr.init_kv_cache(jcfg, S, MAX_LEN)
    tc = ttr.init_kv_cache(tcfg, S, MAX_LEN, device="cpu")
    rng = np.random.RandomState(1)
    out = {"jpre": [], "tpre": [], "jdec": [], "tdec": []}
    with torch.no_grad():
        for s in range(S):
            toks = rng.randint(0, common.DIMS["vocab"], (8,)).astype(np.int32)
            jc, jl = jtr.prefill(params, toks, jc, s, jcfg, length=L)
            tc, tl = ttr.prefill(w, common.t(toks), tc, s, tcfg, length=L)
            out["jpre"].append(np.asarray(jl))
            out["tpre"].append(tl.numpy())
        last = np.stack([p[L - 1] for p in out["jpre"]]).argmax(-1)
        pos = np.full((S,), L, np.int32)
        for _ in range(3):
            last = last.astype(np.int32)
            jc, jl = jtr.decode_step(params, last, jc, pos, jcfg)
            tc, tl = ttr.decode_step(w, common.t(last), tc, common.t(pos),
                                     tcfg)
            out["jdec"].append(np.asarray(jl))
            out["tdec"].append(tl.numpy())
            last, pos = np.asarray(jl).argmax(-1), pos + 1
    return out


@pytest.mark.parametrize("phase", ["pre", "dec"])
def test_int8_logits_match_jax(runs, phase):
    for j, t in zip(runs["j" + phase], runs["t" + phase]):
        np.testing.assert_allclose(t, j, **TOL)


def test_int8_logits_differ_from_f32(runs, tree):
    """The int8 path really runs int8: the f32 model's prefill logits
    are off the int8 ones by more than the summation noise."""
    w = common.torch_weights(common.torch_model(tree))
    tc = ttr.init_kv_cache(common.torch_config(), S, MAX_LEN, device="cpu")
    toks = np.random.RandomState(1).randint(0, common.DIMS["vocab"],
                                            (8,)).astype(np.int32)
    with torch.no_grad():
        _, f32 = ttr.prefill(w, common.t(toks), tc, 0,
                             common.torch_config(), length=L)
    assert np.abs(f32.numpy() - runs["tpre"][0]).max() > 1e-3


# -- the int8 engine against the JAX engine ----------------------------------

VARIANTS = {
    "contiguous": ({}, {}, None),
    "paged": (dict(kv_layout="paged", block_size=4, n_blocks=64,
                   paged_kernel=True),
              dict(kv_layout="paged", block_size=4, n_blocks=64), None),
    "spec": ({}, {}, 4),
    "lora": ({}, {}, None),
}


@pytest.fixture(scope="module")
def jax_adapter():
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jlora.init_adapter(jax.random.PRNGKey(1), common.jax_config(),
                           jlora.LoraConfig(rank=RANK), b_scale=0.5))


def _serve(eng, mode, adapter=None):
    kw = {} if adapter is None else {"adapter": adapter}
    return [eng.submit(p, sampling=mode, max_new_tokens=8, **kw)
            .result(common.TIMEOUT)["tokens"] for p in PROMPTS]


@pytest.fixture(scope="module")
def streams(qtree, qmodel, jax_adapter):
    """Greedy and seeded streams of the port's and JAX's int8 engines in
    every variant."""
    out = {}
    for name, (tkw, jkw, k) in VARIANTS.items():
        port_reg = jax_reg = None
        if name == "lora":
            port_reg = AdapterRegistry(common.torch_config(),
                                       LoraConfig(rank=RANK), capacity=2,
                                       device="cpu")
            port_reg.load("t0", convert.adapter_from_jax(
                jax_adapter, common.torch_config(), LoraConfig(rank=RANK),
                device="cpu"))
            jax_reg = jserve.AdapterRegistry(
                common.jax_config(), jlora.LoraConfig(rank=RANK),
                capacity=2)
            jax_reg.load("t0", jax_adapter)
        tern = GenerationEngine(
            qmodel, GenerationConfig(**ENGINE, **tkw), device="cpu",
            adapters=port_reg, spec=None if k is None else SpecConfig(k=k))
        jeng = jserve.GenerationEngine(
            common.jax_params(qtree), common.jax_config(),
            jserve.GenerationConfig(**ENGINE, **jkw), adapters=jax_reg,
            spec=None if k is None else jspec.SpecConfig(k=k))
        adapter = "t0" if name == "lora" else None
        try:
            for mode, sp in (("greedy", {}), ("seeded", SAMPLED)):
                out[(name, mode)] = (
                    _serve(tern, SamplingParams(**sp), adapter),
                    _serve(jeng, jserve.SamplingParams(**sp), adapter))
        finally:
            tern.shutdown()
            jeng.shutdown()
    return out


@pytest.mark.parametrize("mode", ["greedy", "seeded"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_int8_engine_streams_match_jax(streams, variant, mode):
    got, want = streams[(variant, mode)]
    assert got == want
    assert all(len(t) == 8 for t in got)


def test_int8_tenant_stream_differs_from_base(streams):
    assert streams[("lora", "greedy")][0] != \
        streams[("contiguous", "greedy")][0]


# -- restore_for_inference(dtype="int8") -------------------------------------

def _leaves(node, prefix=""):
    if tquant.as_quantized(node) is not None:
        qt = tquant.as_quantized(node)
        yield prefix + ".q", np.asarray(qt.q)
        yield prefix + ".scale", np.asarray(qt.scale)
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k], f"{prefix}.{k}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(node)


@pytest.fixture(scope="module")
def saved(tmp_path_factory, tree):
    """A port checkpoint of the tiny model's f32 weights (step 0)."""
    d = str(tmp_path_factory.mktemp("int8ckpt"))
    path = os.path.join(d, "ckpt_0")
    host = {"params": convert.params_to_numpy(common.torch_model(tree))}
    tckpt.write_tree(path, host)
    tckpt.write_manifest(path, host, step=0)
    return d, path, host


def test_restore_int8_equals_jax_quantize_tree(saved):
    d, path, host = saved
    assert tckpt.verify_checkpoint(path) is True
    got = tckpt.restore_for_inference(d, dtype="int8")
    assert tckpt.verify_checkpoint(path) is True
    want = jquant.quantize_tree(host)
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes()
    assert isinstance(got["params"]["layers"][0]["wo"],
                      tquant.QuantizedTensor)


def test_restored_int8_serves_as_quantize_model(saved):
    """The int8 restore through params_from_jax generates the tokens of
    quantize_model applied to the same checkpoint's f32 restore."""
    d, _, _ = saved
    cfg = common.torch_config()
    int8 = convert.params_from_jax(
        tckpt.restore_for_inference(d, dtype="int8")["params"], cfg,
        device="cpu")
    f32 = convert.params_from_jax(tckpt.restore_for_inference(d)["params"],
                                  cfg, device="cpu")
    toks = []
    for m in (int8, convert.quantize_model(f32)):
        eng = common.engine(m, max_len=32)
        try:
            toks.append(_serve(eng, SamplingParams()))
        finally:
            eng.shutdown()
    assert toks[0] == toks[1]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return torch_mesh_worker.spawn(
        2, [dict(kind="infer8", dims=common.DIMS)],
        tmp_path_factory.mktemp("int8mesh"), timeout=300)[0]


def test_restore_int8_on_a_mesh_slices_the_global_quantization(world2):
    """tp=2 world: each rank's int8 blocks are the slices of JAX's
    quantize_tree of the global tree (scales split as their columns),
    and params_from_jax/quantize_model on the mesh hold the same."""
    from horovod_tpu_torch.parallel.mesh import Mesh, local_slice
    full = world2[0]["full"]["params"]
    want = jquant.quantize_tree(full)
    specs = ttr.param_specs(common.torch_config(), Mesh(
        axis_names=("dp", "pp", "tp"), shape={"dp": 1, "pp": 1, "tp": 2},
        coords={"dp": 0, "pp": 0, "tp": 0}, ranks={}, groups={}))
    sharded = 0
    for r in world2:
        mesh = Mesh(axis_names=("dp", "pp", "tp"),
                    shape={"dp": 1, "pp": 1, "tp": 2}, coords=r["coords"],
                    ranks={}, groups={})
        for li, layer in enumerate(r["blocks"]["params"]["layers"]):
            for k in ("wqkv", "wo", "w1", "w2"):
                spec = specs["layers"][li][k]
                wq = want["layers"][li][k]
                for got in (layer[k], r["model"][li][k],
                            r["quantized"][li][k]):
                    np.testing.assert_array_equal(
                        got.q, local_slice(wq.q, spec, mesh))
                    np.testing.assert_array_equal(
                        got.scale, local_slice(wq.scale, spec[-1:], mesh))
                sharded += layer[k].q.shape != wq.q.shape
                assert layer[k].scale.shape == layer[k].q.shape[-1:]
    # wqkv and w1 split their columns (and scales), wo and w2 their rows
    assert sharded == 2 * 4 * common.DIMS["n_layers"]


# -- refusals -----------------------------------------------------------------

def test_training_forwards_refuse_int8(qmodel):
    toks = torch.tensor([[1, 2, 3, 4]])
    with pytest.raises(ValueError, match="int8"):
        ttr.forward(qmodel, toks)
    with pytest.raises(ValueError, match="int8"):
        ttr.forward_hidden(qmodel, toks)
    with pytest.raises(ValueError, match="int8"):
        ttr.lm_loss(ttr.gen_weights(qmodel), toks, toks,
                    common.torch_config())
    init_state, _ = ttr.make_parallel_train_step(
        common.torch_config(), torch.optim.SGD, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        init_state(model=qmodel)
    with pytest.raises(ValueError, match="int8"):
        convert.pp_params_from_jax(
            {"embed": tquant.quantize(np.ones((4, 4), np.float32))},
            common.torch_config(), _mesh1(), device="cpu")


def _mesh1():
    from horovod_tpu_torch.parallel.mesh import Mesh
    return Mesh(axis_names=("dp", "pp"), shape={"dp": 1, "pp": 1},
                coords={"dp": 0, "pp": 0}, ranks={}, groups={})


def test_restore_rejects_unknown_dtype(tmp_path):
    assert tckpt.INFERENCE_DTYPES == jserve.INFERENCE_DTYPES
    with pytest.raises(ValueError, match="not supported"):
        tckpt.restore_for_inference(str(tmp_path), dtype="int4")

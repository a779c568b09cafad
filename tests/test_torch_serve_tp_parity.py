"""Port parity under a tp mesh: the KV spec functions, every generation
forward on a tp rank, and the tp engine's streams, against the JAX
package.

The port's side runs in spawned gloo worlds of 2 and 4 ranks
(``torch_serve_tp_worker``), each rank holding its ``param_specs``
blocks of one global tree and its ``n_heads / tp`` heads of the cache.
The JAX side runs in this process:

* the generation functions under ``jax.jit`` on a tp mesh of CPU
  devices, with the parameters placed by ``param_specs`` and the caches
  by ``kv_cache_specs`` / ``paged_kv_cache_specs`` — logits agree at f32
  rtol and atol 1e-5 (the tolerance of ``test_torch_kv_contiguous.py``),
  and each rank's cache block is that cache's head slice;
* the JAX engine on the same global tree, unsharded (JAX's own engine
  does not serve a sharded tree: its AOT compile lowers unsharded
  ``ShapeDtypeStruct``s) — the tp engine's greedy and seeded streams are
  token-identical in both layouts and with each serving feature. The
  greedy positions' top-2 logit margins, read from the port's unsharded
  prompt forward, are asserted above :data:`MARGIN`, which exceeds the
  cross-framework |Δ| by two orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_serve_tp_worker as worker
from horovod_tpu import serve as jserve
from horovod_tpu.ops import quant as jquant
from horovod_tpu.parallel import kv_blocks as jkv
from horovod_tpu.parallel import lora as jlora
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.serve import spec as jspec
from horovod_tpu_torch import convert
from horovod_tpu_torch.ops.quant import quantize_tree
from horovod_tpu_torch.parallel import kv_blocks as tkv
from horovod_tpu_torch.parallel import lora as tlora
from horovod_tpu_torch.parallel import transformer as ttr
from horovod_tpu_torch.parallel.mesh import Mesh as TorchMesh

DIMS = dict(vocab=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-4
TIMEOUT = 60
S, L, MAX_LEN, BS, NB = 2, 5, 32, 4, 17
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]     # 11 tokens: 2 full blocks
PRESSURE = ([7 + (i % 20) for i in range(12)],
            [11 + (i % 17) for i in range(12)])
SEEDED = dict(temperature=0.8, top_k=8, seed=5)
LORA = dict(rank=2, alpha=8.0)


def jax_config():
    return jtr.TransformerConfig(**DIMS, dtype=jnp.float32,
                                 unembed_dtype=jnp.float32,
                                 attn_backend="xla")


def torch_config():
    return ttr.TransformerConfig(**DIMS, dtype=torch.float32,
                                 unembed_dtype=torch.float32)


def _tree():
    params = jtr.init_params(jax.random.PRNGKey(0), jax_config())
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  params)


def _adapters():
    return {f"a{i}": jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jlora.init_adapter(jax.random.PRNGKey(1 + i), jax_config(),
                           jlora.LoraConfig(**LORA), b_scale=0.5))
        for i in range(2)}


# -- the forwards' inputs -----------------------------------------------------

def _fwd_inputs():
    rng = np.random.RandomState(7)
    v = DIMS["vocab"]
    prompts = [rng.randint(0, v, (8,)).astype(np.int32) for _ in range(S)]
    tables = np.arange(1, NB, dtype=np.int32).reshape(S, -1)   # [S, 8]
    mb = tables.shape[1]
    trash = np.zeros((mb,), np.int32)
    cold_read = trash.copy()
    cold_read[:3] = [1, 2, 3]
    hit_read = trash.copy()
    hit_read[:3] = [1, 2, 4]
    toks16 = np.zeros((16,), np.int32)
    toks16[:11] = PROMPT
    toks8 = np.zeros((8,), np.int32)
    toks8[:3] = PROMPT[8:]
    chunked = [
        dict(tokens=toks16, slot=0, write_rows=np.array(
            [[1], [2], [3], [0]], np.int32), read_row=cold_read, start=0,
            length=11, cb=1),
        dict(tokens=toks8, slot=1, write_rows=np.array([[4], [0]], np.int32),
             read_row=hit_read, start=8, length=11, cb=1)]
    return dict(prompts=prompts, length=L, max_len=MAX_LEN, bs=BS,
                n_blocks=NB, tables=tables,
                decode_tokens=[rng.randint(0, v, (S,)).astype(np.int32)
                               for _ in range(3)],
                drafts=rng.randint(0, v, (S, 3)).astype(np.int32),
                chunked=chunked)


def _jax_fwd(tree, inp, tp):
    """The same calls as the worker's ``fwd`` case: JAX's functions under
    ``jax.jit`` on a tp mesh of CPU devices, sharded by the spec
    functions."""
    cfg = jax_config()
    mesh = JaxMesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("dp", "tp"))

    def place(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    def put(tree_, specs):
        return jax.tree_util.tree_map(place, tree_, specs,
                                      is_leaf=lambda x: isinstance(x, P))
    params = put(jax.tree_util.tree_map(jnp.asarray, tree),
                 jtr.param_specs(cfg, mesh))
    kv_specs = jtr.kv_cache_specs(cfg, mesh)
    pkv_specs = jkv.paged_kv_cache_specs(cfg, mesh)
    pre = jax.jit(lambda p, x, c, s: jtr.prefill(p, x, c, s, cfg, length=L))
    dec = jax.jit(lambda p, x, c, q: jtr.decode_step(p, x, c, q, cfg))
    ver = jax.jit(lambda p, x, c, q: jtr.verify_step(p, x, c, q, cfg))
    ppre = jax.jit(lambda p, x, c, s, r: jkv.paged_prefill(
        p, x, c, s, r, cfg, length=L))
    pdec = jax.jit(lambda p, x, c, q, t: jkv.paged_decode_step(
        p, x, c, q, t, cfg))
    pver = jax.jit(lambda p, x, c, q, t: jkv.paged_verify_step(
        p, x, c, q, t, cfg))
    out = {}
    cache = put(jtr.init_kv_cache(cfg, S, MAX_LEN), kv_specs)
    out["prefill"] = []
    for s, toks in enumerate(inp["prompts"]):
        cache, lg = pre(params, toks, cache, s)
        out["prefill"].append(np.asarray(lg))
    base = cache
    out["decode"] = []
    pos = np.full((S,), L, np.int32)
    for last in inp["decode_tokens"]:
        cache, lg = dec(params, last, cache, pos)
        out["decode"].append(np.asarray(lg))
        pos = pos + 1
    out["sharding"] = cache["k"].sharding.spec
    out["cache"] = {n: np.asarray(x) for n, x in cache.items()}
    vc, vl = ver(params, inp["drafts"], base, np.full((S,), L, np.int32))
    out["verify"] = np.asarray(vl)
    out["verify_cache"] = {n: np.asarray(x) for n, x in vc.items()}
    pool = put(jkv.init_paged_kv_cache(cfg, NB, BS, S), pkv_specs)
    ppref = []
    for s, toks in enumerate(inp["prompts"]):
        pool, lg = ppre(params, toks, pool, s, inp["tables"][s])
        ppref.append(np.asarray(lg))
    vbase = pool
    pdecs = []
    pos = np.full((S,), L, np.int32)
    for last in inp["decode_tokens"]:
        pool, lg = pdec(params, last, pool, pos, inp["tables"])
        pdecs.append(np.asarray(lg))
        pos = pos + 1
    _, pvl = pver(params, inp["drafts"], vbase, np.full((S,), L, np.int32),
                  inp["tables"])
    out["paged"] = {"prefill": ppref, "decode": pdecs,
                    "verify": np.asarray(pvl),
                    "pool": {n: np.asarray(x) for n, x in pool.items()}}
    pool = put(jkv.init_paged_kv_cache(cfg, NB, BS, S), pkv_specs)
    out["chunked"] = []
    for a in inp["chunked"]:
        pool, lg = jax.jit(
            lambda p, x, c, w, r, a=a: jkv.paged_chunked_prefill(
                p, x, c, a["slot"], w, r, a["start"], cfg,
                length=a["length"], chunk_blocks=a["cb"]))(
            params, a["tokens"], pool, a["write_rows"], a["read_row"])
        out["chunked"].append(np.asarray(lg))
    out["chunked_pool"] = {n: np.asarray(x) for n, x in pool.items()}
    return out


# -- the engine's variants ----------------------------------------------------

def _requests(adapters=False):
    other = [5, 6, 7, 8, 9, 10]
    reqs = [dict(tokens=PROMPT, max_new=4),
            dict(tokens=other, max_new=5, sampling=SEEDED),
            dict(tokens=PROMPT[:8] + [7, 7], max_new=4),
            dict(tokens=PROMPT, max_new=4, sampling=dict(SEEDED, seed=9))]
    if adapters:
        for r, a in zip(reqs, ("a0", "a1", "a0", None)):
            r["adapter"] = a
    return reqs


HOST_REQUESTS = [dict(tokens=p, max_new=4)
                 for p in (PROMPT, PRESSURE[0], PRESSURE[1], PROMPT)]
BASE = dict(max_slots=2, max_len=16, default_max_new_tokens=4)
PAGED = dict(BASE, kv_layout="paged", block_size=BS)
VARIANTS = {
    "contiguous": dict(config=BASE),
    "paged": dict(config=PAGED),
    "paged_kernel": dict(config=dict(PAGED, paged_kernel=True),
                         jax_config=PAGED),
    "prefix_chunked": dict(config=dict(PAGED, prefix_reuse=True,
                                       chunked_prefill=True)),
    "host_tier": dict(config=dict(PAGED, max_slots=1, n_blocks=8,
                                  host_blocks=8, prefix_reuse=True,
                                  chunked_prefill=True),
                      requests=HOST_REQUESTS, sequential=True),
    "spec": dict(config=BASE, spec_k=2),
    "int8": dict(config=BASE, int8=True),
    "lora": dict(config=PAGED, lora=True, requests=_requests(True)),
}


def _jax_streams(tree, adapters, name, v):
    """The JAX engine on the global tree, unsharded, with the variant's
    knobs (the XLA gather for the port's ``paged_kernel``)."""
    params = jax.tree_util.tree_map(
        jnp.asarray, jquant.quantize_tree(tree) if v.get("int8") else tree)
    reg = None
    if v.get("lora"):
        reg = jserve.AdapterRegistry(jax_config(), jlora.LoraConfig(**LORA),
                                     capacity=len(adapters))
        for a, t in adapters.items():
            reg.load(a, t)
    eng = jserve.GenerationEngine(
        params, jax_config(),
        jserve.GenerationConfig(**v.get("jax_config", v["config"])),
        adapters=reg,
        spec=jspec.SpecConfig(k=v["spec_k"]) if v.get("spec_k") else None)
    try:
        out = []
        for r in v.get("requests", _requests()):
            sp = jserve.SamplingParams(**r.get("sampling", {}))
            h = eng.submit(r["tokens"], max_new_tokens=r["max_new"],
                           sampling=sp, adapter=r.get("adapter"))
            if v.get("sequential"):
                h.result(TIMEOUT)
            out.append(h)
        return [h.result(TIMEOUT)["tokens"] for h in out]
    finally:
        eng.shutdown()


# -- fixtures: both worlds start first, the JAX side runs meanwhile ----------

@pytest.fixture(scope="module")
def tree():
    return _tree()


@pytest.fixture(scope="module")
def adapters():
    return _adapters()


@pytest.fixture(scope="module")
def fwd_inputs():
    return _fwd_inputs()


@pytest.fixture(scope="module")
def worlds(tree, adapters, fwd_inputs, tmp_path_factory):
    fwd = dict(kind="fwd", dims=DIMS, tree=tree, **fwd_inputs)
    eng = dict(kind="engine", dims=DIMS, tree=tree, variants=VARIANTS,
               requests=_requests(), adapters=adapters, lora=LORA,
               timeout=TIMEOUT)
    w2 = worker.start(2, [fwd, eng], tmp_path_factory.mktemp("tp2"),
                      timeout=150)
    w4 = worker.start(4, [fwd], tmp_path_factory.mktemp("tp4"), timeout=150)
    return {2: w2, 4: w4}


@pytest.fixture(scope="module")
def jax_fwd(worlds, tree, fwd_inputs):
    return {tp: _jax_fwd(tree, fwd_inputs, tp) for tp in (2, 4)}


@pytest.fixture(scope="module")
def jax_streams(worlds, tree, adapters):
    return {name: _jax_streams(tree, adapters, name, v)
            for name, v in VARIANTS.items()}


@pytest.fixture(scope="module")
def port_fwd(worlds):
    return {tp: worlds[tp].result()[0] for tp in (2, 4)}


@pytest.fixture(scope="module")
def port_engine(worlds):
    return worlds[2].result()[1][0]


# -- (i) the spec functions ---------------------------------------------------

def _torch_mesh(axes):
    return TorchMesh(axis_names=tuple(axes), shape=dict(axes),
                     coords={a: 0 for a in axes}, ranks={}, groups={})


@pytest.mark.parametrize("axes", [dict(dp=1, tp=2), dict(dp=2, pp=1),
                                  dict(tp=4)])
def test_kv_cache_specs_equal_jax(axes):
    n = int(np.prod(list(axes.values())))
    jmesh = JaxMesh(np.array(jax.devices()[:n]).reshape(
        tuple(axes.values())), tuple(axes))
    tmesh = _torch_mesh(axes)
    for jfn, tfn in ((jtr.kv_cache_specs, ttr.kv_cache_specs),
                     (jkv.paged_kv_cache_specs, tkv.paged_kv_cache_specs)):
        want = jfn(jax_config(), jmesh)
        got = tfn(torch_config(), tmesh)
        assert set(got) == set(want) == {"k", "v", "lengths"}
        for n_ in got:
            assert got[n_] == tuple(want[n_]), (n_, got[n_], want[n_])
    assert ttr.kv_cache_specs(torch_config(), None)["k"] == (None,) * 5


# -- (ii) every forward on a tp rank -----------------------------------------

def _heads(x, tp, r, axis=3):
    h = x.shape[axis] // tp
    return np.take(x, np.arange(r * h, (r + 1) * h), axis=axis)


@pytest.mark.parametrize("tp", [2, 4])
def test_jax_keeps_the_cache_sharded(jax_fwd, tp):
    # (XLA's output sharding drops the trailing replicated dimension.)
    assert tuple(jax_fwd[tp]["sharding"]) == (None, None, None, "tp")


@pytest.mark.parametrize("phase", ["prefill", "decode", "verify"])
@pytest.mark.parametrize("tp", [2, 4])
def test_contiguous_forwards_match_jax_sharded(port_fwd, jax_fwd, tp,
                                               phase):
    want = jax_fwd[tp][phase]
    for r, got in enumerate(port_fwd[tp]):
        assert got["coords"]["tp"] == r
        np.testing.assert_allclose(np.asarray(got[phase]), np.asarray(want),
                                   **TOL)
        cache = "verify_cache" if phase == "verify" else "cache"
        for n in ("k", "v"):
            np.testing.assert_allclose(
                got[cache][n], _heads(jax_fwd[tp][cache][n], tp, r), **TOL)
        np.testing.assert_array_equal(got[cache]["lengths"],
                                      jax_fwd[tp][cache]["lengths"])


@pytest.mark.parametrize("phase", ["prefill", "decode", "verify"])
@pytest.mark.parametrize("kernel", [0, 1])
@pytest.mark.parametrize("tp", [2, 4])
def test_paged_forwards_match_jax_sharded(port_fwd, jax_fwd, tp, kernel,
                                          phase):
    want = jax_fwd[tp]["paged"]
    for r, got in enumerate(port_fwd[tp]):
        got = got[f"paged{kernel}"]
        np.testing.assert_allclose(np.asarray(got[phase]),
                                   np.asarray(want[phase]), **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(got["pool"][n],
                                       _heads(want["pool"][n], tp, r), **TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_chunked_prefill_matches_jax_sharded(port_fwd, jax_fwd, tp):
    want = jax_fwd[tp]
    for r, got in enumerate(port_fwd[tp]):
        for g, w in zip(got["chunked"], want["chunked"]):
            np.testing.assert_allclose(g, w, **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(
                got["chunked_pool"][n],
                _heads(want["chunked_pool"][n], tp, r), **TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_gather_is_bitwise_the_contiguous_step_on_a_rank(port_fwd, tp):
    """JAX's cross-layout contract on each tp rank: the paged gather runs
    the contiguous cache's attention over the same view."""
    for got in port_fwd[tp]:
        for phase in ("prefill", "decode", "verify"):
            np.testing.assert_array_equal(np.asarray(got["paged0"][phase]),
                                          np.asarray(got[phase]))


@pytest.mark.parametrize("tp", [2, 4])
def test_every_rank_returns_the_same_logits(port_fwd, tp):
    ranks = port_fwd[tp]
    for phase in ("prefill", "decode", "verify", "chunked"):
        for got in ranks[1:]:
            a, b = got[phase], ranks[0][phase]
            if not isinstance(a, list):
                a, b = [a], [b]
            for g, w in zip(a, b):
                np.testing.assert_array_equal(g, w)


# -- (iii) the tp engine's streams against JAX's engine -----------------------

def _margins(tree, adapters, name, v, streams):
    """The smallest top-2 logit margin over the greedy positions of the
    variant's streams, from the port's unsharded prompt forward."""
    cfg = torch_config()
    src = quantize_tree(tree) if v.get("int8") else tree
    w = ttr.gen_weights(convert.params_from_jax(src, cfg, device="cpu"))
    lora_kw = {}
    names = sorted(adapters)
    if v.get("lora"):
        lcfg = tlora.LoraConfig(**LORA)
        table = tlora.stack_adapters([adapters[a] for a in names],
                                     device="cpu")
        lora_kw = dict(adapters=table, lora=lcfg)
    worst = np.inf
    for r, toks in zip(v.get("requests", _requests()), streams):
        if r.get("sampling"):
            continue
        seq = list(r["tokens"]) + list(toks[:-1])
        cache = ttr.init_kv_cache(cfg, 1, 64, device="cpu")
        kw = dict(lora_kw)
        if kw:
            kw["adapter_idx"] = (names.index(r["adapter"])
                                 if r.get("adapter") else -1)
        with torch.no_grad():
            _, lg = ttr.prefill(w, torch.tensor(seq, dtype=torch.int32),
                                cache, 0, cfg, **kw)
        rows = lg.numpy()[len(r["tokens"]) - 1:]
        top = np.sort(rows, axis=-1)
        assert (rows.argmax(-1) == np.asarray(toks)).all()
        worst = min(worst, float((top[:, -1] - top[:, -2]).min()))
    return worst


@pytest.mark.parametrize("name", list(VARIANTS))
def test_tp_engine_streams_match_jax_engine(port_engine, jax_streams,
                                            tree, adapters, name):
    got = port_engine[name]["streams"]
    want = jax_streams[name]
    assert got == want
    assert _margins(tree, adapters, name, VARIANTS[name], got) > MARGIN


def test_tp_engine_features_ran(port_engine):
    """The variants exercised what they name: prefix hits, the host tier
    both ways, speculation's verify steps, and the plane's descriptors."""
    g = {n: port_engine[n]["stats"]["generation"] for n in VARIANTS}
    assert g["prefix_chunked"]["prefix_hits_total"] > 0
    assert g["host_tier"]["kv_offload_blocks_total"] > 0
    assert g["host_tier"]["kv_prefetch_blocks_total"] > 0
    assert port_engine["spec"]["stats"]["spec"]["draft_tokens_total"] > 0
    assert port_engine["lora"]["stats"]["adapters_resident"] == 2
    for n in VARIANTS:
        tp = port_engine[n]["stats"]["tp"]
        assert tp["role"] == "leader" and tp["tp"] == 2
        assert tp["calls"] > 0 and tp["error"] is None


def test_tp_contiguous_streams_equal_paged(port_engine):
    """JAX's cross-layout contract, bitwise within the port at tp = 2."""
    want = port_engine["contiguous"]["streams"]
    for name in ("paged", "paged_kernel", "prefix_chunked", "spec"):
        assert port_engine[name]["streams"][0] == want[0]
        assert port_engine[name]["streams"][2] == want[2]
    assert port_engine["paged"]["streams"] == want
    assert port_engine["prefix_chunked"]["streams"] == want

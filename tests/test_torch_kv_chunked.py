"""Port parity: the chunked prefill (``paged_chunked_prefill``) against
the JAX function, and the port's KV hierarchy contracts: a prefix hit's
suffix chunks give logits and pool bytes bitwise those of the cold loop,
hit and cold streams are equal in the engine at every edge geometry
(JAX ``test_kv_hierarchy``), and the host tier's offload → prefetch
round trip under pool pressure, with the ``"wait"`` and ``"miss"``
admission policies, never reads a stale byte.

JAX side: the jitted ``lax.scan`` on XLA's CPU; port side: the same
chunks one after the other, in place. Across the frameworks the logits
agree to f32 summation order (rtol/atol 1e-5).
"""

import jax
import numpy as np
import pytest
import torch

import torch_serve_common as common
from horovod_tpu.parallel import kv_blocks as jkv
from horovod_tpu_torch.parallel import kv_blocks as tkv
from horovod_tpu_torch.serve import GenerationConfig, SamplingParams
from horovod_tpu_torch.serve.spec import SpecConfig

BS, MAX_LEN = 4, 16
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]   # 11 tokens; 2 full blocks @ 4
CHAIN = PROMPT[:8]
# (prompt_len, hit_blocks, full bucket, suffix bucket, chunk_blocks, seed)
GEOMETRIES = {"partial_last_block": (11, 2, 16, 8, 1, 0),
              "one_token_suffix": (9, 2, 16, 8, 1, 1),
              "budget_chain": (15, 3, 16, 8, 1, 3),
              "two_block_chunks": (13, 2, 16, 16, 2, 2)}


@pytest.fixture(scope="module")
def tree():
    return common.make_tree()


@pytest.fixture(scope="module")
def model(tree):
    return common.torch_model(tree)


def _chain_inputs(geom):
    prompt_len, hit_blocks, full_b, suf_b, cb, seed = geom
    C = cb * BS
    prompt = np.random.RandomState(seed).randint(
        0, common.DIMS["vocab"], (prompt_len,)).astype(np.int32)
    max_blocks = MAX_LEN // BS
    n_chain = -(-prompt_len // BS)
    chain = list(range(1, 1 + n_chain))
    row = np.zeros((max_blocks,), np.int32)
    row[:n_chain] = chain
    wrows = np.zeros((full_b // C, cb), np.int32)
    wrows.reshape(-1)[:n_chain] = chain
    toks = np.zeros((full_b,), np.int32)
    toks[:prompt_len] = prompt
    fresh = list(range(1 + n_chain, 1 + n_chain + (n_chain - hit_blocks)))
    rrow = np.zeros((max_blocks,), np.int32)
    rrow[:hit_blocks] = chain[:hit_blocks]
    rrow[hit_blocks:n_chain] = fresh
    wsuf = np.zeros((suf_b // C, cb), np.int32)
    wsuf.reshape(-1)[:len(fresh)] = fresh
    start = hit_blocks * BS
    tsuf = np.zeros((suf_b,), np.int32)
    tsuf[:prompt_len - start] = prompt[start:]
    return dict(prompt_len=prompt_len, cb=cb, toks=toks, wrows=wrows,
                row=row, tsuf=tsuf, wsuf=wsuf, rrow=rrow, start=start,
                chain=chain, fresh=fresh, hit_blocks=hit_blocks)


def _torch_full_and_suffix(model, g):
    tcfg = common.torch_config()
    w = common.torch_weights(model)
    t = common.t
    with torch.no_grad():
        pc = tkv.init_paged_kv_cache(tcfg, 16, BS, 2, device="cpu")
        _, full = tkv.paged_chunked_prefill(
            w, t(g["toks"]), pc, 0, t(g["wrows"]), t(g["row"]), 0, tcfg,
            length=g["prompt_len"], chunk_blocks=g["cb"])
        _, suf = tkv.paged_chunked_prefill(
            w, t(g["tsuf"]), pc, 1, t(g["wsuf"]), t(g["rrow"]), g["start"],
            tcfg, length=g["prompt_len"], chunk_blocks=g["cb"])
    return pc, full.numpy(), suf.numpy()


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_chunked_prefill_matches_jax(tree, model, name):
    """The full-prompt loop and the suffix loop against the JAX scan:
    logits and the pool's written blocks at 1e-5; lengths exact."""
    g = _chain_inputs(GEOMETRIES[name])
    jcfg = common.jax_config()
    params = common.jax_params(tree)
    run = jax.jit(lambda p, x, c, s, wr, r, st: jkv.paged_chunked_prefill(
        p, x, c, s, wr, r, st, jcfg, length=g["prompt_len"],
        chunk_blocks=g["cb"]))
    jc = jkv.init_paged_kv_cache(jcfg, 16, BS, 2)
    jc, jfull = run(params, g["toks"], jc, 0, g["wrows"], g["row"], 0)
    jc, jsuf = run(params, g["tsuf"], jc, 1, g["wsuf"], g["rrow"],
                   g["start"])
    pc, full, suf = _torch_full_and_suffix(model, g)
    np.testing.assert_allclose(full, np.asarray(jfull), **TOL)
    np.testing.assert_allclose(suf, np.asarray(jsuf), **TOL)
    used = g["chain"] + g["fresh"]
    for n in ("k", "v"):
        np.testing.assert_allclose(pc[n][:, used].numpy(),
                                   np.asarray(jc[n])[:, used], **TOL)
    np.testing.assert_array_equal(pc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_suffix_logits_and_pool_bitwise_equal_full_loop(model, name):
    """The skip-compute contract in the port: the suffix loop (started at
    the first non-shared block, reading the hit K/V from the pool) gives
    logits bitwise the full loop's rows for the same positions and
    writes byte-identical K/V into its fresh blocks."""
    g = _chain_inputs(GEOMETRIES[name])
    pc, full, suf = _torch_full_and_suffix(model, g)
    n = g["prompt_len"] - g["start"]
    np.testing.assert_array_equal(full[g["start"]:g["prompt_len"]],
                                  suf[:n])
    for j, fb in enumerate(g["fresh"]):
        src = g["chain"][g["hit_blocks"] + j]
        rows = min(BS, g["prompt_len"] - (g["hit_blocks"] + j) * BS)
        for name_ in ("k", "v"):
            np.testing.assert_array_equal(pc[name_][:, src, :rows].numpy(),
                                          pc[name_][:, fb, :rows].numpy())


def test_single_chunk_bucket_rejected(model):
    tcfg = common.torch_config()
    pc = tkv.init_paged_kv_cache(tcfg, 8, 4, 1, device="cpu")
    with pytest.raises(ValueError, match="trip"):
        tkv.paged_chunked_prefill(
            common.torch_weights(model), torch.zeros(4, dtype=torch.int32),
            pc, 0, torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), 0, tcfg, length=3)
    with pytest.raises(ValueError, match="table depth"):
        tkv.paged_chunked_prefill(
            common.torch_weights(model), torch.zeros(16, dtype=torch.int32),
            pc, 0, torch.zeros((4, 1), dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), 0, tcfg, length=3)


def test_chunked_config_validation():
    with pytest.raises(ValueError, match="prefix_reuse"):
        GenerationConfig(kv_layout="paged", block_size=4, chunked_prefill=True)
    with pytest.raises(ValueError, match="power of two"):
        GenerationConfig(kv_layout="paged", block_size=4, prefix_reuse=True,
                         chunked_prefill=True, chunk_blocks=3)
    with pytest.raises(ValueError, match="chunk"):
        GenerationConfig(kv_layout="paged", block_size=4, max_len=16,
                         max_slots=2, prefix_reuse=True,
                         chunked_prefill=True, chunk_blocks=4)
    with pytest.raises(ValueError, match="prefix_reuse"):
        GenerationConfig(kv_layout="paged", block_size=4, host_blocks=4)
    with pytest.raises(ValueError, match="host_admission"):
        GenerationConfig(kv_layout="paged", block_size=4,
                         prefix_reuse=True, host_blocks=4,
                         host_admission="later")
    with pytest.raises(ValueError, match="host_blocks"):
        GenerationConfig(host_blocks=-1)
    gc = GenerationConfig(kv_layout="paged", block_size=4, max_len=16,
                          max_slots=2, prefix_reuse=True,
                          chunked_prefill=True, chunk_blocks=2)
    assert gc.chunk_tokens == 8


def _engine(model, **kw):
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("paged_kernel", True)
    kw.setdefault("block_size", BS)
    kw.setdefault("prefix_reuse", True)
    kw.setdefault("chunked_prefill", True)
    return common.engine(model, **kw)


def _gen(eng):
    return dict(eng.stats()["generation"])


def _cold_hit(model, prompt, **kw):
    eng = _engine(model)
    try:
        cold = eng.generate(prompt, timeout=common.TIMEOUT, **kw)
        b_cold = eng.stats()["last_prefill_bucket"]
        g0 = _gen(eng)
        hit = eng.generate(prompt, timeout=common.TIMEOUT, **kw)
        snap = eng.stats()
        g1 = _gen(eng)
    finally:
        eng.shutdown()
    assert hit["tokens"] == cold["tokens"], (cold, hit)
    blocks = eng.stats()["blocks"]
    assert blocks["used"] == blocks["registered_prefix_blocks"]
    return (b_cold, snap["last_prefill_bucket"],
            g1["prefill_chunks_total"] - g0["prefill_chunks_total"],
            g1["prefill_chunks_skipped_total"]
            - g0["prefill_chunks_skipped_total"],
            g1["prefix_hits_total"] - g0["prefix_hits_total"])


@pytest.mark.parametrize("case,prompt,want", [
    # the hit skips both full chunks, re-prefills the 3-token tail
    ("partial_last_shared_block", PROMPT, (16, 8, 2, 2, 1)),
    # a prompt that is the chain holds one chunk back for the sampled row
    ("prompt_equals_chain", CHAIN, (8, 8, 2, 1, 1)),
    # chain + one token: a 1-token suffix in the smallest bucket
    ("suffix_shorter_than_one_block", CHAIN + [7], (16, 8, 2, 2, 1)),
])
def test_engine_cold_and_hit_streams_equal(model, case, prompt, want):
    assert _cold_hit(model, prompt) == want


def test_engine_hit_chain_at_slot_budget(model):
    """15 tokens, max_new 1: the 3-block chain plus one fresh block fill
    the slot's budget and the suffix bucket overhangs max_len."""
    p15 = PROMPT + [7, 2, 7, 1]
    eng = _engine(model)
    try:
        cold = eng.generate(p15, timeout=common.TIMEOUT, max_new_tokens=1)
        hit = eng.generate(p15, timeout=common.TIMEOUT, max_new_tokens=1)
        assert hit["tokens"] == cold["tokens"]
        assert eng.stats()["last_prefill_bucket"] == 8
        assert _gen(eng)["prefix_hit_blocks_total"] == 3
    finally:
        eng.shutdown()


def test_engine_seeded_sampling_hit_equals_cold(model):
    samp = SamplingParams(temperature=0.7, top_k=8, seed=11)
    b_cold, b_hit, _, _, hits = _cold_hit(model, PROMPT, sampling=samp)
    assert (b_cold, b_hit, hits) == (16, 8, 1)


def test_engine_chunked_spec_on_matches_spec_off(model):
    plain = _engine(model)
    spec = _engine(model, spec=SpecConfig(k=2))
    try:
        for eng in (plain, spec):
            eng.generate(PROMPT, timeout=common.TIMEOUT)
        p_hit = plain.generate(PROMPT, timeout=common.TIMEOUT)
        s_hit = spec.generate(PROMPT, timeout=common.TIMEOUT)
        assert p_hit["tokens"] == s_hit["tokens"]
        assert spec.stats()["last_prefill_bucket"] == 8
    finally:
        plain.shutdown()
        spec.shutdown()


def test_engine_chunked_streams_match_jax_engine(tree, model):
    """Greedy streams of the chunked engine, cold and on a hit, equal the
    JAX chunked engine's."""
    jeng = common.jax_engine(tree, kv_layout="paged", block_size=BS,
                             prefix_reuse=True, chunked_prefill=True)
    eng = _engine(model)
    try:
        for p in (PROMPT, PROMPT, CHAIN + [7]):
            want = jeng.generate(p, timeout=600)["tokens"]
            assert eng.generate(p, timeout=common.TIMEOUT)["tokens"] == want
    finally:
        jeng.shutdown()
        eng.shutdown()


PRESSURE = ([7 + (i % 20) for i in range(12)],
            [11 + (i % 17) for i in range(12)])


def test_host_tier_offload_prefetch_round_trip(model):
    """Pool pressure offloads the cold registered chain to the host tier
    instead of dropping it; the next admission of the prompt waits for
    the prefetch, hits, and streams the cold run's exact tokens, while a
    device-only engine under the same pressure lost the chain (a miss).
    The prefetched blocks hold the offloaded bytes."""
    tiered = _engine(model, max_slots=1, n_blocks=8, host_blocks=8)
    device = _engine(model, max_slots=1, n_blocks=8)
    try:
        cold = tiered.generate(PROMPT, timeout=common.TIMEOUT)
        device.generate(PROMPT, timeout=common.TIMEOUT)
        for p in PRESSURE:
            tiered.generate(p, timeout=common.TIMEOUT)
            device.generate(p, timeout=common.TIMEOUT)
        snap = tiered.stats()
        assert snap["generation"]["kv_offload_blocks_total"] > 0
        assert snap["blocks"]["host_used"] > 0
        assert (snap["blocks"]["host_used"] + snap["blocks"]["host_free"]
                == snap["blocks"]["host_total"])
        staged = {key: {n: x.clone() for n, x in payload.items()}
                  for key, payload in tiered._blocks._host.items()}
        g0t, g0d = _gen(tiered), _gen(device)
        hit = tiered.generate(PROMPT, timeout=common.TIMEOUT)
        device_re = device.generate(PROMPT, timeout=common.TIMEOUT)
        assert hit["tokens"] == cold["tokens"]
        assert device_re["tokens"] == cold["tokens"]
        g1t, g1d = _gen(tiered), _gen(device)
        assert g1t["kv_prefetch_blocks_total"] > 0
        assert g1t["prefix_hits_total"] - g0t["prefix_hits_total"] == 1
        assert g1d["prefix_misses_total"] - g0d["prefix_misses_total"] == 1
        landed = 0
        for key, payload in staged.items():
            blk = tiered._blocks._registry.get(key)
            if blk is None:
                continue
            landed += 1
            for n in ("k", "v"):
                assert torch.equal(tiered._cache[n][:, blk], payload[n])
        assert landed == g1t["kv_prefetch_blocks_total"]
        snap = tiered.stats()
        assert (snap["blocks"]["free"] + snap["blocks"]["used"]
                == snap["blocks"]["total"])
        assert (snap["blocks"]["used"]
                == snap["blocks"]["registered_prefix_blocks"])
    finally:
        tiered.shutdown()
        device.shutdown()


def test_host_tier_miss_policy_admits_without_waiting(model):
    """``host_admission="miss"``: the admission whose chain is on the host
    does not wait, recomputes from its device hits (none) with the cold
    tokens, and the prefetch it staged lands for the next admission."""
    eng = _engine(model, max_slots=1, n_blocks=8, host_blocks=8,
                  host_admission="miss")
    try:
        cold = eng.generate(PROMPT, timeout=common.TIMEOUT)
        for p in PRESSURE:
            eng.generate(p, timeout=common.TIMEOUT)
        assert _gen(eng)["kv_offload_blocks_total"] > 0
        g0 = _gen(eng)
        racing = eng.generate(PROMPT, timeout=common.TIMEOUT)
        assert racing["tokens"] == cold["tokens"]
        g1 = _gen(eng)
        assert g1["prefix_misses_total"] - g0["prefix_misses_total"] == 1
        again = eng.generate(PROMPT, timeout=common.TIMEOUT)
        assert again["tokens"] == cold["tokens"]
        assert _gen(eng)["prefix_hits_total"] - g1["prefix_hits_total"] == 1
    finally:
        eng.shutdown()


def test_block_manager_host_accounting():
    """Manager-level tier accounting (JAX ``test_kv_hierarchy``): the
    two-phase offload, promote, the host copy a re-register drops, and
    gauges that cover every block in both tiers."""
    bm = tkv.BlockManager(6, 4, host_blocks=4)
    toks = np.arange(8, dtype=np.int32)
    blocks = bm.alloc(2)
    bm.register_prefix(toks, blocks, 2,
                       route_digest=tkv.prefix_route_digest(toks, 4))
    bm.release(blocks)
    cands = bm.offload_candidates(2)
    assert len(cands) == 2
    for key, blk in cands:
        assert bm.offload_commit(key, {"blk": blk})
    g = bm.gauges()
    assert g["host_used"] == 2 and g["free"] == 5
    assert bm.lookup_prefix(toks) == []
    cont = bm.host_lookup(toks, 0)
    assert len(cont) == 2
    blk = bm.alloc(1)[0]
    bm.promote(cont[0][0], blk)
    assert bm.lookup_prefix(toks) == [blk]
    assert bm.host_lookup(toks, 1)
    g = bm.gauges()
    assert g["host_used"] == 1 and g["free"] + g["used"] == g["total"]
    assert bm.route_digests() == (tkv.prefix_route_digest(toks, 4),)
    fresh = bm.alloc(2)
    bm.register_prefix(toks, [blk] + fresh[:1], 2)
    assert bm.gauges()["host_used"] == 0

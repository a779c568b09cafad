"""Port parity: the contiguous KV cache (``prefill``, ``decode_step``,
``verify_step``) against the JAX functions, and the port's own contracts
on it.

The JAX side runs jitted on XLA's CPU from the same f32 weights; the
port writes the cache in place. Across the two frameworks the logits
and cache rows agree to f32 summation order (rtol/atol 1e-5 at these
widths). Inside the port, on the CPU: paged and contiguous logits and
greedy/sampled streams are bitwise equal (both read the same dense
attention over the same ``[max_len]`` view), the verify rows are
bitwise the sequential decode rows (GEMM rows are invariant in M at
K <= 256), and the prompt forward's ``attend`` hook leaves the default
path's logits bit for bit as they were.
"""

import jax
import numpy as np
import pytest
import torch

import torch_serve_common as common
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu_torch.ops.attention import flash_attention_prefill
from horovod_tpu_torch.parallel import kv_blocks as tkv
from horovod_tpu_torch.parallel import transformer as ttr
from horovod_tpu_torch.serve import GenerationConfig, SamplingParams

S, L, W, MAX_LEN = 2, 5, 4, 32
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5]


@pytest.fixture(scope="module")
def tree():
    return common.make_tree()


@pytest.fixture(scope="module")
def model(tree):
    return common.torch_model(tree)


def _prompts():
    rng = np.random.RandomState(1)
    return [rng.randint(0, common.DIMS["vocab"], (8,)).astype(np.int32)
            for _ in range(S)]


@pytest.fixture(scope="module")
def runs(tree, model):
    """Both sides: 8-token buckets (true length 5) prefilled into slots 0
    and 1, W greedy decode steps (the JAX side's tokens feed both), then
    one verify of those W tokens from the post-prefill cache."""
    jcfg, tcfg = common.jax_config(), common.torch_config()
    params = common.jax_params(tree)
    w = common.torch_weights(model)
    jpre = jax.jit(lambda p, x, c, s: jtr.prefill(p, x, c, s, jcfg,
                                                  length=L))
    jdec = jax.jit(lambda p, x, c, q: jtr.decode_step(p, x, c, q, jcfg))
    jver = jax.jit(lambda p, x, c, q: jtr.verify_step(p, x, c, q, jcfg))
    jc = jtr.init_kv_cache(jcfg, S, MAX_LEN)
    tc = ttr.init_kv_cache(tcfg, S, MAX_LEN, device="cpu")
    out = {"jpre": [], "tpre": []}
    with torch.no_grad():
        for s, toks in enumerate(_prompts()):
            jc, jl = jpre(params, toks, jc, s)
            tc, tl = ttr.prefill(w, common.t(toks), tc, s, tcfg, length=L)
            out["jpre"].append(np.asarray(jl))
            out["tpre"].append(tl.numpy())
        out["jpre_cache"] = {n: np.asarray(jc[n]) for n in jc}
        out["tpre_cache"] = {n: tc[n].clone().numpy() for n in tc}
        last = np.stack([p[L - 1] for p in out["jpre"]]).argmax(-1)
        last = last.astype(np.int32)
        pos = np.full((S,), L, np.int32)
        jd, td, drafts = jc, {n: x.clone() for n, x in tc.items()}, []
        out["jdec"], out["tdec"] = [], []
        for _ in range(W):
            drafts.append(last.copy())
            jd, jl = jdec(params, last, jd, pos)
            td, tl = ttr.decode_step(w, common.t(last), td, common.t(pos),
                                     tcfg)
            out["jdec"].append(np.asarray(jl))
            out["tdec"].append(tl.numpy())
            last = np.asarray(jl).argmax(-1).astype(np.int32)
            pos = pos + 1
        drafts = np.stack(drafts, axis=1)
        pos0 = np.full((S,), L, np.int32)
        jv, jvl = jver(params, drafts, jc, pos0)
        tv, tvl = ttr.verify_step(w, common.t(drafts), tc, common.t(pos0),
                                  tcfg)
    out.update(jdec_cache={n: np.asarray(jd[n]) for n in jd},
               tdec_cache={n: td[n].numpy() for n in td},
               jver=np.asarray(jvl), tver=tvl.numpy(),
               jver_cache={n: np.asarray(jv[n]) for n in jv},
               tver_cache={n: tv[n].numpy() for n in tv})
    return out


def test_prefill_matches_jax(runs):
    for j, t in zip(runs["jpre"], runs["tpre"]):
        np.testing.assert_allclose(t, j, **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(runs["tpre_cache"][n][:, :, :8],
                                   runs["jpre_cache"][n][:, :, :8], **TOL)
    np.testing.assert_array_equal(runs["tpre_cache"]["lengths"],
                                  runs["jpre_cache"]["lengths"])


def test_decode_step_matches_jax(runs):
    for j, t in zip(runs["jdec"], runs["tdec"]):
        np.testing.assert_allclose(t, j, **TOL)
        np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))
    for n in ("k", "v"):
        np.testing.assert_allclose(runs["tdec_cache"][n],
                                   runs["jdec_cache"][n], **TOL)
    np.testing.assert_array_equal(runs["tdec_cache"]["lengths"],
                                  runs["jdec_cache"]["lengths"])


def test_verify_step_matches_jax(runs):
    np.testing.assert_allclose(runs["tver"], runs["jver"], **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(runs["tver_cache"][n],
                                   runs["jver_cache"][n], **TOL)
    # only column 0's position is claimed
    np.testing.assert_array_equal(runs["tver_cache"]["lengths"], [L + 1] * S)


def test_verify_matches_sequential_decode_bitwise(runs):
    """The port's own contract: verify rows and the K/V they write are
    bitwise the W sequential decode steps'."""
    np.testing.assert_array_equal(runs["tver"],
                                  np.stack(runs["tdec"], axis=1))
    for n in ("k", "v"):
        np.testing.assert_array_equal(runs["tver_cache"][n],
                                      runs["tdec_cache"][n])


def _paged_setup(w, tcfg, bs=4):
    max_blocks = MAX_LEN // bs
    tables = np.full((S, max_blocks), tkv.TRASH_BLOCK, np.int32)
    for s in range(S):
        tables[s] = 1 + s * max_blocks + np.arange(max_blocks)
    cache = tkv.init_paged_kv_cache(tcfg, S * max_blocks + 1, bs, S,
                                    device="cpu")
    for s, toks in enumerate(_prompts()):
        tkv.paged_prefill(w, common.t(toks), cache, s,
                          common.t(tables[s]), tcfg, length=L)
    return cache, tables


def test_paged_verify_matches_sequential_decode_bitwise(model, runs):
    """Paged verify rows and the pool they write are bitwise W sequential
    paged decode steps', through the paged kernel's route (its plain
    version here) and through the gather."""
    tcfg = common.torch_config()
    w = common.torch_weights(model)
    for kernel in (True, False):
        with torch.no_grad():
            cache, tables = _paged_setup(w, tcfg)
            seq = {n: x.clone() for n, x in cache.items()}
            last = np.stack([p[L - 1] for p in runs["tpre"]]).argmax(-1)
            last = last.astype(np.int32)
            pos = np.full((S,), L, np.int32)
            drafts, logs = [], []
            for _ in range(W):
                drafts.append(last.copy())
                _, lg = tkv.paged_decode_step(
                    w, common.t(last), seq, common.t(pos), common.t(tables),
                    tcfg, kernel=kernel)
                logs.append(lg.numpy())
                last = lg.numpy().argmax(-1).astype(np.int32)
                pos = pos + 1
            _, vl = tkv.paged_verify_step(
                w, common.t(np.stack(drafts, axis=1)), cache,
                common.t(np.full((S,), L, np.int32)), common.t(tables),
                tcfg, kernel=kernel)
        np.testing.assert_array_equal(vl.numpy(), np.stack(logs, axis=1))
        for n in ("k", "v"):
            np.testing.assert_array_equal(cache[n].numpy(), seq[n].numpy())
        # and the paged rows are the contiguous ones: same dense math over
        # the same [max_len] view
        np.testing.assert_array_equal(vl.numpy(), runs["tver"])


def test_verify_tail_past_max_len_is_dropped(model):
    """Writes at or past max_len are dropped: the rows inside the cache
    come out exactly as one decode step wrote them."""
    tcfg = common.torch_config()
    w = common.torch_weights(model)
    rng = np.random.RandomState(2)
    with torch.no_grad():
        cache = ttr.init_kv_cache(tcfg, S, 8, device="cpu")
        for s in range(S):
            ttr.prefill(w, common.t(rng.randint(0, 32, (8,)).astype(
                np.int32)), cache, s, tcfg, length=6)
        ref = {n: x.clone() for n, x in cache.items()}
        pos = np.full((S,), 7, np.int32)
        last = np.array([3, 4], np.int32)
        _, ref_lg = ttr.decode_step(w, common.t(last), ref, common.t(pos),
                                    tcfg)
        drafts = np.stack([last, [9, 9], [11, 11]], axis=1).astype(np.int32)
        _, vl = ttr.verify_step(w, common.t(drafts), cache, common.t(pos),
                                tcfg)
    np.testing.assert_array_equal(vl[:, 0].numpy(), ref_lg.numpy())
    for n in ("k", "v"):
        np.testing.assert_array_equal(cache[n].numpy(), ref[n].numpy())


def test_paged_matches_contiguous_model_layer_bitwise(model):
    """With max_len % block_size == 0 the paged prefill and decode steps
    give logits bitwise the contiguous cache's (JAX ``test_paged_kv``'s
    cross-layout contract, held inside the port), through the paged
    kernel's route (its plain version here) and through the gather."""
    tcfg = common.torch_config()
    w = common.torch_weights(model)
    toks = np.random.RandomState(0).randint(0, 32, (6,)).astype(np.int32)
    for kernel in (True, False):
        with torch.no_grad():
            c = ttr.init_kv_cache(tcfg, S, 16, device="cpu")
            _, cl = ttr.prefill(w, common.t(toks), c, 0, tcfg)
            pc = tkv.init_paged_kv_cache(tcfg, 5, 8, S, device="cpu")
            _, pl = tkv.paged_prefill(w, common.t(toks), pc, 0,
                                      common.t(np.array([1, 2], np.int32)),
                                      tcfg)
            np.testing.assert_array_equal(cl.numpy(), pl.numpy())
            tbl = np.full((S, 2), tkv.TRASH_BLOCK, np.int32)
            tbl[0] = [1, 2]
            last = np.full((S,), 7, np.int32)
            pos = np.full((S,), -1, np.int32)
            tok = int(cl[5].argmax())
            for i in range(6, 10):
                last[0], pos[0] = tok, i
                _, dc = ttr.decode_step(w, common.t(last), c, common.t(pos),
                                        tcfg)
                _, dp = tkv.paged_decode_step(w, common.t(last), pc,
                                              common.t(pos), common.t(tbl),
                                              tcfg, kernel=kernel)
                np.testing.assert_array_equal(dc[0].numpy(), dp[0].numpy())
                tok = int(dc[0].argmax())
        assert int(pc["lengths"][0]) == int(c["lengths"][0]) == 10


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_engine_streams_paged_equal_contiguous_bitwise(model, mode):
    """Engine level: the contiguous, paged and paged+prefix engines give
    the same stream, first and on a warm registry (the paged engines
    through the paged kernel's route, its plain version here, and the
    default gather)."""
    samp = (SamplingParams(temperature=0.7, top_k=8, seed=11)
            if mode == "sampled" else None)
    engines = [common.engine(model, kv_layout="contiguous"),
               common.engine(model, kv_layout="paged", paged_kernel=True,
                             block_size=4),
               common.engine(model, kv_layout="paged", paged_kernel=True,
                             block_size=4, prefix_reuse=True),
               common.engine(model, kv_layout="paged", block_size=4)]
    try:
        res = [e.generate(PROMPT, sampling=samp, timeout=common.TIMEOUT)
               for e in engines]
        again = engines[2].generate(PROMPT, sampling=samp,
                                    timeout=common.TIMEOUT)
    finally:
        for e in engines:
            e.shutdown()
    assert (res[0]["tokens"] == res[1]["tokens"] == res[2]["tokens"]
            == res[3]["tokens"])
    assert again["tokens"] == res[0]["tokens"]
    assert engines[2].stats()["generation"]["prefix_hits_total"] == 1
    assert engines[0].stats()["kv_layout"] == "contiguous"
    assert "blocks" not in engines[0].stats()


def _flash_hook(stored):
    def store(li, k, v):
        stored[li] = (k, v)

    def attend(li, q):
        k, v = stored[li]
        return flash_attention_prefill(q, k[None], v[None], causal=True)
    return store, attend


def test_prompt_forward_attend_hook_default_unchanged(model):
    """A hook that runs the default attention itself gives the default
    path's logits bit for bit; a dense hook over the stored rows gives
    the same logits to f32 rounding."""
    tcfg = common.torch_config()
    w = common.torch_weights(model)
    toks = common.t(np.array(PROMPT, np.int32))
    stored = {}
    store, attend = _flash_hook(stored)
    with torch.no_grad():
        plain = ttr.prompt_forward(w, toks, tcfg, store)
        hooked = ttr.prompt_forward(w, toks, tcfg, store, attend=attend)

        def dense(li, q):
            k, v = stored[li]
            T = q.shape[1]
            return torch.stack([
                ttr.cached_attention(q[0, i:i + 1], k[None], v[None],
                                     torch.tensor([i]))[0]
                for i in range(T)])[None]
        densed = ttr.prompt_forward(w, toks, tcfg, store, attend=dense)
    np.testing.assert_array_equal(plain.numpy(), hooked.numpy())
    np.testing.assert_allclose(densed.numpy(), plain.numpy(), **TOL)


def test_contiguous_cache_and_config_validation():
    tcfg = common.torch_config()
    c = ttr.init_kv_cache(tcfg, 3, 8, device="cpu")
    assert c["k"].shape == (2, 3, 8, 2, 8) and c["lengths"].shape == (3,)
    with pytest.raises(ValueError, match="max_len"):
        ttr.prefill({}, torch.zeros(9, dtype=torch.int32), c, 0, tcfg)
    for knob in (dict(prefix_reuse=True), dict(chunked_prefill=True),
                 dict(host_blocks=2)):
        with pytest.raises(ValueError, match="paged"):
            GenerationConfig(kv_layout="contiguous", **knob)
    with pytest.raises(ValueError, match="paged"):
        GenerationConfig(kv_layout="contiguous", n_blocks=8)
    with pytest.raises(ValueError, match="kv_layout"):
        GenerationConfig(kv_layout="ring")

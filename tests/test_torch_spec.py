"""Port parity: speculative decoding. ``serve/spec.py`` against the JAX
module case for case (the drafter, the config, both acceptance rules;
``accept_sampled`` draws from the request's numpy Generator, so its
output must equal the reference's for the same seed), and the engine:
greedy streams of every layout variant, with and without speculation,
equal the JAX engine's, spec-on streams equal spec-off ones, and a
hostile or empty drafter changes no token.

K8's ``plan_rows=`` keyword only steers the card's split plan; on the
CPU the plain version runs and ignores it.
"""

import numpy as np
import pytest
import torch

import torch_serve_common as common
from horovod_tpu.serve import spec as jspec
from horovod_tpu_torch.ops.paged_attention import (
    paged_attention_reference, paged_decode_attention)
from horovod_tpu_torch.serve import SamplingParams
from horovod_tpu_torch.serve import spec as tspec

CONTEXTS = ([5, 6, 7, 9, 5, 6, 7], [1, 2, 9, 1, 2, 8, 1, 2], [1, 2, 3, 4],
            [7], [1, 2, 1, 2], [3, 4, 5, 6, 3, 4], [9, 3, 1, 2, 3],
            list(np.random.RandomState(0).randint(0, 6, 60)))


@pytest.mark.parametrize("window", [(3, 1), (2, 2), (4, 1), (1, 1)])
def test_ngram_proposer_matches_jax(window):
    mx, mn = window
    for ctx in CONTEXTS:
        for k in (0, 1, 2, 3, 99):
            got = tspec.NgramProposer(mx, mn).propose(np.array(ctx), k)
            want = jspec.NgramProposer(mx, mn).propose(np.array(ctx), k)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_ngram_proposer_cases():
    """JAX ``test_spec``'s drafter cases on the port's proposer."""
    p = tspec.NgramProposer()
    np.testing.assert_array_equal(p.propose(np.array([5, 6, 7, 9, 5, 6, 7]),
                                            3), [9, 5, 6])
    assert p.propose(np.array([1, 2, 9, 1, 2, 8, 1, 2]), 1).tolist() == [8]
    assert p.propose(np.array([1, 2, 3, 4]), 3).size == 0
    assert p.propose(np.array([7]), 3).size == 0
    assert p.propose(np.array([1, 2, 1, 2]), 0).size == 0
    assert p.propose(np.array([3, 4, 5, 6, 3, 4]), 2).tolist() == [5, 6]
    assert p.propose(np.array([3, 4, 5, 6, 3, 4]), 99).tolist() == [5, 6,
                                                                     3, 4]
    assert tspec.NgramProposer(min_ngram=2).propose(
        np.array([9, 3, 1, 2, 3]), 2).size == 0
    with pytest.raises(ValueError):
        tspec.NgramProposer(max_ngram=2, min_ngram=3)


def test_spec_config_matches_jax():
    c = tspec.SpecConfig(k=6, max_ngram=4, min_ngram=2)
    assert tspec.SpecConfig.from_spec(c.to_spec()) == c
    assert c.to_spec() == jspec.SpecConfig(
        k=6, max_ngram=4, min_ngram=2).to_spec()
    assert tspec.SpecConfig.from_spec({}) == tspec.SpecConfig()
    for bad in (dict(k=0), dict(min_ngram=5, max_ngram=2)):
        with pytest.raises(ValueError):
            tspec.SpecConfig(**bad)

    class D:
        def propose(self, context, k):
            return np.empty((0,), np.int64)

    c = tspec.SpecConfig(k=2, drafter=D())
    assert c.make_drafter() is c.drafter
    assert isinstance(tspec.SpecConfig().make_drafter(), tspec.NgramProposer)
    assert isinstance(D(), tspec.DraftProposer)
    with pytest.raises(ValueError):
        c.to_spec()


def _onehot_rows(tokens, vocab=8):
    rows = np.full((len(tokens), vocab), -10.0)
    for j, t in enumerate(tokens):
        rows[j, t] = 10.0
    return rows


@pytest.mark.parametrize("rows,draft,want", [
    ([3, 4, 5, 6], [3, 4, 5], ([3, 4, 5, 6], 3)),
    ([3, 7, 5, 6], [3, 4, 5], ([3, 7], 1)),
    ([3, 4, 5, 6], [], ([3], 0)),
    ([1, 4, 5, 6], [3, 4, 5], ([1], 0)),
])
def test_accept_greedy_matches_jax(rows, draft, want):
    r = _onehot_rows(rows)
    assert tspec.accept_greedy(r, draft) == want
    assert jspec.accept_greedy(r, draft) == want


def _probs(r):
    e = np.exp(r - r.max())
    return e / e.sum()


@pytest.mark.parametrize("seed", [0, 1, 42, 7])
def test_accept_sampled_equals_jax_for_the_same_rng(seed):
    """A pure function of the Generator: the port's draws are the
    reference's, draft for draft, and both leave the rng in one state."""
    rng = np.random.RandomState(seed)
    for _ in range(25):
        k = rng.randint(0, 5)
        rows = rng.randn(k + 1, 8) * 2.0
        draft = rng.randint(0, 8, k).tolist()
        ga, ja = np.random.default_rng(seed), np.random.default_rng(seed)
        assert (tspec.accept_sampled(rows, draft, _probs, ga)
                == jspec.accept_sampled(rows, draft, _probs, ja))
        assert ga.random() == ja.random()


def test_accept_sampled_preserves_target_distribution():
    """The marginal over the first emitted token is the target exactly
    (chi-square, df 7, 0.999 critical value 24.32)."""
    vocab, n = 8, 4000
    p = np.arange(1.0, vocab + 1.0)
    p /= p.sum()
    rows = np.stack([np.log(p), np.log(p)])
    rng = np.random.default_rng(0)
    counts = np.zeros(vocab)
    for _ in range(n):
        toks, _ = tspec.accept_sampled(rows, [2], _probs, rng)
        counts[toks[0]] += 1
    chi2 = float((((counts - n * p) ** 2) / (n * p)).sum())
    assert chi2 < 24.32, (chi2, counts / n, p)


def test_accept_sampled_point_mass_edge_accepts_draft():
    p = np.zeros(8)
    p[5] = 1.0
    rows = np.stack([np.log(np.maximum(p, 1e-300))] * 2)
    toks, hits = tspec.accept_sampled(rows, [5], lambda r: p,
                                      np.random.default_rng(0))
    assert toks[0] == 5 and hits >= 1


def test_paged_plan_rows_is_ignored_on_cpu():
    """``plan_rows`` steers the CUDA kernel's split plan only: on CPU
    tensors the wrapper runs the plain version, whatever it is."""
    g = torch.Generator().manual_seed(0)
    S, W, H, d, bs, nb = 2, 3, 2, 8, 4, 4
    q = torch.randn(S * W, H, d, generator=g)
    kp = torch.randn(9, bs, H, d, generator=g)
    vp = torch.randn(9, bs, H, d, generator=g)
    tables = torch.arange(1, 9, dtype=torch.int32).reshape(S, nb)
    tables = tables.repeat_interleave(W, dim=0)
    pos = torch.tensor([3, 4, 5, 9, 10, 11], dtype=torch.int32)
    want = paged_attention_reference(q, kp, vp, tables, pos)
    for rows in (None, S, 1, 64):
        got = paged_decode_attention(q, kp, vp, tables, pos, plan_rows=rows)
        assert torch.equal(got, want)


# -- the engine ----------------------------------------------------------

PROMPTS = ([1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 7, 8], [9, 9, 9, 9, 9])
VARIANTS = {
    "contiguous": dict(kv_layout="contiguous"),
    "paged": dict(kv_layout="paged", block_size=4, n_blocks=64),
    "paged_chunked": dict(kv_layout="paged", block_size=4, n_blocks=64,
                          prefix_reuse=True, chunked_prefill=True),
}
SPEC = tspec.SpecConfig(k=4)
ENGINE = dict(max_slots=2, max_len=32, default_max_new_tokens=10)


def _port_kw(variant):
    """The port engine's knobs: the paged variants read the pool through
    the paged kernel's route (its plain version here), as JAX's engine
    cannot with speculation on."""
    kw = dict(VARIANTS[variant])
    if kw["kv_layout"] == "paged":
        kw["paged_kernel"] = True
    return kw


@pytest.fixture(scope="module")
def tree():
    return common.make_tree()


@pytest.fixture(scope="module")
def model(tree):
    return common.torch_model(tree)


@pytest.fixture(scope="module")
def engines(model):
    built = {}

    def get(variant, spec=None):
        key = (variant, None if spec is None else id(spec))
        if key not in built:
            built[key] = common.engine(model, spec=spec, **ENGINE,
                                       **_port_kw(variant))
        return built[key]

    yield get
    for eng in built.values():
        eng.shutdown(drain=False)


def _streams(eng, prompts=PROMPTS, max_new=10):
    return [eng.submit(p, max_new_tokens=max_new).result(common.TIMEOUT)
            for p in prompts]


@pytest.fixture(scope="module")
def jax_streams(tree):
    """The JAX engine's greedy streams in the contiguous and paged
    layouts, with and without speculation (JAX engines pin streams
    bitwise across these, the chunked layout against itself)."""
    out = {}
    for variant, spec in (("contiguous", None), ("paged", None),
                          ("contiguous", jspec.SpecConfig(k=4)),
                          ("paged", jspec.SpecConfig(k=4))):
        kw = dict(VARIANTS[variant])
        eng = common.jax_engine(tree, spec=spec, **ENGINE, **kw)
        try:
            out[(variant, spec is not None)] = [
                eng.submit(p, max_new_tokens=10).result(600)["tokens"]
                for p in PROMPTS]
        finally:
            eng.shutdown()
    return out


@pytest.mark.parametrize("with_spec", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_streams_match_jax_engine(engines, jax_streams, variant,
                                         with_spec):
    eng = engines(variant, SPEC if with_spec else None)
    got = [r["tokens"] for r in _streams(eng)]
    ref = "contiguous" if variant == "paged_chunked" else variant
    assert got == jax_streams[(ref, with_spec)]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_spec_on_equals_spec_off(engines, variant):
    plain, spec = engines(variant), engines(variant, SPEC)
    for a, b in zip(_streams(plain), _streams(spec)):
        assert a["tokens"] == b["tokens"]
        assert a["finish_reason"] == b["finish_reason"]
        assert a["spec_accept_rate"] is None
        assert b["spec_accept_rate"] is not None
    if spec.stats()["kv_layout"] == "paged":
        blocks = spec.stats()["blocks"]
        assert blocks["used"] == blocks["registered_prefix_blocks"]


def test_acceptance_fires_on_repetitive_prompt(engines):
    spec = engines("contiguous", SPEC)
    _streams(spec)
    snap = spec.stats()
    sp = snap["spec"]
    assert snap["spec_k"] == 4
    assert sp["draft_tokens_total"] > 0 and sp["accept_rate"] > 0
    assert sp["tokens_per_step"] > 1.0
    assert sp["emitted_tokens_total"] > sp["steps_total"]
    assert engines("contiguous").stats()["spec_k"] == 0


def test_sampled_spec_streams_run_to_run_deterministic(engines):
    spec = engines("paged", SPEC)

    def run():
        return [spec.submit(p, max_new_tokens=10, sampling=SamplingParams(
            temperature=0.8, top_k=8, seed=11 + i)).result(common.TIMEOUT)[
                "tokens"] for i, p in enumerate(PROMPTS)]
    assert run() == run()


def test_hostile_drafter_cannot_change_a_stream(engines, model):
    """Garbage drafts (and out-of-vocab ids the engine filters) cost
    verify rows, never a token; every step still emits one."""
    vocab = common.DIMS["vocab"]

    class Hostile:
        def propose(self, context, k):
            return np.array([vocab - 1 - int(context[-1]) % 2, vocab + 7,
                             -3], np.int64)[:k]

    plain = engines("paged")
    bad = common.engine(model, spec=tspec.SpecConfig(k=3, drafter=Hostile()),
                        **ENGINE, **_port_kw("paged"))
    try:
        for a, b in zip(_streams(plain), _streams(bad)):
            assert a["tokens"] == b["tokens"]
    finally:
        bad.shutdown()


def test_empty_drafter_falls_back_to_plain_decode(engines, model):
    class Mute:
        def propose(self, context, k):
            return np.empty((0,), np.int64)

    eng = common.engine(model, spec=tspec.SpecConfig(k=2, drafter=Mute()),
                        **ENGINE, **VARIANTS["contiguous"])
    try:
        for a, b in zip(_streams(engines("contiguous"), max_new=6),
                        _streams(eng, max_new=6)):
            assert a["tokens"] == b["tokens"]
        sp = eng.stats()["spec"]
    finally:
        eng.shutdown()
    assert sp["steps_total"] > 0 and sp["draft_tokens_total"] == 0
    assert sp["tokens_per_step"] == 1.0
    assert sp["verify_ms_p50"] is None


def test_spec_refuses_oversized_k(model):
    with pytest.raises(ValueError, match="max_len"):
        common.engine(model, spec=tspec.SpecConfig(k=4), max_len=4)
    eng = common.engine(model, spec=tspec.SpecConfig(k=3), max_len=4)
    eng.shutdown()

"""Port parity: the paged generation engine against the JAX engine.

Both engines serve the same f32 weights (the JAX ``init_params`` carried
into the port with ``params_from_jax``): the JAX engine in its paged
layout with the Pallas paged-decode kernel (interpret mode), the port's
on the CPU (the kernels' plain versions). Greedy and seeded sampled
streams must be token-identical for a 9-token prompt (bucket 16, dense
attention on the JAX side) and a 130-token prompt (bucket 256, the
Pallas flash kernel). The rest pins the port engine's own contracts:
batch invariance, the HTTP front end, block accounting, deadlines, and
the knobs this slice does not carry.
"""

import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import serve as jserve
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu_torch.convert import params_from_jax
from horovod_tpu_torch.exceptions import (DeadlineExceededError,
                                          ServerClosedError)
from horovod_tpu_torch.parallel.transformer import TransformerConfig
from horovod_tpu_torch.serve import (GenerationConfig, GenerationEngine,
                                     HttpServer, SamplingParams)

DIMS = dict(vocab=64, d_model=256, n_heads=2, n_layers=2, d_ff=256)
ENGINE = dict(max_slots=2, max_len=256, default_max_new_tokens=6)
SHORT = [3, 1, 4, 1, 5, 9, 2, 6, 5]                     # bucket 16
LONG = list(np.random.RandomState(5).randint(0, 64, 130))  # bucket 256
PROMPTS = {"short": SHORT, "long": LONG}
# Greedy streams of this random model repeat one token; seeded sampling
# (numpy, per request, the same code on both sides) varies every token.
SAMPLED = dict(temperature=1.0, top_k=0, seed=3)
TIMEOUT = 120


@pytest.fixture(scope="module")
def tree():
    jcfg = jtr.TransformerConfig(**DIMS, dtype=jnp.float32,
                                 unembed_dtype=jnp.float32)
    params = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  params)


@pytest.fixture(scope="module")
def model(tree):
    cfg = TransformerConfig(**DIMS, dtype=torch.float32,
                            unembed_dtype=torch.float32)
    return params_from_jax(tree, cfg, device="cpu")


@pytest.fixture(scope="module")
def engine(model):
    eng = GenerationEngine(model, GenerationConfig(**ENGINE), device="cpu")
    eng.warmup()
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def jax_streams(tree):
    jcfg = jtr.TransformerConfig(**DIMS, dtype=jnp.float32,
                                 unembed_dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    eng = jserve.GenerationEngine(params, jcfg, jserve.GenerationConfig(
        **ENGINE, kv_layout="paged", paged_kernel=True))
    try:
        return {(name, mode): eng.generate(
                    p, timeout=600, sampling=jserve.SamplingParams(
                        **(SAMPLED if mode == "sampled" else {})))["tokens"]
                for name, p in PROMPTS.items()
                for mode in ("greedy", "sampled")}
    finally:
        eng.shutdown()


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("name", ["short", "long"])
def test_stream_matches_jax_engine(engine, jax_streams, name, mode):
    """f32 decoding from identical weights: the two engines' logits agree
    to ~1e-6 (summation order), far inside any argmax gap, and the
    seeded sampler draws from probabilities that equal to ~1e-6, so
    the streams must be token-identical."""
    sampling = SamplingParams(**(SAMPLED if mode == "sampled" else {}))
    got = engine.generate(PROMPTS[name], sampling=sampling,
                          timeout=TIMEOUT)
    assert got["tokens"] == jax_streams[(name, mode)]
    assert got["finish_reason"] == "length"
    assert got["n_tokens"] == ENGINE["default_max_new_tokens"]
    if mode == "sampled":
        assert len(set(got["tokens"])) > 1


def test_stream_identical_alone_and_mid_batch(engine):
    """Slot rows are independent: a stream decoded next to another one
    (and admitted while it is mid-stream) equals the stream alone."""
    alone = engine.generate(LONG, timeout=TIMEOUT)["tokens"]
    h_other = engine.submit(SHORT, max_new_tokens=12)
    h = engine.submit(LONG)
    assert h.result(TIMEOUT)["tokens"] == alone
    assert h_other.result(TIMEOUT)["n_tokens"] == 12


def test_blocks_return_to_zero_after_drain(model):
    eng = GenerationEngine(model, GenerationConfig(**ENGINE), device="cpu")
    try:
        hs = [eng.submit(p, max_new_tokens=n)
              for p, n in ((SHORT, 3), (LONG, 5), (SHORT[:4], 8))]
        for h in hs:
            h.result(TIMEOUT)
        assert eng.stats()["peak_active_slots"] >= 1
    finally:
        eng.shutdown()
    blocks = eng.stats()["blocks"]
    assert blocks["used"] == 0 and blocks["free"] == blocks["total"]
    assert eng.stats()["generation"]["generations_total"] == 3


def test_http_generate_streams_tokens(engine):
    """One POST /generate: chunked JSON lines, one per token, then the
    done line; the tokens equal the engine's own stream."""
    want = engine.generate(SHORT, timeout=TIMEOUT)["tokens"]
    with HttpServer(engine) as srv:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        try:
            conn.request("POST", "/generate",
                         body=json.dumps({"tokens": SHORT}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            lines = [json.loads(x) for x in
                     resp.read().decode().strip().splitlines()]
            conn.request("GET", "/healthz")
            health = conn.getresponse()
            assert health.status == 200
            assert json.loads(health.read())["status"] == "ok"
        finally:
            conn.close()
    assert [x["token"] for x in lines[:-1]] == want
    assert lines[-1]["done"] is True and lines[-1]["tokens"] == want


def test_sampled_stream_is_seeded(engine):
    """Temperature/top-k sampling is host-side numpy with a per-request
    seed: the same seed gives the same stream."""
    sp = SamplingParams(temperature=0.8, top_k=5, seed=11)
    a = engine.generate(SHORT, sampling=sp, timeout=TIMEOUT)["tokens"]
    b = engine.generate(SHORT, sampling=sp, timeout=TIMEOUT)["tokens"]
    assert a == b


def test_eos_and_length_clamp(engine):
    first = engine.generate(SHORT, timeout=TIMEOUT)["tokens"][0]
    out = engine.generate(SHORT, eos_id=first, timeout=TIMEOUT)
    assert out["finish_reason"] == "eos" and out["tokens"] == [first]
    # max_new clamps to the cache room: max_len - prompt + 1 tokens
    out = engine.generate([1] * 254, max_new_tokens=50, timeout=TIMEOUT)
    assert out["n_tokens"] == 3 and out["finish_reason"] == "length"


def test_deadline_expires_in_queue(engine):
    """A request whose deadline passes before it reaches a slot fails
    with DeadlineExceededError through its handle and is counted."""
    before = engine.stats()["expired_deadline"]
    with pytest.raises(DeadlineExceededError):
        engine.generate(SHORT, deadline_ms=1e-3, timeout=TIMEOUT)
    assert engine.stats()["expired_deadline"] == before + 1


def test_submit_validation(engine):
    with pytest.raises(ValueError, match="non-empty"):
        engine.submit([])
    with pytest.raises(ValueError, match="max_len"):
        engine.submit([1] * 257)
    with pytest.raises(ValueError, match="token ids"):
        engine.submit([64])


@pytest.mark.parametrize("knob", [
    dict(kv_layout="contiguous"), dict(prefix_reuse=True),
    dict(chunked_prefill=True), dict(host_blocks=4),
    dict(tenant_weights={"a": 1.0}), dict(preempt=True)])
def test_later_slice_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match="later slice"):
        GenerationConfig(**knob)


def test_adapters_and_spec_raise(model):
    for kw in (dict(adapters=object()), dict(spec=object())):
        with pytest.raises(NotImplementedError, match="later slice"):
            GenerationEngine(model, GenerationConfig(**ENGINE),
                             device="cpu", **kw)


def test_shutdown_rejects_new_requests(model):
    eng = GenerationEngine(model, GenerationConfig(**ENGINE), device="cpu")
    assert eng.health()[1] == "warming"
    eng.shutdown()
    assert eng.health()[1] == "draining"
    with pytest.raises(ServerClosedError):
        eng.submit(SHORT)

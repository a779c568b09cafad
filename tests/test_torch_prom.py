"""Port parity: the serving plane's Prometheus exposition
(``ServeMetrics.registry``, ``collect_stats``, the engines'
``prom_collect``/``prom_metrics``) and the HTTP front end with both
engines attached (``/predict``, ``/generate``, ``/metrics``,
``/healthz``, ``/stats``) against the JAX package's.

JAX's ``ServeMetrics`` and the port's take the same sequence of ``on_*``
events; the parsed ``render(*collect_stats(...))`` of each must hold the
same series, labels, ``# TYPE``/``# HELP`` lines and values (but the
uptime, and the version label of ``hvd_build_info``). The two generation
engines serving the same traffic expose the same series. ``HttpServer``
takes JAX's signature (F3 in ``ROADMAP.md`` Queue 3): ``HttpServer(eng)``
is the single-shot engine, ``generate=`` the generation engine.
"""

import http.client
import json
import re

import jax
import numpy as np
import pytest
import torch

import torch_serve_common as common
from horovod_tpu import serve as jserve
from horovod_tpu.parallel import lora as jlora
from horovod_tpu.serve import metrics as jmetrics
from horovod_tpu_torch import convert
from horovod_tpu_torch.obs.registry import parse_exposition, render
from horovod_tpu_torch.parallel.lora import LoraConfig
from horovod_tpu_torch.serve import (AdapterRegistry, Engine,
                                     GenerationConfig, GenerationEngine,
                                     HttpServer, ServeConfig, ServeMetrics,
                                     collect_stats)

ITEM = (12,)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5]
EXTRA = dict(max_slots=8, max_len=64, active_slots=1, peak_active_slots=2,
             prefix_hit_rate=0.5, block_size=16, adapters_resident=2,
             spec_k=4, max_queue=64,
             blocks={"total": 10, "free": 6, "used": 4,
                     "registered_prefix_blocks": 1, "host_total": 8,
                     "host_free": 7, "host_used": 1})


def _feed(m):
    """One sequence of serving events, every hook and label path."""
    m.on_submit(3)
    m.on_submit(1)
    m.on_overload()
    m.on_overload("blocks_exhausted")
    m.on_overload("tenant_quota")
    m.on_deadline_expired(12.0)
    m.on_deadline_expired(5.0, tenant="a")
    m.on_batch(8, 5, 3.2, 2)
    m.on_batch(4, 4, 0.7, 0)
    m.on_response(15.0, 2.0)
    m.on_response(150.0, 40.0)
    m.on_first_token(20.0, tenant="a", slo_ms=10.0)
    m.on_first_token(5.0, tenant="b", slo_ms=10.0)
    m.on_first_token(7.0)
    m.on_tokens(5, tenant="a")
    m.on_tokens(4, tenant="b")
    m.on_tokens(3)
    m.on_spec_step(4, 3, 5, 0.2, 1.5)
    m.on_spec_step(0, 0, 1, 0.1, 0.0)
    m.on_prefix(2, 4)
    m.on_prefix(0, 3)
    m.on_kv_offload(3)
    m.on_kv_prefetch(0.004, 2)
    m.on_chunked_prefill(3, 1)
    m.on_preempt("evicted", tenant="a")
    m.on_preempt("resumed")
    m.on_generation_end(10, 0.5, tenant="a")
    m.on_generation_end(6, 0.02, tenant="b")
    m.on_generation_end(1, 0.1)
    m.forget_tenant("b")
    m.on_shutdown_cancel(2)


def _exposition(metrics, collect):
    snap = metrics.snapshot()
    snap.update(EXTRA)
    return render(*collect(snap, metrics.registry, engine="generate"))


def _normalized(parsed):
    out = {}
    for (name, labels), v in parsed.items():
        if name == "hvd_build_info":
            labels = tuple((k, "*" if k == "version" else x)
                           for k, x in labels)
        out[(name, labels)] = v
    return out


@pytest.fixture(scope="module")
def expositions():
    jm, tm = jmetrics.ServeMetrics(), ServeMetrics()
    _feed(jm)
    _feed(tm)
    return (_exposition(jm, jmetrics.collect_stats),
            _exposition(tm, collect_stats))


def test_series_and_labels_equal_jax(expositions):
    want, got = (_normalized(parse_exposition(t)) for t in expositions)
    assert got.keys() == want.keys()
    names = {k[0] for k in got}
    for series in ("hvd_tenant_ttft_seconds_bucket",
                   "hvd_tenant_slo_burn", "hvd_generate_ttft_seconds_sum",
                   "hvd_kv_prefetch_seconds_count", "hvd_rejected_total",
                   "hvd_build_info", "hvd_spec_verify_seconds_bucket",
                   "hvd_tenant_tokens_per_sec_user_bucket"):
        assert series in names, series
    # the evicted tenant's counters folded into "retired"
    assert ("hvd_tenant_tokens_generated_total",
            (("engine", "generate"), ("tenant", "retired"))) in got


def test_type_and_help_lines_equal_jax(expositions):
    want, got = ({ln for ln in t.splitlines() if ln.startswith("#")}
                 for t in expositions)
    assert got == want
    assert sum(ln.startswith("# TYPE hvd_tenant_ttft_seconds histogram")
               for ln in got) == 1


def test_values_equal_jax(expositions):
    want, got = (_normalized(parse_exposition(t)) for t in expositions)
    for key, v in want.items():
        if key[0] == "hvd_uptime_seconds":
            continue
        assert got[key] == pytest.approx(v, rel=1e-12, abs=0), key


def test_build_info_carries_the_version(expositions):
    from horovod_tpu_torch.version import __version__
    parsed = parse_exposition(expositions[1])
    assert parsed[("hvd_build_info", (("engine", "generate"),
                                      ("version", __version__)))] == 1.0


# -- the engines --------------------------------------------------------------

def _mlp():
    rng = np.random.RandomState(0)
    w = {"k0": rng.randn(12, 16), "b0": rng.randn(16),
         "k1": rng.randn(16, 5), "b1": rng.randn(5)}
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in w.items()}


def _apply(w, x):
    return torch.relu(x @ w["k0"] + w["b0"]) @ w["k1"] + w["b1"]


def _predict_engine():
    return Engine(_apply, _mlp(), item_shape=ITEM, device="cpu",
                  config=ServeConfig(max_batch=4, batch_timeout_ms=5))


@pytest.fixture(scope="module")
def tree():
    return common.make_tree()


@pytest.fixture(scope="module")
def jax_adapter():
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jlora.init_adapter(jax.random.PRNGKey(1), common.jax_config(),
                           jlora.LoraConfig(rank=2), b_scale=0.5))


PAGED = dict(max_slots=2, max_len=32, default_max_new_tokens=4,
             kv_layout="paged", block_size=4, prefix_reuse=True)


def test_generation_engine_series_equal_jax(tree, jax_adapter):
    """Both generation engines (paged, a tenant and base traffic) expose
    the same series and labels; the port's carries its version."""
    reg = AdapterRegistry(common.torch_config(), LoraConfig(rank=2),
                          capacity=2, device="cpu")
    reg.load("t0", convert.adapter_from_jax(
        jax_adapter, common.torch_config(), LoraConfig(rank=2),
        device="cpu"))
    jreg = jserve.AdapterRegistry(common.jax_config(),
                                  jlora.LoraConfig(rank=2), capacity=2)
    jreg.load("t0", jax_adapter)
    engines = (GenerationEngine(common.torch_model(tree),
                                GenerationConfig(**PAGED), device="cpu",
                                adapters=reg),
               jserve.GenerationEngine(common.jax_params(tree),
                                       common.jax_config(),
                                       jserve.GenerationConfig(**PAGED),
                                       adapters=jreg))
    texts = []
    try:
        for eng in engines:
            for adapter in ("t0", None):
                eng.submit(PROMPT, adapter=adapter).result(common.TIMEOUT)
            texts.append(eng.prom_metrics())
    finally:
        for eng in engines:
            eng.shutdown()
    got, want = (_normalized(parse_exposition(t)) for t in texts)
    assert got.keys() == want.keys()
    assert ("hvd_tenant_generations_total",
            (("engine", "generate"), ("tenant", "t0"))) in got
    assert engines[0].load() == 0 and engines[0]._active_rows() == 0


def _request(srv, method, path, body=None):
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
    try:
        conn.request(method, path, body=None if body is None
                     else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_http_both_engines(tree):
    """``/predict`` to the single-shot engine, ``/generate`` to the
    generation engine; ``/healthz`` ready only when both are warm;
    ``/stats`` nests the generation snapshot; ``/metrics`` one merged
    exposition labelled ``engine=``."""
    eng = _predict_engine()
    gen = common.engine(common.torch_model(tree), max_len=32,
                        kv_layout="paged", block_size=4)
    try:
        with HttpServer(eng, generate=gen) as srv:
            code, _, body = _request(srv, "GET", "/healthz")
            assert code == 503 and json.loads(body)["status"] == "warming"
            eng.warmup()
            code, _, _ = _request(srv, "GET", "/healthz")
            assert code == 503                    # generate still warming
            gen.warmup()
            code, _, body = _request(srv, "GET", "/healthz")
            assert code == 200 and json.loads(body)["status"] == "ok"

            x = np.random.RandomState(1).randn(*ITEM).astype(np.float32)
            code, _, body = _request(srv, "POST", "/predict",
                                     {"inputs": x.tolist()})
            assert code == 200
            np.testing.assert_allclose(json.loads(body)["outputs"],
                                       eng.infer(x, timeout=30),
                                       rtol=1e-6, atol=1e-6)
            code, _, body = _request(srv, "POST", "/generate",
                                     {"tokens": PROMPT, "stream": False})
            assert code == 200
            assert json.loads(body)["tokens"] == \
                gen.generate(PROMPT, timeout=common.TIMEOUT)["tokens"]

            code, _, body = _request(srv, "GET", "/stats")
            snap = json.loads(body)
            assert snap["buckets"] == [1, 2, 4]
            assert snap["responses_total"] >= 2
            assert snap["generate"]["kv_layout"] == "paged"

            code, headers, body = _request(srv, "GET", "/metrics")
            assert code == 200
            assert headers["Content-Type"] == \
                "text/plain; version=0.0.4; charset=utf-8"
            text = body.decode()
            assert text.count("# TYPE hvd_requests_total counter") == 1
            parsed = parse_exposition(text)
            for engine in ("predict", "generate"):
                assert any(k[0] == "hvd_build_info"
                           and ("engine", engine) in k[1] for k in parsed)
            assert parsed[("hvd_request_seconds_count",
                           (("engine", "predict"),))] >= 2
            assert parsed[("hvd_generate_ttft_seconds_count",
                           (("engine", "generate"),))] >= 1
            assert ("hvd_kv_blocks_free", (("engine", "generate"),)) \
                in parsed

            code, _, _ = _request(srv, "POST", "/predict",
                                  {"inputs": [[1.0, 2.0]]})
            assert code == 400
            code, _, _ = _request(srv, "POST", "/predict", {"x": 1})
            assert code == 400
            code, _, _ = _request(srv, "GET", "/nope")
            assert code == 404
            gen.shutdown()
            code, _, body = _request(srv, "GET", "/healthz")
            assert code == 503 and json.loads(body)["status"] == "draining"
    finally:
        eng.shutdown()
        gen.shutdown()


def test_http_server_signature_is_jax(tree):
    """F3: ``HttpServer(engine)`` serves the single-shot engine (its
    ``/predict``), ``HttpServer(generate=...)`` the generation engine,
    and neither alone raises; with no engine it is JAX's ValueError."""
    with pytest.raises(ValueError, match="engine="):
        HttpServer()
    eng = _predict_engine()
    gen = common.engine(common.torch_model(tree))
    try:
        eng.warmup()
        gen.warmup()
        x = np.zeros(ITEM, np.float32)
        with HttpServer(eng) as srv:
            code, _, body = _request(srv, "POST", "/predict",
                                     {"inputs": x.tolist()})
            assert code == 200 and len(json.loads(body)["outputs"]) == 5
            code, _, _ = _request(srv, "POST", "/generate",
                                  {"tokens": PROMPT})
            assert code == 404
            code, _, body = _request(srv, "GET", "/metrics")
            assert re.search(rb'engine="predict"', body)
            assert not re.search(rb'engine="generate"', body)
        with HttpServer(generate=gen) as srv:
            code, _, _ = _request(srv, "POST", "/predict",
                                  {"inputs": x.tolist()})
            assert code == 404
            code, _, body = _request(srv, "POST", "/generate",
                                     {"tokens": PROMPT, "stream": False})
            assert code == 200 and len(json.loads(body)["tokens"]) == 4
            code, _, body = _request(srv, "GET", "/stats")
            assert "generate" not in json.loads(body)
    finally:
        eng.shutdown()
        gen.shutdown()

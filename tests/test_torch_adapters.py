"""Port parity: the multi-tenant plane (``serve/adapters.py``, the
engine's ``adapters=``, ``save_adapter``/``restore_adapter``) against the
JAX package's.

Both engines serve the JAX KV tests' tiny f32 model and the same two JAX
``init_adapter`` trees (``b_scale=0.5``: distinct tenants), carried into
the port with ``convert.adapter_from_jax``. Mixed-adapter streams, greedy
and seeded, are token-identical to the JAX engine's on both layouts;
each tenant alone is bitwise the same tenant in a mixed batch, and base
traffic through the adapter engine is bitwise a plain engine's. The
registry drills, the tenant-salted prefix registry, the evict fold of
the tenant metrics and the adapter checkpoint round trip pin the rest.
"""

import http.client
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

import torch_serve_common as common
from horovod_tpu import serve as jserve
from horovod_tpu.parallel import lora as jlora
from horovod_tpu.serve.adapters import AdapterRegistry as JaxRegistry
from horovod_tpu_torch import convert
from horovod_tpu_torch.exceptions import (CheckpointCorruptError,
                                          ServerOverloadedError)
from horovod_tpu_torch.parallel import checkpoint as tckpt
from horovod_tpu_torch.parallel.lora import LoraConfig
from horovod_tpu_torch.serve import (AdapterRegistry, GenerationConfig,
                                     GenerationEngine, HttpServer,
                                     SamplingParams)

PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5]
RANK = 2
ENGINE = dict(max_slots=4, max_len=16, default_max_new_tokens=6)
SAMPLED = SamplingParams(temperature=0.7, top_k=8, seed=11)
TIMEOUT = 120


@pytest.fixture(scope="module")
def tree():
    return common.make_tree()


@pytest.fixture(scope="module")
def model(tree):
    return common.torch_model(tree)


@pytest.fixture(scope="module")
def jax_adapters():
    lora = jlora.LoraConfig(rank=RANK)
    return {f"a{i}": jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jlora.init_adapter(jax.random.PRNGKey(1 + i), common.jax_config(),
                           lora, b_scale=0.5)) for i in range(2)}


def _port(tree_np):
    return convert.adapter_from_jax(tree_np, common.torch_config(),
                                    LoraConfig(rank=RANK), device="cpu")


def _registry(jax_adapters, names=("a0", "a1"), capacity=3):
    reg = AdapterRegistry(common.torch_config(), LoraConfig(rank=RANK),
                          capacity=capacity, device="cpu")
    for n in names:
        reg.load(n, _port(jax_adapters[n]))
    return reg


def _jax_registry(jax_adapters, names=("a0", "a1")):
    reg = JaxRegistry(common.jax_config(), jlora.LoraConfig(rank=RANK),
                      capacity=3)
    for n in names:
        reg.load(n, jax_adapters[n])
    return reg


def _engine(model, adapters=None, **kw):
    cfg = dict(ENGINE)
    cfg.update(kw)
    return GenerationEngine(model, GenerationConfig(**cfg), device="cpu",
                            adapters=adapters)


def _jax_engine(tree, adapters=None, **kw):
    cfg = dict(ENGINE)
    cfg.update(kw)
    return jserve.GenerationEngine(common.jax_params(tree),
                                   common.jax_config(),
                                   jserve.GenerationConfig(**cfg),
                                   adapters=adapters)


LAYOUTS = {"contiguous": {}, "paged": dict(kv_layout="paged", block_size=4)}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def engines(request, tree, model, jax_adapters):
    """A plain port engine, a port adapter engine and the JAX adapter
    engine, in one layout."""
    kw = LAYOUTS[request.param]
    engs = {"plain": _engine(model, **kw),
            "adapter": _engine(model, _registry(jax_adapters), **kw),
            "jax": _jax_engine(tree, _jax_registry(jax_adapters), **kw)}
    yield engs
    for e in engs.values():
        e.shutdown()


def _mixed(eng, **kw):
    hs = [eng.submit(PROMPT, adapter=t, **kw) for t in ("a0", "a1", None)]
    return [h.result(TIMEOUT) for h in hs]


@pytest.mark.parametrize("sampling", [None, SAMPLED],
                         ids=["greedy", "seeded"])
def test_mixed_streams_match_jax(engines, sampling):
    kw = {} if sampling is None else {"sampling": sampling}
    got = _mixed(engines["adapter"], **kw)
    want = _mixed(engines["jax"], **kw)
    assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
    assert [r["tenant"] for r in got] == ["a0", "a1", "base"]
    assert [r["adapter"] for r in got] == ["a0", "a1", None]
    # the tenants really differ from each other and from the base
    toks = [tuple(r["tokens"]) for r in got]
    assert len(set(toks)) == 3


@pytest.mark.parametrize("sampling", [None, SAMPLED],
                         ids=["greedy", "seeded"])
def test_each_tenant_alone_bitwise_mixed(engines, sampling):
    """A tenant's stream alone equals the same tenant in a mixed batch,
    and base traffic through the adapter engine equals a plain
    engine's."""
    kw = {} if sampling is None else {"sampling": sampling}
    eng = engines["adapter"]
    alone = {t: eng.generate(PROMPT, adapter=t, timeout=TIMEOUT,
                             **kw)["tokens"] for t in ("a0", "a1")}
    base = engines["plain"].generate(PROMPT, timeout=TIMEOUT, **kw)
    mixed = _mixed(eng, **kw)
    assert mixed[0]["tokens"] == alone["a0"]
    assert mixed[1]["tokens"] == alone["a1"]
    assert mixed[2]["tokens"] == base["tokens"]
    assert eng.generate(PROMPT, timeout=TIMEOUT, **kw)["tokens"] == \
        base["tokens"]


def test_registry_load_evict_refcount_drill(jax_adapters):
    reg = AdapterRegistry(common.torch_config(), LoraConfig(rank=RANK),
                          capacity=2, device="cpu")
    assert reg.resident() == ()
    i0 = reg.load("a0", _port(jax_adapters["a0"]), quota=3)
    assert reg.index_of("a0") == i0 and reg.quota("a0") == 3
    row = reg.table()["layers"][0]["wqkv"]["a"][i0]
    np.testing.assert_array_equal(
        row.numpy(), jax_adapters["a0"]["layers"][0]["wqkv"]["a"])
    before = reg.table()
    i1 = reg.load("a1", jax_adapters["a1"])      # numpy leaves load too
    assert i1 != i0 and reg.resident() == ("a0", "a1")
    # a load swaps in a new table; the old one is never written
    assert reg.table() is not before
    assert not before["layers"][0]["wqkv"]["a"][i1].any()
    with pytest.raises(ValueError, match="table full"):
        reg.load("a2", jax_adapters["a0"])
    assert reg.retain("a0") == i0 and reg.refcount("a0") == 1
    with pytest.raises(RuntimeError, match="referenced"):
        reg.evict("a0")
    with pytest.raises(RuntimeError, match="hot-reload"):
        reg.load("a0", jax_adapters["a1"])
    reg.release("a0")
    with pytest.raises(RuntimeError, match="unretained"):
        reg.release("a0")
    gen = reg.generation("a0")
    reg.load("a0", jax_adapters["a1"])           # hot reload, same row
    assert reg.index_of("a0") == i0 and reg.generation("a0") == gen + 1
    seen = []
    reg.add_evict_listener(seen.append)
    reg.evict("a0")
    assert seen == ["a0"] and reg.quota("a0") is None
    with pytest.raises(ValueError, match="no adapter"):
        reg.evict("a0")
    with pytest.raises(ValueError, match="not resident"):
        reg.retain("a0")
    reg.remove_evict_listener(seen.append)
    reg.remove_evict_listener(seen.append)       # idempotent
    g = reg.gauges()
    assert g["capacity"] == 2 and g["resident"] == 1 and g["free_rows"] == 1
    assert g["loads_total"] == 3 and g["evictions_total"] == 1


def _gated_load(monkeypatch, reg, name, adapter):
    """Start ``reg.load(name, adapter)`` on a thread that stops inside the
    table copy until the returned gate is set; returns (thread, gate,
    errors) once the copy has begun."""
    from horovod_tpu_torch.serve import adapters as tadapters
    inside, gate, errors = threading.Event(), threading.Event(), []
    real = tadapters._with_row

    def slow(row):
        one = real(row)

        def leaf(*a):
            inside.set()
            assert gate.wait(TIMEOUT)
            return one(*a)
        return leaf

    monkeypatch.setattr(tadapters, "_with_row", slow)

    def run():
        try:
            reg.load(name, adapter)
        except Exception as e:  # noqa: BLE001 — read by the test
            errors.append(e)
    t = threading.Thread(target=run)
    t.start()
    assert inside.wait(TIMEOUT)
    return t, gate, errors


def _call_on_thread(fn, *args):
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except Exception as e:  # noqa: BLE001 — read by the test
            out["error"] = e
    t = threading.Thread(target=run)
    t.start()
    return t, out


def test_registry_retain_waits_for_a_hot_reload(monkeypatch, jax_adapters):
    """A retain that arrives while a hot reload copies the table waits for
    the swap: it never holds the row across two generations (prefill on
    the old weights, decode on the new), and the reload's
    referenced-check is not skipped."""
    reg = _registry(jax_adapters, names=("a0",))
    gen = reg.generation("a0")
    loader, gate, errors = _gated_load(monkeypatch, reg, "a0",
                                       jax_adapters["a1"])
    getter, got = _call_on_thread(
        lambda: (reg.retain("a0"), reg.generation("a0")))
    getter.join(0.3)
    assert getter.is_alive(), "retain ran inside a load's table swap"
    gate.set()
    loader.join(TIMEOUT)
    getter.join(TIMEOUT)
    assert not errors and "error" not in got
    assert got["value"] == (reg.index_of("a0"), gen + 1)
    np.testing.assert_array_equal(
        reg.table()["layers"][0]["wqkv"]["a"][reg.index_of("a0")].numpy(),
        jax_adapters["a1"]["layers"][0]["wqkv"]["a"])
    assert reg.refcount("a0") == 1


def test_registry_evict_waits_for_a_load(monkeypatch, jax_adapters):
    """An evict that arrives while the same name's reload copies the
    table waits for the swap, so the row ends free exactly once and
    unnamed; the next tenant's load takes it without touching another
    tenant's row."""
    reg = _registry(jax_adapters, names=("a0", "a1"), capacity=3)
    keep = reg.index_of("a1")
    keep_row = reg.table()["layers"][0]["wqkv"]["a"][keep].clone()
    loader, gate, errors = _gated_load(monkeypatch, reg, "a0",
                                       jax_adapters["a1"])
    evicter, got = _call_on_thread(reg.evict, "a0")
    evicter.join(0.3)
    assert evicter.is_alive(), "evict ran inside a load's table swap"
    gate.set()
    loader.join(TIMEOUT)
    evicter.join(TIMEOUT)
    assert not errors and "error" not in got
    assert reg.resident() == ("a1",)
    g = reg.gauges()
    assert g["free_rows"] == 2 and g["resident"] == 1
    monkeypatch.undo()
    rows = {reg.load(n, jax_adapters["a0"]) for n in ("b0", "b1")}
    assert keep not in rows and len(rows) == 2
    assert torch.equal(reg.table()["layers"][0]["wqkv"]["a"][keep],
                       keep_row)


def test_registry_names_policy_and_shapes(jax_adapters):
    reg = AdapterRegistry(common.torch_config(), LoraConfig(rank=RANK),
                          capacity=2, device="cpu")
    for bad in ("base", "retired", "a b", ""):
        with pytest.raises(ValueError):
            reg.load(bad, jax_adapters["a0"])
    with pytest.raises(ValueError, match="weight"):
        reg.load("a0", jax_adapters["a0"], weight=0)
    with pytest.raises(ValueError, match="slo_ttft_ms"):
        reg.load("a0", jax_adapters["a0"], slo_ttft_ms=0)
    with pytest.raises(ValueError, match="layer 0 target"):
        bad = {"layers": [dict(x) for x in jax_adapters["a0"]["layers"]]}
        bad["layers"][0] = dict(bad["layers"][0])
        bad["layers"][0]["w1"] = {"a": np.zeros((3, RANK), np.float32),
                                  "b": bad["layers"][0]["w1"]["b"]}
        reg.load("a0", bad)
    assert reg.resident() == ()
    reg.load("a0", jax_adapters["a0"], quota=2, weight=3.0, priority=1,
             slo_ttft_ms=50.0)
    assert (reg.quota("a0"), reg.weight("a0"), reg.priority("a0"),
            reg.slo_ttft_ms("a0")) == (2, 3.0, 1, 50.0)
    reg.set_quota("base", 1)
    reg.set_weight("base", 2.0)
    reg.set_priority("base", 2)
    reg.set_slo_ttft_ms("base", 10.0)
    assert (reg.quota("base"), reg.weight("base"), reg.priority("base"),
            reg.slo_ttft_ms("base")) == (1, 2.0, 2, 10.0)
    with pytest.raises(ValueError, match="quota"):
        reg.set_quota("base", 0)
    for setter in (reg.set_quota, reg.set_weight, reg.set_priority,
                   reg.set_slo_ttft_ms):
        setter("base", None)
    assert reg.quota("base") is None and reg.priority("base") is None
    with pytest.raises(ValueError, match="capacity"):
        AdapterRegistry(common.torch_config(), LoraConfig(rank=RANK),
                        capacity=0, device="cpu")


def test_engine_refuses_a_foreign_registry(model, jax_adapters):
    with pytest.raises(TypeError, match="AdapterRegistry"):
        _engine(model, adapters=object())
    from horovod_tpu_torch.parallel.transformer import TransformerConfig
    other = AdapterRegistry(TransformerConfig(d_model=32, n_heads=2,
                                              n_layers=2, d_ff=32),
                            LoraConfig(rank=RANK), device="cpu")
    with pytest.raises(ValueError, match="model shape"):
        _engine(model, adapters=other)


def test_quota_rejection_split_and_release(model, jax_adapters):
    reg = _registry(jax_adapters, names=("a0",), capacity=2)
    reg.set_quota("a0", 1)
    eng = _engine(model, reg, kv_layout="paged", block_size=4)
    try:
        h1 = eng.submit(PROMPT, adapter="a0", max_new_tokens=8)
        with pytest.raises(ServerOverloadedError, match="quota") as ei:
            eng.submit(PROMPT, adapter="a0")
        assert 50.0 <= ei.value.retry_after_ms <= 30000.0
        assert h1.result(TIMEOUT)["n_tokens"] == 8
        assert eng.generate(PROMPT, adapter="a0",
                            timeout=TIMEOUT)["n_tokens"] >= 1
        snap = eng.stats()
        assert snap["rejected_tenant_quota"] == 1
        assert snap["rejected_overload"] == 1
        assert snap["rejected_slots_full"] == 0
        assert snap["adapter_table"]["refcounts"]["a0"] == 0
    finally:
        eng.shutdown()


def test_unknown_adapter_and_no_registry_errors(model, jax_adapters):
    plain = _engine(model)
    eng = _engine(model, _registry(jax_adapters))
    try:
        with pytest.raises(ValueError, match="load"):
            eng.submit(PROMPT, adapter="nope")
        with pytest.raises(ValueError, match="AdapterRegistry"):
            plain.submit(PROMPT, adapter="a0")
        with pytest.raises(ValueError, match="AdapterRegistry"):
            plain.load_adapter("a0", jax_adapters["a0"])
        assert plain.adapter_names() is None
        assert plain.adapters_resident() is None and plain.adapters is None
        assert eng.adapter_names() == ("a0", "a1")
        assert eng.adapters_resident() == 2
        assert eng.load_adapter("a2", jax_adapters["a0"]) == 2
        assert eng.adapters_resident() == 3
    finally:
        plain.shutdown()
        eng.shutdown()


def test_prefix_reuse_is_tenant_salted(tree, model, jax_adapters):
    """A tenant's registered prefix never serves base (or a reloaded
    adapter of the same name); each identity hits its own prefix, with
    JAX's counts."""
    reg = _registry(jax_adapters, names=("a0",), capacity=2)
    jreg = _jax_registry(jax_adapters, names=("a0",))
    kw = dict(kv_layout="paged", block_size=4, prefix_reuse=True)
    eng, jeng = _engine(model, reg, **kw), _jax_engine(tree, jreg, **kw)
    plain = _engine(model)
    try:
        for e, r in ((eng, reg), (jeng, jreg)):
            first = e.generate(PROMPT, adapter="a0", timeout=TIMEOUT)
            base = e.generate(PROMPT, timeout=TIMEOUT)
            e.generate(PROMPT, timeout=TIMEOUT)
            hit = e.generate(PROMPT, adapter="a0", timeout=TIMEOUT)
            assert hit["tokens"] == first["tokens"]
            hits = e.stats()["generation"]["prefix_hits_total"]
            r.evict("a0")
            r.load("a0", jax_adapters["a1"] if e is jeng
                   else _port(jax_adapters["a1"]))
            reloaded = e.generate(PROMPT, adapter="a0", timeout=TIMEOUT)
            snap = e.stats()["generation"]
            assert snap["prefix_hits_total"] == hits == 2
            assert snap["prefix_misses_total"] == 3
            assert reloaded["tokens"] != first["tokens"]
            if e is eng:
                port = (first, base, reloaded)
            else:
                ref = (first, base, reloaded)
        assert [x["tokens"] for x in port] == [x["tokens"] for x in ref]
        assert port[1]["tokens"] == plain.generate(
            PROMPT, timeout=TIMEOUT)["tokens"]
        digests = set(eng.prefix_digests())
        assert digests == set(jeng.prefix_digests())
    finally:
        for e in (eng, jeng, plain):
            e.shutdown()


def test_evict_folds_tenant_metric_state(model, jax_adapters):
    reg = _registry(jax_adapters, names=("a0",), capacity=2)
    eng = _engine(model, reg)
    try:
        r = eng.generate(PROMPT, adapter="a0", timeout=TIMEOUT)
        eng.generate(PROMPT, timeout=TIMEOUT)
        snap = eng.stats()
        assert snap["tenants"]["a0"]["generations_total"] == 1
        assert snap["tenants"]["base"]["generations_total"] == 1
        assert snap["tenants"]["a0"]["ttft_p50"] is not None
        reg.evict("a0")
        snap = eng.stats()
        assert "a0" not in snap["tenants"]
        assert snap["tenants"]["retired"]["generations_total"] == 1
        assert snap["tenants"]["retired"]["tokens_generated_total"] == \
            r["n_tokens"]
        assert snap["adapters_resident"] == 0
    finally:
        eng.shutdown()
    # the engine unhooked its listener at shutdown
    reg.load("a1", jax_adapters["a1"])
    reg.evict("a1")
    assert "a1" not in eng.stats()["tenants"]


def test_base_only_engine_has_no_tenant_split(model):
    eng = _engine(model)
    try:
        eng.generate(PROMPT, timeout=TIMEOUT)
        snap = eng.stats()
        assert snap["tenants"] == {}
        assert "adapters_resident" not in snap
    finally:
        eng.shutdown()


def test_http_adapter_field_and_healthz(model, jax_adapters):
    eng = _engine(model, _registry(jax_adapters))
    try:
        eng.warmup()
        want = eng.generate(PROMPT, adapter="a1", timeout=TIMEOUT)["tokens"]
        with HttpServer(generate=eng) as srv:
            conn = http.client.HTTPConnection(srv.host, srv.port,
                                              timeout=60)
            conn.request("POST", "/generate", body=json.dumps(
                {"tokens": PROMPT, "adapter": "a1", "stream": False}))
            body = json.loads(conn.getresponse().read())
            assert body["tokens"] == want and body["tenant"] == "a1"
            conn.request("POST", "/generate", body=json.dumps(
                {"tokens": PROMPT, "adapter": "nope", "stream": False}))
            resp = conn.getresponse()
            assert resp.status == 400 and b"not resident" in resp.read()
            conn.request("GET", "/healthz")
            health = json.loads(conn.getresponse().read())
            assert health["adapters_resident"] == 2
            conn.close()
    finally:
        eng.shutdown()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree)


def test_adapter_checkpoint_round_trip_and_corrupt_leaf(tmp_path, model,
                                                        jax_adapters):
    """save_adapter/restore_adapter round trip bitwise (the manifest is
    JAX's, with ``adapter_name``); a flipped byte in one leaf raises
    CheckpointCorruptError naming the path and the leaf, and the engine's
    base weights are untouched."""
    d = str(tmp_path)
    port = _port(jax_adapters["a0"])
    path = tckpt.save_adapter(d, "a0", port)
    assert path == os.path.join(d, "adapter_a0")
    assert tckpt.adapter_path(d, "a0") == path
    man = tckpt.read_manifest(path)
    assert man["adapter_name"] == "a0" and len(man["leaves"]) == 16
    back = tckpt.restore_adapter(d, "a0")
    for (ka, a), (kb, b) in zip(_leaves(back), _leaves(jax_adapters["a0"])):
        assert ka == kb
        np.testing.assert_array_equal(a, b)
    # JAX's manifest check accepts the port's records
    from horovod_tpu.parallel.checkpoint import _verify_leaves
    _verify_leaves(path, man, back)
    eng = _engine(model, _registry(jax_adapters, names=()))
    try:
        eng.load_adapter("a0", back)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        leaf = sorted(os.listdir(os.path.join(path, "leaves")))[3]
        victim = os.path.join(path, "leaves", leaf)
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) - 5)
            b = f.read(1)
            f.seek(os.path.getsize(victim) - 5)
            f.write(bytes([b[0] ^ 0xFF]))
        with pytest.raises(CheckpointCorruptError) as ei:
            tckpt.restore_adapter(d, "a0")
        assert path in str(ei.value) and "CRC" in str(ei.value)
        assert all(torch.equal(v, before[k])
                   for k, v in model.state_dict().items())
        assert eng.generate(PROMPT, adapter="a0",
                            timeout=TIMEOUT)["n_tokens"] >= 1
    finally:
        eng.shutdown()
    with pytest.raises(FileNotFoundError):
        tckpt.restore_adapter(d, "missing")
    with pytest.raises(ValueError):
        tckpt.adapter_path(d, "base")
    os.remove(os.path.join(path, "hvd_manifest.json"))
    with pytest.raises(CheckpointCorruptError, match="cannot verify"):
        tckpt.restore_adapter(d, "a0")
    assert tckpt.restore_adapter(d, "a0", verify=False) is not None

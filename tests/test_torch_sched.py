"""Port parity: the fair scheduler (``serve/sched.py``), per-tenant block
budgets and preempt-by-evict in the engine, against the JAX package's.

``FairScheduler.pick`` sequences equal JAX's on the same held lines,
weights, priorities and blocked sets. On the JAX KV tests' tiny f32
model: a tenant over its block budget is rejected alone; a stream
preempted by a higher-priority tenant ends bitwise its unpreempted run
(greedy and seeded, both layouts) and equal to the JAX engine's
preempted stream; past ``preempt_retries`` it fails with
``PreemptedError``; ``preempt=False`` never evicts.
"""

import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import torch_serve_common as common
from horovod_tpu import serve as jserve
from horovod_tpu.parallel import lora as jlora
from horovod_tpu.serve.adapters import AdapterRegistry as JaxRegistry
from horovod_tpu.serve.sched import FairScheduler as JaxScheduler
from horovod_tpu_torch import convert
from horovod_tpu_torch.exceptions import (PreemptedError,
                                          ServerOverloadedError)
from horovod_tpu_torch.parallel.lora import LoraConfig
from horovod_tpu_torch.serve import (AdapterRegistry, FairScheduler,
                                     GenerationConfig, GenerationEngine,
                                     SamplingParams)

PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5]
PROMPT2 = [2, 7, 1, 8, 2, 8, 1, 8, 2]
RANK = 2
TIMEOUT = 120
SAMPLED = SamplingParams(temperature=0.9, top_k=5, seed=7)


def _r(tenant):
    return SimpleNamespace(tenant=tenant)


@pytest.mark.parametrize("seed", range(6))
def test_pick_sequences_match_jax(seed):
    """Random held lines over five tenants with random weights, priority
    classes and blocked sets: every pick, and the deficit state it
    leaves, equals JAX's; admitted requests leave the line."""
    rng = np.random.RandomState(seed)
    tenants = ["base", "a", "b", "c", "d"]
    weights = {t: float(rng.choice([0.5, 1.0, 2.0, 3.0])) for t in tenants}
    prios = {t: int(rng.choice([0, 0, 1])) for t in tenants}
    ours = FairScheduler(weights.__getitem__, prios.__getitem__)
    ref = JaxScheduler(weights.__getitem__, prios.__getitem__)
    held = [_r(t) for t in rng.choice(tenants, 40)]
    for _ in range(60):
        blocked = frozenset(t for t in tenants if rng.rand() < 0.2)
        i, j = ours.pick(held, blocked=blocked), ref.pick(held,
                                                         blocked=blocked)
        assert i == j
        assert ours._deficit == ref._deficit
        if i is not None and rng.rand() < 0.7:
            held.pop(i)
        if rng.rand() < 0.3:
            held.append(_r(str(rng.choice(tenants))))
        if rng.rand() < 0.1:
            t = str(rng.choice(tenants))
            ours.forget(t)
            ref.forget(t)


def test_pick_rules():
    """The DRR rules, as JAX's tests state them: weights are shares, one
    tenant is FIFO, blocked tenants keep their deficit and hold nobody,
    priority classes are strict, weights must be positive."""
    sched = FairScheduler({"a": 3.0, "b": 1.0}.__getitem__)
    held = [_r("a")] * 8 + [_r("b")] * 8
    picks = [held[sched.pick(held)].tenant for _ in range(8)]
    assert picks.count("a") == 6 and picks.count("b") == 2
    fifo = FairScheduler(lambda t: 1.0)
    assert all(fifo.pick([_r("base")] * 5) == 0 for _ in range(5))
    assert fifo.pick([_r("a")], blocked=frozenset({"a"})) is None
    assert fifo.pick([]) is None
    strict = FairScheduler({"lo": 100.0, "hi": 1.0}.__getitem__,
                           {"lo": 0, "hi": 1}.__getitem__)
    held = [_r("lo")] * 4 + [_r("hi")] * 2
    assert [held.pop(strict.pick(held)).tenant for _ in range(4)] == \
        ["hi", "hi", "lo", "lo"]
    with pytest.raises(ValueError, match="weight"):
        FairScheduler(lambda t: 0.0).pick([_r("a")])
    keep = FairScheduler({"a": 2.0, "b": 1.0}.__getitem__)
    held = [_r("a")] * 4 + [_r("b")] * 4
    assert held[keep.pick(held)].tenant == "a"
    for _ in range(2):
        assert held[keep.pick(held, blocked=frozenset({"a"}))].tenant == "b"
    assert held[keep.pick(held)].tenant == "a"
    keep.forget("a")
    keep.forget("never-seen")
    assert "a" not in keep._deficit


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


def _registry(jax_adapters, names=("a0",)):
    reg = AdapterRegistry(common.torch_config(), LoraConfig(rank=RANK),
                          capacity=3, device="cpu")
    for n in names:
        reg.load(n, convert.adapter_from_jax(
            jax_adapters[n], common.torch_config(), LoraConfig(rank=RANK),
            device="cpu"))
    return reg


def _jax_registry(jax_adapters, names=("a0",)):
    reg = JaxRegistry(common.jax_config(), jlora.LoraConfig(rank=RANK),
                      capacity=3)
    for n in names:
        reg.load(n, jax_adapters[n])
    return reg


DEFAULTS = dict(max_slots=1, max_len=64, default_max_new_tokens=48)


def _engine(model, adapters=None, **kw):
    cfg = dict(DEFAULTS)
    cfg.update(kw)
    return GenerationEngine(model, GenerationConfig(**cfg), device="cpu",
                            adapters=adapters)


def _jax_engine(tree, adapters=None, **kw):
    cfg = dict(DEFAULTS)
    cfg.update(kw)
    return jserve.GenerationEngine(common.jax_params(tree),
                                   common.jax_config(),
                                   jserve.GenerationConfig(**cfg),
                                   adapters=adapters)


@pytest.fixture(scope="module")
def budget_engine(model, jax_adapters):
    """Paged engine with a0 budgeted at 2 blocks (one in-flight stream at
    max_new <= 8): block_size 8, max_len 16, 4 slots."""
    eng = _engine(model, _registry(jax_adapters, ("a0", "a1")),
                  max_slots=4, max_len=16, default_max_new_tokens=6,
                  kv_layout="paged", block_size=8,
                  tenant_block_budgets={"a0": 2})
    yield eng
    eng.shutdown()


def test_budget_rejects_only_that_tenant(budget_engine):
    eng = budget_engine
    h0 = eng.submit(PROMPT, adapter="a0", max_new_tokens=4)
    with pytest.raises(ServerOverloadedError,
                       match="blocks_exhausted") as ei:
        eng.submit(PROMPT2, adapter="a0", max_new_tokens=4)
    assert "THIS tenant" in str(ei.value)
    assert 50.0 <= ei.value.retry_after_ms <= 30000.0
    hb = eng.submit(PROMPT2, max_new_tokens=4)
    h1 = eng.submit(PROMPT2, adapter="a1", max_new_tokens=4)
    for h in (h0, hb, h1):
        assert h.result(TIMEOUT)["n_tokens"] == 4
    assert eng.stats()["rejected_blocks_exhausted"] >= 1


def test_budget_demand_returns_to_zero(budget_engine):
    eng = budget_engine
    eng.generate(PROMPT, adapter="a0", max_new_tokens=4, timeout=TIMEOUT)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        owned = eng.stats()["blocks_by_tenant"]["owned"]
        if not eng._tenant_blocks and owned.get("a0", 0) == 0:
            break
        time.sleep(0.05)
    assert not eng._tenant_blocks
    assert eng.stats()["blocks_by_tenant"] == {"owned": {},
                                               "budgets": {"a0": 2}}
    assert eng.generate(PROMPT, adapter="a0", max_new_tokens=4,
                        timeout=TIMEOUT)["n_tokens"] == 4


def test_budget_impossible_request_and_quota_hint(budget_engine):
    eng = budget_engine
    eng._blocks.set_budget("a1", 1)
    try:
        with pytest.raises(ValueError, match="NEVER"):
            eng.submit(PROMPT, adapter="a1", max_new_tokens=8)
    finally:
        eng._blocks.set_budget("a1", None)
    eng.adapters.set_quota("base", 1)
    try:
        h0 = eng.submit(PROMPT, max_new_tokens=4)
        with pytest.raises(ServerOverloadedError, match="over quota") as ei:
            eng.submit(PROMPT2, max_new_tokens=4)
        assert 50.0 <= ei.value.retry_after_ms <= 30000.0
        h0.result(TIMEOUT)
    finally:
        eng.adapters.set_quota("base", None)


def test_over_budget_tenant_reclaims_its_own_prefix_first(model,
                                                          jax_adapters):
    """With prefix reuse, a tenant's registered residue counts against
    its budget; its next admission reclaims its OWN cold blocks and
    admits, and the owner ledger never exceeds the budget."""
    eng = _engine(model, _registry(jax_adapters, ("a0",)), max_slots=2,
                  max_len=16, default_max_new_tokens=4, kv_layout="paged",
                  block_size=4, prefix_reuse=True,
                  tenant_block_budgets={"a0": 4})
    try:
        eng.generate(PROMPT, adapter="a0", timeout=TIMEOUT)
        owned = eng.stats()["blocks_by_tenant"]["owned"]["a0"]
        assert owned == 2       # the two registered prompt blocks
        r = eng.generate(PROMPT2, adapter="a0", timeout=TIMEOUT)
        assert r["n_tokens"] == 4
        assert eng.stats()["blocks_by_tenant"]["owned"]["a0"] <= 4
        # base's residue is not the tenant's to reclaim
        eng.generate(PROMPT, timeout=TIMEOUT)
        assert eng.stats()["blocks_by_tenant"]["owned"].get("base") == 2
    finally:
        eng.shutdown()


def test_tenant_knobs_validated_like_jax():
    for kw, match in ((dict(tenant_block_budgets={"a0": 2}), "paged"),
                      (dict(kv_layout="paged",
                            tenant_block_budgets={"a0": 0}), ">= 1"),
                      (dict(tenant_weights={"a0": 0.0}), "> 0"),
                      (dict(tenant_slo_ttft_ms={"a0": -1.0}), "> 0"),
                      (dict(preempt_retries=-1), "preempt_retries")):
        with pytest.raises(ValueError, match=match) as ours:
            GenerationConfig(**kw)
        with pytest.raises(ValueError) as ref:
            jserve.GenerationConfig(**kw)
        assert str(ours.value) == str(ref.value)


LAYOUTS = {"contiguous": {}, "paged": dict(kv_layout="paged", block_size=8)}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def preempt_pair(request, tree, model, jax_adapters):
    """One decode slot, a0 in priority class 1 above base, on both
    sides: a pending a0 admission always preempts a running base
    stream."""
    kw = dict(LAYOUTS[request.param], tenant_priorities={"a0": 1})
    pair = (_engine(model, _registry(jax_adapters), **kw),
            _jax_engine(tree, _jax_registry(jax_adapters), **kw))
    yield pair
    for e in pair:
        e.shutdown()


def _preempt_run(eng, sampling=None):
    """A long base stream, then (once it holds the slot) a priority-1 a0
    stream: base is evicted, a0 runs, base replays and resumes."""
    kw = {"sampling": sampling} if sampling is not None else {}
    h = eng.submit(PROMPT, max_new_tokens=40, **kw)
    kind, _ = h.next_event(timeout=TIMEOUT)
    assert kind == "token"
    hp = eng.submit(PROMPT2, adapter="a0", max_new_tokens=4)
    rp = hp.result(TIMEOUT)
    return h.result(TIMEOUT), rp


@pytest.mark.parametrize("sampling", [None, SAMPLED],
                         ids=["greedy", "seeded"])
def test_preempted_stream_bitwise_unpreempted_and_jax(preempt_pair,
                                                      sampling):
    eng, jeng = preempt_pair
    kw = {"sampling": sampling} if sampling is not None else {}
    ref = eng.generate(PROMPT, max_new_tokens=40, timeout=TIMEOUT, **kw)
    before = eng.stats()["generation"]
    rb, rp = _preempt_run(eng, sampling)
    assert rb["tokens"] == ref["tokens"] and rb["n_tokens"] == 40
    after = eng.stats()["generation"]
    assert after["preemptions_total"] > before["preemptions_total"]
    assert after["preempt_resumed_total"] > before["preempt_resumed_total"]
    assert after["preempt_exhausted_total"] == \
        before["preempt_exhausted_total"]
    assert eng.stats()["tenants"]["base"]["preemptions_total"] >= 1
    jb, jp = _preempt_run(jeng, sampling)
    assert rb["tokens"] == jb["tokens"] and rp["tokens"] == jp["tokens"]


def test_retry_budget_exhaustion_is_terminal(model, jax_adapters):
    eng = _engine(model, _registry(jax_adapters),
                  tenant_priorities={"a0": 1}, preempt_retries=0)
    try:
        h = eng.submit(PROMPT, max_new_tokens=40)
        kind, _ = h.next_event(timeout=TIMEOUT)
        assert kind == "token"
        hp = eng.submit(PROMPT2, adapter="a0", max_new_tokens=4)
        with pytest.raises(PreemptedError, match="preempted_exhausted"):
            h.result(TIMEOUT)
        assert hp.result(TIMEOUT)["n_tokens"] == 4
        gen = eng.stats()["generation"]
        assert gen["preempt_exhausted_total"] == 1
        assert gen["preemptions_total"] == 1
        assert not eng._tenant_inflight     # the failed stream was released
    finally:
        eng.shutdown()


def test_preempt_off_never_evicts(model, jax_adapters):
    eng = _engine(model, _registry(jax_adapters),
                  tenant_priorities={"a0": 1}, preempt=False,
                  default_max_new_tokens=8)
    try:
        h = eng.submit(PROMPT, max_new_tokens=8)
        hp = eng.submit(PROMPT2, adapter="a0", max_new_tokens=4)
        h.result(TIMEOUT)
        hp.result(TIMEOUT)
        assert eng.stats()["generation"]["preemptions_total"] == 0
    finally:
        eng.shutdown()


def test_replay_divergence_raises(model, jax_adapters):
    """The replay guard: a stream whose regenerated prefix differs from
    its envelope fails loudly (an engine fault), never silently."""
    eng = _engine(model, _registry(jax_adapters),
                  tenant_priorities={"a0": 1})
    try:
        h = eng.submit(PROMPT, max_new_tokens=40)
        for _ in range(3):      # past the prefill: a decode step replays
            kind, _ = h.next_event(timeout=TIMEOUT)
            assert kind == "token"
        req = h.request
        real = eng._preempt

        def tamper(slot):
            real(slot)
            if req.replay_expect:
                req.replay_expect[-1] = (req.replay_expect[-1] + 1) % 32
        eng._preempt = tamper
        eng.submit(PROMPT2, adapter="a0", max_new_tokens=4).result(TIMEOUT)
        with pytest.raises(RuntimeError, match="replay diverged"):
            h.result(TIMEOUT)
    finally:
        eng.shutdown()


def test_slo_burn_and_deadline_miss(model, jax_adapters):
    reg = _registry(jax_adapters)
    reg.set_slo_ttft_ms("a0", 1e-6)     # every first token misses
    eng = _engine(model, reg, default_max_new_tokens=2)
    try:
        eng.generate(PROMPT, adapter="a0", timeout=TIMEOUT)
        assert eng.slo_burn("a0") == 1.0
        assert eng.slo_burn("base") == 0.0
        t = eng.stats()["tenants"]["a0"]
        assert t["ttft_slo_miss_total"] == 1
        assert t["slo_ttft_target_ms"] == 1e-6
    finally:
        eng.shutdown()

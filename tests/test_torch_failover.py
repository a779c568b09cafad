"""Port parity: deterministic stream failover, mirroring
``tests/test_failover.py`` on the port — the router's strand-and-resume
plane, the serving fault hook, the retry budget, the overload waits and
hints, the engine's loop liveness, and the real kill drill against the
JAX engine.

The failover logic runs against fake generation engines on the port's
``ReadinessMixin`` and ``GenerationHandle`` whose tokens are a pure
function of the prompt (the determinism a seeded engine provides). The
real drill builds the JAX KV tests' tiny f32 LM from JAX ``init_params``
(``torch_serve_common``), carried across by ``convert.params_from_jax``,
serves greedy and seeded streams through two port thread replicas with
``replica_kill=r1@stream=2``, and holds every stream token-identical
(exact equality) to the JAX single engine's uninterrupted stream on the
same params and to the port's own single engine, in both KV layouts; the
killed replica leaves membership without a drain and a flight-recorder
dump naming it and its in-flight streams.
"""

import glob
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch_serve_common as common
from horovod_tpu import serve as jserve
from horovod_tpu.testing import faults as jfaults
from horovod_tpu_torch import serve
from horovod_tpu_torch.exceptions import (DeadlineExceededError,
                                          FailoverExhaustedError,
                                          PreemptedError,
                                          ServerOverloadedError)
from horovod_tpu_torch.obs.registry import parse_exposition, render
from horovod_tpu_torch.serve.engine import ReadinessMixin
from horovod_tpu_torch.serve.generate import GenerationHandle
from horovod_tpu_torch.serve.metrics import FleetMetrics, ServeMetrics
from horovod_tpu_torch.serve.router import FleetRouter
from horovod_tpu_torch.testing import faults


class _Cfg:
    default_deadline_ms = None


class _FakeGenEngine(ReadinessMixin):
    """Emits ``max_new_tokens`` tokens ``prompt[-1]+1, +2, ...``.

    ``strand_after=k`` emits k tokens and goes silent without finishing
    or failing (a crashed replica delivers nothing); ``fail_after=k``
    emits k tokens then fails the handle with ``fail_with`` (an engine
    loop error); ``finish_after=k`` finishes after k tokens; ``diverge``
    offsets every token by 100 (a replica breaking determinism)."""

    def __init__(self, warmed=True, load=0, reject=None,
                 strand_after=None, fail_after=None, fail_with=None,
                 fail_always=False, finish_after=None, diverge=False):
        self._queue = []
        self._warmed = warmed
        self._closed = False
        self._load = load
        self._cfg = _Cfg()
        self.reject = reject
        self.reject_count = 0
        self.strand_after = strand_after
        self.fail_after = fail_after
        self.fail_with = fail_with or RuntimeError("engine loop error")
        self.fail_always = fail_always
        self.finish_after = finish_after
        self.diverge = diverge
        self.alive_flag = True
        self.submits = []

    def load(self):
        return self._load

    def loop_alive(self, stall_s=0.0):
        return self.alive_flag

    def submit(self, tokens, *, max_new_tokens=4, sampling=None,
               eos_id=None, deadline_ms=None, adapter=None):
        if self.reject is not None:
            self.reject_count += 1
            raise self.reject
        self.submits.append({"tokens": list(tokens),
                             "deadline_ms": deadline_ms,
                             "adapter": adapter})
        off = 100 if self.diverge else 0
        toks = [int(tokens[-1]) + 1 + i + off
                for i in range(max_new_tokens)]
        h = GenerationHandle()
        if self.strand_after is not None:
            for t in toks[:self.strand_after]:
                h._emit(t)
            self.strand_after = None
        elif self.fail_after is not None:
            for t in toks[:self.fail_after]:
                h._emit(t)
            h._fail(self.fail_with)
            if not self.fail_always:
                self.fail_after = None
        elif self.finish_after is not None:
            short = toks[:self.finish_after]
            for t in short:
                h._emit(t)
            h._finish({"tokens": short, "finish_reason": "length",
                       "n_tokens": len(short)})
        else:
            for t in toks:
                h._emit(t)
            h._finish({"tokens": toks, "finish_reason": "length",
                       "n_tokens": len(toks)})
        return h

    def warmup(self):
        self._warmed = True

    def shutdown(self, drain=True, timeout=None):
        self._closed = True

    def stats(self):
        return {}

    def prom_collect(self):
        return {}, []


def _router(*engines, **kw):
    # poll_interval_s=0: liveness verdicts come from poll() alone.
    kw.setdefault("poll_interval_s", 0)
    kw.setdefault("failover_backoff_s", 0.001)
    return FleetRouter(engines=list(engines), **kw)


def _wait_tokens(h, n):
    deadline = time.monotonic() + 5
    while len(h._tokens) < n and time.monotonic() < deadline:
        time.sleep(0.005)


@pytest.fixture
def fault_spec(monkeypatch):
    """Arm HVD_FAULT_SPEC for one test (both packages' fired-sets reset:
    their hooks read the same variable)."""
    def arm(spec):
        monkeypatch.setenv("HVD_FAULT_SPEC", spec)
        faults.reset()
        jfaults.reset()
    yield arm
    faults.reset()
    jfaults.reset()


class TestFailover:
    def test_dead_replica_strands_nothing_stream_resumes_bit_identical(self):
        e0 = _FakeGenEngine(load=0, strand_after=2)
        e1 = _FakeGenEngine(load=5)
        router = _router(e0, e1)
        h = router.submit([7], max_new_tokens=4)
        _wait_tokens(h, 2)
        assert h._tokens == [8, 9] and not h.done()
        e0.alive_flag = False
        router.poll()
        r = h.result(timeout=5)
        assert r["tokens"] == [8, 9, 10, 11]
        assert h._tokens == [8, 9, 10, 11]
        assert r["failovers"] == 1
        assert e1.submits and e1.submits[0]["tokens"] == [7]
        assert router._metrics.failover_counts() == {"resumed": 1,
                                                     "exhausted": 0}
        assert router._metrics.stranded_count() == 1
        assert router.counts()["ready"] == 1
        router.shutdown()

    def test_engine_loop_error_fails_over_without_liveness_verdict(self):
        e0 = _FakeGenEngine(load=0, fail_after=1)
        e1 = _FakeGenEngine(load=5)
        router = _router(e0, e1)
        r = router.submit([3], max_new_tokens=3).result(timeout=5)
        assert r["tokens"] == [4, 5, 6]
        assert r["failovers"] == 1
        assert router._metrics.failover_counts()["resumed"] == 1
        router.shutdown()

    def test_retry_budget_exhausts_loudly_never_loops(self):
        e0 = _FakeGenEngine(load=0, strand_after=1)
        e1 = _FakeGenEngine(load=5, fail_after=0, fail_always=True)
        router = _router(e0, e1, failover_retries=2)
        h = router.submit([5], max_new_tokens=4)
        _wait_tokens(h, 1)
        e0.alive_flag = False
        router.poll()
        with pytest.raises(FailoverExhaustedError, match="re-submit") as ei:
            h.result(timeout=5)
        assert ei.value.reason == "exhausted"
        assert len(e1.submits) == 2
        assert h._tokens == [6]
        assert router._metrics.failover_counts() == {"resumed": 0,
                                                     "exhausted": 1}
        assert router._metrics.stranded_count() == 3
        router.shutdown()

    def test_preemption_strand_reports_preempted_exhausted(self):
        e0 = _FakeGenEngine(load=0, fail_after=1, fail_always=True,
                            fail_with=PreemptedError("evicted"))
        router = _router(e0, failover_retries=1)
        with pytest.raises(FailoverExhaustedError) as ei:
            router.submit([5], max_new_tokens=3).result(timeout=5)
        assert ei.value.reason == "preempted_exhausted"
        router.shutdown()

    def test_overload_waits_on_the_hint_without_burning_the_budget(self):
        reject = ServerOverloadedError("queue full")
        reject.retry_after_ms = 10.0
        e0 = _FakeGenEngine(load=0, strand_after=1)
        e1 = _FakeGenEngine(load=5, reject=reject)
        router = _router(e0, e1, failover_retries=2,
                         failover_overload_wait_s=0.08)
        h = router.submit([5], max_new_tokens=4)
        _wait_tokens(h, 1)
        e0.alive_flag = False
        router.poll()
        with pytest.raises(FailoverExhaustedError, match="re-submit"):
            h.result(timeout=5)
        assert 2 <= e1.reject_count <= 30
        assert h._tokens == [6]
        assert router._metrics.failover_counts() == {"resumed": 0,
                                                     "exhausted": 1}
        assert router._metrics.stranded_count() == 1
        router.shutdown()

    def test_diverging_replay_fails_loudly_never_mis_continues(self):
        e0 = _FakeGenEngine(load=0, strand_after=2)
        e1 = _FakeGenEngine(load=5, diverge=True)
        router = _router(e0, e1)
        h = router.submit([7], max_new_tokens=4)
        _wait_tokens(h, 2)
        e0.alive_flag = False
        router.poll()
        with pytest.raises(FailoverExhaustedError, match="diverged"):
            h.result(timeout=5)
        assert h._tokens == [8, 9]
        assert router._metrics.failover_counts() == {"resumed": 0,
                                                     "exhausted": 1}
        router.shutdown()

    def test_replay_finishing_short_of_the_prefix_is_divergence(self):
        e0 = _FakeGenEngine(load=0, strand_after=2)
        e1 = _FakeGenEngine(load=5, finish_after=1)
        router = _router(e0, e1)
        h = router.submit([7], max_new_tokens=4)
        _wait_tokens(h, 2)
        e0.alive_flag = False
        router.poll()
        with pytest.raises(FailoverExhaustedError, match="finished"):
            h.result(timeout=5)
        assert h._tokens == [8, 9]
        assert router._metrics.failover_counts() == {"resumed": 0,
                                                     "exhausted": 1}
        router.shutdown()

    def test_failover_avoids_the_replica_the_stream_just_failed_on(self):
        sick = _FakeGenEngine(load=0, fail_after=1, fail_always=True)
        healthy = _FakeGenEngine(load=9)
        router = _router(sick, healthy)
        r = router.submit([3], max_new_tokens=3).result(timeout=5)
        assert r["tokens"] == [4, 5, 6]
        assert r["failovers"] == 1
        assert len(healthy.submits) == 1
        assert router._metrics.failover_counts() == {"resumed": 1,
                                                     "exhausted": 0}
        router.shutdown()

    def test_submit_time_value_error_passes_through_untouched(self):
        e0 = _FakeGenEngine(load=0, reject=ValueError("bad prompt"))
        e1 = _FakeGenEngine(load=5)
        router = _router(e0, e1)
        with pytest.raises(ValueError, match="bad prompt"):
            router.submit([3])
        assert not e1.submits
        assert router._metrics.stranded_count() == 0
        router.shutdown()

    def test_mid_stream_value_error_is_a_replica_fault_and_fails_over(self):
        e0 = _FakeGenEngine(load=0, fail_after=1,
                            fail_with=ValueError("loop bug"))
        e1 = _FakeGenEngine(load=5)
        router = _router(e0, e1)
        r = router.submit([3], max_new_tokens=3).result(timeout=5)
        assert r["tokens"] == [4, 5, 6]
        assert r["failovers"] == 1
        assert router._metrics.failover_counts() == {"resumed": 1,
                                                     "exhausted": 0}
        router.shutdown()

    def test_eviction_racing_the_dispatch_register_window_strands_nothing(
            self):
        router_box = []

        class _EvictDuringSubmit(_FakeGenEngine):
            def submit(self, *a, **kw):
                h = super().submit(*a, **kw)
                self.alive_flag = False
                router_box[0].poll()
                return h

        e0 = _EvictDuringSubmit(load=0, strand_after=1)
        e1 = _FakeGenEngine(load=5)
        router = _router(e0, e1)
        router_box.append(router)
        r = router.submit([3], max_new_tokens=3).result(timeout=5)
        assert r["tokens"] == [4, 5, 6]
        assert r["failovers"] == 1
        assert router._metrics.failover_counts()["resumed"] == 1
        assert router.counts()["ready"] == 1
        router.shutdown()

    def test_single_shot_future_fleets_stay_untracked(self):
        class _Single(ReadinessMixin):
            def __init__(self):
                self._queue = []
                self._warmed = True
                self._closed = False

            def load(self):
                return 0

            def submit(self, *a, **kw):
                return "a-future"

            def shutdown(self, drain=True, timeout=None):
                pass

        router = _router(_Single())
        assert router.submit("x") == "a-future"
        assert router._live_streams == {}
        router.shutdown()

    def test_failover_retries_validated(self):
        with pytest.raises(ValueError, match="failover_retries"):
            _router(_FakeGenEngine(), failover_retries=0)

    def test_the_sweeper_delivers_the_verdict_without_a_poll(self):
        # A static fleet with no autoscaler still fails over: the
        # router's own sweep thread starts with the first tracked stream.
        e0 = _FakeGenEngine(load=0, strand_after=1)
        e1 = _FakeGenEngine(load=5)
        router = _router(e0, e1, poll_interval_s=0.02)
        h = router.submit([2], max_new_tokens=3)
        _wait_tokens(h, 1)
        e0.alive_flag = False
        assert h.result(timeout=5)["tokens"] == [3, 4, 5]
        router.shutdown()


class TestDeadlineThroughFailover:
    def test_replay_keeps_the_original_absolute_deadline(self):
        e0 = _FakeGenEngine(load=0, strand_after=1)
        e1 = _FakeGenEngine(load=5)
        router = _router(e0, e1)
        h = router.submit([5], max_new_tokens=3, deadline_ms=60000.0)
        _wait_tokens(h, 1)
        e0.alive_flag = False
        router.poll()
        r = h.result(timeout=5)
        assert r["tokens"] == [6, 7, 8]
        replayed = e1.submits[0]["deadline_ms"]
        assert replayed is not None and 0 < replayed < 60000.0
        router.shutdown()

    def test_deadline_expiry_during_failover_is_deadline_not_overload(self):
        e0 = _FakeGenEngine(load=0, strand_after=1)
        e1 = _FakeGenEngine(load=5,
                            reject=ServerOverloadedError("queue full"))
        router = _router(e0, e1, failover_retries=1000,
                         failover_backoff_s=0.01)
        h = router.submit([5], deadline_ms=150.0)
        _wait_tokens(h, 1)
        e0.alive_flag = False
        router.poll()
        with pytest.raises(DeadlineExceededError, match="deadline"):
            h.result(timeout=10)
        assert router._metrics.failover_counts()["resumed"] == 0
        router.shutdown()


class TestServeFaultHook:
    @pytest.mark.parametrize("spec", [
        "replica_kill=r1@stream=3,replica_hang=r0@stream=2@epoch=1,"
        "slow_step=50,rank=1:kill@step=3",
        "replica_proc_kill=r1@stream=3"])
    def test_grammar_matches_jax(self, spec):
        assert [vars(f) for f in faults.parse_spec(spec)] \
            == [vars(f) for f in jfaults.parse_spec(spec)]

    @pytest.mark.parametrize("bad", [
        "replica_kill=r1", "replica_kill=r1@stream=0",
        "replica_kill=@stream=3", "replica_hang=r0@bogus=1",
        "replica_kill=r1@stream=x", "slow_step=0", "slow_step=abc",
        "slow_step=50@stream=2", "replica_proc_kill=r1"])
    def test_grammar_rejects_loudly(self, bad):
        with pytest.raises(faults.FaultSpecError):
            faults.parse_spec(bad)

    def test_serve_hook_fires_once_on_the_named_replica(self, fault_spec):
        fault_spec("replica_kill=r1@stream=2")
        calls = [("r1", 1), ("r0", 9), ("r1", 2), ("r1", 3)]
        got = [faults.serve_hook(*c) for c in calls]
        assert got == [None, None, "kill", None]
        jfaults.reset()
        assert got == [jfaults.serve_hook(*c) for c in calls]

    def test_serve_hook_hang_proc_kill_and_slow_step(self, fault_spec):
        fault_spec("replica_hang=r0@stream=1,replica_proc_kill=r1@stream=2")
        assert faults.serve_hook("r0", 1) == "hang"
        assert faults.serve_hook("r1", 1) is None
        assert faults.serve_hook("r1", 2) == "proc_kill"
        assert faults.serve_hook("r1", 3) is None
        fault_spec("slow_step=30")
        t0 = time.monotonic()
        assert faults.serve_hook("anything", 0) is None
        assert time.monotonic() - t0 >= 0.025


class TestFailoverMetrics:
    def test_series_pre_seeded_and_validated(self):
        m = FleetMetrics()
        parsed = dict(((n, tuple(sorted(labels.items()))), v)
                      for n, labels, v in m.registry.collect()[1])
        assert parsed[("hvd_failover_total",
                       (("outcome", "resumed"),))] == 0.0
        assert parsed[("hvd_failover_total",
                       (("outcome", "exhausted"),))] == 0.0
        assert parsed[("hvd_streams_stranded_total", ())] == 0.0
        m.on_stranded(2)
        m.on_failover("resumed")
        assert m.stranded_count() == 2
        assert m.failover_counts() == {"resumed": 1, "exhausted": 0}
        with pytest.raises(ValueError, match="outcome"):
            m.on_failover("lost")
        body = render(*m.registry.collect())
        assert ("hvd_failover_total",
                (("outcome", "resumed"),)) in parse_exposition(body)

    def test_retry_after_ms_tracks_the_measured_service_rate(self):
        m = ServeMetrics()
        assert m.retry_after_ms(10) == 1000.0
        m.responses_total = 100
        m._t0 = time.monotonic() - 10.0
        assert 1800.0 <= m.retry_after_ms(19) <= 2200.0
        assert m.retry_after_ms(0) >= 50.0
        assert m.retry_after_ms(10 ** 9) == 30000.0

    def test_fleet_overload_carries_the_soonest_drain_hint(self):
        e_slow = ServerOverloadedError("full")
        e_slow.retry_after_ms = 700.0
        e_fast = ServerOverloadedError("full")
        e_fast.retry_after_ms = 300.0
        router = _router(_FakeGenEngine(load=0, reject=e_slow),
                         _FakeGenEngine(load=1, reject=e_fast))
        with pytest.raises(ServerOverloadedError) as ei:
            router.submit([1])
        assert ei.value.retry_after_ms == 300.0
        router.shutdown()

    def test_http_503_carries_retry_after_hint(self):
        class _OverloadedEngine(ReadinessMixin):
            _warmed = True

            def __init__(self):
                self._queue = []

            def infer(self, x, deadline_ms=None):
                err = ServerOverloadedError("queue full")
                err.retry_after_ms = 2500.0
                raise err

        with serve.HttpServer(engine=_OverloadedEngine()) as srv:
            req = urllib.request.Request(
                f"http://{srv.host}:{srv.port}/predict",
                data=json.dumps({"inputs": [1.0]}).encode(),
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req)
            err = ei.value
            body = json.loads(err.read())
            assert err.code == 503
            assert body["retryable"] is True
            assert body["retry_after_ms"] == 2500.0
            assert err.headers["Retry-After"] == "3"


class _FakeRegistry:
    def __init__(self):
        self.rows = {}
        self.quotas = {}

    def resident(self):
        return tuple(self.rows)

    def quota(self, name):
        return self.quotas.get(name)


class _FakeAdapterEngine(_FakeGenEngine):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.adapters = _FakeRegistry()

    def load_adapter(self, name, tree, quota=None):
        self.adapters.rows[name] = tree
        self.adapters.quotas[name] = quota

    def adapter_names(self):
        return tuple(self.adapters.rows)


class TestAdapterPlane:
    def test_scale_up_seeds_resident_set_with_quotas(self):
        e0 = _FakeAdapterEngine()
        e0.load_adapter("a0", "tree:a0", quota=3)
        e0.load_adapter("a1", "tree:a1")
        router = _router(e0, factory=lambda name: _FakeAdapterEngine(),
                         adapter_source=lambda n: f"tree:{n}")
        grown = router.add_replica(warm=False)
        assert grown.engine.adapters.rows == {"a0": "tree:a0",
                                              "a1": "tree:a1"}
        assert grown.engine.adapters.quotas == {"a0": 3, "a1": None}
        router.shutdown()

    def test_no_adapter_source_means_no_seeding(self):
        e0 = _FakeAdapterEngine()
        e0.load_adapter("a0", "tree:a0")
        router = _router(e0, factory=lambda name: _FakeAdapterEngine())
        grown = router.add_replica(warm=False)
        assert grown.engine.adapters.rows == {}
        router.shutdown()

    def test_affine_dispatch_then_one_lazy_load_with_the_quota(self):
        e0 = _FakeAdapterEngine(load=5)
        e0.load_adapter("a0", "tree:a0", quota=2)
        e1 = _FakeAdapterEngine(load=0)
        router = _router(e0, e1, adapter_source=lambda n: f"tree:{n}")
        router.submit([1], adapter="a0").result(timeout=5)
        # Residency outranks load: the busier replica holding a0 wins.
        assert e0.submits and not e1.submits
        e0.reject = ServerOverloadedError("full")
        router.submit([1], adapter="a0").result(timeout=5)
        assert e1.adapters.rows == {"a0": "tree:a0"}
        assert e1.adapters.quotas == {"a0": 2}
        assert router._metrics.adapter_dispatch_counts() == {
            "affine": 1, "miss": 1}
        assert router.adapters_resident() == 1
        router.shutdown()

    def test_no_source_names_the_remedy(self):
        e0 = _FakeAdapterEngine()
        router = _router(e0)
        with pytest.raises(ValueError, match="adapter_source="):
            router.submit([1], adapter="nope")
        router.shutdown()


# -- the port's real engine -----------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    return common.make_tree()


@pytest.fixture(scope="module")
def model(tree):
    return common.torch_model(tree)


def _real_engine(model, **kw):
    kw.setdefault("default_max_new_tokens", 6)
    eng = common.engine(model, **kw)
    eng.warmup()
    return eng


class TestLoopLiveness:
    def test_idle_loop_is_never_stale_a_wedged_busy_loop_is(self, model):
        eng = _real_engine(model)
        try:
            time.sleep(0.05)
            assert eng.loop_alive(0.01)         # idle: a stale beat is fine
            assert eng.loop_alive(0.01)         # ...and does not flap
            eng._held.append(object())          # stuck work
            assert eng.loop_alive(0.04)         # the first busy observation
            time.sleep(0.08)
            assert not eng.loop_alive(0.04)     # no progress: wedged
            eng._held.clear()
            assert eng.loop_alive(0.04)         # idle again: recovered
            assert eng.loop_alive(0)            # stall_s=0: thread only
        finally:
            eng.shutdown(drain=False)
        assert eng.loop_alive(0.01)             # a shut-down loop: no death

    def test_hang_drill_reads_dead_through_the_handle(self, model,
                                                       fault_spec):
        from horovod_tpu_torch.serve.router import ReplicaHandle
        fault_spec("replica_hang=r0@stream=1")
        eng = _real_engine(model)
        eng.serve_name = "r0"
        handle = ReplicaHandle("r0", eng, stall_timeout_s=0.1)
        try:
            h = eng.submit([1, 2, 3], max_new_tokens=4)
            _wait_tokens(h, 1)              # admitted: the hook fires next
            # Polled as the router's sweep polls: the stall clock starts
            # at the first busy observation after the loop's last beat.
            t0 = time.monotonic()
            while handle.state() != "dead":
                assert time.monotonic() - t0 < 10, "a hung loop read alive"
                time.sleep(0.02)
            assert time.monotonic() - t0 >= 0.1
            assert eng._thread.is_alive()   # parked, not gone
        finally:
            eng.shutdown(drain=False, timeout=0.5)


_PROMPTS = [[int(t) for t in p] for p in
            np.random.RandomState(7).randint(1, 32, size=(6, 4))]


def _samplings(pkg):
    # Greedy and seeded sampled streams in one drill.
    return [None if i % 2 == 0 else
            pkg.SamplingParams(temperature=0.8, seed=40 + i)
            for i in range(len(_PROMPTS))]


class TestRealKillDrill:
    @pytest.mark.parametrize("layout", ["paged", "contiguous"])
    def test_replica_kill_mid_stream_resumes_token_identical_to_jax(
            self, tree, model, layout, fault_spec, monkeypatch, tmp_path):
        monkeypatch.setenv("HVD_FLIGHTREC_DIR", str(tmp_path))
        jeng = common.jax_engine(tree, kv_layout=layout,
                                 default_max_new_tokens=6)
        try:
            want = [tuple(jeng.generate(p, sampling=s,
                                        timeout=common.TIMEOUT)["tokens"])
                    for p, s in zip(_PROMPTS, _samplings(jserve))]
        finally:
            jeng.shutdown()
        ref = _real_engine(model, kv_layout=layout)
        try:
            own = [tuple(ref.generate(p, sampling=s,
                                      timeout=common.TIMEOUT)["tokens"])
                   for p, s in zip(_PROMPTS, _samplings(serve))]
        finally:
            ref.shutdown()
        assert own == want
        fault_spec("replica_kill=r1@stream=2")
        router = FleetRouter(engines=[_real_engine(model, kv_layout=layout),
                                      _real_engine(model, kv_layout=layout)],
                             poll_interval_s=0.05)
        try:
            handles = [router.submit(p, sampling=s)
                       for p, s in zip(_PROMPTS, _samplings(serve))]
            results = [h.result(timeout=common.TIMEOUT) for h in handles]
            # Nothing stranded: every stream token-identical to the
            # uninterrupted single engines, JAX's and the port's.
            assert [tuple(r["tokens"]) for r in results] == want
            counts = router._metrics.failover_counts()
            assert counts["resumed"] >= 1 and counts["exhausted"] == 0
            assert router._metrics.stranded_count() >= 1
            assert sum(r["failovers"] for r in results) == counts["resumed"]
            # The killed replica left membership without a drain.
            assert router.counts() == {"ready": 1, "warming": 0,
                                       "draining": 0, "dead": 0}
            assert [h.name for h in router.replicas()] == ["r0"]
        finally:
            router.shutdown()
        dumps = glob.glob(str(tmp_path / "hvd_flightrec.rank*.json"))
        assert dumps, "the killed replica left no flight-recorder dump"
        with open(dumps[0]) as f:
            events = json.load(f)["events"]
        crash = [e for e in events if e["kind"] == "serve_crash"]
        assert crash and crash[0]["replica"] == "r1"
        assert crash[0]["inflight"], "the post-mortem names no stream"
        admitted = {e["stream"] for e in events
                    if e["kind"] == "serve_admit" and e["replica"] == "r1"}
        assert set(crash[0]["inflight"]) <= admitted

"""Port parity: the serving fleet (``serve/router.py``, ``serve/fleet.py``,
``FleetMetrics``), mirroring ``tests/test_fleet.py`` on the port.

The router's and the autoscaler's contracts are host-side control flow,
so most of this file runs them against fake engines built on the port's
``ReadinessMixin``: least-depth dispatch, warming and draining
membership, overload only when every ready replica rejected, eviction on
a liveness verdict, hysteresis, cooldown, one pending change at a time,
the caps, the TTFT trigger, and the fleet's ``/metrics`` surface. The
real-engine drills run the port's ``GenerationEngine`` on the CPU over
the JAX KV tests' tiny model (``torch_serve_common``): a shrink drains
every admitted stream token-identically to one engine's run (greedy
streams: exact), and a router mounted in ``HttpServer`` answers
``/generate``, ``/stats``, ``/healthz`` (with ``replicas``) and one
``/metrics`` exposition with ``replica=`` labels, which the fleet
poller's serving line reads.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import torch_serve_common as common
from horovod_tpu_torch import serve
from horovod_tpu_torch.exceptions import (ServerClosedError,
                                          ServerOverloadedError)
from horovod_tpu_torch.obs.registry import parse_exposition
from horovod_tpu_torch.serve.engine import ReadinessMixin
from horovod_tpu_torch.serve.fleet import FleetAutoscaler, heartbeat_liveness
from horovod_tpu_torch.serve.metrics import FleetMetrics
from horovod_tpu_torch.serve.router import FleetRouter


class _FakeEngine(ReadinessMixin):
    def __init__(self, warmed=True, load=0, reject=None):
        self._queue = []
        self._warmed = warmed
        self._closed = False
        self._load = load
        self.reject = reject      # exception instance raised by submit
        self.submits = []
        self.drained = None       # the drain= flag shutdown() saw

    def load(self):
        return self._load

    def submit(self, *a, **kw):
        if self.reject is not None:
            raise self.reject
        self.submits.append((a, kw))
        return "accepted"

    def warmup(self):
        self._warmed = True

    def shutdown(self, drain=True, timeout=None):
        self._closed = True
        self.drained = drain

    def stats(self):
        return {"requests_total": len(self.submits),
                "queue_depth": len(self._queue)}

    def prom_collect(self):
        return ({"hvd_requests_total": ("counter", "requests")},
                [("hvd_requests_total", {"engine": "generate"},
                  float(len(self.submits)))])


class _FakeCoordClient:
    """A heartbeat plane's verdict surface: ``aborted()`` flips once the
    member is declared dead."""

    def __init__(self):
        self._aborted = False

    def aborted(self):
        return self._aborted


def _fakes(*specs):
    return [_FakeEngine(**s) for s in specs]


class TestRouterDispatch:
    def test_least_depth_wins(self):
        engines = _fakes({"load": 5}, {"load": 0}, {"load": 3})
        router = FleetRouter(engines=engines)
        assert router.submit("x") == "accepted"
        assert engines[1].submits and not engines[0].submits
        assert router._metrics.dispatch_counts() == {"r1": 1}

    def test_warming_replica_takes_no_traffic(self):
        warm, cold = _fakes({"load": 50}, {"warmed": False, "load": 0})
        router = FleetRouter(engines=[warm, cold])
        router.submit("x")
        assert warm.submits and not cold.submits

    def test_all_warming_is_retryable_overload(self):
        router = FleetRouter(engines=_fakes({"warmed": False}))
        with pytest.raises(ServerOverloadedError, match="warming") as ei:
            router.submit("x")
        assert ei.value.retry_after_ms == 1000.0

    def test_overload_only_when_all_ready_reject(self):
        full = ServerOverloadedError("queue full")
        e0, e1 = _fakes({"load": 0, "reject": full}, {"load": 9})
        router = FleetRouter(engines=[e0, e1])
        router.submit("x")
        assert e1.submits
        e1.reject = full
        with pytest.raises(ServerOverloadedError, match="all 2 ready"):
            router.submit("x")

    def test_failover_past_a_racing_drain(self):
        e0, e1 = _fakes({"load": 0, "reject": ServerClosedError("bye")},
                        {"load": 9})
        router = FleetRouter(engines=[e0, e1])
        router.submit("x")
        assert e1.submits

    def test_closed_router_and_empty_fleet(self):
        router = FleetRouter(engines=_fakes({}))
        router.shutdown()
        with pytest.raises(ServerClosedError):
            router.submit("x")
        assert FleetRouter().health()[0] is False


class TestMembership:
    def test_remove_replica_drains_and_leaves(self):
        e0, e1 = _fakes({"load": 3}, {"load": 1})
        router = FleetRouter(engines=[e0, e1])
        handle = router.remove_replica()
        assert handle.engine is e1
        handle._drain_thread.join(5)
        assert e1.drained is True
        assert [h.engine for h in router.replicas()] == [e0]
        router.submit("x")
        assert e0.submits

    def test_draining_replica_takes_no_new_traffic(self):
        gate = threading.Event()
        e0, e1 = _fakes({"load": 0}, {"load": 9})
        e0.shutdown = lambda drain=True, timeout=None: gate.wait(5)
        router = FleetRouter(engines=[e0, e1])
        handle = router.remove_replica(name="r0")
        assert handle.state() == "draining"
        router.submit("x")
        assert e1.submits and not e0.submits
        gate.set()
        handle._drain_thread.join(5)

    def test_dead_replica_evicted_via_heartbeat_plane(self):
        client = _FakeCoordClient()
        router = FleetRouter(
            engines=_fakes({}),
            liveness_factory=lambda name: heartbeat_liveness(client))
        assert router.counts()["ready"] == 1
        client._aborted = True
        router.poll()
        assert router.counts() == {"ready": 0, "warming": 0,
                                   "draining": 0, "dead": 0}
        with pytest.raises(ServerClosedError, match="no live replicas"):
            router.submit("x")

    def test_add_replica_needs_factory(self):
        router = FleetRouter(engines=_fakes({}))
        with pytest.raises(RuntimeError, match="factory"):
            router.add_replica()

    def test_serve_name_is_stamped_on_attach(self):
        e0, e1 = _fakes({}, {})
        FleetRouter(engines=[e0, e1])
        assert (e0.serve_name, e1.serve_name) == ("r0", "r1")


class TestAutoscaler:
    def _router(self, initial=1):
        return FleetRouter(factory=lambda name: _FakeEngine(),
                           initial=initial)

    def _join_drains(self, router):
        for h in router.replicas():
            if h._drain_thread is not None:
                h._drain_thread.join(5)

    def test_hysteresis_no_oscillation_across_a_watermark(self):
        router = self._router()
        p = {"v": 0.0}
        scaler = FleetAutoscaler(router, min_replicas=1, max_replicas=3,
                                 high_watermark=4.0, low_watermark=1.0,
                                 breach_up=2, breach_down=2,
                                 cooldown_s=0.0,
                                 pressure_fn=lambda: p["v"])
        p["v"] = 5.0
        assert scaler.poll_once() is None
        assert scaler.poll_once() == "grow"
        assert router.counts()["ready"] == 2
        p["v"] = 2.0
        assert all(scaler.poll_once() is None for _ in range(10))
        p["v"] = 0.0
        assert scaler.poll_once() is None
        p["v"] = 2.0
        assert all(scaler.poll_once() is None for _ in range(5))
        p["v"] = 0.0
        assert scaler.poll_once() is None
        assert scaler.poll_once() == "shrink"
        self._join_drains(router)
        assert router.counts()["ready"] == 1
        assert all(scaler.poll_once() is None for _ in range(5))
        assert router._metrics.scale_counts() == {"grow": 1, "shrink": 1}

    def test_cooldown_holds_between_changes(self):
        router = self._router()
        clock = {"t": 0.0}
        p = {"v": 5.0}
        scaler = FleetAutoscaler(router, min_replicas=1, max_replicas=3,
                                 high_watermark=4.0, low_watermark=1.0,
                                 breach_up=1, breach_down=1,
                                 cooldown_s=10.0,
                                 pressure_fn=lambda: p["v"],
                                 clock=lambda: clock["t"])
        assert scaler.poll_once() == "grow"
        p["v"] = 0.0
        assert scaler.poll_once() is None
        clock["t"] = 11.0
        assert scaler.poll_once() == "shrink"

    def test_one_pending_change_at_a_time(self):
        gate = threading.Event()
        router = self._router(initial=2)
        slow = router.replicas()[0].engine
        slow.shutdown = lambda drain=True, timeout=None: gate.wait(5)
        p = {"v": 0.0}
        scaler = FleetAutoscaler(router, min_replicas=1, max_replicas=4,
                                 high_watermark=4.0, low_watermark=1.0,
                                 breach_up=1, breach_down=1,
                                 cooldown_s=0.0,
                                 pressure_fn=lambda: p["v"])
        assert scaler.poll_once() == "shrink"
        p["v"] = 9.0
        assert router.counts()["draining"] == 1
        assert scaler.poll_once() is None
        gate.set()
        self._join_drains(router)
        assert scaler.poll_once() == "grow"

    def test_max_cap_and_min_refill(self):
        router = self._router()
        p = {"v": 9.0}
        scaler = FleetAutoscaler(router, min_replicas=1, max_replicas=2,
                                 high_watermark=4.0, low_watermark=1.0,
                                 breach_up=1, breach_down=1,
                                 cooldown_s=0.0,
                                 pressure_fn=lambda: p["v"])
        assert scaler.poll_once() == "grow"
        assert all(scaler.poll_once() is None for _ in range(3))
        p["v"] = 2.0
        for h in router.replicas():
            h._dead = True
        assert scaler.poll_once() == "grow"
        assert router.counts()["ready"] >= 1

    def test_ttft_secondary_trigger(self):
        class _Ttft:
            def __init__(self):
                self.sum, self.n = 0.0, 0

            def ttft_totals(self):
                return self.sum, self.n

        router = self._router()
        meter = _Ttft()
        router.replicas()[0].engine._metrics = meter
        scaler = FleetAutoscaler(router, min_replicas=1, max_replicas=3,
                                 high_watermark=4.0, low_watermark=1.0,
                                 breach_up=2, breach_down=2,
                                 cooldown_s=0.0, ttft_high_ms=10.0,
                                 pressure_fn=lambda: 2.0)
        meter.sum, meter.n = 0.5, 10
        assert scaler.poll_once() is None
        meter.sum, meter.n = 1.0, 20
        assert scaler.poll_once() == "grow"

    def test_default_pressure_is_load_per_ready_replica(self):
        router = FleetRouter(engines=_fakes({"load": 6}, {"load": 2},
                                            {"warmed": False, "load": 90}),
                             factory=lambda name: _FakeEngine())
        scaler = FleetAutoscaler(router)
        assert scaler.pressure() == 4.0

    def test_knob_validation(self):
        router = self._router()
        with pytest.raises(ValueError, match="min_replicas"):
            FleetAutoscaler(router, min_replicas=0)
        with pytest.raises(ValueError, match="factory"):
            FleetAutoscaler(FleetRouter(engines=_fakes({})))
        with pytest.raises(ValueError, match="max_replicas"):
            FleetAutoscaler(router, min_replicas=3, max_replicas=2)
        with pytest.raises(ValueError, match="oscillation"):
            FleetAutoscaler(router, high_watermark=2.0, low_watermark=2.0)
        with pytest.raises(ValueError, match="breach"):
            FleetAutoscaler(router, breach_up=0)
        with pytest.raises(ValueError, match="direction"):
            FleetMetrics().on_scale("sideways")


class TestFleetMetricsSurface:
    def test_one_valid_exposition_with_replica_labels(self):
        router = FleetRouter(engines=_fakes({}, {"load": 1}))
        router.submit("x")
        body = router.prom_metrics()
        parsed = parse_exposition(body)
        assert body.count("# TYPE hvd_requests_total counter") == 1
        assert parsed[("hvd_requests_total",
                       (("engine", "generate"), ("replica", "r0")))] == 1.0
        assert parsed[("hvd_fleet_replicas", (("state", "ready"),))] == 2.0
        assert parsed[("hvd_fleet_dispatch_total",
                       (("replica", "r0"),))] == 1.0
        for d in ("grow", "shrink"):
            assert parsed[("hvd_fleet_scale_events_total",
                           (("direction", d),))] == 0.0
        # The lazy series stay absent from a thread-only, adapter-free
        # fleet.
        names = {n for n, _ in parsed}
        assert not names & {"hvd_fleet_replica_procs",
                            "hvd_fleet_adapters_resident",
                            "hvd_fleet_adapter_dispatch_total",
                            "hvd_fleet_prefix_dispatch_total"}

    def test_retired_replica_series_fold_bounds_cardinality(self):
        m = FleetMetrics()
        for name in ("r0", "r1", "r2"):
            m.on_dispatch(name)
            m.on_dispatch(name)
            m.forget_replica(name)
        assert m.dispatch_counts() == {"retired": 6}
        _, samples = m.registry.collect()
        labels = [dict(ls) for n, ls, _ in samples
                  if n == "hvd_fleet_dispatch_total"]
        assert labels == [{"replica": "retired"}]
        m.forget_replica("never-seen")
        # A dispatch racing an eviction credits the retired aggregate.
        m.on_dispatch("r1")
        assert m.dispatch_counts() == {"retired": 7}

    def test_shrink_keeps_cumulative_aggregates_monotone(self):
        e0, e1 = _fakes({"load": 0}, {"load": 1})
        router = FleetRouter(engines=[e0, e1])
        router.submit("a")
        router.submit("b")
        before = router.stats()["requests_total"]
        assert before == 2
        handle = router.remove_replica()
        assert handle.engine is e0
        handle._drain_thread.join(5)
        after = router.stats()
        assert after["requests_total"] == before
        assert after["fleet"]["replicas"] == 1
        assert after["queue_depth"] == 0

    def test_stats_aggregates_and_nests(self):
        router = FleetRouter(engines=_fakes({}, {}))
        router.submit("x")
        snap = router.stats()
        assert snap["requests_total"] == 1
        assert set(snap["replicas"]) == {"r0", "r1"}
        assert snap["fleet"]["n_ready"] == 2
        assert snap["fleet"]["dispatch_total"] == {"r0": 1}
        json.dumps(snap)


# -- real engines: the port's GenerationEngine on the CPU -----------------------

@pytest.fixture(scope="module")
def model():
    return common.torch_model(common.make_tree())


def _real_engine(model, **kw):
    eng = common.engine(model, **kw)
    eng.warmup()
    return eng


_PROMPTS = [[int(t) for t in p] for p in
            np.random.RandomState(7).randint(1, 32, size=(6, 4))]


class TestRealFleet:
    def test_single_shot_engines_as_replicas(self):
        """The single-shot ``Engine`` answers what ``ReplicaHandle``
        reads: a fleet of two routes ``infer`` least-depth, returns each
        replica's rows unchanged (an untracked future: no failover), and
        its loop thread is the liveness ground truth."""
        import torch
        w = torch.randn((8, 3), generator=torch.Generator().manual_seed(0))

        def apply(v, x):
            return x @ v

        engines = [serve.Engine(apply, w, item_shape=(8,), device="cpu",
                                config=serve.ServeConfig(max_batch=4))
                   for _ in range(2)]
        for e in engines:
            e.warmup()
        router = FleetRouter(engines=engines, poll_interval_s=0)
        try:
            x = np.arange(8, dtype=np.float32)
            got = router.infer(x, timeout=common.TIMEOUT)
            np.testing.assert_array_equal(
                got, apply(w, torch.from_numpy(x)[None]).numpy()[0])
            assert router._live_streams == {}
            assert router.counts()["ready"] == 2
            assert router.stats()["fleet"]["dispatch_total"] == {"r0": 1}
            assert all(h.alive() for h in router.replicas())
        finally:
            router.shutdown()
        assert all(not e._thread.is_alive() for e in engines)

    def test_drain_on_evict_bit_identical_to_single_engine(self, model):
        ref = _real_engine(model)
        try:
            ref_streams = sorted(
                tuple(ref.generate(p, timeout=common.TIMEOUT)["tokens"])
                for p in _PROMPTS)
        finally:
            ref.shutdown()
        router = FleetRouter(engines=[_real_engine(model),
                                      _real_engine(model)])
        handles = [router.submit(p) for p in _PROMPTS]
        # Scale down mid-flight: the evicted replica finishes every stream
        # it admitted; none is lost or resampled.
        evicted = router.remove_replica()
        results = [h.result(timeout=common.TIMEOUT) for h in handles]
        evicted._drain_thread.join(30)
        assert len(results) == len(_PROMPTS)
        assert sorted(tuple(r["tokens"]) for r in results) == ref_streams
        dispatch = router._metrics.dispatch_counts()
        assert "retired" in dispatch and len(dispatch) == 2
        assert all(v > 0 for v in dispatch.values())
        assert router.counts()["ready"] == 1
        # The retired replica's history stays in the fleet aggregates.
        assert router.stats()["generation"]["generations_total"] \
            == len(_PROMPTS)
        router.shutdown()

    def test_http_mount_metrics_stats_healthz_generate(self, model):
        router = FleetRouter(engines=[_real_engine(model),
                                      _real_engine(model)])
        router.generate(_PROMPTS[0], timeout=common.TIMEOUT)
        try:
            with serve.HttpServer(generate=router) as srv:
                base = f"http://{srv.host}:{srv.port}"
                hz = json.loads(urllib.request.urlopen(
                    base + "/healthz").read())
                assert hz["status"] == "ok"
                assert hz["replicas"]["ready"] == 2
                assert "replica_metrics" not in hz   # thread replicas
                snap = json.loads(urllib.request.urlopen(
                    base + "/stats").read())
                assert set(snap["replicas"]) == {"r0", "r1"}
                assert snap["fleet"]["n_ready"] == 2
                body = urllib.request.urlopen(
                    base + "/metrics").read().decode()
                parsed = parse_exposition(body)
                assert body.count(
                    "# TYPE hvd_generations_total counter") == 1
                assert ("hvd_fleet_replicas",
                        (("state", "ready"),)) in parsed
                assert any(dict(labels).get("replica") == "r0"
                           for (name, labels) in parsed
                           if name == "hvd_generate_ttft_seconds_bucket")
                req = urllib.request.Request(
                    base + "/generate",
                    data=json.dumps({"tokens": _PROMPTS[1],
                                     "stream": False}).encode(),
                    headers={"Content-Type": "application/json"})
                out = json.loads(urllib.request.urlopen(req).read())
                assert len(out["tokens"]) == out["n_tokens"] > 0
                # The fleet poller's serving line (tpurun_torch
                # --metrics-summary against this port).
                from horovod_tpu_torch.obs.summary import FleetPoller
                fp = FleetPoller(srv.host, srv.port, 1)
                line = fp.line()
                assert fp.last_mode == "serving"
                assert "2/2 replicas ready" in line
                assert "depth=" in line and "ttft_p50" in line
                time.sleep(0.05)
                assert "tokens/s" in fp.line()
        finally:
            router.shutdown()

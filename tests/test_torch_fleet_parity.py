"""Port parity: the port's ``FleetRouter`` and ``FleetAutoscaler`` make the
JAX package's decisions on the same scripts.

One fake generation engine a package, on that package's
``ReadinessMixin`` and ``GenerationHandle``: its tokens are a pure
function of the prompt (``prompt[-1] + 1, + 2, …``), as
``tests/test_failover.py``'s fake is, with scripted loads, rejections,
warming, strands, failures, divergence. Each scenario runs through JAX's
router and the port's, and these must be equal (exactly):

* each request's chosen replica and outcome (its tokens and failovers,
  or its error's type, message, ``reason`` and ``retry_after_ms``);
* ``counts()`` and ``stats()["fleet"]`` (membership, dispatch, scale
  events, strands and failover outcomes);
* the parsed ``/metrics`` samples (names, labels and values; the fakes
  export no timing histograms).

``FleetAutoscaler.poll_once`` takes the same pressure and TTFT sequences
(cooldown 0) in both packages and must return the same decisions with
the same membership after each.
"""

import threading
import time

import pytest

from horovod_tpu.exceptions import (PreemptedError as JPreemptedError,
                                    ServerClosedError as JServerClosedError,
                                    ServerOverloadedError as JOverloaded)
from horovod_tpu.obs.registry import parse_exposition as jparse
from horovod_tpu.serve import engine as jengine
from horovod_tpu.serve import fleet as jfleet
from horovod_tpu.serve import generate as jgenerate
from horovod_tpu.serve import router as jrouter
from horovod_tpu_torch.exceptions import (PreemptedError, ServerClosedError,
                                          ServerOverloadedError)
from horovod_tpu_torch.obs.registry import parse_exposition
from horovod_tpu_torch.serve import engine as tengine
from horovod_tpu_torch.serve import fleet as tfleet
from horovod_tpu_torch.serve import generate as tgenerate
from horovod_tpu_torch.serve import router as trouter


def _fake_class(mixin, handle_cls):
    class _Cfg:
        default_deadline_ms = None

    class Fake(mixin):
        def __init__(self, log, warmed=True, load=0, reject=None,
                     strand_after=None, fail_after=None, fail_with=None,
                     fail_always=False, diverge=False, shared=None):
            self._queue = []
            self._warmed = warmed
            self._closed = False
            self._load = load
            self._shared = shared       # a dict whose "load" all read
            self._cfg = _Cfg()
            self.log = log
            self.reject = reject
            self.strand_after = strand_after
            self.fail_after = fail_after
            self.fail_with = fail_with
            self.fail_always = fail_always
            self.diverge = diverge
            self.alive_flag = True
            self.submits = 0
            self.tokens = 0

        def load(self):
            return self._shared["load"] if self._shared else self._load

        def loop_alive(self, stall_s=0.0):
            return self.alive_flag

        def submit(self, tokens, *, max_new_tokens=4, sampling=None,
                   eos_id=None, deadline_ms=None, adapter=None):
            if self.reject is not None:
                self.log.append(("rejected", self.serve_name))
                raise self.reject
            self.log.append(("admitted", self.serve_name))
            self.submits += 1
            off = 100 if self.diverge else 0
            toks = [int(tokens[-1]) + 1 + i + off
                    for i in range(max_new_tokens)]
            h = handle_cls()
            if self.strand_after is not None:
                toks = toks[:self.strand_after]
                self.strand_after = None
            elif self.fail_after is not None:
                for t in toks[:self.fail_after]:
                    h._emit(t)
                self.tokens += self.fail_after
                h._fail(self.fail_with)
                if not self.fail_always:
                    self.fail_after = None
                return h
            for t in toks:
                h._emit(t)
            self.tokens += len(toks)
            if len(toks) == max_new_tokens:
                h._finish({"tokens": toks, "finish_reason": "length",
                           "n_tokens": len(toks)})
            return h

        def warmup(self):
            self._warmed = True

        def shutdown(self, drain=True, timeout=None):
            self._closed = True

        def stats(self):
            return {"requests_total": self.submits, "queue_depth": 0,
                    "active_slots": 0,
                    "generation": {"generations_total": self.submits,
                                   "tokens_generated_total": self.tokens}}

        def prom_collect(self):
            return ({"hvd_requests_total": ("counter", "requests"),
                     "hvd_tokens_generated_total": ("counter", "tokens")},
                    [("hvd_requests_total", {"engine": "generate"},
                      float(self.submits)),
                     ("hvd_tokens_generated_total", {"engine": "generate"},
                      float(self.tokens))])
    return Fake


class _Pkg:
    def __init__(self, jax_side: bool):
        if jax_side:
            self.Fake = _fake_class(jengine.ReadinessMixin,
                                    jgenerate.GenerationHandle)
            self.FleetRouter = jrouter.FleetRouter
            self.FleetAutoscaler = jfleet.FleetAutoscaler
            self.Overloaded = JOverloaded
            self.Closed = JServerClosedError
            self.Preempted = JPreemptedError
            self.parse = jparse
        else:
            self.Fake = _fake_class(tengine.ReadinessMixin,
                                    tgenerate.GenerationHandle)
            self.FleetRouter = trouter.FleetRouter
            self.FleetAutoscaler = tfleet.FleetAutoscaler
            self.Overloaded = ServerOverloadedError
            self.Closed = ServerClosedError
            self.Preempted = PreemptedError
            self.parse = parse_exposition

    def overloaded(self, hint=None):
        e = self.Overloaded("queue full")
        if hint is not None:
            e.retry_after_ms = hint
        return e


def _outcome(fn):
    try:
        r = fn()
    except Exception as e:  # noqa: BLE001 — the outcome is the datum
        return ("error", type(e).__name__, str(e),
                getattr(e, "reason", None),
                getattr(e, "retry_after_ms", None))
    if isinstance(r, dict):
        return ("ok", tuple(r["tokens"]), r.get("failovers"))
    return ("ok", r)


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.002)
    assert pred()


def _snapshot(router, pkg, log, outcomes):
    return {"outcomes": outcomes, "log": list(log),
            "counts": router.counts(),
            "fleet": router.stats()["fleet"],
            "metrics": pkg.parse(router.prom_metrics())}


def _router(pkg, engines, **kw):
    kw.setdefault("poll_interval_s", 0)
    kw.setdefault("failover_backoff_s", 0.001)
    return pkg.FleetRouter(engines=engines, **kw)


def _dispatch(pkg):
    """Loads, a warming replica, rejections with hints, a racing drain,
    every ready replica rejecting, a warmup, a drain-on-evict."""
    log = []
    F = pkg.Fake
    e = [F(log, load=3), F(log, load=0), F(log, warmed=False, load=0),
         F(log, load=1, reject=pkg.overloaded(200.0))]
    router = _router(pkg, e)
    out = []
    out.append(_outcome(lambda: router.submit([1]).result(5)))
    e[1]._load = 5
    out.append(_outcome(lambda: router.submit([2]).result(5)))
    e[0].reject = pkg.Closed("bye")
    out.append(_outcome(lambda: router.submit([3]).result(5)))
    e[1].reject = pkg.overloaded(700.0)
    out.append(_outcome(lambda: router.submit([4])))
    e[2].warmup()
    out.append(_outcome(lambda: router.submit([5]).result(5)))
    for x in e:
        x.reject = None
    handle = router.remove_replica()
    handle._drain_thread.join(5)
    out.append(handle.name)
    out.append(_outcome(lambda: router.submit([6]).result(5)))
    snap = _snapshot(router, pkg, log, out)
    router.shutdown()
    return snap


def _stranded(pkg):
    """A replica that strands its stream dies (liveness verdict); the
    stream resumes on the survivor with its prefix suppressed."""
    log = []
    e0 = pkg.Fake(log, load=0, strand_after=2)
    e1 = pkg.Fake(log, load=5)
    router = _router(pkg, [e0, e1])
    h = router.submit([7], max_new_tokens=4)
    _wait(lambda: len(h._tokens) == 2)
    e0.alive_flag = False
    router.poll()
    out = [_outcome(lambda: h.result(5))]
    out.append(_outcome(lambda: router.submit([9], max_new_tokens=3)
                        .result(5)))
    snap = _snapshot(router, pkg, log, out)
    router.shutdown()
    return snap


def _diverging(pkg):
    """The replay on the survivor diverges: the stream fails, counted
    exhausted alone."""
    log = []
    e0 = pkg.Fake(log, load=0, strand_after=2)
    e1 = pkg.Fake(log, load=5, diverge=True)
    router = _router(pkg, [e0, e1])
    h = router.submit([7], max_new_tokens=4)
    _wait(lambda: len(h._tokens) == 2)
    e0.alive_flag = False
    router.poll()
    out = [_outcome(lambda: h.result(5)), tuple(h._tokens)]
    snap = _snapshot(router, pkg, log, out)
    router.shutdown()
    return snap


def _exhausted(pkg):
    """A sick survivor fails every replay: the budget's worth of
    re-dispatches, then ``failover_exhausted``; a stream preempted on
    every replica ends ``preempted_exhausted``."""
    log = []
    F = pkg.Fake
    e0 = F(log, load=0, strand_after=1)
    e1 = F(log, load=5, fail_after=0, fail_always=True,
           fail_with=RuntimeError("sick"))
    router = _router(pkg, [e0, e1], failover_retries=2)
    h = router.submit([5], max_new_tokens=4)
    _wait(lambda: len(h._tokens) == 1)
    e0.alive_flag = False
    router.poll()
    out = [_outcome(lambda: h.result(5)), tuple(h._tokens)]
    e2 = F(log, load=0, fail_after=1, fail_always=True,
           fail_with=pkg.Preempted("evicted"))
    e3 = F(log, load=9, fail_after=1, fail_with=pkg.Preempted("again"))
    router2 = _router(pkg, [e2, e3], failover_retries=1)
    out.append(_outcome(lambda: router2.submit([3], max_new_tokens=3)
                        .result(5)))
    snap = _snapshot(router, pkg, log, out)
    snap["fleet2"] = router2.stats()["fleet"]
    router.shutdown()
    router2.shutdown()
    return snap


def _lifecycle(pkg):
    """A factory fleet: replicas built at construction, one grown (seeded
    warm), a dead one evicted by poll, health through the changes."""
    log = []
    router = _router(pkg, None, factory=lambda name: pkg.Fake(log),
                     initial=2)
    out = [router.health()[:2]]
    grown = router.add_replica(warm=False)
    out.append((grown.name, router.health()[:2]))
    router.replicas()[0]._dead = True
    out.append(router.poll())
    out.append(_outcome(lambda: router.submit([4], max_new_tokens=2)
                        .result(5)))
    for h in router.replicas():
        h.engine.alive_flag = False
    router.poll()
    out.append(_outcome(lambda: router.submit([4])))
    out.append(router.health()[:2])
    snap = _snapshot(router, pkg, log, out)
    router.shutdown()
    out.append(_outcome(lambda: router.submit([4])))
    return snap


SCENARIOS = [_dispatch, _stranded, _diverging, _exhausted, _lifecycle]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__.strip("_") for s in SCENARIOS])
def test_router_decisions_match_jax(scenario):
    want = scenario(_Pkg(jax_side=True))
    got = scenario(_Pkg(jax_side=False))
    assert got == want


# -- the autoscaler -------------------------------------------------------------

PRESSURE = [5, 5, 2, 2, 0, 9, 9, 9, 0, 0, 0, 3, 0, 0, 9, 9, 0.5, 0.5]


def _settle(router):
    _wait(lambda: router.counts()["draining"] == 0)


def _scale(pkg, seq, **kw):
    log = []
    p = {"v": 0.0}
    router = pkg.FleetRouter(factory=lambda name: pkg.Fake(log), initial=1,
                             poll_interval_s=0)
    scaler = pkg.FleetAutoscaler(router, cooldown_s=0.0,
                                 pressure_fn=lambda: p["v"], **kw)
    trace = []
    for v in seq:
        p["v"] = float(v)
        d = scaler.poll_once()
        _settle(router)
        trace.append((d, router.counts()["ready"]))
    trace.append(router.stats()["fleet"]["scale_events"])
    router.shutdown()
    return trace


@pytest.mark.parametrize("knobs", [
    dict(min_replicas=1, max_replicas=3, high_watermark=4.0,
         low_watermark=1.0, breach_up=2, breach_down=2),
    dict(min_replicas=1, max_replicas=2, high_watermark=4.0,
         low_watermark=1.0, breach_up=1, breach_down=1),
    dict(min_replicas=2, max_replicas=4, high_watermark=8.0,
         low_watermark=1.0, breach_up=1, breach_down=3)],
    ids=["hysteresis", "caps", "refill"])
def test_autoscaler_decisions_match_jax(knobs):
    want = _scale(_Pkg(jax_side=True), PRESSURE, **knobs)
    got = _scale(_Pkg(jax_side=False), PRESSURE, **knobs)
    assert got == want
    assert any(d == "grow" for d, _ in got[:-1])


def _scale_default_signal(pkg):
    """The default signals: load per ready replica from the replicas
    themselves, and the TTFT trigger differenced from their
    ``ttft_totals``; one drain held open (one pending change at a
    time)."""
    log = []
    shared = {"load": 0}

    class _Ttft:
        def __init__(self):
            self.sum, self.n = 0.0, 0

        def ttft_totals(self):
            return self.sum, self.n

    meter = _Ttft()

    def factory(name):
        eng = pkg.Fake(log, shared=shared)
        eng._metrics = meter
        return eng

    router = pkg.FleetRouter(factory=factory, initial=1, poll_interval_s=0)
    scaler = pkg.FleetAutoscaler(router, min_replicas=1, max_replicas=3,
                                 high_watermark=4.0, low_watermark=1.0,
                                 breach_up=2, breach_down=2, cooldown_s=0.0,
                                 ttft_high_ms=10.0)
    trace = []
    for load, ttft in ((2, (0.5, 10)), (2, (1.0, 20)), (2, (1.0, 20)),
                       (6, (1.0, 20)), (6, (1.0, 20)), (0, (1.0, 20))):
        shared["load"] = load
        meter.sum, meter.n = ttft
        trace.append((scaler.pressure(), scaler.poll_once(),
                      router.counts()["ready"]))
        _settle(router)
    gate = threading.Event()
    for h in router.replicas():
        h.engine.shutdown = lambda drain=True, timeout=None: gate.wait(5)
    trace.append(scaler.poll_once())
    shared["load"] = 9
    trace.append((scaler.poll_once(), router.counts()["draining"]))
    gate.set()
    _settle(router)
    trace.append(scaler.poll_once())
    trace.append(router.stats()["fleet"]["scale_events"])
    router.shutdown()
    return trace


def test_autoscaler_default_signals_match_jax():
    want = _scale_default_signal(_Pkg(jax_side=True))
    got = _scale_default_signal(_Pkg(jax_side=False))
    assert got == want
    flat = [x for t in got for x in (t if isinstance(t, tuple) else (t,))]
    assert "grow" in flat and "shrink" in flat
    assert got[7] == (None, 1)      # a drain in flight: no decision

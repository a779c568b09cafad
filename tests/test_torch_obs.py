"""Port parity: the telemetry plane (``obs``: registry, flight recorder,
HTTP listener), the Chrome-trace timeline (``utils.timeline``) and the
fault grammar (``testing.faults``) against the JAX package's copies of
the same framework-neutral modules, on the CPU.

* The same counter, gauge and histogram operations render the same
  Prometheus exposition text, byte for byte, and parse back the same.
* The Trainer registers the same metric names, kinds and help strings
  (names are API) and counts its steps, samples and epochs.
* A checkpoint save through ``AsyncCheckpointer`` emits the same
  timeline events (names and phases) as JAX's, and the same timeline
  calls write the same event stream (timestamps aside).
* The flight recorder dumps the same record; the fault spec parser gives
  the same faults and refuses the same specs; ``/metrics`` serves the
  registry over HTTP on localhost.
"""

import contextlib
import importlib
import json
import os
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_dist_worker
from horovod_tpu import trainer as jtrainer
from horovod_tpu import training as jtraining
from horovod_tpu.obs import flightrec as jflight
from horovod_tpu.testing import faults as jfaults
from horovod_tpu.utils import timeline as jtl
from horovod_tpu_torch import runtime
from horovod_tpu_torch import trainer as ttrainer
from horovod_tpu_torch.obs import flightrec as tflight
from horovod_tpu_torch.obs import http as thttp
from horovod_tpu_torch.testing import faults as tfaults
from horovod_tpu_torch.training import create_train_state, make_train_step
from horovod_tpu_torch.utils import timeline as ttl

# (``obs.registry`` the attribute is the registry() function.)
jreg = importlib.import_module("horovod_tpu.obs.registry")
treg = importlib.import_module("horovod_tpu_torch.obs.registry")
class _JaxDense(nn.Module):
    @nn.compact
    def __call__(self, x, train=True):
        return nn.Dense(10)(x)


TRAINER_METRICS = ("hvd_steps_total", "hvd_step_seconds",
                   "hvd_samples_total", "hvd_bad_steps_total",
                   "hvd_epochs_total", "hvd_global_step")


@pytest.fixture
def world1(monkeypatch):
    for var in ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK", "HVD_ZERO",
                "HVD_OVERLAP", "HVD_GUARD_NONFINITE", "HVD_WIRE_DTYPE",
                "HVD_METRICS_PORT", "HOROVOD_TIMELINE"):
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    yield
    runtime.shutdown()


def _exercise(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("hvd_things_total", "Things done")
    c.inc()
    c.inc(2.5)
    g = reg.gauge("hvd_level", "A level")
    g.set(7)
    g.dec(0.25)
    h = reg.histogram("hvd_wait_seconds", "Waits", buckets=[0.1, 1, 10])
    for v in (0.05, 0.5, 5, 50):
        h.observe(v)
    lab = reg.counter("hvd_req_total", "Requests", labels=("code", "path"))
    lab.labels(code="200", path='/a"b\\c\nd').inc(3)
    lab.labels(code="503", path="/x").inc()
    gone = reg.gauge("hvd_gone", "Removed", labels=("r",))
    gone.labels(r="1").set(1)
    gone.labels(r="2").set(2)
    gone.remove(r="1")
    errors = []
    for bad in (lambda: reg.gauge("hvd_things_total"),
                lambda: reg.histogram("hvd_wait_seconds", buckets=[1]),
                lambda: c.inc(-1), lambda: reg.counter("bad name"),
                lambda: lab.inc()):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    return reg, errors


def test_exposition_is_byte_identical():
    (jr, jerr), (tr, terr) = _exercise(jreg), _exercise(treg)
    for labels in (None, {"rank": "3"}):
        assert tr.render(labels) == jr.render(labels)
    assert terr == jerr and len(terr) == 5
    text = tr.render({"rank": "0"})
    assert treg.parse_exposition(text) == jreg.parse_exposition(text)
    assert treg.render(*tr.collect()) == jreg.render(*jr.collect())


@contextlib.contextmanager
def _trainer_metrics_unregistered(reg):
    """The process-default registry without the Trainer's metrics for the
    block (restored after): the first registration of a name keeps its
    help text, so a test that read a counter earlier in this worker
    (``registry().counter(name)``, no help) would otherwise decide what
    the Trainer's registration shows."""
    saved = dict(reg._metrics)
    for name in TRAINER_METRICS:
        reg._metrics.pop(name, None)
    try:
        yield
    finally:
        reg._metrics.clear()
        reg._metrics.update(saved)


def test_trainer_metric_names_match_jax(world1):
    state = create_train_state(torch_dist_worker._MLP(),
                               torch_dist_worker.OPTS["sgd"], device="cpu")
    with _trainer_metrics_unregistered(treg.registry()):
        ttrainer.Trainer(make_train_step(), state, verbose=False)
        tmeta, _ = treg.registry().collect()
    jstate, opt = jtraining.create_train_state(
        _JaxDense(), jax.random.PRNGKey(0), jnp.zeros((2, 8)),
        optax.sgd(0.1))
    with _trainer_metrics_unregistered(jreg.registry()):
        jtrainer.Trainer(jtraining.make_train_step(_JaxDense(), opt),
                         jstate, verbose=False)
        jmeta, _ = jreg.registry().collect()
    for name in TRAINER_METRICS:
        assert tmeta[name] == jmeta[name], name
    for name in ("hvd_world_size", "hvd_rank"):
        assert tmeta[name] == jmeta[name], name


def test_trainer_counts_steps_samples_and_epochs(world1):
    reg = treg.registry()
    before = {n: reg.counter(n).value for n in
              ("hvd_steps_total", "hvd_samples_total", "hvd_epochs_total")}
    steps0 = reg.histogram("hvd_step_seconds").count
    state = create_train_state(torch_dist_worker._MLP(),
                               torch_dist_worker.OPTS["sgd"], device="cpu")
    rng = np.random.RandomState(0)
    batches = [(rng.randn(6, 8).astype(np.float32),
                rng.randint(0, 10, 6)) for _ in range(3)]
    tr = ttrainer.Trainer(make_train_step(), state, verbose=False)
    tr.fit(lambda: batches, epochs=2)
    assert reg.counter("hvd_steps_total").value - before[
        "hvd_steps_total"] == 6
    assert reg.counter("hvd_samples_total").value - before[
        "hvd_samples_total"] == 36
    assert reg.counter("hvd_epochs_total").value - before[
        "hvd_epochs_total"] == 2
    assert reg.histogram("hvd_step_seconds").count - steps0 == 6
    assert reg.gauge("hvd_global_step").value == 6
    assert tflight.recorder().last("step")["step"] == 5


def _events(path):
    with open(path) as f:
        evs = json.load(f)
    names = {e["pid"]: e["args"]["name"] for e in evs
             if e.get("name") == "process_name"}
    return [(names[e["pid"]], e["name"], e["ph"]) for e in evs
            if e.get("ph") in ("B", "E", "i")]


def test_checkpoint_save_timeline_events_match_jax(tmp_path, world1):
    state = create_train_state(torch_dist_worker._MLP(),
                               torch_dist_worker.OPTS["sgd"], device="cpu")
    t_path = str(tmp_path / "port.json")
    w = ttrainer.AsyncCheckpointer(timeline=ttl.Timeline(t_path))
    ttrainer.save_checkpoint(str(tmp_path / "port"), state, writer=w)
    w.close()
    w.timeline.close()
    jstate, _ = jtraining.create_train_state(
        _JaxDense(), jax.random.PRNGKey(0), jnp.zeros((2, 8)),
        optax.sgd(0.1))
    j_path = str(tmp_path / "jax.json")
    jw = jtrainer.AsyncCheckpointer(timeline=jtl.Timeline(j_path))
    jtrainer.save_checkpoint(str(tmp_path / "jax"), jstate, writer=jw)
    jw.close()
    jw.timeline.close()
    got = _events(t_path)
    assert sorted(got) == sorted(_events(j_path))
    assert sorted(got) == sorted([
        ("ckpt.snapshot", "CKPT_SNAPSHOT", "B"), ("ckpt.snapshot", "", "E"),
        ("ckpt.write", "CKPT_WRITE", "B"), ("ckpt.write", "", "E")])


def _timeline_calls(mod, path):
    tl = mod.Timeline(path)
    tl.negotiate_instant("grad.0", "ALLREDUCE", ready_ranks=[0, 1])
    tl.start("grad.0", "ALLREDUCE")
    with tl.activity("grad.0", "QUEUE"):
        pass
    tl.end("grad.0", output=np.zeros((2, 3), np.float32))
    with pytest.raises(mod.TimelineStateError):
        tl.end("grad.0")
    try:
        with tl.op("ckpt.write", "CKPT_WRITE"):
            raise KeyError("x")
    except KeyError:
        pass
    with mod.maybe_op(None, "x", "H2D") as none:
        assert none is None
    tl.close()
    with open(path) as f:
        evs = json.load(f)
    for e in evs:
        e.pop("ts", None)
    return evs


def test_timeline_writes_the_same_stream(tmp_path):
    assert _timeline_calls(ttl, str(tmp_path / "t.json")) == \
        _timeline_calls(jtl, str(tmp_path / "j.json"))
    assert (ttl.H2D, ttl.CKPT_SNAPSHOT, ttl.CKPT_WRITE, ttl.BAD_STEP) == \
        (jtl.H2D, jtl.CKPT_SNAPSHOT, jtl.CKPT_WRITE, jtl.BAD_STEP)


def test_flight_recorder_dumps_the_same_record(tmp_path):
    recs = []
    for mod, sub in ((tflight, "t"), (jflight, "j")):
        rec = mod.FlightRecorder(capacity=3)
        for i in range(5):
            rec.record("step", step=i, epoch=0)
        rec.record("bad_step", step=4, consecutive=1)
        path = rec.dump("drill", directory=str(tmp_path / sub), rank=1)
        with open(path) as f:
            out = json.load(f)
        for key in ("dumped_at",):
            out.pop(key)
        for ev in out["events"]:
            ev.pop("t")
        recs.append((os.path.basename(path), out))
    assert recs[0] == recs[1]
    assert recs[0][1]["last_step"] == 4 and recs[0][1]["n_events"] == 3


SPECS = ("rank=2:kill@step=3", "rank=1:mute@step=2,coord:delay_ms=50",
         "rank=0:exit@step=4@epoch=1", "ckpt:flip@step=5",
         "resize:shrink=2@step=3", "replica_kill=r1@stream=3",
         "slow_step=50")
BAD_SPECS = ("rank=x:kill@step=1", "rank=1:kill", "ckpt:kill@step=1",
             "coord:delay_ms=5@step=1", "resize:grow=0@step=1",
             "replica_kill=r1", "nope:kill@step=1")


def test_fault_grammar_matches_jax():
    for spec in SPECS:
        assert [vars(f) for f in tfaults.parse_spec(spec)] == \
            [vars(f) for f in jfaults.parse_spec(spec)]
    for spec in BAD_SPECS:
        with pytest.raises(tfaults.FaultSpecError) as te:
            tfaults.parse_spec(spec)
        with pytest.raises(jfaults.FaultSpecError) as je:
            jfaults.parse_spec(spec)
        assert str(te.value) == str(je.value)
    tfaults.step_hook(3)          # unset: a no-op


def test_metrics_listener_serves_the_registry():
    reg, _ = _exercise(treg)
    with thttp.MetricsListener(0, render=lambda: reg.render(
            {"rank": "0"})) as lis:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{lis.port}/metrics", timeout=10) as r:
            body = r.read().decode()
            ctype = r.headers["Content-Type"]
    assert body == reg.render({"rank": "0"})
    assert ctype == thttp.CONTENT_TYPE


def test_runtime_starts_the_listener_from_the_environment(monkeypatch):
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("HVD_METRICS_PORT", str(port))
    monkeypatch.setenv("HVD_METRICS_HOST", "127.0.0.1")
    runtime.init(device="cpu")
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            body = r.read().decode()
    finally:
        runtime.shutdown()
    assert 'hvd_world_size{rank="0"} 1' in body
    assert runtime._metrics_listener is None

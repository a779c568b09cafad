"""Port parity: the single-shot bucketed batching ``Engine`` (and the
batcher's ``bucket_sizes``, ``pad_rows``, ``Request``) against the JAX
package's, mirroring ``tests/test_serve.py``'s classes.

The JAX tests' MLP (Dense 16, ReLU, Dense 5 over a 12-feature item) has
its flax weights carried into a plain PyTorch ``apply_fn``; the engine
runs on the CPU. Served rows are held bitwise to ``apply_fn`` rerun on
the exact executed batch (the reference's serving contract) and within
rtol 1e-5 / atol 1e-6 of JAX's ``model.apply`` on the row alone. A small
CIFAR ResNet in eval mode, its flax variables carried with
``convert.resnet_from_jax``, is served the same way against JAX's
``apply(train=False)``.
"""

import functools
import json
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import serve as jserve
from horovod_tpu.models import resnet as jres
from horovod_tpu_torch import convert
from horovod_tpu_torch.exceptions import (DeadlineExceededError,
                                          ServerClosedError,
                                          ServerOverloadedError)
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.serve import (SERVE_PHASES, Engine, Request,
                                     ServeConfig, bucket_for, bucket_sizes,
                                     pad_rows)
from horovod_tpu_torch.utils.timeline import Timeline

ITEM = (12,)


class _MLP(nn.Module):
    @nn.compact
    def __call__(self, x, train=False):
        x = nn.Dense(16)(x)
        x = nn.relu(x)
        return nn.Dense(5)(x)


@pytest.fixture(scope="module")
def model_and_vars():
    m = _MLP()
    v = m.init(jax.random.PRNGKey(0), jnp.zeros((1,) + ITEM, jnp.float32))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)
    return m, v


def _weights(v):
    """The flax MLP's weights as f32 tensors (``[in, out]`` kernels)."""
    p = v["params"]
    return {f"{k}{i}": torch.tensor(p[f"Dense_{i}"][n])
            for i in (0, 1) for k, n in (("k", "kernel"), ("b", "bias"))}


def _apply(w, x):
    return torch.relu(x @ w["k0"] + w["b0"]) @ w["k1"] + w["b1"]


def _engine(v, **cfg_kw):
    cfg_kw.setdefault("record_executed_batch", True)
    return Engine(_apply, _weights(v), item_shape=ITEM,
                  config=ServeConfig(**cfg_kw), device="cpu")


def _rows(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*ITEM).astype(np.float32) for _ in range(n)]


def _rerun(v, batch):
    with torch.no_grad():
        return _apply(_weights(v), torch.from_numpy(batch)).numpy()


class TestBatcher:
    @pytest.mark.parametrize("max_batch", [1, 8, 32])
    def test_bucket_sizes_match_jax(self, max_batch):
        assert bucket_sizes(max_batch) == jserve.bucket_sizes(max_batch)

    @pytest.mark.parametrize("bad", [6, 0])
    def test_bucket_sizes_refuse(self, bad):
        with pytest.raises(ValueError):
            bucket_sizes(bad)

    def test_bucket_for(self):
        buckets = bucket_sizes(16)
        assert [bucket_for(n, buckets) for n in (1, 2, 3, 4, 5, 9, 16)] \
            == [jserve.bucket_for(n, buckets)
                for n in (1, 2, 3, 4, 5, 9, 16)] == [1, 2, 4, 4, 8, 16, 16]
        with pytest.raises(ValueError):
            bucket_for(17, buckets)

    def test_pad_rows_replicates_row0(self):
        rows = _rows(3)
        out = pad_rows(rows, 8)
        assert out.shape == (8,) + ITEM
        np.testing.assert_array_equal(out, jserve.pad_rows(rows, 8))
        for i in range(3, 8):
            np.testing.assert_array_equal(out[i], rows[0])
        with pytest.raises(ValueError):
            pad_rows(rows, 2)
        with pytest.raises(ValueError):
            pad_rows([], 2)

    def test_request_expiry(self):
        now = time.monotonic()
        assert not Request(inputs=None, future=None, enqueued_at=now,
                           deadline_at=None).expired()
        r = Request(inputs=None, future=None, enqueued_at=now,
                    deadline_at=now + 1.0)
        assert not r.expired(now) and r.expired(now + 1.0)


class TestEngineCorrectness:
    def test_served_bit_identical_mixed_sizes(self, model_and_vars):
        """Across mixed request counts (and so buckets and padding) every
        served row is bitwise ``apply_fn`` on the executed batch."""
        _, v = model_and_vars
        eng = _engine(v, max_batch=8, batch_timeout_ms=10)
        try:
            eng.warmup()
            futs = []
            for burst, seed in ((1, 1), (3, 2), (8, 3), (5, 4)):
                for x in _rows(burst, seed):
                    futs.append(eng.submit(x))
                time.sleep(0.08)
            buckets = set()
            for f in futs:
                served = f.result(30)
                req = f.request
                buckets.add(req.bucket)
                assert served.tobytes() == \
                    _rerun(v, req.executed_batch)[req.row].tobytes()
            assert buckets <= {1, 2, 4, 8} and len(buckets) > 1
            assert eng.stats()["batch_fill_ratio"] <= 1.0
        finally:
            eng.shutdown()

    def test_served_close_to_jax_apply(self, model_and_vars):
        """Padding and batching change nothing beyond f32 noise against
        JAX's model.apply on the row alone."""
        m, v = model_and_vars
        eng = _engine(v, max_batch=4, batch_timeout_ms=5)
        try:
            xs = _rows(6, seed=9)
            outs = [f.result(30) for f in [eng.submit(x) for x in xs]]
            for x, out in zip(xs, outs):
                direct = np.asarray(m.apply(v, x[None], train=False))[0]
                np.testing.assert_allclose(out, direct, rtol=1e-5,
                                           atol=1e-6)
        finally:
            eng.shutdown()

    def test_warmup_runs_every_bucket(self, model_and_vars):
        _, v = model_and_vars
        eng = _engine(v, max_batch=8)
        try:
            assert eng.stats()["buckets_compiled"] == []
            assert eng.health()[1] == "warming"
            assert eng.warmup() == (1, 2, 4, 8)
            assert eng.stats()["buckets_compiled"] == [1, 2, 4, 8]
            assert eng.health() == (True, "ok", 0)
        finally:
            eng.shutdown()

    def test_warmup_rejects_batchless_output(self, model_and_vars):
        _, v = model_and_vars
        eng = Engine(lambda w, x: _apply(w, x).sum(), _weights(v),
                     item_shape=ITEM, config=ServeConfig(max_batch=2),
                     device="cpu")
        try:
            with pytest.raises(ValueError, match="leading batch axis"):
                eng.warmup()
        finally:
            eng.shutdown(drain=False)

    def test_submit_shape_validation(self, model_and_vars):
        _, v = model_and_vars
        eng = _engine(v, max_batch=2)
        try:
            with pytest.raises(ValueError, match="item shape"):
                eng.submit(np.zeros((3, 7), np.float32))
        finally:
            eng.shutdown()

    def test_tree_outputs_split_per_row(self, model_and_vars):
        _, v = model_and_vars
        eng = Engine(lambda w, x: {"logits": _apply(w, x),
                                   "pair": (x[:, :2], x.sum(-1))},
                     _weights(v), item_shape=ITEM,
                     config=ServeConfig(max_batch=4), device="cpu")
        try:
            eng.warmup()
            x = _rows(1)[0]
            out = eng.infer(x, timeout=30)
            assert out["logits"].shape == (5,)
            np.testing.assert_array_equal(out["pair"][0], x[:2])
            assert out["pair"][1].shape == ()
        finally:
            eng.shutdown()

    def test_default_device_is_the_gpu(self, model_and_vars):
        _, v = model_and_vars
        if torch.cuda.is_available():
            pytest.skip("this host has a GPU")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(_apply, _weights(v), item_shape=ITEM)


class TestFlushPolicy:
    def test_timeout_flush_partial_batch(self, model_and_vars):
        _, v = model_and_vars
        eng = _engine(v, max_batch=8, batch_timeout_ms=20)
        try:
            futs = [eng.submit(x) for x in _rows(2)]
            outs = [f.result(30) for f in futs]
            assert all(o.shape == (5,) for o in outs)
            assert all(f.request.bucket <= 2 for f in futs)
            assert eng.stats()["batches_total"] >= 1
        finally:
            eng.shutdown()

    def test_full_batch_flushes_without_timeout(self, model_and_vars):
        _, v = model_and_vars
        eng = _engine(v, max_batch=4, batch_timeout_ms=60_000)
        try:
            futs = [eng.submit(x) for x in _rows(4)]
            assert len([f.result(30) for f in futs]) == 4
        finally:
            eng.shutdown(drain=False)


class TestBackpressure:
    def test_overload_rejection_and_closed_cancel(self, model_and_vars):
        _, v = model_and_vars
        eng = _engine(v, max_batch=8, batch_timeout_ms=1000, max_queue=2)
        try:
            accepted, rejected = [], 0
            for x in _rows(8):
                try:
                    accepted.append(eng.submit(x))
                except ServerOverloadedError as e:
                    rejected += 1
                    assert 50.0 <= e.retry_after_ms <= 30000.0
            assert rejected >= 1 and len(accepted) >= 2
            assert eng.stats()["rejected_overload"] == rejected
        finally:
            eng.shutdown(drain=False)
        failed = 0
        for f in accepted:
            try:
                f.result(5)
            except ServerClosedError:
                failed += 1
        with pytest.raises(ServerClosedError):
            eng.submit(_rows(1)[0])
        assert eng.stats()["cancelled_shutdown"] == failed

    def test_deadline_expiry_in_queue(self, model_and_vars):
        _, v = model_and_vars
        eng = _engine(v, max_batch=8, batch_timeout_ms=60)
        try:
            fut = eng.submit(_rows(1)[0], deadline_ms=1.0)
            with pytest.raises(DeadlineExceededError):
                fut.result(30)
            snap = eng.stats()
            assert snap["expired_deadline"] == 1
            assert snap["responses_total"] == 0
        finally:
            eng.shutdown()

    def test_default_deadline_from_config(self, model_and_vars):
        _, v = model_and_vars
        eng = _engine(v, max_batch=8, batch_timeout_ms=60,
                      default_deadline_ms=1.0)
        try:
            with pytest.raises(DeadlineExceededError):
                eng.infer(_rows(1)[0], timeout=30)
        finally:
            eng.shutdown()

    def test_graceful_drain_serves_queued_requests(self, model_and_vars):
        _, v = model_and_vars
        eng = _engine(v, max_batch=8, batch_timeout_ms=5000)
        futs = [eng.submit(x) for x in _rows(5)]
        eng.shutdown(drain=True)   # flushes at once despite the 5 s knob
        outs = [f.result(10) for f in futs]
        assert len(outs) == 5 and all(o.shape == (5,) for o in outs)
        assert eng.stats()["responses_total"] == 5
        assert not eng._thread.is_alive()
        assert eng.health()[1] == "draining"

    def test_client_cancel_does_not_poison_batch(self, model_and_vars):
        _, v = model_and_vars
        eng = _engine(v, max_batch=8, batch_timeout_ms=100)
        try:
            xs = _rows(3)
            f0 = eng.submit(xs[0])
            rest = [eng.submit(x) for x in xs[1:]]
            cancelled = f0.cancel()
            outs = [f.result(30) for f in rest]
            assert len(outs) == 2 and all(o.shape == (5,) for o in outs)
            if cancelled:
                assert f0.cancelled()
            else:
                assert f0.result(30).shape == (5,)
        finally:
            eng.shutdown()

    def test_cancelled_future_survives_nondrain_shutdown(self,
                                                         model_and_vars):
        _, v = model_and_vars
        eng = _engine(v, max_batch=8, batch_timeout_ms=60_000)
        f0 = eng.submit(_rows(1)[0])
        f1 = eng.submit(_rows(1, seed=1)[0])
        assert f0.cancel()
        eng.shutdown(drain=False)
        with pytest.raises(ServerClosedError):
            f1.result(5)
        assert eng.stats()["cancelled_shutdown"] == 1

    def test_shutdown_idempotent(self, model_and_vars):
        _, v = model_and_vars
        eng = _engine(v, max_batch=2)
        eng.shutdown()
        eng.shutdown()


class TestStats:
    def test_snapshot_counters_and_quantiles(self, model_and_vars):
        _, v = model_and_vars
        eng = _engine(v, max_batch=4, batch_timeout_ms=5)
        try:
            for x in _rows(6):
                eng.infer(x, timeout=30)
            snap = eng.stats()
            assert snap["requests_total"] == 6
            assert snap["responses_total"] == 6
            assert snap["batches_total"] >= 2
            assert 0.0 < snap["batch_fill_ratio"] <= 1.0
            lat = snap["latency_ms"]
            assert lat["request_p99"] >= lat["request_p50"] > 0
            assert lat["execute_p50"] > 0
            assert snap["buckets"] == [1, 2, 4]
            assert eng.load() == 0
            json.dumps(snap)
        finally:
            eng.shutdown()

    def test_snapshot_keys_are_jax_engines(self, model_and_vars):
        """The port's snapshot carries every key of the JAX engine's."""
        m, v = model_and_vars
        eng = _engine(v, max_batch=2)
        jeng = jserve.Engine(lambda vv, x: m.apply(vv, x, train=False), v,
                             item_shape=ITEM,
                             config=jserve.ServeConfig(max_batch=2))
        try:
            got, want = eng.stats(), jeng.stats()
        finally:
            eng.shutdown()
            jeng.shutdown()

        def keys(d, prefix=""):
            return {prefix + k for k in d} | {
                k2 for k, x in d.items() if isinstance(x, dict)
                for k2 in keys(x, prefix + k + ".")}
        assert keys(want) <= keys(got)


class TestTimeline:
    def test_serving_phases_emitted(self, model_and_vars, tmp_path):
        """A served batch appears as an INFERENCE op with the QUEUE → PAD →
        XLA_EXECUTE → RESPOND activities, balanced through shutdown."""
        _, v = model_and_vars
        assert SERVE_PHASES == jserve.SERVE_PHASES
        path = str(tmp_path / "serve.json")
        tl = Timeline(path)
        eng = Engine(_apply, _weights(v), item_shape=ITEM,
                     config=ServeConfig(max_batch=4, batch_timeout_ms=5),
                     timeline=tl, device="cpu")
        try:
            for x in _rows(3):
                eng.infer(x, timeout=30)
        finally:
            eng.shutdown()
        tl.close()
        events = json.load(open(path))
        names = [e["name"] for e in events if e.get("ph") == "B"]
        first = names.index("INFERENCE")
        assert names[first + 1:first + 5] == list(SERVE_PHASES)
        depth = {}
        for e in events:
            if e.get("ph") == "B":
                depth[e["pid"]] = depth.get(e["pid"], 0) + 1
            elif e.get("ph") == "E":
                depth[e["pid"]] = depth.get(e["pid"], 0) - 1
                assert depth[e["pid"]] >= 0, events
        assert all(d == 0 for d in depth.values()), depth


# -- a small CIFAR ResNet in eval mode ----------------------------------------

RN_ITEM = (16, 16, 3)


@pytest.fixture(scope="module")
def resnet_vars():
    """Randomized flax variables of cifar_resnet_v1(depth=8), f32, with
    random running statistics (eval mode reads them)."""
    m = jres.cifar_resnet_v1(depth=8, num_classes=10, dtype=jnp.float32)
    v = jax.jit(m.init)(jax.random.PRNGKey(0),
                        jnp.zeros((1,) + RN_ITEM, jnp.float32))
    rng = np.random.RandomState(0)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        a = np.asarray(leaf, np.float32)
        if "scale" in name:
            return (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        if "bias" in name or "mean" in name:
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        if "var" in name:
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        return a
    return m, jax.tree_util.tree_map_with_path(perturb, v)


def test_resnet_served_matches_jax_eval(resnet_vars):
    m, v = resnet_vars
    cfg = tres.ResNetConfig(stage_sizes=(1, 1, 1), num_classes=10,
                            num_filters=16, dtype=torch.float32,
                            block="basic", cifar_stem=True)
    model = convert.resnet_from_jax(v, cfg, device="cpu")
    model.eval()
    eng = Engine(lambda mod, x: mod(x, train=False), model,
                 item_shape=RN_ITEM, device="cpu",
                 config=ServeConfig(max_batch=4, batch_timeout_ms=5,
                                    record_executed_batch=True))
    rng = np.random.RandomState(3)
    xs = [rng.randn(*RN_ITEM).astype(np.float32) for _ in range(6)]
    try:
        eng.warmup()
        futs = [eng.submit(x) for x in xs]
        outs = [f.result(60) for f in futs]
        jit_apply = jax.jit(functools.partial(m.apply, train=False))
        for x, out, f in zip(xs, outs, futs):
            direct = np.asarray(jit_apply(v, jnp.asarray(x[None])))[0]
            np.testing.assert_allclose(out, direct, rtol=1e-4, atol=1e-5)
            with torch.no_grad():
                again = model(torch.from_numpy(f.request.executed_batch),
                              train=False).numpy()
            assert out.tobytes() == again[f.request.row].tobytes()
    finally:
        eng.shutdown()

"""Port parity: ``trainer.Trainer``, ``AsyncCheckpointer``,
``restore_checkpoint``'s broadcast, ``MetricAverageCallback`` and the
input pipeline (``data``) against the JAX package, on the CPU.

* ``Trainer.fit``: the port's in a spawned 2-rank gloo world and JAX's on
  a 2-device CPU mesh (the JAX world re-formed over two devices for this
  module), 2 epochs × 3 steps of the CIFAR ResNet-8 (f32) from the same
  variables and global batches, with ``BroadcastGlobalVariablesCallback``
  and ``LearningRateWarmupCallback(warmup_epochs=2)``: the learning rate
  of every batch agrees exactly (the same Python float arithmetic on
  both sides, from an lr exact in f32), the corrected momentum to f32
  rounding (rtol 2^-22: JAX holds the previous lr as an f32 array), the
  epoch losses at the tolerance
  ``tests/test_torch_bench.py`` holds the CIFAR ResNet's loss to (rtol
  1e-4; f32 on both sides: two steps of sums in other orders move the
  loss by ~1e-6 here).
* The bad-step budget: the guarded step on NaN batches raises
  ``NonFiniteGradError`` on both sides at the same global step with the
  same count.
* ``AsyncCheckpointer`` mirrors ``tests/test_async_checkpoint.py``:
  ``wait`` re-raises a writer error, ``close`` refuses later submits,
  ``max_pending`` backpressures, ``on_durable`` runs only after a
  successful write, ``wait(timeout=)`` raises ``CheckpointTimeoutError``.
* In the 2-rank world, ``restore_checkpoint`` from a different directory
  on each rank leaves both ranks bit-identical to rank 0's checkpoint,
  and ``MetricAverageCallback`` averages the logs over the ranks.
* ``shard_iterator``/``prefetch_to_device`` keep this rank's rows, stay
  ahead, re-raise source errors and close the source when abandoned.
"""

import functools
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import torch_dist_worker
from horovod_tpu import callbacks as jcb
from horovod_tpu import optimizer as jopt
from horovod_tpu import trainer as jtrainer
from horovod_tpu import training as jtraining
from horovod_tpu.exceptions import NonFiniteGradError as JNonFinite
from horovod_tpu.models import resnet as jres
from horovod_tpu_torch import convert, data, runtime
from horovod_tpu_torch import trainer as ttrainer
from horovod_tpu_torch.exceptions import (CheckpointTimeoutError,
                                          NonFiniteGradError)
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.training import create_train_state, make_train_step

DEPTH = 8
EPOCHS, STEPS, WARMUP = 2, 3, 2
IMAGE, BATCH = 16, 8
# An lr and momentum exact in f32: the JAX state holds them as f32
# arrays, the torch optimizer as Python floats.
LR, MOMENTUM = 0.125, 0.875
SGD = functools.partial(torch.optim.SGD, lr=LR, momentum=MOMENTUM)


@pytest.fixture
def world1(monkeypatch):
    for var in ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK", "HVD_ZERO",
                "HVD_OVERLAP", "HVD_GUARD_NONFINITE", "HVD_WIRE_DTYPE",
                "HVD_MAX_BAD_STEPS"):
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    yield
    runtime.shutdown()


@pytest.fixture(scope="module")
def variables():
    model = jres.cifar_resnet_v1(DEPTH, dtype=jnp.float32)
    return jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32)))


def _batches(seed):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(
        np.float32), rng.randint(0, 10, BATCH).astype(np.int64))
        for _ in range(STEPS)]


def _port_cfg():
    return dict(stage_sizes=((DEPTH - 2) // 6,) * 3, num_classes=10,
                num_filters=16, dtype=torch.float32, block="basic",
                cifar_stem=True)


@pytest.fixture(scope="module")
def world2(variables, tmp_path_factory, world2_checkpoints):
    workdir = tmp_path_factory.mktemp("trainer_w2")
    inp = {"cfg": _port_cfg(), "variables": variables,
           "fit": {"batches": _batches(1), "epochs": EPOCHS, "steps": STEPS,
                   "warmup": WARMUP,
                   "sgd": dict(lr=LR, momentum=MOMENTUM)},
           "restore_dirs": world2_checkpoints["dirs"]}
    return torch_dist_worker.spawn_ckpt(2, str(workdir), inp)


@pytest.fixture(scope="module")
def world2_checkpoints(variables, tmp_path_factory):
    """Two checkpoints of different states, one directory per rank."""
    base = tmp_path_factory.mktemp("trainer_ckpts")
    runtime.init(device="cpu")
    try:
        dirs, want = [], None
        for r in range(2):
            v = jax.tree_util.tree_map(lambda a, r=r: a + 0.5 * r, variables)
            model = convert.resnet_from_jax(v, tres.ResNetConfig(
                **_port_cfg()), device="cpu")
            state = create_train_state(model, SGD, device="cpu")
            x, y = _batches(5 + r)[0]
            state, _ = make_train_step()(state, (torch.from_numpy(x),
                                                 torch.from_numpy(y)))
            state.optimizer.param_groups[0]["lr"] = 0.1 + r
            d = str(base / f"rank{r}")
            ttrainer.save_checkpoint(d, state)
            dirs.append(d)
            if r == 0:
                want = {"variables": convert.resnet_to_numpy(model),
                        "momentum": [
                            state.optimizer.state[p]["momentum_buffer"]
                            .numpy().copy()
                            for _, p in state.optimizer.named_parameters],
                        "lr": 0.1, "step": 1}
    finally:
        runtime.shutdown()
    return {"dirs": dirs, "want": want}


@pytest.fixture(scope="module")
def jax_two_devices():
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2])
    yield
    jhvd.shutdown()
    jhvd.init()


def _jax_fit(variables, batches):
    model = jres.cifar_resnet_v1(DEPTH, dtype=jnp.float32)
    dist_opt = jopt.DistributedOptimizer(jcb.hyper_sgd(LR,
                                                       momentum=MOMENTUM))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=dist_opt.init(params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    step = jtraining.make_train_step(model, dist_opt)
    trainer = jtrainer.Trainer(step, state, steps_per_epoch=STEPS,
                               verbose=False)
    lrs = []

    class Spy(jcb.Callback):
        def on_batch_begin(self, batch, logs=None):
            o = trainer.state.opt_state
            lrs.append((jcb.get_hyperparam(o, "learning_rate"),
                        jcb.get_hyperparam(o, "momentum")))
    history = trainer.fit(
        lambda: batches, epochs=EPOCHS,
        callbacks=[jcb.BroadcastGlobalVariablesCallback(0),
                   jcb.LearningRateWarmupCallback(warmup_epochs=WARMUP),
                   Spy()])
    return history, lrs


def test_fit_matches_jax_in_a_two_rank_world(world2, variables,
                                             jax_two_devices):
    assert jhvd.size() == 2
    history, lrs = _jax_fit(variables, _batches(1))
    for r in world2:
        assert [lr for lr, _ in r["lrs"]] == [lr for lr, _ in lrs]
        # The momentum correction divides by the previous batch's lr,
        # which JAX reads back from its state as an f32 array and the
        # port from param_groups as a Python float: f32 rounding.
        np.testing.assert_allclose([m for _, m in r["lrs"]],
                                   [m for _, m in lrs], rtol=2.0 ** -22)
        assert len(lrs) == EPOCHS * STEPS and lrs[0][0] < lrs[-1][0]
        assert [sorted(h) for h in r["history"]] == [sorted(h)
                                                     for h in history]
        for got, want in zip(r["history"], history):
            assert got["lr"] == want["lr"]
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert world2[0]["history"] == world2[1]["history"]


def test_restore_checkpoint_leaves_ranks_identical_to_rank_zero(
        world2, world2_checkpoints):
    want = world2_checkpoints["want"]
    for r in world2:
        got = r["restored"]
        assert got["step"] == want["step"] and got["lr"] == want["lr"]
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_flatten_with_path(got["variables"])[0],
                jax.tree_util.tree_flatten_with_path(want["variables"])[0]):
            assert pa == pb and a.tobytes() == b.tobytes()
        assert all(a.tobytes() == b.tobytes() for a, b in
                   zip(got["momentum"], want["momentum"]))


def test_metric_average_and_process_index_in_two_ranks(world2):
    for r, out in enumerate(world2):
        assert out["metric_average"] == {"loss": 1.5, "acc": 0.125,
                                         "name": "x"}
        assert out["process"] == (r, 2)


def _tiny_resnet_state(variables=None):
    model = tres.ResNet(tres.ResNetConfig(**_port_cfg()), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return create_train_state(model, SGD, device="cpu")


def test_bad_step_budget_raises_at_the_same_step_as_jax(world1):
    import flax.linen as nn

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x, train=True):
            return nn.Dense(10)(nn.relu(nn.Dense(16)(x)))
    rng = np.random.RandomState(2)
    good = (rng.randn(8, 8).astype(np.float32),
            rng.randint(0, 10, 8).astype(np.int64))
    bad = (good[0].copy(), good[1])
    bad[0][0, 0] = np.nan
    stream = [good, bad, bad, bad]
    state = create_train_state(torch_dist_worker._MLP(), SGD, device="cpu")
    tr = ttrainer.Trainer(make_train_step(guard_nonfinite=True), state,
                          max_bad_steps=2, verbose=False)
    with pytest.raises(NonFiniteGradError) as port_err:
        tr.fit(lambda: stream, epochs=1)
    model = MLP()
    jstate, dist_opt = jtraining.create_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, 8)),
        jcb.hyper_sgd(LR, momentum=MOMENTUM))
    jtr = jtrainer.Trainer(
        jtraining.make_train_step(model, dist_opt, guard_nonfinite=True),
        jstate, max_bad_steps=2, verbose=False, prefetch=0)
    with pytest.raises(JNonFinite) as jax_err:
        jtr.fit(lambda: stream, epochs=1)
    head = "2 consecutive non-finite-gradient steps at global step 2"
    assert str(port_err.value).startswith(head)
    assert str(jax_err.value).startswith(head)


def test_guard_logs_and_env_budget(world1, monkeypatch):
    """Skipped steps add 0 to the epoch means (the mean is over good
    steps), ``bad_steps`` is logged, and HVD_MAX_BAD_STEPS sets the
    budget (default 5, floor 1)."""
    from horovod_tpu_torch.utils import config
    assert config.max_bad_steps() == 5
    monkeypatch.setenv("HVD_MAX_BAD_STEPS", "0")
    assert config.max_bad_steps() == 1
    monkeypatch.setenv("HVD_MAX_BAD_STEPS", "3")
    good, _ = _batches(2)[:2]
    bad = (good[0].copy(), good[1])
    bad[0][0, 0, 0, 0] = np.nan
    tr = ttrainer.Trainer(make_train_step(guard_nonfinite=True),
                          _tiny_resnet_state(), verbose=False)
    assert tr.max_bad_steps == 3
    hist = tr.fit(lambda: [good, bad, good], epochs=1)
    ref = ttrainer.Trainer(make_train_step(), _tiny_resnet_state(),
                           verbose=False).fit(lambda: [good, good],
                                              epochs=1)
    assert hist[0]["bad_steps"] == 1.0
    np.testing.assert_allclose(hist[0]["loss"], ref[0]["loss"], rtol=1e-6)


def test_eval_logs_are_row_weighted(world1):
    from horovod_tpu_torch.training import make_eval_step
    state = _tiny_resnet_state()
    ev = make_eval_step()
    batches = _batches(3)
    tr = ttrainer.Trainer(make_train_step(), state, eval_step=ev,
                          steps_per_epoch=1, verbose=False)
    small = (batches[1][0][:2], batches[1][1][:2])
    hist = tr.fit(lambda: batches, epochs=1,
                  eval_data=lambda: [batches[2], small])
    want = {k: (BATCH * float(ev(state, tuple(map(torch.from_numpy,
                                                  batches[2])))[k])
                + 2 * float(ev(state, tuple(map(torch.from_numpy,
                                                small)))[k])) / (BATCH + 2)
            for k in ("loss", "accuracy")}
    for k, v in want.items():
        assert hist[0][f"val_{k}"] == pytest.approx(v, rel=1e-6)
    assert tr.steps_per_epoch == 1


def test_elastic_and_resize_are_refused():
    """Live resize stays refused naming item 15; an ElasticState is
    accepted since the launcher and elastic recovery landed (the rollback
    itself: tests/test_torch_elastic.py)."""
    from horovod_tpu_torch.elastic import ElasticState
    with pytest.raises(NotImplementedError, match="item 15"):
        ttrainer.Trainer(lambda s, b: (s, {}), None, resize=object())
    es = ElasticState(None, directory="unused")
    assert ttrainer.Trainer(lambda s, b: (s, {}), None,
                            elastic=es).elastic is es


# -- AsyncCheckpointer (mirrors tests/test_async_checkpoint.py) ------------------

def test_async_restore_bit_identical_to_sync(tmp_path, world1):
    state = _tiny_resnet_state()
    x, y = _batches(4)[0]
    state, _ = make_train_step()(state, (torch.from_numpy(x),
                                         torch.from_numpy(y)))
    ttrainer.save_checkpoint(str(tmp_path / "sync"), state)
    with ttrainer.AsyncCheckpointer() as w:
        assert ttrainer.save_checkpoint(str(tmp_path / "async"), state,
                                        writer=w) is not None
        w.wait()
    for sub in ("sync", "async"):
        assert sorted(os.listdir(tmp_path / sub / "ckpt_1")) == [
            "hvd_manifest.json", "hvd_tree.json", "leaves"]
    a = [open(os.path.join(tmp_path / "sync" / "ckpt_1" / "leaves", f),
              "rb").read()
         for f in sorted(os.listdir(tmp_path / "sync" / "ckpt_1" /
                                    "leaves"))]
    b = [open(os.path.join(tmp_path / "async" / "ckpt_1" / "leaves", f),
              "rb").read()
         for f in sorted(os.listdir(tmp_path / "async" / "ckpt_1" /
                                    "leaves"))]
    assert a == b


def test_wait_reraises_and_on_durable_only_after_success():
    durable = []
    w = ttrainer.AsyncCheckpointer()

    def fail():
        raise IOError("disk gone")
    w.submit(fail, on_durable=lambda: durable.append("bad"))
    with pytest.raises(IOError, match="disk gone"):
        w.wait()
    w.submit(lambda: None, on_durable=lambda: durable.append("good"))
    w.wait()
    assert durable == ["good"]
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(lambda: None)


def test_close_reraises_writer_error():
    w = ttrainer.AsyncCheckpointer()
    w.submit(lambda: (_ for _ in ()).throw(IOError("late")))
    with pytest.raises(IOError, match="late"):
        w.close()


def test_max_pending_backpressures():
    started, release = threading.Event(), threading.Event()
    w = ttrainer.AsyncCheckpointer(max_pending=1)
    w.submit(lambda: (started.set(), release.wait(30)))
    assert started.wait(10)       # the writer holds this one
    w.submit(lambda: None)        # fills the queue
    blocked = threading.Event()

    def third():
        w.submit(lambda: None)
        blocked.set()
    t = threading.Thread(target=third)
    t.start()
    assert not blocked.wait(0.3), "submit did not backpressure"
    release.set()
    assert blocked.wait(5)
    t.join(5)
    assert not t.is_alive()
    w.close()


def test_wait_timeout_on_stalled_writer():
    release = threading.Event()
    w = ttrainer.AsyncCheckpointer()
    w.submit(release.wait)
    with pytest.raises(CheckpointTimeoutError, match="in flight"):
        w.wait(timeout=0.2)
    release.set()
    w.wait(timeout=5)
    w.close()


def test_save_returns_before_a_slow_write(tmp_path, world1, monkeypatch):
    """Only the snapshot is on the caller's thread: save_checkpoint returns
    while the write is held, and the bytes land after it is released."""
    from horovod_tpu_torch.parallel import checkpoint as tckpt
    real = tckpt.write_tree
    started, release = threading.Event(), threading.Event()

    def held(*a, **k):
        started.set()
        assert release.wait(30)
        return real(*a, **k)
    monkeypatch.setattr(tckpt, "write_tree", held)
    w = ttrainer.AsyncCheckpointer()
    path = ttrainer.save_checkpoint(str(tmp_path), _tiny_resnet_state(),
                                    writer=w)
    assert started.wait(10)
    assert not os.path.exists(path)
    release.set()
    w.close()
    assert os.listdir(tmp_path) == ["ckpt_0"]


# -- the input pipeline --------------------------------------------------------

def test_shard_iterator_keeps_this_ranks_rows():
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    got = data.shard_batch({"x": x, "y": (x[:, 0],)}, rank=1, size=4)
    assert np.array_equal(got["x"].numpy(), x[2:4])
    assert np.array_equal(got["y"][0].numpy(), x[2:4, 0])
    with pytest.raises(ValueError, match="does not split"):
        data.shard_batch(x, rank=0, size=3)
    assert [b.shape[0] for b in data.shard_iterator([x, x])] == [8, 8]


def test_prefetch_stays_ahead_reraises_and_closes():
    pulled = []
    closed = []

    def source():
        try:
            for i in range(10):
                pulled.append(i)
                yield (np.full((2, 2), i, np.float32),)
        finally:
            closed.append(True)
    it = data.prefetch_to_device(source(), size=2, device="cpu")
    first = next(it)
    assert float(first[0][0, 0]) == 0
    deadline = time.monotonic() + 5
    while len(pulled) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(pulled) >= 3       # staged ahead of the consumer
    it.close()
    assert closed == [True]

    def broken():
        yield (np.zeros(2),)
        raise RuntimeError("source died")
    it = data.prefetch_to_device(broken(), size=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="source died"):
        next(it)
    with pytest.raises(ValueError, match=">= 1"):
        data.prefetch_to_device([], size=0)

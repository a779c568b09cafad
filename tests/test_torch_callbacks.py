"""Port parity: the callbacks (``callbacks``), the schedule math
(``utils.lr_schedule``) and the hooks (``hooks``) against the JAX package,
on the CPU.

* ``LRScheduleCore`` and ``warmup_multiplier``: the same decisions, to
  the bit, on the same epochs, batches and momenta (both are the same
  Python float arithmetic).
* ``LearningRateScheduleCallback`` (staircase and smooth, with momentum
  correction), ``LearningRateWarmupCallback`` and
  ``ReduceLROnPlateauCallback`` driven through the same callback calls
  and logs on both sides: the learning rate and momentum after every
  call agree exactly (JAX's hyperparameters live in its optimizer state,
  the port's in ``param_groups``; no train step runs between the calls,
  so no f32 rounding enters).
* ``MonitoredTrainingLoop`` with ``StopAtStepHook``,
  ``CheckpointSaverHook`` and ``LoggingHook`` runs the same steps and
  writes the same ``ckpt_<n>`` names as JAX's; the broadcast hook and
  callback leave a world of one bit-unchanged.

``MetricAverageCallback`` over two ranks is in ``test_torch_trainer.py``
(its gloo world).
"""

import functools
import os
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker
from horovod_tpu import callbacks as jcb
from horovod_tpu import hooks as jhooks
from horovod_tpu import training as jtraining
from horovod_tpu.utils import lr_schedule as jlr
from horovod_tpu_torch import callbacks as tcb
from horovod_tpu_torch import hooks as thooks
from horovod_tpu_torch import runtime
from horovod_tpu_torch.training import create_train_state, make_train_step
from horovod_tpu_torch.utils import lr_schedule as tlr

# Exact in f32 (JAX's initial hyperparameter arrays) and in f64.
LR, MOMENTUM = 0.5, 0.75


@pytest.fixture
def world1(monkeypatch):
    for var in ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK", "HVD_ZERO",
                "HVD_OVERLAP", "HVD_GUARD_NONFINITE", "HVD_WIRE_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    yield
    runtime.shutdown()


def _cores(mod, **kw):
    return mod.LRScheduleCore(**kw)


@pytest.mark.parametrize("kw", [
    dict(multiplier=lambda e: 0.5 ** e, staircase=True),
    dict(multiplier=lambda e: 1.0 / (1.0 + e), staircase=False,
         steps_per_epoch=3, start_epoch=1, end_epoch=3),
    dict(multiplier=0.1, start_epoch=1, momentum_correction=False),
])
def test_schedule_core_decisions_match_jax(kw):
    sides = [_cores(m, **kw) for m in (jlr, tlr)]
    trace = []
    for core in sides:
        core.train_begin(LR)
        seq = []
        lr, m = LR, MOMENTUM
        for epoch in range(4):
            core.epoch_begin(epoch)
            for batch in range(3):
                new = core.target_lr(batch)
                seq.append(("lr", new))
                if new is not None:
                    seq.append(("m", core.corrected_momentum(lr, new, m)))
                    lr = new
                seq.append(("restore", core.momentum_to_restore()))
        trace.append(seq)
    assert trace[0] == trace[1]
    assert any(v is not None for k, v in trace[1] if k == "lr")


@pytest.mark.parametrize("size", [1, 2, 8])
def test_warmup_multiplier_matches_jax(size):
    fns = [m.warmup_multiplier(3, lambda: 4, lambda: size) for m in
           (jlr, tlr)]
    xs = [e + b / 4 for e in range(4) for b in range(4)]
    assert [fns[0](x) for x in xs] == [fns[1](x) for x in xs]
    assert fns[1](3 - 0.25) == pytest.approx(1.0)


def _jax_trainer():
    params = {"w": jnp.zeros((3,))}
    state = types.SimpleNamespace(
        opt_state=jcb.hyper_sgd(LR, momentum=MOMENTUM).init(params))
    return types.SimpleNamespace(state=state, steps_per_epoch=3)


def _port_trainer():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.SGD([p], lr=LR, momentum=MOMENTUM)
    return types.SimpleNamespace(state=types.SimpleNamespace(optimizer=opt),
                                 steps_per_epoch=3)


def _hyper(side, trainer):
    if side == "jax":
        o = trainer.state.opt_state
        return (jcb.get_hyperparam(o, "learning_rate"),
                jcb.get_hyperparam(o, "momentum"))
    o = trainer.state.optimizer
    return (tcb.get_hyperparam(o, "learning_rate"),
            tcb.get_hyperparam(o, "momentum"))


def _drive(side, make_cb, logs_seq=None):
    mod = jcb if side == "jax" else tcb
    trainer = _jax_trainer() if side == "jax" else _port_trainer()
    cb = make_cb(mod)
    cb.set_trainer(trainer)
    seq = []
    cb.on_train_begin()
    for epoch in range(4):
        cb.on_epoch_begin(epoch)
        for batch in range(3):
            cb.on_batch_begin(batch)
            seq.append(_hyper(side, trainer))
            cb.on_batch_end(batch)
            seq.append(_hyper(side, trainer))
        logs = dict(logs_seq[epoch]) if logs_seq else {}
        cb.on_epoch_end(epoch, logs)
        seq.append((logs.get("lr"),) + _hyper(side, trainer))
    return seq


@pytest.mark.parametrize("name,make_cb", [
    ("staircase", lambda m: m.LearningRateScheduleCallback(
        lambda e: 0.5 ** e, start_epoch=1, staircase=True)),
    ("smooth", lambda m: m.LearningRateScheduleCallback(
        lambda e: 1.0 / (1.0 + e), staircase=False, end_epoch=3)),
    ("warmup", lambda m: m.LearningRateWarmupCallback(warmup_epochs=2)),
])
def test_lr_callbacks_match_jax(name, make_cb, monkeypatch):
    # The warmup reads the world's size when it is built: four ranks on
    # both sides (lr/4 -> lr).
    import horovod_tpu.runtime as jruntime
    monkeypatch.setattr(jruntime, "size", lambda: 4)
    monkeypatch.setattr(runtime, "size", lambda: 4)
    got = _drive("port", make_cb)
    assert got == _drive("jax", make_cb)
    assert len({t[-2] for t in got}) > 1


def test_reduce_lr_on_plateau_matches_jax():
    logs = [{"val_loss": v} for v in (1.0, 1.2, 1.1, 0.5)]

    def make(m):
        return m.ReduceLROnPlateauCallback(monitor="val_loss", factor=0.5,
                                           patience=2, min_lr=0.2)
    got = _drive("port", make, logs)
    assert got == _drive("jax", make, logs)
    assert got[-1][1] == 0.25
    # Past the floor: min_lr holds.
    cb = make(tcb)
    tr = _port_trainer()
    cb.set_trainer(tr)
    for e, v in enumerate((1.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0)):
        cb.on_epoch_end(e, {"val_loss": v})
    assert tcb.get_hyperparam(tr.state.optimizer, "learning_rate") == 0.2


def test_hyperparams_of_the_distributed_and_zero_optimizers(world1):
    for zero in (False, True):
        state = create_train_state(torch_dist_worker._MLP(),
                                   torch_dist_worker.OPTS["sgd"], zero=zero,
                                   fusion_threshold=300, device="cpu")
        opt = state.optimizer
        tcb.set_hyperparam(opt, "learning_rate", 0.25)
        assert tcb.get_hyperparam(opt, "learning_rate") == 0.25
        assert opt.optimizer.param_groups[0]["lr"] == 0.25
        assert tcb.get_hyperparam(opt, "momentum") == 0.9
    adam = torch.optim.Adam([torch.nn.Parameter(torch.zeros(2))])
    assert tcb.get_hyperparam(adam, "momentum") is None


# -- hooks ---------------------------------------------------------------------

class _JaxMLP(nn.Module):
    @nn.compact
    def __call__(self, x, train=True):
        return nn.Dense(10)(nn.relu(nn.Dense(16)(x)))


def _hook_batches():
    rng = np.random.RandomState(4)
    return [(rng.randn(8, 8).astype(np.float32),
             rng.randint(0, 10, 8).astype(np.int64)) for _ in range(9)]


def test_monitored_loop_matches_jax(tmp_path, world1, capsys):
    import optax
    model = _JaxMLP()
    jstate, dist_opt = jtraining.create_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, 8)), optax.sgd(0.1))
    jloop = jhooks.MonitoredTrainingLoop(
        jtraining.make_train_step(model, dist_opt), jstate,
        [jhooks.BroadcastGlobalVariablesHook(0), jhooks.StopAtStepHook(5),
         jhooks.CheckpointSaverHook(str(tmp_path / "jax"), save_steps=2),
         jhooks.LoggingHook(every_n_steps=2)])
    jloop.run(iter(_hook_batches()))
    jax_out = capsys.readouterr().out
    state = create_train_state(torch_dist_worker._MLP(),
                               functools.partial(torch.optim.SGD, lr=0.1),
                               device="cpu")
    loop = thooks.MonitoredTrainingLoop(
        make_train_step(), state,
        [thooks.BroadcastGlobalVariablesHook(0), thooks.StopAtStepHook(5),
         thooks.CheckpointSaverHook(str(tmp_path / "port"), save_steps=2),
         thooks.LoggingHook(every_n_steps=2)])
    pulled = []
    loop.run(b for b in _hook_batches() if not pulled.append(1))
    port_out = capsys.readouterr().out
    assert loop.global_step == jloop.global_step == 5
    assert loop.state.step == int(jloop.state.step) == 5
    assert len(pulled) == 5       # the stop costs the input no batch
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax")) == ["ckpt_2", "ckpt_4",
                                                 "ckpt_5"]
    assert [ln.split(" [")[0] for ln in port_out.splitlines()] == \
        [ln.split(" [")[0] for ln in jax_out.splitlines()] == \
        ["step 2", "step 4"]


def test_broadcast_callback_and_hook_keep_a_world_of_one(world1):
    state = create_train_state(torch_dist_worker._MLP(),
                               torch_dist_worker.OPTS["sgd"],
                               device="cpu")
    x, y = _hook_batches()[0]
    state, _ = make_train_step()(state, (torch.from_numpy(x),
                                         torch.from_numpy(y)))
    before = [p.detach().clone() for p in state.model.parameters()]
    mom = [state.optimizer.state[p]["momentum_buffer"].clone()
           for p in state.model.parameters()]
    tr = types.SimpleNamespace(state=state)
    cb = tcb.BroadcastGlobalVariablesCallback(0)
    cb.set_trainer(tr)
    cb.on_train_begin()
    thooks.BroadcastGlobalVariablesHook(0).after_create_session(tr)
    assert tr.state is state and state.step == 1
    assert all(torch.equal(a, b) for a, b in
               zip(before, state.model.parameters()))
    assert all(torch.equal(a, state.optimizer.state[p]["momentum_buffer"])
               for a, p in zip(mom, state.model.parameters()))

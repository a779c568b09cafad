"""Training callbacks — parity with ``horovod/keras/callbacks.py``.

Port of the JAX package's ``callbacks.py``:

* :class:`BroadcastGlobalVariablesCallback` — sync all state from rank 0
  at train begin (``callbacks.py:8-34``).
* :class:`MetricAverageCallback` — epoch-end average of the metrics over
  ranks, so LR-plateau and loggers see global values
  (``callbacks.py:37-87``).
* :class:`LearningRateScheduleCallback` — epoch- or batch-granular LR
  multiplier with momentum correction (``callbacks.py:90-199``).
* :class:`ReduceLROnPlateauCallback` — the Keras callback the reference
  stacks after :class:`MetricAverageCallback`.
* :class:`LearningRateWarmupCallback` — gradual warmup ``lr/size → lr``
  over ``warmup_epochs`` (``callbacks.py:202-259``).

The JAX package keeps ``learning_rate``/``momentum`` in its optimizer
state (``hyper_sgd``); here they are the wrapped optimizer's
``param_groups`` entries (``lr``, ``momentum``), read and written
between steps by :func:`get_hyperparam` / :func:`set_hyperparam`. Under
ZeRO the groups are those of the optimizer over the shards. The decisions
themselves are :mod:`horovod_tpu_torch.utils.lr_schedule`'s.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from . import runtime
from .ops.collectives import allreduce
from .optimizer import broadcast_global_variables
from .utils.lr_schedule import LRScheduleCore, warmup_multiplier

# The JAX package's hyperparameter names -> torch's param_groups keys.
_GROUP_KEYS = {"learning_rate": "lr", "momentum": "momentum"}


def _optimizer_of(state):
    opt = getattr(state, "optimizer", None)
    return opt if opt is not None else state.opt_state


def get_hyperparam(optimizer, name: str) -> Optional[float]:
    """The first parameter group's ``name`` (``"learning_rate"`` or
    ``"momentum"``, or a ``param_groups`` key), or None when the optimizer
    has no such hyperparameter (Adam has no momentum)."""
    v = optimizer.param_groups[0].get(_GROUP_KEYS.get(name, name))
    return None if v is None else float(v)


def set_hyperparam(optimizer, name: str, value) -> None:
    """Set ``name`` in every parameter group."""
    key = _GROUP_KEYS.get(name, name)
    for g in optimizer.param_groups:
        if torch.is_tensor(g.get(key)):
            g[key].fill_(value)
        else:
            g[key] = value


class Callback:
    """Keras-shaped callback protocol. ``trainer`` is any object with
    ``.state`` (whose ``optimizer`` carries the hyperparameters) and
    ``.steps_per_epoch``."""

    trainer: Any = None

    def set_trainer(self, trainer):
        self.trainer = trainer

    def on_train_begin(self, logs: Optional[Dict] = None): ...
    def on_train_end(self, logs: Optional[Dict] = None): ...
    def on_epoch_begin(self, epoch: int, logs: Optional[Dict] = None): ...
    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None): ...
    def on_batch_begin(self, batch: int, logs: Optional[Dict] = None): ...
    def on_batch_end(self, batch: int, logs: Optional[Dict] = None): ...


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast params, buffers, optimizer state and step from
    ``root_rank`` at train begin (``callbacks.py:8-34``): after a restore
    on rank 0 it makes every rank bit-identical again."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, logs=None):
        t = self.trainer
        t.state = broadcast_global_variables(t.state, self.root_rank)


class MetricAverageCallback(Callback):
    """Average epoch-end metrics over ranks (``callbacks.py:37-87``), all
    of them in one eager allreduce. Must precede callbacks that consume
    metrics (ReduceLROnPlateau-style), as the reference documents."""

    def on_epoch_end(self, epoch, logs=None):
        if not logs:
            return
        keys = [k for k, v in logs.items()
                if isinstance(v, (int, float, np.floating, np.integer))
                or (hasattr(v, "shape") and getattr(v, "shape") == ())]
        if not keys:
            return
        dev = runtime.device() if runtime.is_initialized() else None
        vals = torch.tensor([float(logs[k]) for k in keys],
                            dtype=torch.float32, device=dev)
        for k, v in zip(keys, allreduce(vals, average=True).tolist()):
            logs[k] = float(v)


class LearningRateScheduleCallback(Callback):
    """LR = ``initial_lr * multiplier(epoch)`` between ``start_epoch`` and
    ``end_epoch`` (``callbacks.py:90-199``). ``staircase=True`` adjusts
    once per epoch at integer epoch; ``staircase=False`` every batch at
    fractional ``epoch + batch/steps_per_epoch``. With
    ``momentum_correction``, while a batch runs at an adjusted LR the
    momentum is scaled by ``new_lr/old_lr`` and restored after it."""

    def __init__(self, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None):
        self.core = LRScheduleCore(
            multiplier, start_epoch=start_epoch, end_epoch=end_epoch,
            staircase=staircase, momentum_correction=momentum_correction,
            steps_per_epoch=steps_per_epoch)

    @property
    def steps_per_epoch(self):
        return self.core.steps_per_epoch

    @property
    def end_epoch(self):
        return self.core.end_epoch

    def _opt(self):
        return _optimizer_of(self.trainer.state)

    def _get_lr(self) -> float:
        return get_hyperparam(self._opt(), "learning_rate")

    def _set_lr(self, v: float):
        set_hyperparam(self._opt(), "learning_rate", v)

    def _get_momentum(self) -> Optional[float]:
        return get_hyperparam(self._opt(), "momentum")

    def _set_momentum(self, v: float):
        set_hyperparam(self._opt(), "momentum", v)

    def on_train_begin(self, logs=None):
        if not self.core.staircase and not self.core.steps_per_epoch:
            self.core.steps_per_epoch = getattr(
                self.trainer, "steps_per_epoch", None)
        self.core.train_begin(self._get_lr())

    def on_epoch_begin(self, epoch, logs=None):
        self.core.epoch_begin(epoch)

    def on_batch_begin(self, batch, logs=None):
        new_lr = self.core.target_lr(batch)
        if new_lr is None:
            return
        old_lr = self._get_lr()
        self._set_lr(new_lr)
        m = self.core.corrected_momentum(old_lr, new_lr,
                                         self._get_momentum())
        if m is not None:
            self._set_momentum(m)

    def on_batch_end(self, batch, logs=None):
        m = self.core.momentum_to_restore()
        if m is not None:
            self._set_momentum(m)

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr"] = self._get_lr()


class ReduceLROnPlateauCallback(Callback):
    """Reduce LR when a monitored metric plateaus — stacked AFTER
    :class:`MetricAverageCallback` (``keras_mnist_advanced.py:87-95``), so
    every rank takes the same decision."""

    def __init__(self, monitor: str = "val_loss", factor: float = 0.1,
                 patience: int = 10, min_lr: float = 0.0,
                 mode: str = "min"):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.mode = mode
        self.best: Optional[float] = None
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        if not logs or self.monitor not in logs:
            return
        current = float(logs[self.monitor])
        improved = (self.best is None
                    or (self.mode == "min" and current < self.best)
                    or (self.mode == "max" and current > self.best))
        if improved:
            self.best = current
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            opt = _optimizer_of(self.trainer.state)
            lr = get_hyperparam(opt, "learning_rate")
            new_lr = max(lr * self.factor, self.min_lr)
            if new_lr < lr:
                set_hyperparam(opt, "learning_rate", new_lr)
            self.wait = 0


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual warmup ``lr/size → lr`` over ``warmup_epochs``
    (``callbacks.py:202-259``; Goyal et al. 1706.02677)::

        lr'(epoch) = lr/size * (epoch * (size-1)/warmup + 1)
    """

    def __init__(self, warmup_epochs: int = 5,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None, verbose: int = 0):
        self.verbose = verbose
        super().__init__(
            warmup_multiplier(warmup_epochs,
                              lambda: self.core.steps_per_epoch,
                              runtime.size),
            start_epoch=0, end_epoch=warmup_epochs, staircase=False,
            momentum_correction=momentum_correction,
            steps_per_epoch=steps_per_epoch)

    def on_epoch_end(self, epoch, logs=None):
        super().on_epoch_end(epoch, logs)
        if epoch == self.end_epoch - 1 and self.verbose > 0 \
                and runtime.rank() == 0:
            print(f"\nEpoch {epoch + 1}: finished gradual learning rate "
                  f"warmup to {self._get_lr():g}.")

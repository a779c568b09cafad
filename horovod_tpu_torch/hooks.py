"""Hook-style training integration — the third integration pattern.

Port of the JAX package's ``hooks.py``: the reference shows three ways to
train with Horovod — raw loops, Keras ``model.fit`` + callbacks
(:class:`horovod_tpu_torch.trainer.Trainer`), and Estimator +
SessionRunHooks (``examples/tensorflow_mnist_estimator.py:145-191``:
``BroadcastGlobalVariablesHook``, ``StopAtStepHook``,
``LoggingTensorHook``, rank-0-only ``model_dir``). This module is the
third: a ``SessionRunHook``-shaped protocol and a
:class:`MonitoredTrainingLoop` that drives the train step through hooks.
The JAX package's ``Estimator`` façade is not ported in this slice.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Sequence

from . import runtime
from .data import shard_iterator


class TrainingHook:
    """SessionRunHook protocol (reference ``tf.train.SessionRunHook``
    lifecycle, ``horovod/tensorflow/__init__.py:93-124``)."""

    def begin(self, loop: "MonitoredTrainingLoop"): ...

    def after_create_session(self, loop: "MonitoredTrainingLoop"): ...

    def before_run(self, loop: "MonitoredTrainingLoop", step: int): ...

    def after_run(self, loop: "MonitoredTrainingLoop", step: int,
                  metrics: Dict[str, Any]): ...

    def end(self, loop: "MonitoredTrainingLoop"): ...


class BroadcastGlobalVariablesHook(TrainingHook):
    """Broadcast the initial state from ``root_rank`` once the loop starts
    (``hvd.BroadcastGlobalVariablesHook``, run in
    ``after_create_session`` — ``__init__.py:93-124``)."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def after_create_session(self, loop):
        from .optimizer import broadcast_global_variables
        if runtime.is_initialized() and runtime.size() > 1:
            loop.state = broadcast_global_variables(
                loop.state, root_rank=self.root_rank)


class StopAtStepHook(TrainingHook):
    """Stop after ``last_step`` global steps (``tf.train.StopAtStepHook``,
    ``tensorflow_mnist_estimator.py:169``)."""

    def __init__(self, last_step: int):
        self.last_step = last_step

    def after_run(self, loop, step, metrics):
        if step + 1 >= self.last_step:
            loop.request_stop()


class LoggingHook(TrainingHook):
    """Print metrics every ``every_n_steps``, rank 0 only
    (``tf.train.LoggingTensorHook``)."""

    def __init__(self, every_n_steps: int = 10):
        self.every_n_steps = every_n_steps
        self._t0 = None

    def begin(self, loop):
        self._t0 = time.perf_counter()

    def after_run(self, loop, step, metrics):
        if (step + 1) % self.every_n_steps:
            return
        if runtime.is_initialized() and runtime.rank() != 0:
            return
        dt = time.perf_counter() - self._t0
        msg = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
        print(f"step {step + 1} [{dt:.1f}s] {msg}", flush=True)


class CheckpointSaverHook(TrainingHook):
    """Rank-0-only periodic checkpointing every ``save_steps`` steps and at
    the end (the reference's Estimator writes only where ``model_dir`` is
    set, which is rank 0 — ``README.md:78-80``)."""

    def __init__(self, checkpoint_dir: str, save_steps: int = 100):
        self.checkpoint_dir = checkpoint_dir
        self.save_steps = save_steps

    def after_run(self, loop, step, metrics):
        if (step + 1) % self.save_steps == 0:
            from .trainer import save_checkpoint
            save_checkpoint(self.checkpoint_dir, loop.state)

    def end(self, loop):
        from .trainer import save_checkpoint
        save_checkpoint(self.checkpoint_dir, loop.state)


class MonitoredTrainingLoop:
    """Drive a train step through hooks (the ``MonitoredTrainingSession``
    analog: hooks observe and steer the loop, the loop owns the state)."""

    def __init__(self, train_step: Callable, state: Any,
                 hooks: Sequence[TrainingHook] = ()):
        self.train_step = train_step
        self.state = state
        self.hooks: List[TrainingHook] = list(hooks)
        self._stop = False
        self.global_step = 0

    def request_stop(self):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def run(self, data: Iterable) -> Any:
        """Run until the data iterable ends or a hook requests stop; the
        iterable yields global host batches (sharded here). The stop flag
        is checked before the next batch is pulled, so a stop costs the
        input pipeline no extra batch."""
        for h in self.hooks:
            h.begin(self)
        for h in self.hooks:
            h.after_create_session(self)
        it = shard_iterator(data)
        while not self._stop:
            try:
                batch = next(it)
            except StopIteration:
                break
            step = self.global_step
            for h in self.hooks:
                h.before_run(self, step)
            self.state, metrics = self.train_step(self.state, batch)
            for h in self.hooks:
                h.after_run(self, step, metrics)
            self.global_step += 1
        for h in self.hooks:
            h.end(self)
        return self.state

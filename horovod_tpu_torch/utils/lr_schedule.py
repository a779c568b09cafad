"""Shared LR-schedule / warmup / momentum-correction math.

A copy of the JAX package's ``utils/lr_schedule.py`` (framework-neutral):
ONE implementation of the reference's schedule semantics
(``horovod/keras/callbacks.py:90-259``), consumed by
:class:`horovod_tpu_torch.callbacks.LearningRateScheduleCallback`, which
owns only the get/set plumbing of the wrapped optimizer's
``param_groups``; the *decisions* — when to adjust, to what value, and how
to momentum-correct (Goyal et al. 1706.02677 §3: while a batch runs at
lr' = lr·m, momentum is scaled by ``new_lr/old_lr`` and restored after
the batch) — live here.
"""

from __future__ import annotations

from typing import Callable, Optional


class LRScheduleCore:
    """Schedule state machine: LR = ``initial_lr * multiplier(epoch)``
    between ``start_epoch`` and ``end_epoch``.

    ``staircase=True`` adjusts once per epoch (batch 0) at integer epoch;
    ``staircase=False`` adjusts every batch at fractional
    ``epoch + batch/steps_per_epoch`` (parity:
    ``horovod/keras/callbacks.py:155-199``).
    """

    def __init__(self, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None):
        if not callable(multiplier):
            staircase = True
            self.multiplier = lambda epoch: multiplier
        else:
            self.multiplier = multiplier
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.steps_per_epoch = steps_per_epoch
        self.initial_lr: Optional[float] = None
        self.current_epoch = 0
        self.restore_momentum: Optional[float] = None

    def train_begin(self, initial_lr: float) -> None:
        self.initial_lr = initial_lr
        if not self.staircase and not self.steps_per_epoch:
            raise ValueError(
                "steps_per_epoch is required for staircase=False "
                "(smooth per-batch adjustment)")

    def epoch_begin(self, epoch: int) -> None:
        self.current_epoch = epoch

    def target_lr(self, batch: int) -> Optional[float]:
        """The LR this batch should run at, or ``None`` for no adjustment
        (outside the schedule window, or staircase off-batch)."""
        e = self.current_epoch
        if e < self.start_epoch or (self.end_epoch is not None
                                    and e >= self.end_epoch):
            return None
        if self.staircase:
            if batch != 0:
                return None
            return self.initial_lr * self.multiplier(e)
        return self.initial_lr * self.multiplier(
            e + float(batch) / self.steps_per_epoch)

    def corrected_momentum(self, old_lr: float, new_lr: float,
                           momentum: Optional[float]) -> Optional[float]:
        """Momentum to run the adjusted batch with (``m·new_lr/old_lr``),
        remembering the value :meth:`momentum_to_restore` hands back after
        the batch. ``None`` = no correction (disabled, no momentum in the
        optimizer, or old_lr unusable)."""
        if not self.momentum_correction or momentum is None \
                or not old_lr > 0:
            return None
        self.restore_momentum = momentum
        return momentum * new_lr / old_lr

    def momentum_to_restore(self) -> Optional[float]:
        """The pre-correction momentum to reinstate at batch end (once),
        or ``None``."""
        m, self.restore_momentum = self.restore_momentum, None
        return m


def warmup_multiplier(warmup_epochs: int,
                      steps_per_epoch_fn: Callable[[], int],
                      size_fn: Callable[[], int]):
    """Goyal et al. gradual-warmup multiplier ``lr/size → lr`` over
    ``warmup_epochs`` (parity: ``horovod/keras/callbacks.py:213-247``),
    shifted by one step so each epoch ends on a round multiplier::

        lr'(epoch) = lr/size * (epoch * (size-1)/warmup + 1)

    ``steps_per_epoch_fn``/``size_fn`` are callables so values resolved at
    train time (trainer-provided steps, a lazily-initialized world) are
    honored.
    """
    def multiplier(epoch: float) -> float:
        size = size_fn()
        epoch += 1.0 / steps_per_epoch_fn()
        return 1.0 / size * (epoch * (size - 1) / warmup_epochs + 1)
    return multiplier

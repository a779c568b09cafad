"""The data-parallel train and eval steps.

Port of the plain plane of the JAX package's ``training.py``:
``cross_entropy_loss``/``accuracy`` (:54-72), ``TrainState`` (:43),
``create_train_state`` (:227) and ``make_train_step`` (:324, with its
``_value_and_grad`` hook) with ``accum_steps=1`` and no guard, ZeRO,
overlap or hybrid mesh, and ``make_eval_step`` (:1264).

One step: forward in training mode (BatchNorm updates its running
statistics in place), the loss, backward, the fused-bucket gradient
allreduce and the wrapped optimizer's update (``DistributedOptimizer``),
and the loss averaged over the world — the JAX step's ``pmean``. The
state is updated in place; the step returns it with the metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import convert
from .device import DeviceLike, resolve_device
from .ops.collectives import allreduce
from .optimizer import DistributedOptimizer


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy over integer labels (f32 reduction)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


@dataclasses.dataclass
class TrainState:
    """The model (params and, as buffers, batch_stats), the distributed
    optimizer (its state is the wrapped optimizer's), and the step."""

    model: torch.nn.Module
    optimizer: DistributedOptimizer
    step: int = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


def create_train_state(model: torch.nn.Module,
                       optimizer: Callable[..., torch.optim.Optimizer],
                       *, average: bool = True,
                       fusion_threshold: Optional[int] = None,
                       device: DeviceLike = "cuda") -> TrainState:
    """Move ``model`` to ``device`` and wrap ``optimizer(params)`` (e.g.
    ``functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)``) in a
    :class:`DistributedOptimizer` that plans its buckets in the flax leaf
    order. Every rank must call it on identically built models; call
    :func:`~horovod_tpu_torch.optimizer.broadcast_parameters` to start
    them from rank 0's weights."""
    dev = resolve_device(device)
    model.to(dev)
    named = convert.jax_leaf_order(model)
    opt = DistributedOptimizer(optimizer([p for _, p in named]),
                               named_parameters=named, average=average,
                               fusion_threshold=fusion_threshold)
    return TrainState(model=model, optimizer=opt)


def make_train_step(loss_fn: Callable = cross_entropy_loss, *,
                    _value_and_grad: Optional[Callable] = None):
    """Build ``step(state, (inputs, labels)) -> (state, {"loss": ...})``.
    The batch is this rank's shard; the loss is the world average.

    ``_value_and_grad(model, batch) -> loss`` (the counterpart of the
    JAX hook of the same name) replaces the default loss of
    ``loss_fn(model(inputs, train=True), labels)``: it computes the loss
    of the whole batch from the model and leaves the gradients in each
    parameter's ``.grad`` (e.g. by ``loss.backward()``). The transformer
    LM's step (:func:`~.parallel.transformer.make_parallel_train_step`)
    plugs in its own forward and loss this way."""

    def default_value_and_grad(model, batch) -> torch.Tensor:
        inputs, labels = batch
        loss = loss_fn(model(inputs, train=True), labels)
        loss.backward()
        return loss

    vag = default_value_and_grad if _value_and_grad is None \
        else _value_and_grad

    def step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = vag(state.model, batch)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": _world_mean(loss.detach().float())}

    return step


def make_eval_step(loss_fn: Callable = cross_entropy_loss):
    """Build ``eval(state, (inputs, labels)) -> {"loss", "accuracy"}``,
    both world averages. BatchNorm uses its running averages, so every
    block runs its stock branch."""

    def step(state: TrainState, batch) -> dict:
        inputs, labels = batch
        state.model.eval()
        with torch.no_grad():
            logits = state.model(inputs, train=False)
            return {"loss": _world_mean(loss_fn(logits, labels).float()),
                    "accuracy": _world_mean(accuracy(logits, labels))}

    return step


def _world_mean(x: torch.Tensor) -> torch.Tensor:
    return allreduce(x.reshape(1))[0]

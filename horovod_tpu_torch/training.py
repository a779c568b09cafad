"""The data-parallel train and eval steps.

Port of the plain plane of the JAX package's ``training.py``:
``cross_entropy_loss``/``accuracy`` (:54-72), ``TrainState`` (:43),
``create_train_state`` (:227), ``make_train_step`` (:324-754, with its
``_value_and_grad`` hook, in-step accumulation (``_acc_dtype`` :74,
``_split_microbatches`` :83, ``_accumulate_grads`` :100,
``_check_accum_batch`` :185), ``remat``, the bad-step guard, ZeRO-1 and
backward-overlapped bucket collectives; no hybrid mesh) and
``make_eval_step`` (:1264).

One step: forward in training mode (BatchNorm updates its running
statistics in place), the loss, backward, the fused-bucket gradient
allreduce and the wrapped optimizer's update (``DistributedOptimizer``),
and the loss averaged over the world — the JAX step's ``pmean``. The
state is updated in place; the step returns it with the metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import convert
from .device import DeviceLike, resolve_device
from .ops.collectives import allreduce
from .optimizer import Compression, DistributedOptimizer
from .utils import config as _config


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
                       wire_dtype=None, zero: Optional[bool] = None,
                       overlap: Optional[bool] = None,
                       compression=Compression.none,
                       device: DeviceLike = "cuda") -> TrainState:
    """Move ``model`` to ``device`` and wrap ``optimizer(params)`` (e.g.
    ``functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)``) in a
    :class:`DistributedOptimizer` that plans its buckets in the flax leaf
    order. Every rank must call it on identically built models; call
    :func:`~horovod_tpu_torch.optimizer.broadcast_parameters` to start
    them from rank 0's weights. ``wire_dtype`` is the optimizer's
    gradient wire format (default ``HVD_WIRE_DTYPE``); ``zero`` (default
    ``HVD_ZERO``) shards its state ZeRO-1 style over the world (the
    wrapped optimizer then runs over flat f32 shards: pin ``foreach`` in
    the factory where the replicated and the ZeRO runs must agree
    bitwise, since its default differs between CPU and CUDA); ``overlap``
    (default ``HVD_OVERLAP``) arms the backward-overlapped exchange;
    ``compression`` is :class:`~horovod_tpu_torch.optimizer.Compression`
    (``Compression.bf16`` is the bf16 wire)."""
    dev = resolve_device(device)
    model.to(dev)
    named = convert.jax_leaf_order(model)
    opt = DistributedOptimizer(
        optimizer([p for _, p in named]), named_parameters=named,
        average=average, fusion_threshold=fusion_threshold,
        wire_dtype=wire_dtype,
        zero=_config.zero_enabled() if zero is None else zero,
        overlap=overlap, compression=compression)
    return TrainState(model=model, optimizer=opt)


# -- in-step gradient accumulation ---------------------------------------------
# N microbatches' gradients are summed in the step (f32 for sub-f32
# gradients), scaled by 1/N once after the loop, and exchanged ONCE per
# accumulated step — the reference's ``backward_passes_per_step``.

def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype: f32 for sub-f32 floats, unchanged otherwise."""
    if dtype.is_floating_point and dtype.itemsize < 4:
        return torch.float32
    return dtype


def _split_microbatches(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, ...]:
    """``(B, ...) -> n`` views of ``B // n`` contiguous rows each."""
    return x.reshape(n, x.shape[0] // n, *x.shape[1:]).unbind(0)


def _check_accum_batch(inputs: torch.Tensor, accum_steps: int) -> None:
    """Leading-dim divisibility check, raised eagerly with the
    arithmetic instead of a reshape error from inside the step."""
    rows = inputs.shape[0]
    if rows % accum_steps:
        raise ValueError(
            f"this rank's batch of {rows} rows cannot be split into "
            f"{accum_steps} microbatches (needs divisibility by "
            f"{accum_steps}; {rows} % {accum_steps} = "
            f"{rows % accum_steps}); adjust the batch size or accum_steps")


def _accumulate_grads(vag: Callable, model: torch.nn.Module, batch,
                      accum_steps: int, metrics_fn: Optional[Callable],
                      before_last: Optional[Callable] = None):
    """Run ``vag`` over ``accum_steps`` microbatches of ``batch``, summing
    the gradients into each parameter's ``.grad``. Returns ``(mean loss,
    mean extras)``; on return each ``.grad`` holds the microbatch MEAN.

    f32 gradients accumulate in ``.grad`` itself (autograd's ``+=`` is
    the f32 sum); narrower ones move into f32 accumulators after each
    backward and are cast back after the mean. BatchNorm's running
    statistics thread through the microbatches (N momentum updates per
    step). Integer metric leaves keep the microbatch SUM — the
    full-batch value of a count — instead of a flooring integer mean.
    ``before_last()`` runs before the last microbatch's backward (the
    overlapped exchange arms there)."""
    n = accum_steps
    inputs, labels = batch
    params = [p for p in model.parameters() if p.requires_grad]
    acc: Dict[int, torch.Tensor] = {}
    lacc = macc = None
    for i, (x, y) in enumerate(zip(_split_microbatches(inputs, n),
                                   _split_microbatches(labels, n))):
        if i == n - 1 and before_last is not None:
            before_last()
        loss, logits = vag(model, (x, y))
        for p in params:
            g = p.grad
            if g is not None and _acc_dtype(g.dtype) != g.dtype:
                a = acc.get(id(p))
                acc[id(p)] = g.float() if a is None else a.add_(g)
                p.grad = None
        lacc = loss.float() if lacc is None else lacc + loss.float()
        if metrics_fn is not None:
            m = {k: torch.as_tensor(v) for k, v in
                 metrics_fn(logits, y).items()}
            macc = ({k: v.to(_acc_dtype(v.dtype)) for k, v in m.items()}
                    if macc is None else
                    {k: macc[k] + m[k].to(macc[k].dtype) for k in macc})
    inv = 1.0 / n
    with torch.no_grad():
        for p in params:
            if id(p) in acc:
                p.grad = (acc[id(p)] * inv).to(p.dtype)
            elif p.grad is not None:
                p.grad.mul_(inv)
    extras = None
    if macc is not None:
        extras = {k: v * inv if v.is_floating_point() else v
                  for k, v in macc.items()}
    return lacc * inv, extras


def _remat_forward(model: torch.nn.Module, inputs: torch.Tensor
                   ) -> torch.Tensor:
    """The training forward under ``torch.utils.checkpoint`` (the JAX
    ``jax.checkpoint`` of the loss): nothing but the input is kept, and
    the backward recomputes the forward. The recompute would update
    BatchNorm's running statistics a second time, so the buffers are
    put back after the backward (:func:`_restore`)."""
    return checkpoint(lambda x: model(x, train=True), inputs,
                      use_reentrant=False)


def _snapshot(model: torch.nn.Module) -> List[torch.Tensor]:
    return [b.detach().clone() for b in model.buffers()]


def _restore(model: torch.nn.Module, saved: List[torch.Tensor]) -> None:
    with torch.no_grad():
        for b, s in zip(model.buffers(), saved):
            b.copy_(s)


def _build_value_and_grad(loss_fn: Callable, remat: bool) -> Callable:
    """The default ``(model, batch) -> (loss, logits)``: the training
    forward (checkpointed under ``remat``), ``loss_fn``, and the backward
    into each parameter's ``.grad``."""

    def value_and_grad(model, batch):
        inputs, labels = batch
        if not remat:
            logits = model(inputs, train=True)
            loss = loss_fn(logits, labels)
            loss.backward()
            return loss.detach(), logits.detach()
        logits = _remat_forward(model, inputs)
        stats = _snapshot(model)
        loss = loss_fn(logits, labels)
        loss.backward()
        _restore(model, stats)
        return loss.detach(), logits.detach()

    return value_and_grad


def make_train_step(loss_fn: Callable = cross_entropy_loss, *,
                    metrics_fn: Optional[Callable] = None,
                    accum_steps: int = 1, remat: bool = False,
                    guard_nonfinite: Optional[bool] = None,
                    zero: Optional[bool] = None,
                    overlap: Optional[bool] = None,
                    _value_and_grad: Optional[Callable] = None):
    """Build ``step(state, (inputs, labels)) -> (state, metrics)``. The
    batch is this rank's shard; ``metrics`` (the loss, plus
    ``metrics_fn(logits, labels)``'s dict) are world averages.

    ``accum_steps=N`` splits the batch into N microbatches run one after
    another in the step; their gradients are summed (f32 for sub-f32
    gradients), scaled by ``1/N`` once after the loop, and exchanged
    ONCE. BatchNorm statistics thread through the microbatches (N
    momentum updates); integer metric leaves keep their sum. Leave the
    ``DistributedOptimizer`` at ``accum_steps=1``: the step owns the
    ``1/N``. The batch must divide by N (checked eagerly).

    ``remat`` checkpoints each microbatch's forward
    (``torch.utils.checkpoint``): activations are recomputed in the
    backward; BatchNorm's running statistics are updated once.

    ``guard_nonfinite`` (default ``HVD_GUARD_NONFINITE``) arms the
    bad-step guard: the world-wide all-finite flag comes from the reduced
    gradient buckets (no extra collective), and the step reads it on the
    host once. A non-finite gradient on any rank leaves params, optimizer
    state and BatchNorm running statistics bit-unchanged (the buffers,
    updated in place by the forward, are snapshot before it and put
    back); the step counter still advances. The metrics gain a
    replica-identical ``bad_step`` (1.0 = skipped) and the other metrics
    read 0 on a skipped step. With the guard off the step launches
    nothing more than without it.

    ``zero`` (default: the optimizer's ``zero``, or ``HVD_ZERO``) runs
    the ZeRO-1 plane of a ``DistributedOptimizer(zero=True)``
    (``create_train_state(zero=True)``): one reduce-scatter and one
    all-gather per bucket, the optimizer state sharded 1/size() per
    rank. It must agree with the optimizer, both ways (checked at each
    call). Under the guard the world-wide verdict rides the all-gather
    and a skip puts the shards' optimizer state back.

    ``overlap`` (default: the optimizer's ``overlap``, or
    ``HVD_OVERLAP``) starts each bucket's collective during the backward
    as its last gradient lands (the optimizer's hooks, armed before the
    backward — before the LAST microbatch's under ``accum_steps``, with
    the ``1/N`` folded into each bucket's prescale). The same
    collectives as without it; on the ZeRO plane only their order
    changes. Accumulation with overlap needs f32 gradients (a narrower
    gradient leaves ``.grad`` for an f32 accumulator after each
    microbatch).

    ``_value_and_grad(model, batch) -> (loss, logits)`` (the counterpart
    of the JAX hook of the same name) replaces the default loss of
    ``loss_fn(model(inputs, train=True), labels)``: it computes the loss
    of the whole batch from the model, leaves the gradients summed into
    each parameter's ``.grad`` (e.g. by ``loss.backward()``) and returns
    the detached loss and the logits (None when it has none). The
    transformer LM's step (:func:`~.parallel.transformer.
    make_parallel_train_step`) plugs in its own forward and loss this
    way; it owns its remat (``TransformerConfig.remat``)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if _value_and_grad is not None and remat:
        raise ValueError(
            "a custom _value_and_grad owns its own remat policy — "
            "make_train_step(remat=) applies to the model's forward only")
    guard = (_config.guard_nonfinite() if guard_nonfinite is None
             else bool(guard_nonfinite))
    env_zero, env_overlap = _config.zero_enabled(), _config.overlap_enabled()

    vag = _build_value_and_grad(loss_fn, remat) \
        if _value_and_grad is None else _value_and_grad

    def resolve(opt: DistributedOptimizer) -> bool:
        """Check the step's knobs against the optimizer's stamps; returns
        whether this step arms the overlapped exchange."""
        want_zero = (opt.zero or env_zero) if zero is None else zero
        if want_zero and not opt.zero:
            raise ValueError(
                "zero=True (or HVD_ZERO=1) requires a ZeRO-sharded "
                "optimizer: build it with DistributedOptimizer(opt, "
                "zero=True) (create_train_state(zero=True) does this for "
                "you)")
        if opt.zero and not want_zero:
            raise ValueError(
                "this DistributedOptimizer was built with zero=True — its "
                "state is rank-sharded and the step must be built with "
                "make_train_step(zero=True) (leave zero unset to "
                "auto-detect)")
        arm = (opt.overlap or env_overlap) if overlap is None else overlap
        if arm:
            opt.enable_overlap()
        if accum_steps > 1:
            if opt.accum_steps > 1:
                raise ValueError(
                    "accum_steps is set on BOTH make_train_step and "
                    "DistributedOptimizer — the gradients would be divided "
                    "by N twice; set it in one place (make_train_step owns "
                    "the microbatch loop and its 1/N)")
            if arm and any(p.dtype != torch.float32
                           for _, p in opt.named_parameters):
                raise ValueError(
                    "overlap with accum_steps > 1 needs f32 gradients: a "
                    "narrower gradient moves to an f32 accumulator after "
                    "each microbatch, before its bucket could be emitted")
        return arm

    def step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        opt = state.optimizer
        arm = resolve(opt)
        if accum_steps > 1:
            _check_accum_batch(batch[0], accum_steps)
        state.model.train()
        opt.zero_grad(set_to_none=True)
        saved = _snapshot(state.model) if guard else None
        if accum_steps == 1:
            if arm:
                opt.arm()
            loss, logits = vag(state.model, batch)
            extras = (metrics_fn(logits, batch[1])
                      if metrics_fn is not None else None)
        else:
            before_last = (lambda: opt.arm(1.0 / accum_steps)) if arm \
                else None
            loss, extras = _accumulate_grads(vag, state.model, batch,
                                             accum_steps, metrics_fn,
                                             before_last)
        if guard:
            finite, applied = opt.guarded_step()
            if not applied:
                _restore(state.model, saved)
        else:
            opt.step()
        state.step += 1
        metrics = {"loss": _world_mean(loss.float())}
        if extras is not None:
            metrics.update({k: _world_mean(torch.as_tensor(v))
                            for k, v in extras.items()})
        if guard:
            metrics = {k: torch.where(finite, v, torch.zeros_like(v))
                       for k, v in metrics.items()}
            metrics["bad_step"] = (~finite).float()
        return state, metrics

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

"""``DistributedOptimizer`` and the parameter/optimizer-state broadcasts.

Port of the JAX package's ``optimizer.py`` plain plane:
``DistributedOptimizer`` (:583-640) wraps any ``torch.optim.Optimizer``;
its ``step()`` fused-allreduces the ``.grad`` of every parameter, bucket
by bucket in the order of ``named_parameters`` (:func:`.ops.fusion.
fused_allreduce`, with its ``accum_steps`` prescale and ``wire_dtype``),
and then runs the wrapped step. ``allreduce_gradients`` (:788) is the
exchange alone. ``broadcast_parameters`` (the counterpart
of ``broadcast_global_variables`` :877) sends rank 0's parameters AND
buffers (BatchNorm running statistics) to every rank;
``broadcast_optimizer_state`` (:895) does the same for the optimizer's
state and hyperparameters.

Bucket order is the plan's contract: every rank must hand the same
parameters in the same order. A parameter whose ``.grad`` is None takes
part as zeros, so every rank runs the same plan.
"""

from __future__ import annotations

from typing import (Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch
import torch.distributed as dist

from . import runtime
from .ops.fusion import fused_allreduce, resolve_wire_dtype
from .utils import config as _config

NamedParams = Sequence[Tuple[str, torch.nn.Parameter]]


def allreduce_gradients(params: Iterable[torch.nn.Parameter],
                        average: bool = True,
                        fusion_threshold: Optional[int] = None,
                        group=None, accum_steps: int = 1,
                        wire_dtype=None, return_finite: bool = False):
    """Replace each parameter's ``.grad`` with its average (or sum) over
    ``group`` (the world when None) through the fused bucket allreduce,
    in the order given. ``accum_steps > 1`` divides by the local
    microbatch count (the caller's ``.grad`` holds a SUM over that many
    backward passes) as a prescale fused into each bucket; ``wire_dtype``
    passes through to :func:`~.ops.fusion.fused_allreduce`.
    ``return_finite=True`` returns the world-wide all-finite flag (a
    0-dim bool tensor) read from the reduced buckets; None otherwise."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    out = fused_allreduce(grads, average=average,
                          fusion_threshold=fusion_threshold,
                          prescale=None if accum_steps <= 1
                          else 1.0 / accum_steps,
                          group=group, wire_dtype=wire_dtype,
                          return_finite=return_finite)
    reduced, finite = out if return_finite else (out, None)
    with torch.no_grad():
        for p, g, r in zip(params, grads, reduced):
            if p.grad is None:
                p.grad = r.clone()
            else:
                g.copy_(r)
    return finite


class DistributedOptimizer:
    """Wrap ``optimizer`` so that ``step()`` first averages the gradients
    over the world, or over ``process_group`` when one is given (the
    averaging denominator is then that group's size).

    ``named_parameters`` fixes the bucket order (default: the wrapped
    optimizer's parameter groups in order). ``accum_steps`` is the
    reference's ``backward_passes_per_step``: the caller's ``.grad``
    holds the SUM of that many microbatch gradients and the exchange
    divides by it, folded into each bucket's prescale (do not also set
    ``make_train_step(accum_steps=)``, which owns its own ``1/N``).
    ``wire_dtype`` (``"bf16"``, ``"fp8"``; default ``HVD_WIRE_DTYPE``)
    puts float gradient buckets on the wire in reduced precision with
    f32 scales and f32 results (:func:`~.ops.fusion.fused_allreduce`).
    Every other attribute — ``param_groups``, ``state``, ``zero_grad``,
    ``state_dict`` … — is the wrapped optimizer's, so its state is
    exactly the plain optimizer's."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[NamedParams] = None,
                 average: bool = True,
                 fusion_threshold: Optional[int] = None,
                 process_group=None, accum_steps: int = 1,
                 wire_dtype=None):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.optimizer = optimizer
        self.average = average
        self.fusion_threshold = fusion_threshold
        self.process_group = process_group
        self.accum_steps = accum_steps
        self.wire_dtype = resolve_wire_dtype(
            wire_dtype if wire_dtype is not None
            else _config.wire_dtype_default())
        owned = [p for g in optimizer.param_groups for p in g["params"]]
        if named_parameters is None:
            named_parameters = [(f"param_{i}", p) for i, p in
                                enumerate(owned)]
        named_parameters = list(named_parameters)
        if {id(p) for _, p in named_parameters} != {id(p) for p in owned}:
            raise ValueError(
                "named_parameters must list exactly the parameters the "
                "wrapped optimizer updates")
        names = [n for n, _ in named_parameters]
        if len(set(names)) != len(names):
            raise ValueError("named_parameters has duplicate names")
        self.named_parameters = named_parameters

    def synchronize(self, return_finite: bool = False):
        """The gradient exchange alone; with ``return_finite`` it returns
        the world-wide all-finite flag of the reduced gradients (the
        bad-step guard's signal, no extra collective)."""
        return allreduce_gradients(
            [p for _, p in self.named_parameters], average=self.average,
            fusion_threshold=self.fusion_threshold,
            group=self.process_group, accum_steps=self.accum_steps,
            wire_dtype=self.wire_dtype, return_finite=return_finite)

    def step(self, closure=None):
        self.synchronize()
        return self.optimizer.step(closure)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def __getattr__(self, name):
        # Only reached for attributes this wrapper does not define.
        return getattr(self.__dict__["optimizer"], name)


def _tensors_of(params) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if isinstance(params, Mapping):
        return list(params.items())
    return [(str(n), t) for n, t in params]


def broadcast_parameters(params: Union[torch.nn.Module,
                                       Mapping[str, torch.Tensor],
                                       Sequence[Tuple[str, torch.Tensor]]],
                         root_rank: int = 0) -> None:
    """Overwrite, in place, every tensor of ``params`` (a module — its
    ``state_dict()``, buffers included —, a state dict, or ``(name,
    tensor)`` pairs) with ``root_rank``'s."""
    if not 0 <= root_rank < runtime.size():
        raise ValueError(f"root_rank {root_rank} is out of range for world "
                         f"size {runtime.size()}")
    with torch.no_grad():
        for _, t in _tensors_of(params):
            buf = t.data if t.is_contiguous() else t.data.contiguous()
            dist.broadcast(buf, src=root_rank)
            if buf is not t.data:
                t.data.copy_(buf)


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Give every rank ``root_rank``'s optimizer state (per-parameter
    tensors such as momentum buffers, and the hyperparameters of each
    group). A rank that has no state yet for a parameter gets it."""
    opt = getattr(optimizer, "optimizer", optimizer)
    params = [p for g in opt.param_groups for p in g["params"]]
    spec = None
    if runtime.rank() == root_rank:
        spec = {"groups": [{k: v for k, v in g.items() if k != "params"}
                           for g in opt.param_groups],
                "state": [{k: (tuple(v.shape), str(v.dtype))
                           if torch.is_tensor(v) else v
                           for k, v in opt.state.get(p, {}).items()}
                          for p in params]}
    box = [spec]
    dist.broadcast_object_list(box, src=root_rank)
    spec = box[0]
    for g, hyper in zip(opt.param_groups, spec["groups"]):
        g.update(hyper)
    with torch.no_grad():
        for p, entries in zip(params, spec["state"]):
            state: Dict = opt.state[p] if entries else {}
            for key in sorted(entries):
                desc = entries[key]
                if isinstance(desc, tuple):
                    shape, dtype = desc
                    dt = getattr(torch, dtype.replace("torch.", ""))
                    t = state.get(key)
                    if (t is None or tuple(t.shape) != shape
                            or t.dtype != dt):
                        # A step counter lives on the CPU; everything
                        # else on the parameter's device.
                        dev = t.device if t is not None else (
                            torch.device("cpu") if shape == ()
                            else p.device)
                        t = torch.zeros(shape, dtype=dt, device=dev)
                        state[key] = t
                    if t.device.type == "cpu" and \
                            runtime.world().backend == "nccl":
                        moved = t.to(runtime.device())
                        dist.broadcast(moved, src=root_rank)
                        t.copy_(moved)
                    else:
                        dist.broadcast(t, src=root_rank)
                else:
                    state[key] = desc

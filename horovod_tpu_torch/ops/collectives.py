"""Eager collectives over the world: ``allreduce``, ``allgather``,
``broadcast``.

Port of the JAX package's ``ops/collectives.py`` eager surface (``Op``
:57, ``allreduce`` :251, ``allgather`` :291, ``broadcast`` :354) on
``torch.distributed``: NCCL on the GPU, gloo on the CPU. Each call is one
collective on the default process group and returns a new tensor; the
input is left as it is. Collectives are matched across ranks by call
order, so ``name=`` is accepted for API parity and not used.

Not ported yet: the variable-first-dim allgather, alltoall,
reducescatter, the async handles and the object collectives.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch
import torch.distributed as dist

from .. import runtime


class Op(enum.Enum):
    """Reduction op (``average=True`` is ``AVERAGE``)."""

    SUM = "sum"
    AVERAGE = "average"
    MIN = "min"
    MAX = "max"
    PRODUCT = "product"


_REDUCE_OPS = {Op.SUM: dist.ReduceOp.SUM, Op.AVERAGE: dist.ReduceOp.SUM,
               Op.MIN: dist.ReduceOp.MIN, Op.MAX: dist.ReduceOp.MAX,
               Op.PRODUCT: dist.ReduceOp.PRODUCT}


def reduce_(tensor: torch.Tensor, op: Op, group=None) -> torch.Tensor:
    """All-reduce a contiguous tensor IN PLACE over ``group`` (the world
    when None) and return it. ``AVERAGE`` sums, then divides by the
    group's size (a true division, as the JAX package's ``pmean``); an
    integer tensor averages into a float one."""
    dist.all_reduce(tensor, op=_REDUCE_OPS[op], group=group)
    if op is Op.AVERAGE:
        n = runtime.size() if group is None else dist.get_world_size(group)
        if tensor.is_floating_point():
            return tensor.div_(n)
        return tensor / n
    return tensor


def allreduce(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None,
              op: Optional[Op] = None) -> torch.Tensor:
    """Sum (or average) ``tensor`` across all ranks."""
    del name
    resolved = op if op is not None else (Op.AVERAGE if average else Op.SUM)
    return reduce_(tensor.detach().clone(
        memory_format=torch.contiguous_format), resolved)


def allgather(tensor: torch.Tensor,
              name: Optional[str] = None) -> torch.Tensor:
    """Concatenate each rank's tensor along dim 0, in rank order. Every
    rank must pass the same shape."""
    del name
    t = tensor.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(runtime.size())]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim=0)


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None) -> torch.Tensor:
    """Every rank receives the root's tensor."""
    del name
    if not 0 <= root_rank < runtime.size():
        raise ValueError(f"root_rank {root_rank} is out of range for world "
                         f"size {runtime.size()}")
    out = tensor.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=root_rank)
    return out

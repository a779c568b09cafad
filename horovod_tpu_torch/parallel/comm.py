"""Differentiable collectives of the tp, sp, ep and pp axes.

The JAX package runs its parallel layers under a full-manual
``shard_map``, where the transpose of ``psum`` is ``psum``, of ``pmean``
``pmean``, of a tiled ``all_to_all`` the inverse ``all_to_all`` and of a
``ppermute`` the opposite ``ppermute``. These autograd functions give
the port's eager layers the same forwards and backwards over a process
group (``torch.distributed`` collectives carry no autograd of their
own). A group of one rank moves nothing: the collective is skipped both
ways.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _group_size(group) -> int:
    return dist.get_world_size(group)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    if _group_size(group) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group``; the backward sums the cotangent over the
    group too (JAX's ``psum`` transpose under a full-manual
    ``shard_map``, not Megatron's identity)."""
    return _Psum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean of ``x`` over ``group``; the backward is the mean of the
    cotangent (JAX's ``pmean`` transpose)."""
    return psum(x, group) / _group_size(group)


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 split into equal blocks: block ``j`` goes to group rank
    ``j``; block ``i`` of the result came from group rank ``i``. Moves
    raw bytes, so every dtype rides (gloo reduces few)."""
    n = _group_size(group)
    if n == 1:
        return x
    t = x.contiguous()
    raw = t.view(n, -1).view(torch.uint8)
    out = torch.empty_like(raw)
    dist.all_to_all_single(out, raw, group=group)
    return out.view(t.dtype).view(t.shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """All-to-all over dim 0 (``x.shape[0]`` divisible by the group
    size; JAX ``all_to_all(split_axis=0, concat_axis=0, tiled=True)``);
    differentiable, its backward is the same exchange of the
    cotangent."""
    if x.shape[0] % _group_size(group):
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"split over {_group_size(group)} ranks")
    return _AllToAll.apply(x, group)


def _shift(x: torch.Tensor, peers: Sequence[int], index: int, step: int,
           group) -> torch.Tensor:
    """Send ``x`` to the peer ``step`` places on along ``peers`` and
    return what the peer ``step`` places back sent; the send and the
    receive are posted together (at two ranks the peer is the same both
    ways)."""
    n = len(peers)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, peers[(index + step) % n], group),
           dist.P2POp(dist.irecv, out, peers[(index - step) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, peers, index, group):
        ctx.args = (peers, index, group)
        return _shift(x, peers, index, 1, group)

    @staticmethod
    def backward(ctx, g):
        peers, index, group = ctx.args
        return _shift(g, peers, index, -1, group), None, None, None


def rotate(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """One hop around the ring of ``axis``: this rank's ``x`` goes to the
    next index, the previous index's arrives (JAX ``ppermute`` with
    ``[(i, i+1 mod S)]``); the backward rotates the cotangent the other
    way."""
    peers = mesh.ranks[axis]
    if len(peers) == 1:
        return x
    return _Rotate.apply(x, tuple(peers), mesh.coords[axis],
                         mesh.groups[axis])

"""Tensor parallelism: Megatron-style sharded matmul pairs over ``tp``.

Port of the JAX package's ``parallel/tp.py``: ``init_column`` (:23),
``init_row`` (:34), ``column_parallel`` (:44) and ``row_parallel``
(:50). Activations stay replicated across tp while the weights are
sharded: a column-parallel matmul (out-features sharded, no
communication) feeds a row-parallel one (in-features sharded, one sum
all-reduce to recombine).

The backward of ``row_parallel``'s all-reduce is a sum all-reduce too,
as the JAX package's ``psum`` transposes under its full-manual
``shard_map`` — not the identity of Megatron's f/g pair. A tp-sharded
weight's gradient then arrives tp times the true one on every rank, and
a replicated leaf's per-rank partials sum to tp times the true gradient;
the spec-grouped gradient plan divides both back out
(:func:`~..ops.fusion.plan_grad_sync`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from .comm import psum


def _tp(mesh, axis_name: str):
    return mesh.shape.get(axis_name, 1), mesh.coords.get(axis_name, 0)


def _draw(seed: int, rank: int, shape, scale: float, dtype,
          device: DeviceLike) -> torch.Tensor:
    dev = resolve_device(device)
    # The tp rank folds into the seed: shards differ across tp, dp and sp
    # replicas (same tp rank, same seed) agree.
    gen = torch.Generator(device=dev).manual_seed(
        (int(seed) * 1_000_003 + int(rank)) % (2 ** 63))
    w = torch.randn(shape, generator=gen, device=dev) * scale
    return w.to(dtype)


def init_column(seed: int, d_in: int, d_out: int, mesh, *,
                axis_name: str = "tp", dtype=torch.float32,
                device: DeviceLike = "cuda") -> torch.Tensor:
    """This rank's ``[d_in, d_out/S]`` shard of a column-parallel weight,
    N(0, 1/d_in), drawn from a generator seeded with ``seed`` and this
    rank's tp index (no full-size weight is drawn)."""
    S, r = _tp(mesh, axis_name)
    return _draw(seed, r, (d_in, d_out // S), d_in ** -0.5, dtype, device)


def init_row(seed: int, d_in: int, d_out: int, mesh, *,
             axis_name: str = "tp", dtype=torch.float32,
             device: DeviceLike = "cuda") -> torch.Tensor:
    """This rank's ``[d_in/S, d_out]`` shard of a row-parallel weight,
    N(0, 1/d_in)."""
    S, r = _tp(mesh, axis_name)
    return _draw(seed, r, (d_in // S, d_out), d_in ** -0.5, dtype, device)


def column_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[..., d_in] @ [d_in, d_out_local]``: no communication, the
    output stays sharded on its feature dimension."""
    return x @ w


def row_parallel(x_local: torch.Tensor, w: torch.Tensor, mesh=None, *,
                 axis_name: str = "tp", group=None) -> torch.Tensor:
    """``[..., d_in_local] @ [d_in_local, d_out]`` summed over the tp
    group (``group``, or ``mesh``'s ``axis_name`` group): the pair's one
    collective, with a sum all-reduce as its backward."""
    if group is None:
        group = mesh.groups[axis_name]
    return psum(x_local @ w, group)


def tp_reduce(mesh, axis_name: str = "tp") -> Optional[callable]:
    """The row-parallel combine of ``mesh``'s tp axis as a function of
    the local product (None when the mesh has no such axis)."""
    if mesh is None or axis_name not in mesh.shape:
        return None
    group = mesh.groups[axis_name]
    return lambda y: psum(y, group)

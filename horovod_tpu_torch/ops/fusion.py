"""Tensor fusion: bucket planning and the fused allreduce.

Port of the plain plane of the JAX package's ``ops/fusion.py``:
``_greedy_scan``/``plan_buckets`` (:48, :98), ``_fuse``/``_unfuse``
(:276), ``_prescale_array`` (:290) and ``fused_allreduce`` (:599) with a
full-precision wire, no overlap and no sparse leaves, over the world or
one process group; and the spec-grouped plan ``GradSync`` /
``plan_grad_sync`` (:434-487), which decides per leaf which mesh axes its
gradient is summed over.

The plan walks the tensors in request order and fuses while the dtype
matches and the bucket stays within the byte threshold, closing the
bucket at the first tensor that does not fit — it never looks ahead and
never reorders. Each bucket rides ONE ``all_reduce``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..utils import config as _config
from .collectives import Op, reduce_

_Key = Tuple[Tuple[int, ...], str]


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def _greedy_scan(key: Sequence[_Key], order: Sequence[int],
                 fusion_threshold: int) -> Tuple[Tuple[int, ...], ...]:
    """Fuse while dtype matches and cumulative bytes stay within the
    threshold; close the bucket at the first non-fusable tensor."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_dtype = None
    cur_bytes = 0
    for i in order:
        shape, dtype = key[i]
        nbytes = int(math.prod(shape)) * _itemsize(dtype)
        if (fusion_threshold > 0 and cur and dtype == cur_dtype
                and cur_bytes + nbytes <= fusion_threshold):
            cur.append(i)
            cur_bytes += nbytes
        else:
            if cur:
                buckets.append(cur)
            cur, cur_dtype, cur_bytes = [i], dtype, nbytes
    if cur:
        buckets.append(cur)
    return tuple(tuple(b) for b in buckets)


@functools.lru_cache(maxsize=512)
def _plan_cached(key: Tuple[_Key, ...],
                 fusion_threshold: int) -> Tuple[Tuple[int, ...], ...]:
    return _greedy_scan(key, range(len(key)), fusion_threshold)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def plan_buckets(tensors: Sequence[torch.Tensor],
                 fusion_threshold: Optional[int] = None) -> List[List[int]]:
    """Partition tensor indices into fusion buckets, preserving order.
    ``fusion_threshold`` defaults to ``HOROVOD_FUSION_THRESHOLD``; 0 gives
    one bucket per tensor. The scan is cached per (shapes, dtypes,
    threshold); each call returns a fresh list."""
    if fusion_threshold is None:
        fusion_threshold = _config.fusion_threshold_bytes()
    key = tuple((tuple(t.shape), _dtype_name(t.dtype)) for t in tensors)
    return [list(b) for b in _plan_cached(key, int(fusion_threshold))]


def _fuse(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unfuse(flat: torch.Tensor,
            like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, offset = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[offset:offset + n].view(t.shape))
        offset += n
    return out


def _prescale_array(x: torch.Tensor, prescale: Optional[float]
                    ) -> torch.Tensor:
    """Scale one bucket before its collective. Sub-f32 float buckets are
    scaled IN f32 with one final cast (a bf16 multiply would quantize the
    scale and round twice); integer buckets pass through."""
    if prescale is None or not x.is_floating_point():
        return x
    if x.element_size() < 4:
        return (x.float() * prescale).to(x.dtype)
    return x * prescale


def fused_allreduce(tensors: Sequence[torch.Tensor], average: bool = True,
                    fusion_threshold: Optional[int] = None,
                    prescale: Optional[float] = None, group=None
                    ) -> List[torch.Tensor]:
    """Allreduce ``tensors`` over ``group`` (the world when None) bucket
    by bucket (one ``all_reduce`` each) and return the reduced tensors in
    the same order. ``average`` divides the sums by the group's size;
    ``prescale`` multiplies every bucket before its reduce."""
    tensors = list(tensors)
    op = Op.AVERAGE if average else Op.SUM
    reduced: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for bucket in plan_buckets(tensors, fusion_threshold):
        members = [tensors[j] for j in bucket]
        if len(bucket) == 1:
            operand = members[0].detach().clone(
                memory_format=torch.contiguous_format)
        else:
            operand = _fuse([m.detach() for m in members])
        operand = _prescale_array(operand, prescale)
        r = reduce_(operand, op, group)
        if len(bucket) == 1:
            reduced[bucket[0]] = r.view(members[0].shape)
        else:
            for j, rr in zip(bucket, _unfuse(r, members)):
                reduced[j] = rr
    return reduced


# -- the spec-grouped plan ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GradSync:
    """One leaf's gradient-sync decision on a named mesh: ``psum``, the
    mesh axes the gradient is summed over (the leaf is replicated across
    exactly these); ``shard``, the axes the leaf itself is sharded over;
    ``denom``, the averaging denominator (the product of the ``psum``
    axis sizes)."""

    psum: Tuple[str, ...]
    shard: Tuple[str, ...]
    denom: int


def _spec_axes(spec) -> set:
    """Mesh axis names a spec names (entries are an axis name, a tuple of
    names, or None)."""
    axes = set()
    for s in (spec or ()):
        if s is not None:
            axes.update((s,) if isinstance(s, str) else s)
    return axes


def plan_grad_sync(specs: Sequence[Any], mesh, *,
                   skip_axes: Tuple[str, ...] = ()) -> List[GradSync]:
    """Per-leaf :class:`GradSync` for a flat list of specs (one tuple per
    leaf naming the mesh axis each dimension is sharded over, or None)
    over ``mesh`` (:class:`~..parallel.mesh.Mesh`): the gradient is
    summed over every mesh axis the leaf is replicated across, minus
    ``skip_axes``, and averaged by the product of those axes' sizes. The
    JAX rule's tp correction has no counterpart until the port has a tp
    axis."""
    out = []
    for spec in specs:
        leaf_axes = _spec_axes(spec)
        over = tuple(a for a in mesh.axis_names
                     if a not in leaf_axes and a not in skip_axes)
        shard = tuple(a for a in mesh.axis_names
                      if a in leaf_axes and a not in skip_axes)
        out.append(GradSync(psum=over, shard=shard,
                            denom=math.prod(mesh.shape[a] for a in over)))
    return out

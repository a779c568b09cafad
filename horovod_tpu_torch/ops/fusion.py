"""Tensor fusion: bucket planning and the fused allreduce.

Port of the plain plane of the JAX package's ``ops/fusion.py``:
``_greedy_scan``/``plan_buckets`` (:48, :98), ``_fuse``/``_unfuse``
(:276), ``_prescale_array`` (:290), the low-precision wire formats
(``resolve_wire_dtype`` :330, ``wire_dtype_name`` :351,
``_wire_applies`` :359, ``_wire_exchange``/``_wire_sum`` :368-405) and
``fused_allreduce`` (:599) with its wire and its all-finite flag, no
overlap and no sparse leaves, over the world or one process group; and
the spec-grouped plan ``GradSync`` / ``plan_grad_sync`` (:434-487),
which decides per leaf which mesh axes its gradient is summed over.

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
import torch.distributed as dist

from .. import runtime
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


# -- low-precision wire formats ----------------------------------------------
# Cast on send, f32 results: every scale that touches a bucket (average's
# 1/size, accumulation's 1/N, fp8's dynamic scale) is applied in f32 BEFORE
# the one cast, the collective carries the wire dtype, and the result is
# back in f32 with the scale divided out and cast to the bucket's dtype —
# the only loss is the one quantization on send.

# fp8 (e4m3) headroom: values are scaled so the worst-case reduced sum
# (every rank at amax, same sign) lands at half of the 448 format max.
_FP8_MARGIN = 224.0

_WIRE_ALIASES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn, "fp8_e4m3": torch.float8_e4m3fn,
    "f8e4m3": torch.float8_e4m3fn, "float8_e4m3fn": torch.float8_e4m3fn,
}
_WIRE_NONE = (None, "", "none", "fp32", "f32", "float32")


def resolve_wire_dtype(spec) -> Optional[torch.dtype]:
    """Normalize a wire-format spec to a torch dtype (None = full
    precision). Accepts the knob spellings (``"bf16"``, ``"fp8"``), the
    canonical dtype names, torch dtypes, or None/``"fp32"``. Unknown specs
    raise eagerly with the supported set named — a typo must not silently
    train at full precision."""
    if spec in _WIRE_NONE:
        return None
    key = spec if isinstance(spec, str) else _dtype_name(spec)
    key = key.strip().lower()
    if key in _WIRE_NONE:
        return None
    wire = _WIRE_ALIASES.get(key)
    if wire is None:
        raise ValueError(
            f"unknown wire_dtype {spec!r}: supported are 'bf16', 'fp8' "
            f"(e4m3 with per-bucket dynamic scaling), or None/'fp32' for "
            f"full precision")
    return wire


def wire_dtype_name(wire) -> str:
    """Knob spelling of a wire dtype (for JSON lines)."""
    w = resolve_wire_dtype(wire)
    if w is None:
        return "fp32"
    return "bf16" if w == torch.bfloat16 else "fp8"


def _wire_applies(dtype: torch.dtype, wire: Optional[torch.dtype]) -> bool:
    """A bucket rides the wire format only when it is float and strictly
    wider than the wire dtype (a bf16 bucket under a bf16 wire is already
    at wire width; integers never quantize)."""
    return (wire is not None and dtype.is_floating_point
            and dtype.itemsize > wire.itemsize)


def native_wire_reduce(backend: str, wire: torch.dtype,
                       device: Optional[torch.device] = None) -> bool:
    """Whether ``backend``'s ``all_reduce`` sums ``wire`` itself. bf16:
    gloo and NCCL both do. fp8 e4m3: gloo does not (its ``all_reduce``
    raises "Invalid scalar type"); NCCL does from 2.24 on sm_90 and newer.
    Where this is False the wire bytes travel by all-gather and are summed
    in f32 (:func:`_gather_sum`)."""
    if wire == torch.bfloat16:
        return backend in ("gloo", "nccl")
    if backend != "nccl" or device is None or device.type != "cuda":
        return False
    return (torch.cuda.nccl.version() >= (2, 24)
            and torch.cuda.get_device_capability(device) >= (9, 0))


def wire_path(wire, group=None) -> str:
    """The path a bucket in ``wire`` takes over ``group`` (the world when
    None): ``"native"`` (the backend sums the wire dtype) or ``"gather"``
    (:func:`_gather_sum`); ``"fp32"`` for no wire."""
    w = resolve_wire_dtype(wire)
    if w is None:
        return "fp32"
    backend = dist.get_backend(group)
    return ("native" if native_wire_reduce(backend, w, runtime.device())
            else "gather")


def _gather_sum(w: torch.Tensor, group) -> torch.Tensor:
    """The world's sum of the wire tensor ``w`` for a backend that cannot
    reduce its dtype: every rank's wire bytes are all-gathered as uint8
    and the values summed in f32 in rank order (exact for fp8 up to
    millions of ranks: 4 significant bits each), so every rank computes
    the same sum."""
    n = dist.get_world_size(group)
    raw = w.contiguous().view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=group)
    out = parts[0].view(w.dtype).float()
    for p in parts[1:]:
        out += p.view(w.dtype).float()
    return out


def _wire_sum(flat: torch.Tensor, wire: torch.dtype, group,
              prescale: Optional[float] = None) -> torch.Tensor:
    """One wire-format sum over ``group``: f32 prescale → (fp8: dynamic
    scale) → ONE cast on send → the reduce in the wire dtype (or
    :func:`_gather_sum` where the backend cannot) → f32 result, scale
    divided back out, cast to the bucket's dtype.

    fp8 additionally exchanges one scalar MAX per bucket (the only
    collective any wire format adds): the dynamic scale must be the same
    on every rank, and the sum of ``world`` in-range values must stay in
    range — so it is ``224 / (world · global amax)``, applied in f32 and
    divided back out of the f32 result."""
    orig = flat.dtype
    x = flat.float()
    if prescale is not None:
        x = x * prescale
    scale = None
    if wire.itemsize == 1:
        amax = x.abs().max().reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        world = float(dist.get_world_size(group))
        scale = torch.where(amax > 0, _FP8_MARGIN / (world * amax),
                            torch.ones_like(amax))
        x = x * scale
    w = x.to(wire)
    backend = dist.get_backend(group)
    if native_wire_reduce(backend, wire, w.device):
        dist.all_reduce(w, group=group)
        out = w.float()
    else:
        out = _gather_sum(w, group)
    if scale is not None:
        out = out / scale
    return out.to(orig)


def fused_allreduce(tensors: Sequence[torch.Tensor], average: bool = True,
                    fusion_threshold: Optional[int] = None,
                    prescale: Optional[float] = None, group=None,
                    wire_dtype=None, return_finite: bool = False):
    """Allreduce ``tensors`` over ``group`` (the world when None) bucket
    by bucket (one ``all_reduce`` each) and return the reduced tensors in
    the same order. ``average`` divides the sums by the group's size;
    ``prescale`` multiplies every bucket before its reduce.

    ``wire_dtype`` (``"bf16"``/``"fp8"``) puts float buckets on the wire
    in reduced precision (:func:`_wire_sum`; the average's ``1/size``
    folds into the f32 prescale). The bucket plan is unchanged.

    ``return_finite=True`` returns ``(reduced, all_finite)``: a 0-dim bool
    tensor on the buckets' device, True iff every float bucket of every
    rank's input was finite. It is read from the REDUCED buckets — a sum
    carries any rank's NaN/Inf — so it is the same on every rank and
    costs no extra collective."""
    wire = resolve_wire_dtype(wire_dtype)
    tensors = list(tensors)
    op = Op.AVERAGE if average else Op.SUM
    reduced: List[Optional[torch.Tensor]] = [None] * len(tensors)
    finite = None
    for bucket in plan_buckets(tensors, fusion_threshold):
        members = [tensors[j] for j in bucket]
        if len(bucket) == 1:
            operand = members[0].detach().clone(
                memory_format=torch.contiguous_format)
        else:
            operand = _fuse([m.detach() for m in members])
        if _wire_applies(operand.dtype, wire):
            eff = prescale
            if op is Op.AVERAGE:
                n = runtime.size() if group is None \
                    else dist.get_world_size(group)
                eff = 1.0 / n if eff is None else eff * (1.0 / n)
            r = _wire_sum(operand, wire, group, prescale=eff)
        else:
            r = reduce_(_prescale_array(operand, prescale), op, group)
        if return_finite and r.is_floating_point():
            flag = torch.isfinite(r).all()
            finite = flag if finite is None else finite & flag
        if len(bucket) == 1:
            reduced[bucket[0]] = r.view(members[0].shape)
        else:
            for j, rr in zip(bucket, _unfuse(r, members)):
                reduced[j] = rr
    if not return_finite:
        return reduced
    if finite is None:
        dev = tensors[0].device if tensors else torch.device("cpu")
        finite = torch.ones((), dtype=torch.bool, device=dev)
    return reduced, finite


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

"""Tensor fusion: bucket planning, the fused allreduce, ZeRO-1's fused
reduce-scatter and all-gather, and backward-overlapped emission.

Port of the JAX package's ``ops/fusion.py``: ``_greedy_scan``/
``plan_buckets`` (:48, :98), ``_fuse``/``_unfuse`` (:276),
``_prescale_array`` (:290), the low-precision wire formats
(``resolve_wire_dtype`` :330, ``wire_dtype_name`` :351,
``_wire_applies`` :359, ``_wire_exchange``/``_wire_sum``/
``_wire_scatter`` :368-415), the spec-grouped plan ``GradSync`` /
``plan_grad_sync`` (:434-487), ``fused_allreduce`` (:599) with its wire,
its all-finite flag and its schedule, the overlap plan
(``BucketSchedule``/``plan_schedule`` :152-201, ``probe_grad_order``
:204, ``zero_emit_order`` :249) and the ZeRO plane (``ZeroPlan`` :771 with
its hybrid fields, ``_local_shape`` :861, ``plan_zero`` :882,
``_fuse_bucket`` :999, ``fused_reduce_scatter`` :1008, ``shard_params``
:1105, ``_unfuse_flat`` :1126, ``_ns_coords``/``_block_index``/
``zero_stack_global``/``zero_unstack_global`` :1153-1232,
``fused_allgather_params`` :1234), over the world or a mesh's groups:
on a hybrid mesh each bucket is reduce-scattered over the rank's dp
group, a replicated bucket is summed over its other axes on the shard,
and the updated shards are all-gathered over dp.

The plan walks the tensors in request order and fuses while the dtype
matches and the bucket stays within the byte threshold, closing the
bucket at the first tensor that does not fit — it never looks ahead and
never reorders. Each bucket rides ONE collective. Where the JAX package
pins emission order inside one compiled program, the port starts each
bucket's collective from a post-accumulate-grad hook
(:class:`OverlapExchange`) and probes the backward's order by recording
those hooks (:func:`probe_grad_order`).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import weakref
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import runtime
from ..utils import config as _config
from .collectives import Op, _finish, _Handle, _size, _start_reduce


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def _greedy_scan(key: Sequence[tuple], order: Sequence[int],
                 fusion_threshold: int) -> Tuple[Tuple[int, ...], ...]:
    """Fuse while the fusion key (``key[i][1:]``: the dtype, and the
    spec group where there is one) matches and the bucket stays within
    the threshold; close the bucket at the first non-fusable tensor.
    ``key[i]`` is ``(shape, dtype)`` or ``(shape, dtype, group)``."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_key = None
    cur_bytes = 0
    for i in order:
        shape, fkey = key[i][0], key[i][1:]
        nbytes = int(math.prod(shape)) * _itemsize(key[i][1])
        if (fusion_threshold > 0 and cur and fkey == cur_key
                and cur_bytes + nbytes <= fusion_threshold):
            cur.append(i)
            cur_bytes += nbytes
        else:
            if cur:
                buckets.append(cur)
            cur, cur_key, cur_bytes = [i], fkey, nbytes
    if cur:
        buckets.append(cur)
    return tuple(tuple(b) for b in buckets)


@functools.lru_cache(maxsize=512)
def _plan_cached(key: Tuple[tuple, ...],
                 fusion_threshold: int) -> Tuple[Tuple[int, ...], ...]:
    return _greedy_scan(key, range(len(key)), fusion_threshold)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _plan_key(tensors: Sequence[torch.Tensor],
              groups: Optional[Sequence[Any]] = None) -> Tuple[tuple, ...]:
    if groups is None:
        return tuple((tuple(t.shape), _dtype_name(t.dtype))
                     for t in tensors)
    if len(groups) != len(tensors):
        raise ValueError(
            f"groups must align with the tensors: {len(groups)} group keys "
            f"for {len(tensors)} tensors")
    return tuple((tuple(t.shape), _dtype_name(t.dtype), g)
                 for t, g in zip(tensors, groups))


def plan_buckets(tensors: Sequence[torch.Tensor],
                 fusion_threshold: Optional[int] = None,
                 groups: Optional[Sequence[Any]] = None) -> List[List[int]]:
    """Partition tensor indices into fusion buckets, preserving order.
    ``fusion_threshold`` defaults to ``HOROVOD_FUSION_THRESHOLD``; 0 gives
    one bucket per tensor. ``groups`` (one hashable per tensor, e.g. its
    :class:`GradSync`) adds a second fusion key beside the dtype. The
    scan is cached per (shapes, dtypes, groups, threshold); each call
    returns a fresh list."""
    if fusion_threshold is None:
        fusion_threshold = _config.fusion_threshold_bytes()
    key = _plan_key(tensors, groups)
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


def _wire_exchange(flat: torch.Tensor, wire: torch.dtype, group,
                   reduce_fn, prescale: Optional[float] = None
                   ) -> torch.Tensor:
    """One wire-format reduction, shared by the all-reduce and ZeRO
    planes: f32 prescale → (fp8: dynamic scale) → ONE cast on send →
    ``reduce_fn`` of the wire tensor (f32 result) → scale divided back
    out, cast to the bucket's dtype.

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
    out = reduce_fn(x.to(wire))
    if scale is not None:
        out = out / scale
    return out.to(orig)


def _native(w: torch.Tensor, group) -> bool:
    return native_wire_reduce(dist.get_backend(group), w.dtype, w.device)


def _wire_sum(flat: torch.Tensor, wire: torch.dtype, group,
              prescale: Optional[float] = None) -> torch.Tensor:
    """The wire-format sum over ``group`` (:func:`_wire_exchange`): the
    reduce in the wire dtype, or :func:`_gather_sum` where the backend
    cannot."""
    def reduce_fn(w):
        if not _native(w, group):
            return _gather_sum(w, group)
        dist.all_reduce(w, group=group)
        return w.float()
    return _wire_exchange(flat, wire, group, reduce_fn, prescale)


def _wire_scatter(flat: torch.Tensor, wire: torch.dtype, group,
                  prescale: Optional[float] = None) -> torch.Tensor:
    """The wire-format reduce-scatter over ``group``
    (:func:`_wire_exchange`): this rank's shard comes back in the
    bucket's dtype, so the optimizer update accumulates at full
    precision. A backend that cannot reduce the wire dtype sums every
    rank's wire bytes (:func:`_gather_sum`) and keeps this rank's
    slice."""
    n = dist.get_world_size(group)

    def reduce_fn(w):
        s = w.numel() // n
        if not _native(w, group):
            r = dist.get_rank(group)
            return _gather_sum(w, group)[r * s:(r + 1) * s]
        out = w.new_empty(s)
        dist.reduce_scatter_tensor(out, w, group=group)
        return out.float()
    return _wire_exchange(flat, wire, group, reduce_fn, prescale)


def _fold(*scales: Optional[float]) -> Optional[float]:
    """The product of the scales that are not None (None if all are)."""
    out = None
    for s in scales:
        if s is not None:
            out = s if out is None else out * s
    return out


def _reduce_bucket(members: Sequence[torch.Tensor], op: Op,
                   prescale: Optional[float], wire, group,
                   async_op: bool = False) -> _Handle:
    """Start one bucket's all-reduce: fuse the members (one copy; a
    lone member is cloned), prescale, and reduce in place — in the wire
    format when one applies (synchronously), else with ``async_op``.
    The handle's ``wait()`` returns the reduced flat bucket."""
    if len(members) == 1:
        operand = members[0].detach().clone(
            memory_format=torch.contiguous_format).reshape(-1)
    else:
        operand = _fuse([m.detach() for m in members])
    n = _size(group)
    if _wire_applies(operand.dtype, wire):
        avg = 1.0 / n if op is Op.AVERAGE else None
        r = _wire_sum(operand, wire, group, prescale=_fold(prescale, avg))
        return _Handle(None, lambda: r)
    work, buf, rdtype = _start_reduce(_prescale_array(operand, prescale),
                                      op, group, async_op)
    return _Handle(work, lambda: _finish(buf, op, n, rdtype))


def fused_allreduce(tensors: Sequence[torch.Tensor], average: bool = True,
                    fusion_threshold: Optional[int] = None,
                    prescale: Optional[float] = None, group=None,
                    wire_dtype=None, return_finite: bool = False,
                    grad_order: Optional[Sequence[int]] = None):
    """Allreduce ``tensors`` over ``group`` (the world when None) bucket
    by bucket (one ``all_reduce`` each) and return the reduced tensors in
    the same order. ``average`` divides the sums by the group's size;
    ``prescale`` multiplies every bucket before its reduce.

    ``wire_dtype`` (``"bf16"``/``"fp8"``) puts float buckets on the wire
    in reduced precision (:func:`_wire_sum`; the average's ``1/size``
    folds into the f32 prescale). The bucket plan is unchanged.

    ``grad_order`` (a backward-completion permutation of the tensors,
    :func:`probe_grad_order`) groups the buckets along that order
    (:func:`plan_schedule`) and reduces them in it: the same plan the
    backward-overlapped exchange (:class:`OverlapExchange`) emits early,
    with the same count of collectives.

    ``return_finite=True`` returns ``(reduced, all_finite)``: a 0-dim bool
    tensor on the buckets' device, True iff every float bucket of every
    rank's input was finite. It is read from the REDUCED buckets — a sum
    carries any rank's NaN/Inf — so it is the same on every rank and
    costs no extra collective."""
    wire = resolve_wire_dtype(wire_dtype)
    tensors = list(tensors)
    op = Op.AVERAGE if average else Op.SUM
    if grad_order is None:
        buckets = plan_buckets(tensors, fusion_threshold)
    else:
        buckets = plan_schedule(tensors, grad_order,
                                fusion_threshold).buckets
    flats = [_reduce_bucket([tensors[j] for j in b], op, prescale, wire,
                            group).wait() for b in buckets]
    reduced = _unfuse_buckets(flats, buckets, tensors)
    if not return_finite:
        return reduced
    dev = tensors[0].device if tensors else torch.device("cpu")
    return reduced, _all_finite(flats, dev)


def _unfuse_buckets(flats: Sequence[torch.Tensor],
                    buckets: Sequence[Sequence[int]],
                    like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The members of each reduced flat bucket, as views of ``like``'s
    shapes, back in tensor order."""
    out: List[Optional[torch.Tensor]] = [None] * len(like)
    for flat, bucket in zip(flats, buckets):
        for j, r in zip(bucket, _unfuse(flat, [like[j] for j in bucket])):
            out[j] = r
    return out


def _all_finite(flats: Sequence[torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """True iff every float tensor of ``flats`` is finite (0-dim bool)."""
    finite = torch.ones((), dtype=torch.bool, device=device)
    for f in flats:
        if f.is_floating_point():
            finite = finite & torch.isfinite(f).all()
    return finite


# -- the spec-grouped plan ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GradSync:
    """One leaf's gradient-sync decision on a named mesh: ``psum``, the
    mesh axes the gradient is summed over (the leaf is replicated across
    exactly these); ``shard``, the axes the leaf itself is sharded over;
    ``denom``, the averaging denominator (the product of the ``psum``
    axis sizes, times tp for a tp-sharded leaf)."""

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
    ``skip_axes``, and averaged by the product of those axes' sizes —
    times the tp size for a leaf sharded over ``tp``: the backward of
    the row-parallel all-reduce is a sum all-reduce, so such a leaf's
    gradient arrives tp times too large (the JAX rule,
    ``parallel.mesh.grad_sync_by_spec``), and the correction rides the
    bucket's one prescale."""
    out = []
    for spec in specs:
        leaf_axes = _spec_axes(spec)
        over = tuple(a for a in mesh.axis_names
                     if a not in leaf_axes and a not in skip_axes)
        shard = tuple(a for a in mesh.axis_names
                      if a in leaf_axes and a not in skip_axes)
        denom = math.prod(mesh.shape[a] for a in over)
        if "tp" in leaf_axes and "tp" in mesh.shape:
            denom *= int(mesh.shape["tp"])
        out.append(GradSync(psum=over, shard=shard, denom=int(denom)))
    return out


#: The world's axis name in a plan of the whole world (the JAX package's
#: ``runtime.AXIS``).
WORLD_AXIS = "hvd"


def plan_exchange(tensors: Sequence[Any], *, world_size: int,
                  axis_name: str = WORLD_AXIS,
                  fusion_threshold: Optional[int] = None
                  ) -> Tuple[List[List[int]], List[GradSync]]:
    """The gradient plan seen from the coordinator's 1-D world (the JAX
    package's ``plan_exchange``, ``ops/fusion.py:488``): every rank holds
    a whole gradient, so each leaf's sync is ``GradSync(psum=(axis_name,),
    shard=(), denom=world_size)``, and the buckets come from the same
    fusion scan with the sync as the group key (one group: the plain
    dtype and threshold walk). Returns ``(buckets, syncs)``. The port's
    gradients ride the process group, whose plan is this one: the
    optimizer carries it as ``exchange_plan``."""
    syncs = [GradSync(psum=(axis_name,), shard=(), denom=int(world_size))
             for _ in tensors]
    return plan_buckets(tensors, fusion_threshold, groups=syncs), syncs


# -- backward-overlapped emission ----------------------------------------------
# One collective per bucket, started as soon as the backward has produced
# the bucket's last gradient (a post-accumulate-grad hook on every
# parameter), in one fixed emission order so every rank issues its
# collectives in the same sequence. The all-reduce plane groups its
# buckets along the backward-completion order (:func:`plan_schedule`), so
# a bucket's members land together; the ZeRO plane keeps its plan's
# membership (it defines the sharded state's layout and the checkpoint's
# form) and only orders emission by readiness (:func:`zero_emit_order`).

@dataclasses.dataclass(frozen=True)
class BucketSchedule:
    """An ordered fusion plan: ``buckets`` are tensor-index groups built
    by walking the tensors in ``order`` (backward-completion order from
    :func:`probe_grad_order`); a pure function of (shapes, dtypes,
    threshold, order)."""

    buckets: Tuple[Tuple[int, ...], ...]
    order: Tuple[int, ...]
    threshold: int


@functools.lru_cache(maxsize=512)
def _schedule_cached(key, order, fusion_threshold: int):
    return _greedy_scan(key, order, fusion_threshold)


def plan_schedule(tensors: Sequence[torch.Tensor],
                  grad_order: Optional[Sequence[int]] = None,
                  fusion_threshold: Optional[int] = None) -> BucketSchedule:
    """The overlap emission schedule of ``tensors``: the fusion scan
    walked in ``grad_order`` (None: flatten order, which is
    :func:`plan_buckets`' plan). Raises unless ``grad_order`` is a
    permutation of the tensor indices."""
    if fusion_threshold is None:
        fusion_threshold = _config.fusion_threshold_bytes()
    key = _plan_key(tensors)
    order = (tuple(range(len(key))) if grad_order is None
             else tuple(int(i) for i in grad_order))
    if sorted(order) != list(range(len(key))):
        raise ValueError(
            f"grad_order must be a permutation of the {len(key)} leaf "
            f"indices; got {order}")
    return BucketSchedule(
        buckets=_schedule_cached(key, order, int(fusion_threshold)),
        order=order, threshold=int(fusion_threshold))


def _on_landed(recorder: "weakref.ref[_OrderRecorder]",
               p: torch.Tensor) -> None:
    rec = recorder()
    if rec is not None:
        rec._landed(p)


class _OrderRecorder:
    """Post-accumulate-grad hooks that note the index of each parameter
    whose gradient lands, in landing order, while ``on``. The hooks hold
    the recorder weakly: autograd keeps a parameter's hooks alive from
    C++, where Python's cycle collector cannot see them, so a strong
    reference would keep the recorder — and through it every parameter
    and the optimizer state — alive for as long as the parameters."""

    def __init__(self, params: Sequence[torch.Tensor], callback=None):
        self.params = list(params)
        self._index = {id(p): i for i, p in enumerate(self.params)}
        if len(self._index) != len(self.params):
            raise ValueError("a parameter is listed twice: every parameter "
                             "must appear once (a tied weight is one leaf)")
        self._callback = callback
        self.on = False
        self.landed: List[int] = []
        hook = functools.partial(_on_landed, weakref.ref(self))
        self._hooks = [p.register_post_accumulate_grad_hook(hook)
                       for p in self.params]

    def _landed(self, p: torch.Tensor) -> None:
        if not self.on:
            return
        j = self._index[id(p)]
        self.landed.append(j)
        if self._callback is not None:
            self._callback(j)

    def order(self) -> Optional[Tuple[int, ...]]:
        """The recorded landing order, completed with the parameters
        whose gradient never landed (flatten order); None when none
        landed."""
        if not self.landed:
            return None
        seen = set(self.landed)
        return tuple(self.landed) + tuple(
            i for i in range(len(self.params)) if i not in seen)

    def remove(self) -> None:
        for h in self._hooks:
            h.remove()
        self._hooks = []


def probe_grad_order(params: Sequence[torch.Tensor],
                     run_backward: Callable[[], Any]
                     ) -> Optional[Tuple[int, ...]]:
    """Backward-completion order of ``params``: the order in which
    ``run_backward()`` (one forward and backward) lands each parameter's
    gradient, from post-accumulate-grad hooks. Parameters whose gradient
    never lands keep flatten order at the end; None when none lands — the
    caller then keeps flatten order. The eager counterpart of the JAX
    probe, which ranks each leaf by its defining equation in a trace."""
    rec = _OrderRecorder(params)
    rec.on = True
    try:
        run_backward()
    finally:
        rec.remove()
    return rec.order()


class OverlapExchange:
    """Per-bucket early emission of a gradient exchange.

    A post-accumulate-grad hook on each of ``params`` counts the members
    of each bucket that have landed; while :meth:`arm`-ed, a bucket whose
    members have all landed is started (``start(bucket index, member
    gradients, prescale) -> handle``) once every bucket before it in the
    emission order has been. :meth:`collect` starts the buckets the
    backward left (a member whose gradient never landed rides as
    ``grad_of`` gives it), waits on every handle in emission order and
    returns the flat results in plan order. :meth:`drain` waits on and
    drops what an armed backward started with no exchange after it.
    :meth:`landing_order` is the last armed backward's (see
    :func:`probe_grad_order`)."""

    def __init__(self, params: Sequence[torch.Tensor], start: Callable,
                 grad_of: Callable[[torch.Tensor], torch.Tensor],
                 buckets: Sequence[Sequence[int]],
                 emit_order: Sequence[int]):
        self._start, self._grad_of = start, grad_of
        self._rec = _OrderRecorder(params, self._landed)
        self._pending: dict = {}
        self.set_schedule(buckets, emit_order)

    @property
    def armed(self) -> bool:
        return self._rec.on

    def set_schedule(self, buckets: Sequence[Sequence[int]],
                     emit_order: Sequence[int]) -> None:
        if self.armed or self._pending:
            raise RuntimeError("the schedule cannot change mid-exchange")
        self.buckets = [tuple(b) for b in buckets]
        self.emit_order = tuple(emit_order)
        self._bucket_of = {j: b for b, members in enumerate(self.buckets)
                           for j in members}

    def arm(self, prescale: Optional[float] = None) -> None:
        """Emit the next backward's buckets as they complete, each
        multiplied by ``prescale`` before its collective."""
        self.drain()
        self._prescale = prescale
        self._left = [len(b) for b in self.buckets]
        self._next = 0
        self._rec.landed = []
        self._rec.on = True

    def _landed(self, j: int) -> None:
        self._left[self._bucket_of[j]] -= 1
        while (self._next < len(self.emit_order)
               and self._left[self.emit_order[self._next]] == 0):
            self._emit()

    def _emit(self) -> None:
        b = self.emit_order[self._next]
        params = self._rec.params
        self._pending[b] = self._start(
            b, [self._grad_of(params[j]) for j in self.buckets[b]],
            self._prescale)
        self._next += 1

    def collect(self) -> List[torch.Tensor]:
        if not self.armed:
            raise RuntimeError("collect() needs an armed backward")
        self._rec.on = False
        while self._next < len(self.emit_order):
            self._emit()
        flats: List[Optional[torch.Tensor]] = [None] * len(self.buckets)
        for b in self.emit_order:
            flats[b] = self._pending[b].wait()
        self._pending = {}
        return flats

    def drain(self) -> None:
        self._rec.on = False
        for b in sorted(self._pending, key=self.emit_order.index):
            self._pending[b].wait()
        self._pending = {}

    def landing_order(self) -> Optional[Tuple[int, ...]]:
        return self._rec.order()


# -- ZeRO-1 sharded-update plane ----------------------------------------------
# The bucket plan feeds a reduce-scatter instead of an all-reduce: each
# rank receives the REDUCED 1/N slice of every flat bucket, updates its
# slice only, and the updated slices ride one all-gather per bucket back
# into the full parameters. Same bytes on the wire as the all-reduce;
# optimizer state and update work drop by the world size.

@dataclasses.dataclass(frozen=True)
class ZeroPlan:
    """Layout of the tensors' rank-sharded flat buckets: ``buckets`` are
    :func:`plan_buckets` index groups, ``sizes``/``padded`` the true and
    rank-padded flat length of each (``padded[i]`` is the smallest
    multiple of ``nshards`` >= ``sizes[i]``), ``shapes``/``dtypes`` the
    tensors' layout.

    The spec-grouped plan (``plan_zero(specs=, mesh=)``) groups buckets
    by each leaf's :class:`GradSync` and records per bucket the
    averaging denominator (``denoms``), the axes of an extra sum
    (``extra_axes``: the axes the bucket is replicated across besides
    the scatter axis) and the axes the bucket's leaves are sharded over
    (``shard_axes``); ``nonscatter`` are the mesh axes besides
    ``scatter_axis`` and the skipped ones, with their sizes, whatever
    they are. Membership is scanned on the GLOBAL shapes
    (``global_shapes``), so the plan, and the canonical checkpoint form
    defined on it, are the same across (dp, tp) reshapes of one set of
    axis names; ``shapes``/``sizes``/``padded`` describe the LOCAL
    blocks a rank holds (its tp, pp or ep block of each leaf)."""

    buckets: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    padded: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    nshards: int
    scatter_axis: Optional[str] = None
    denoms: Optional[Tuple[int, ...]] = None
    extra_axes: Optional[Tuple[Tuple[str, ...], ...]] = None
    shard_axes: Optional[Tuple[Tuple[str, ...], ...]] = None
    nonscatter: Tuple[Tuple[str, int], ...] = ()
    leaf_specs: Optional[Tuple[Any, ...]] = None
    global_shapes: Optional[Tuple[Tuple[int, ...], ...]] = None

    @property
    def hybrid(self) -> bool:
        return self.leaf_specs is not None

    def shard_len(self, i: int) -> int:
        return self.padded[i] // self.nshards

    def bucket_denom(self, i: int) -> int:
        return self.nshards if self.denoms is None else self.denoms[i]

    def bucket_extra(self, i: int) -> Tuple[str, ...]:
        return () if self.extra_axes is None else self.extra_axes[i]

    def bucket_shard_axes(self, i: int) -> Tuple[str, ...]:
        return () if self.shard_axes is None else self.shard_axes[i]

    def bucket_ns(self, i: int) -> int:
        """Product of the sizes of the non-scatter axes bucket ``i``'s
        leaves are sharded over: how many different local blocks of the
        bucket the mesh holds."""
        sizes = dict(self.nonscatter)
        return math.prod(int(sizes[a]) for a in self.bucket_shard_axes(i))

    def shard_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """Per-bucket stacked shape: ``(nshards, shard_len)`` on the 1-D
        world; ``(nshards, ns · shard_len)`` on a hybrid mesh, where
        block ``[:, c·s:(c+1)·s]`` is non-scatter coordinate ``c``'s dp
        stack (:func:`zero_stack_global`). The rank at dp coordinate
        ``d`` and coordinate ``c`` holds ``[d, c·s:(c+1)·s]``; a
        replicated bucket (``ns == 1``) is held alike by every rank of
        its extra axes."""
        return tuple((self.nshards, self.bucket_ns(i) * self.shard_len(i))
                     for i in range(len(self.buckets)))

    def canonical_sizes(self) -> Tuple[int, ...]:
        """Per-bucket length of the world- and mesh-agnostic canonical
        form: the bucket's unpadded flat length on the 1-D world, the
        flat concatenation of its GLOBAL leaves on a hybrid mesh."""
        if not self.hybrid:
            return self.sizes
        return tuple(sum(int(math.prod(self.global_shapes[j])) for j in b)
                     for b in self.buckets)


def _refuse_sparse(tensors: Sequence[Any]) -> None:
    from .sparse import IndexedSlices
    if any(isinstance(t, IndexedSlices) or getattr(t, "is_sparse", False)
           for t in tensors):
        raise ValueError(
            "ZeRO sharded updates require dense gradients: an "
            "IndexedSlices leaf cannot be flattened into rank-sharded "
            "buckets (densify with sparse_as_dense=True, or use the "
            "replicated DistributedOptimizer for sparse models)")


def _local_shape(shape, spec, axis_sizes) -> Tuple[int, ...]:
    """The block shape of a global leaf laid out by ``spec`` (one mesh
    axis per dimension at most)."""
    out = list(shape)
    for d, s in enumerate(spec or ()):
        if s is None:
            continue
        axes = (s,) if isinstance(s, str) else tuple(s)
        if len(axes) > 1:
            raise ValueError(
                f"ZeRO spec-grouped plans support one mesh axis per tensor "
                f"dim; got {spec} (dim {d} sharded over {axes})")
        n = int(axis_sizes[axes[0]])
        if out[d] % n:
            raise ValueError(
                f"dim {d} of shape {tuple(shape)} does not divide by the "
                f"{axes[0]}={n} mesh axis (spec {spec})")
        out[d] //= n
    return tuple(out)


def _global_shape(shape, spec, axis_sizes) -> Tuple[int, ...]:
    """The global shape of a rank's block ``shape`` under ``spec``: each
    sharded dimension times its axis' size."""
    out = list(shape)
    for d, s in enumerate(spec or ()):
        if s is not None:
            if d >= len(out):
                raise ValueError(
                    f"spec {spec} names more dimensions than the block "
                    f"{tuple(shape)}: pass global_shapes=")
            out[d] *= int(axis_sizes[s if isinstance(s, str) else s[0]])
    return tuple(out)


def plan_zero(tensors: Sequence[torch.Tensor], nshards: int,
              fusion_threshold: Optional[int] = None, *, specs=None,
              mesh=None, scatter_axis: str = "dp",
              skip_axes: Tuple[str, ...] = (),
              global_shapes: Optional[Sequence[Sequence[int]]] = None
              ) -> ZeroPlan:
    """The sharded-update layout of ``tensors`` over ``nshards`` ranks.

    ``specs=`` (one spec per tensor, as :func:`plan_grad_sync` takes)
    and ``mesh=`` build the spec-grouped (hybrid) plan, as the JAX steps
    do on any mesh: buckets group within a spec group and the state
    shards over ``scatter_axis``, whose size must be ``nshards``, for
    sharded and replicated leaves alike; every other mesh axis not in
    ``skip_axes`` is a non-scatter axis, whatever its size. ``tensors``
    are this rank's blocks; the plan is made on the GLOBAL shapes, which
    ``global_shapes`` gives (default: each block's sharded dimensions
    times their axis sizes), so it equals the JAX plan of the global
    tree on the same specs and mesh shape, field for field."""
    tensors = list(tensors)
    _refuse_sparse(tensors)
    if nshards < 1:
        raise ValueError(f"nshards must be >= 1, got {nshards}")
    dtypes = tuple(_dtype_name(t.dtype) for t in tensors)
    if specs is None:
        shapes = tuple(tuple(t.shape) for t in tensors)
        buckets = plan_buckets(tensors, fusion_threshold)
        sizes = tuple(sum(int(math.prod(shapes[j])) for j in b)
                      for b in buckets)
        return ZeroPlan(buckets=tuple(tuple(b) for b in buckets),
                        sizes=sizes,
                        padded=tuple(-(-n // nshards) * nshards
                                     for n in sizes),
                        shapes=shapes, dtypes=dtypes, nshards=nshards)
    if mesh is None:
        raise ValueError("plan_zero(specs=...) requires mesh= (the "
                         "named mesh the specs refer to)")
    if scatter_axis not in mesh.shape:
        raise ValueError(
            f"scatter_axis {scatter_axis!r} is not an axis of the mesh "
            f"{dict(mesh.shape)} — ZeRO shards the optimizer state over "
            f"the data-parallel axis")
    if nshards != int(mesh.shape[scatter_axis]):
        raise ValueError(
            f"nshards={nshards} does not match the mesh's "
            f"{scatter_axis}={mesh.shape[scatter_axis]} — the ZeRO "
            f"shard count IS the {scatter_axis} axis size")
    specs = list(specs)
    if len(specs) != len(tensors):
        raise ValueError(
            f"param_specs has {len(specs)} specs for {len(tensors)} "
            f"parameter leaves — they must mirror")
    axis_sizes = dict(mesh.shape)
    for spec in specs:
        unknown = _spec_axes(spec) - set(axis_sizes)
        if unknown:
            raise ValueError(f"spec {spec} names axes {sorted(unknown)} "
                             f"that are not on the mesh {mesh.axis_names}")
    if global_shapes is None:
        global_shapes = [_global_shape(t.shape, spec, axis_sizes)
                         for t, spec in zip(tensors, specs)]
    global_shapes = tuple(tuple(int(n) for n in g) for g in global_shapes)
    if len(global_shapes) != len(tensors):
        raise ValueError(f"global_shapes has {len(global_shapes)} shapes "
                         f"for {len(tensors)} parameter leaves")
    syncs = plan_grad_sync(specs, mesh, skip_axes=skip_axes)
    for spec, sync in zip(specs, syncs):
        if scatter_axis not in sync.psum:
            raise ValueError(
                f"a parameter with spec {spec} is sharded over the "
                f"scatter axis {scatter_axis!r} — ZeRO-over-"
                f"{scatter_axis} requires params replicated across it")
    shapes = tuple(_local_shape(g, spec, axis_sizes)
                   for g, spec in zip(global_shapes, specs))
    for j, (t, shape) in enumerate(zip(tensors, shapes)):
        if t.numel() != math.prod(shape):
            raise ValueError(
                f"tensor {j} holds {t.numel()} elements, but its block of "
                f"the global shape {global_shapes[j]} under spec "
                f"{specs[j]} on {dict(mesh.shape)} is {shape}")
    key = tuple((g, d, s) for g, d, s in zip(global_shapes, dtypes, syncs))
    if fusion_threshold is None:
        fusion_threshold = _config.fusion_threshold_bytes()
    buckets = _plan_cached(key, int(fusion_threshold))
    sizes = tuple(sum(int(math.prod(shapes[j])) for j in b)
                  for b in buckets)
    return ZeroPlan(
        buckets=buckets, sizes=sizes,
        padded=tuple(-(-n // nshards) * nshards for n in sizes),
        shapes=shapes, dtypes=dtypes, nshards=nshards,
        scatter_axis=scatter_axis,
        denoms=tuple(syncs[b[0]].denom for b in buckets),
        extra_axes=tuple(tuple(a for a in syncs[b[0]].psum
                               if a != scatter_axis) for b in buckets),
        shard_axes=tuple(syncs[b[0]].shard for b in buckets),
        nonscatter=tuple((a, int(axis_sizes[a])) for a in mesh.axis_names
                         if a != scatter_axis and a not in skip_axes),
        leaf_specs=tuple(specs), global_shapes=global_shapes)


@dataclasses.dataclass(frozen=True)
class ZeroGroups:
    """The process groups a hybrid plan's exchange runs over on one
    rank: ``scatter``, its slice along the scatter axis (None: the
    world); per bucket, ``extra[i]``, its slice along the bucket's extra
    axes (None where they span one rank); ``fold``, its slice along the
    non-scatter axes, which the guard's verdict folds over (None: one
    rank)."""

    scatter: Any = None
    extra: Tuple[Any, ...] = ()
    fold: Any = None


def zero_groups(plan: ZeroPlan, mesh=None) -> ZeroGroups:
    """The :class:`ZeroGroups` of ``plan`` on ``mesh`` (the world's for a
    1-D plan). Creates the groups the plan needs in plan order — the
    canonical form's too, each bucket's slice along the scatter axis and
    its shard axes (:func:`~..optimizer.zero_to_canonical`) —, which is
    collective: every rank must call it alike."""
    nb = len(plan.buckets)
    if not plan.hybrid or mesh is None:
        return ZeroGroups(extra=(None,) * nb)

    def sub(axes):
        return mesh.group(axes) if axes and mesh.subset_size(axes) > 1 \
            else None
    scatter = mesh.group((plan.scatter_axis,))
    extra = tuple(sub(plan.bucket_extra(i)) for i in range(nb))
    for i in range(nb):
        mesh.group((plan.scatter_axis,) + plan.bucket_shard_axes(i))
    return ZeroGroups(scatter=scatter, extra=extra,
                      fold=sub(tuple(a for a, _ in plan.nonscatter)))


def _fuse_bucket(members: Sequence[torch.Tensor], plan: ZeroPlan,
                 i: int) -> torch.Tensor:
    """Bucket ``i``'s ``members`` as one rank-padded flat vector (a
    copy)."""
    flat = _fuse([m.detach() for m in members])
    pad = plan.padded[i] - plan.sizes[i]
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def _scatter_bucket(flat: torch.Tensor, plan: ZeroPlan, i: int,
                    average: bool, prescale: Optional[float], wire, group,
                    async_op: bool = False, extra_group=None) -> _Handle:
    """Start bucket ``i``'s reduce-scatter of the padded ``flat`` over
    ``group``: the average's ``1/denom`` and ``prescale`` fold into one
    multiply before it; a scatter over one rank reduces nothing (no
    collective, no wire cast). ``extra_group`` (a hybrid plan's bucket
    replicated across non-scatter axes) sums the received shard over
    those axes once it lands: the cheap place for that sum, on 1/dp of
    the bucket."""
    denom = plan.bucket_denom(i)
    scale = _fold(1.0 / denom if average and denom > 1 else None, prescale)

    def finish(shard):
        if extra_group is not None:
            dist.all_reduce(shard, group=extra_group)
        return shard
    if plan.nshards == 1:
        shard = _prescale_array(flat, scale)
        return _Handle(None, lambda: finish(shard))
    if _wire_applies(flat.dtype, wire):
        shard = _wire_scatter(flat, wire, group, prescale=scale)
        return _Handle(None, lambda: finish(shard))
    x = _prescale_array(flat, scale)
    out = x.new_empty(plan.shard_len(i))
    work = dist.reduce_scatter_tensor(out, x, group=group, async_op=async_op)
    return _Handle(work, lambda: finish(out))


def _check_world(plan: ZeroPlan, group) -> None:
    n = _size(group)
    if n != plan.nshards:
        raise ValueError(
            f"the plan shards over {plan.nshards} rank(s) but this exchange "
            f"runs over {n} — build the plan after hvd.init(), over the "
            f"group the step runs over")


def fold_finite(finite: torch.Tensor, group) -> torch.Tensor:
    """``finite`` ANDed over ``group`` with one scalar MIN (unchanged for
    None): the hybrid plane's guard fold over its non-scatter axes,
    where a sharded bucket's NaN reaches one block's ranks only."""
    if group is None:
        return finite
    f = finite.to(torch.int32).reshape(1)
    dist.all_reduce(f, op=dist.ReduceOp.MIN, group=group)
    return f[0] > 0


def fused_reduce_scatter(tensors: Sequence[torch.Tensor], plan: ZeroPlan,
                         *, average: bool = True,
                         prescale: Optional[float] = None,
                         return_finite: bool = False, wire_dtype=None,
                         emit_order: Optional[Sequence[int]] = None,
                         group=None, groups: Optional[ZeroGroups] = None):
    """Reduce-scatter ``tensors`` into this rank's flat bucket shards
    (plan order): each bucket is flattened, zero-padded to ``padded[i]``,
    scaled once (the average's ``1/denom`` times ``prescale``) and fed to
    one ``reduce_scatter_tensor`` over ``group`` (the world when None) —
    the rank at scatter coordinate ``r`` receives the reduced
    ``flat[r·s:(r+1)·s]``. ``groups`` (a hybrid plan's
    :class:`ZeroGroups`) replaces ``group`` with its scatter group and
    adds each replicated bucket's sum over its extra axes.

    ``return_finite=True`` also returns the all-finite flag of the
    reduced shards, local to the scatter group's rank (a rank's NaN
    lands in one rank's shard only; on a hybrid mesh it is first folded
    over the non-scatter axes with one scalar MIN, the only collective
    the guard adds there); :func:`fused_allgather_params` ANDs it over
    the scatter group on the gather the updated shards already take
    (``and_finite=``). ``wire_dtype`` runs the scatter in reduced
    precision (:func:`_wire_scatter`). ``emit_order`` (a bucket
    permutation, :func:`zero_emit_order`) starts every bucket's scatter
    in that order before waiting on the first; membership and the
    returned order never change."""
    _refuse_sparse(tensors)
    if groups is not None:
        group = groups.scatter
    _check_world(plan, group)
    wire = resolve_wire_dtype(wire_dtype)
    nb = len(plan.buckets)
    order = tuple(range(nb)) if emit_order is None \
        else tuple(int(i) for i in emit_order)
    if sorted(order) != list(range(nb)):
        raise ValueError(f"emit_order must be a permutation of the {nb} "
                         f"bucket indices; got {order}")
    handles: dict = {}
    shards: List[Optional[torch.Tensor]] = [None] * nb
    for i in order:
        flat = _fuse_bucket([tensors[j] for j in plan.buckets[i]], plan, i)
        handles[i] = _scatter_bucket(
            flat, plan, i, average, prescale, wire, group,
            async_op=emit_order is not None,
            extra_group=None if groups is None else groups.extra[i])
        if emit_order is None:
            shards[i] = handles.pop(i).wait()
    for i in order:
        if i in handles:
            shards[i] = handles.pop(i).wait()
    if not return_finite:
        return shards
    dev = shards[0].device if shards else torch.device("cpu")
    finite = _all_finite(shards, dev)
    return shards, fold_finite(finite, None if groups is None
                               else groups.fold)


def shard_params(tensors: Sequence[torch.Tensor], plan: ZeroPlan,
                 rank: int, out: Optional[Sequence[torch.Tensor]] = None
                 ) -> List[torch.Tensor]:
    """This rank's flat bucket shards of ``tensors`` (no collective):
    ``flat[rank·s:(rank+1)·s]`` of each padded bucket, copied segment by
    segment from the members it overlaps (into ``out`` when given)."""
    shards = []
    for i, bucket in enumerate(plan.buckets):
        s = plan.shard_len(i)
        lo, hi = rank * s, (rank + 1) * s
        dst = out[i] if out is not None else \
            tensors[bucket[0]].new_empty(s)
        off = 0
        with torch.no_grad():
            for j in bucket:
                n = int(math.prod(plan.shapes[j]))
                a, b = max(lo, off), min(hi, off + n)
                if a < b:
                    dst[a - lo:b - lo].copy_(
                        tensors[j].detach().reshape(-1)[a - off:b - off])
                off += n
            if hi > plan.sizes[i]:
                dst[max(plan.sizes[i], lo) - lo:].zero_()
        shards.append(dst)
    return shards


def _unfuse_flat(flats: Sequence[torch.Tensor],
                 plan: ZeroPlan) -> List[torch.Tensor]:
    """The tensors (views) from per-bucket UNPADDED flat vectors."""
    out: List[Optional[torch.Tensor]] = [None] * len(plan.shapes)
    for i, bucket in enumerate(plan.buckets):
        off = 0
        for j in bucket:
            n = int(math.prod(plan.shapes[j]))
            out[j] = flats[i][off:off + n].view(plan.shapes[j])
            off += n
    return out


def fused_allgather_params(shards: Sequence[torch.Tensor], plan: ZeroPlan,
                           *, and_finite: Optional[torch.Tensor] = None,
                           group=None):
    """Every rank's flat bucket shards gathered back into the full
    tensors (views, plan order): one ``all_gather_into_tensor`` per
    bucket, padding stripped.

    ``and_finite`` (the rank-local flag of :func:`fused_reduce_scatter`)
    rides the same gather as one extra element of the first float
    bucket's shard, so every rank sees every rank's flag: returns
    ``(tensors, all_finite)`` with the world-wide verdict and no extra
    collective."""
    _check_world(plan, group)
    nb = len(plan.buckets)
    flag_bucket = None
    if and_finite is not None:
        flag_bucket = next((i for i in range(nb) if getattr(
            torch, plan.dtypes[plan.buckets[i][0]]).is_floating_point),
            None)
    flats, all_finite = [], None
    for i in range(nb):
        shard = shards[i].reshape(-1)
        if i == flag_bucket:
            shard = torch.cat([shard, and_finite.to(shard.dtype).reshape(1)])
        if plan.nshards > 1:
            gathered = shard.new_empty(plan.nshards * shard.numel())
            dist.all_gather_into_tensor(gathered, shard.contiguous(),
                                        group=group)
        else:
            gathered = shard
        if i == flag_bucket:
            s = plan.shard_len(i)
            blocks = gathered.view(plan.nshards, s + 1)
            # 1.0/0.0 flags, exact in every float dtype.
            all_finite = (blocks[:, -1].float() > 0.5).all()
            gathered = blocks[:, :s].reshape(-1)
        flats.append(gathered[:plan.sizes[i]])
    out = _unfuse_flat(flats, plan)
    if and_finite is None:
        return out
    # No float bucket: an all-integer tree is finite by construction.
    return out, (and_finite if all_finite is None else all_finite)


@functools.lru_cache(maxsize=512)
def _emit_order_cached(buckets, grad_order):
    pos = {leaf: p for p, leaf in enumerate(grad_order)}
    ready = [max(pos.get(j, j) for j in b) for b in buckets]
    return tuple(sorted(range(len(buckets)), key=lambda i: (ready[i], i)))


def emit_order(buckets: Sequence[Sequence[int]],
               grad_order: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """Emission order of fixed ``buckets`` under overlap: sorted by
    readiness (the latest backward-completion position among the
    bucket's members); plan order for no ``grad_order``. Membership
    never changes: the ZeRO plane's (:func:`zero_emit_order`) and the
    spec-grouped all-reduce plane's."""
    if grad_order is None:
        return tuple(range(len(buckets)))
    return _emit_order_cached(tuple(tuple(b) for b in buckets),
                              tuple(int(i) for i in grad_order))


def zero_emit_order(plan: ZeroPlan, grad_order: Optional[Sequence[int]]
                    ) -> Tuple[int, ...]:
    """Emission order of a :class:`ZeroPlan`'s buckets under overlap
    (:func:`emit_order` of its buckets)."""
    return emit_order(plan.buckets, grad_order)


# -- the hybrid plan's stacked layout, on the host ----------------------------
# The JAX package lays a hybrid bucket's optimizer state out as one global
# [nshards, ns·shard_len] array; the port's rank holds one row's block of
# it. These build and take apart that array from the GLOBAL leaves (the
# canonical checkpoint form) on numpy arrays or CPU tensors.

def _ns_coords(plan: ZeroPlan, i: int):
    """Non-scatter coordinates of bucket ``i``'s shard axes, row-major in
    the plan's (mesh) axis order: block ``[:, c·s:(c+1)·s]`` of the
    stacked array is coordinate ``c``'s dp stack."""
    axes = plan.bucket_shard_axes(i)
    sizes = dict(plan.nonscatter)
    for coord in itertools.product(*[range(int(sizes[a])) for a in axes]):
        yield dict(zip(axes, coord))


def ns_index(plan: ZeroPlan, i: int, coords) -> int:
    """The index ``c`` of the non-scatter coordinates ``coords`` (a mesh's
    ``coords``) among bucket ``i``'s :func:`_ns_coords`."""
    sizes = dict(plan.nonscatter)
    c = 0
    for a in plan.bucket_shard_axes(i):
        c = c * int(sizes[a]) + int(coords[a])
    return c


def _block_index(shape, spec, coord, axis_sizes):
    """The slice tuple of the block of a global array at non-scatter
    coordinate ``coord`` under ``spec``."""
    idx = []
    for d in range(len(shape)):
        s = spec[d] if spec is not None and d < len(spec) else None
        if s is None:
            idx.append(slice(None))
            continue
        a = s if isinstance(s, str) else tuple(s)[0]
        if a not in coord:
            idx.append(slice(None))
            continue
        w = shape[d] // int(axis_sizes[a])
        idx.append(slice(coord[a] * w, (coord[a] + 1) * w))
    return tuple(idx)


def _cat(parts):
    if torch.is_tensor(parts[0]):
        return torch.cat(parts)
    return np.concatenate(parts)


def zero_stack_global(leaves, plan: ZeroPlan, i: int):
    """Bucket ``i``'s stacked ``[nshards, ns·shard_len]`` array from
    GLOBAL leaves (numpy arrays or CPU tensors, indexed like the plan's
    tensors): for each non-scatter coordinate, the members' blocks
    flattened, rank-padded and stacked ``[nshards, shard_len]``, and the
    coordinates concatenated along the trailing dim. A 1-D plan gives
    the plain flatten-pad-stack."""
    axis_sizes = dict(plan.nonscatter)
    s = plan.shard_len(i)
    pad = plan.padded[i] - plan.sizes[i]
    cols = []
    for coord in (_ns_coords(plan, i) if plan.hybrid else ({},)):
        parts = []
        for j in plan.buckets[i]:
            arr = leaves[j]
            if plan.hybrid:
                arr = arr[_block_index(arr.shape, plan.leaf_specs[j],
                                       coord, axis_sizes)]
            parts.append(arr.reshape(-1))
        flat = _cat(parts) if len(parts) > 1 else parts[0]
        if pad:
            zeros = (flat.new_zeros(pad) if torch.is_tensor(flat)
                     else np.zeros((pad,), flat.dtype))
            flat = _cat([flat, zeros])
        cols.append(flat.reshape(plan.nshards, s))
    if len(cols) == 1:
        return cols[0]
    return (torch.cat(cols, 1) if torch.is_tensor(cols[0])
            else np.concatenate(cols, axis=1))


def zero_unstack_global(stacked, plan: ZeroPlan, i: int) -> list:
    """Inverse of :func:`zero_stack_global`: bucket ``i``'s GLOBAL leaves
    from its stacked ``[nshards, ns·shard_len]`` array."""
    axis_sizes = dict(plan.nonscatter)
    s = plan.shard_len(i)
    tensor = torch.is_tensor(stacked)
    if not tensor:
        stacked = np.asarray(stacked)
    shapes = [plan.global_shapes[j] if plan.hybrid else plan.shapes[j]
              for j in plan.buckets[i]]
    out = [stacked.new_zeros(g) if tensor else np.zeros(g, stacked.dtype)
           for g in shapes]
    for ci, coord in enumerate(_ns_coords(plan, i) if plan.hybrid
                               else ({},)):
        flat = stacked[:, ci * s:(ci + 1) * s].reshape(-1)[:plan.sizes[i]]
        off = 0
        for k, j in enumerate(plan.buckets[i]):
            n = int(math.prod(plan.shapes[j]))
            block = flat[off:off + n].reshape(plan.shapes[j])
            off += n
            if plan.hybrid:
                out[k][_block_index(out[k].shape, plan.leaf_specs[j],
                                    coord, axis_sizes)] = block
            else:
                out[k] = block
    return out

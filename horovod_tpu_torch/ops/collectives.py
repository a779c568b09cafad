"""Eager collectives over the world.

Port of the JAX package's ``ops/collectives.py`` eager surface on
``torch.distributed`` (NCCL on the GPU, gloo on the CPU): ``Op`` (:57),
``allreduce`` (:251), the variable-first-dim ``allgather`` (:291) and
``allgather_ragged`` (:308), ``broadcast`` (:354), ``alltoall`` (:376),
``reducescatter`` (:399), the async handles ``allreduce_async_``,
``allgather_async_``, ``broadcast_async_`` and ``synchronize``
(:431-490), ``broadcast_object`` and ``allgather_object`` (:492-549)
and ``grouped_allreduce`` (:550). Each call takes this rank's tensor,
leaves it as it is and returns a new one.

In a coordinated world (``runtime.World.coord``: more than one rank and
``HVD_COORD_ADDR``, which the launcher exports) the public eager calls go
through the host coordination plane, as the JAX package's
``_eager_dispatch`` (:185-199) sends them: each is matched across ranks
by its name (``name=``, else :func:`_auto_name`'s counter), validated
(a dtype, shape, root or op that differs between ranks raises
:class:`~..exceptions.FailedPreconditionError` on every rank instead of
hanging) and reduced at the rank-0 coordinator in rank order, or on the
client-to-client ring above ``HOROVOD_RING_THRESHOLD``; ``plane=``
(``"auto"``, ``"star"``, ``"ring"``) picks per call, and a world without
a coordinator refuses any plane but ``"auto"``. In a plain world the calls
run on the process group and are matched by call order. Either way the
gradient exchange (:mod:`.fusion`), the bulk parameter broadcasts and
:func:`reduce_` with a ``group`` stay on the process group.

Dtypes neither NCCL nor gloo reduces are reduced in a wider carrier
dtype chosen from a table (:data:`_CARRIERS`), never by catching a
failed collective: a bool SUM, AVERAGE or PRODUCT counts in int32 (the
JAX package's ``psum`` of a bool is an int32 count; AVERAGE then divides
into f32), a bool MIN or MAX runs in uint8 and comes back bool (AND,
OR); int16 runs in int32 and is cast back (the same wrapped result as
an int16 sum). Gathers and broadcasts move raw bytes, so they take
every dtype.
"""

from __future__ import annotations

import enum
import math
import pickle
import re
from typing import List, Optional, Sequence, Tuple

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

# dtype -> {op: (carrier dtype the reduce runs in, result dtype)} for the
# dtypes neither backend reduces itself (NCCL has no bool or int16; gloo's
# all_reduce refuses int16 with "Invalid scalar type").
_COUNT = (torch.int32, torch.int32)
_CARRIERS = {
    torch.bool: {Op.SUM: _COUNT, Op.AVERAGE: _COUNT, Op.PRODUCT: _COUNT,
                 Op.MIN: (torch.uint8, torch.bool),
                 Op.MAX: (torch.uint8, torch.bool)},
    torch.int16: {op: (torch.int32, torch.int16) for op in Op},
}

# The most dimensions a variable-first-dim gather exchanges shapes for.
_MAX_DIMS = 8


_name_counter = 0


def _auto_name(kind: str, name: Optional[str]) -> str:
    """The cross-rank matching key of an eager call: ``Horovod<kind>_``
    and the sanitized ``name``, or a per-process counter when there is
    none (every rank calls in the same order, so the counters agree)."""
    global _name_counter
    if name is None:
        _name_counter += 1
        name = f"tensor_{_name_counter}"
    return f"Horovod{kind}_" + re.sub(r"[^a-zA-Z0-9_]", "_", str(name))


def _coord(plane: str):
    """The world's coordination client, or None in a plain world (which
    refuses a ``plane`` other than ``"auto"``)."""
    coord = runtime.world().coord
    if coord is None and plane != "auto":
        raise ValueError(
            f"plane={plane!r} is a multi-process eager-plane knob (star vs "
            f"client-to-client ring); this world has no coordination plane")
    return coord


def _size(group) -> int:
    return runtime.size() if group is None else dist.get_world_size(group)


def _check_root(root_rank: int) -> None:
    if not 0 <= root_rank < runtime.size():
        raise ValueError(f"root_rank {root_rank} is out of range for world "
                         f"size {runtime.size()}")


def _resolve(average: bool, op: Optional[Op]) -> Op:
    return op if op is not None else (Op.AVERAGE if average else Op.SUM)


def _finish(tensor: torch.Tensor, op: Op, n: int,
            result_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """What follows a reduce: AVERAGE's true division by ``n`` (an
    integer sum averages into a float tensor) and the cast back from a
    carrier dtype."""
    if op is Op.AVERAGE:
        if tensor.is_floating_point():
            return tensor.div_(n)
        return tensor / n
    if result_dtype is not None and tensor.dtype != result_dtype:
        return tensor.to(result_dtype)
    return tensor


def _start_reduce(tensor: torch.Tensor, op: Op, group, async_op: bool):
    """Start the all-reduce of ``tensor`` (in place, or in a carrier copy
    for the dtypes of :data:`_CARRIERS`). Returns ``(work, buffer,
    result dtype)``; ``work`` is None when the call was synchronous."""
    carrier = _CARRIERS.get(tensor.dtype, {}).get(op)
    buf, result_dtype = tensor, None
    if carrier is not None:
        buf, result_dtype = tensor.to(carrier[0]), carrier[1]
    work = dist.all_reduce(buf, op=_REDUCE_OPS[op], group=group,
                           async_op=async_op)
    return work, buf, result_dtype


def reduce_(tensor: torch.Tensor, op: Op, group=None) -> torch.Tensor:
    """All-reduce a contiguous tensor over ``group`` (the world when
    None) and return the result: ``tensor`` itself, reduced in place,
    unless AVERAGE turns an integer sum into a float tensor or the dtype
    rides a carrier (:data:`_CARRIERS`). ``AVERAGE`` sums, then divides by
    the group's size (a true division, as the JAX package's ``pmean``)."""
    _, buf, result_dtype = _start_reduce(tensor, op, group, False)
    return _finish(buf, op, _size(group), result_dtype)


def _own_copy(tensor: torch.Tensor) -> torch.Tensor:
    return tensor.detach().clone(memory_format=torch.contiguous_format)


@runtime.maps_peer_failures
def allreduce(tensor, average: bool = True, name: Optional[str] = None,
              op: Optional[Op] = None, plane: str = "auto"):
    """Sum (or average, or ``op``) ``tensor`` across all ranks. An
    :class:`~.sparse.IndexedSlices` takes the sparse path (two
    allgathers, :func:`~.sparse.allreduce_indexed_slices`), which only
    SUM and AVERAGE compose with."""
    from .sparse import IndexedSlices, allreduce_indexed_slices
    resolved = _resolve(average, op)
    if isinstance(tensor, IndexedSlices):
        if resolved not in (Op.SUM, Op.AVERAGE):
            raise ValueError(
                f"op={resolved} is not supported for sparse (IndexedSlices) "
                "allreduce; the sliced form only composes under SUM/AVERAGE")
        return allreduce_indexed_slices(
            tensor, average=resolved is Op.AVERAGE, name=name)
    key = _auto_name("Allreduce", name)
    coord = _coord(plane)
    if coord is not None:
        return coord.collective("allreduce", tensor, key, op=resolved,
                                plane=plane)
    return reduce_(_own_copy(tensor), resolved)


def _gather_shapes(t: torch.Tensor) -> List[Tuple[int, ...]]:
    """Every rank's shape of ``t`` (one all-gather of a fixed-length
    int64 vector: the rank count, then the dims)."""
    if t.dim() > _MAX_DIMS:
        raise ValueError(f"allgather takes at most {_MAX_DIMS} dims; got "
                         f"shape {tuple(t.shape)}")
    desc = torch.zeros(1 + _MAX_DIMS, dtype=torch.int64, device=t.device)
    desc[0] = t.dim()
    if t.dim():
        desc[1:1 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    parts = [torch.empty_like(desc) for _ in range(runtime.size())]
    dist.all_gather(parts, desc)
    rows = torch.stack(parts).tolist()
    return [tuple(r[1:1 + r[0]]) for r in rows]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


class _Handle:
    """A collective in flight (``work`` None: already done): ``wait()``
    waits on its work, runs ``finish`` once and returns its result
    (:func:`synchronize`)."""

    def __init__(self, work, finish):
        self._work, self._finish, self._done = work, finish, False
        self._result = None

    def wait(self):
        if not self._done:
            if self._work is not None:
                self._work.wait()
            self._result = self._finish()
            self._done = True
        return self._result


def _allgather(tensor: torch.Tensor, async_op: bool):
    t = tensor.detach()
    if t.dim() == 0:
        t = t.reshape(1)
    shapes = _gather_shapes(t)
    trailing = {s[1:] for s in shapes}
    if len({len(s) for s in shapes}) != 1 or len(trailing) != 1:
        raise ValueError(
            f"Mismatched ALLGATHER tensor shapes: ranks may differ in the "
            f"first dimension only; got {shapes}")
    rowbytes = math.prod(t.shape[1:]) * t.element_size()
    counts = [s[0] for s in shapes]
    width = max(counts) * rowbytes
    raw = _bytes(t)
    if raw.numel() < width:
        raw = torch.cat([raw, raw.new_zeros(width - raw.numel())])
    out = raw.new_empty(runtime.size() * width)
    work = dist.all_gather_into_tensor(out, raw, async_op=async_op)

    def finish():
        blocks = out.view(runtime.size(), width)
        flat = torch.cat([blocks[r, :c * rowbytes]
                          for r, c in enumerate(counts)])
        return flat.view(t.dtype).reshape((sum(counts),) + t.shape[1:])
    return work, finish


def _rows(tensor: torch.Tensor) -> torch.Tensor:
    return tensor.reshape(1) if tensor.dim() == 0 else tensor


@runtime.maps_peer_failures
def allgather(tensor: torch.Tensor, name: Optional[str] = None,
              plane: str = "auto") -> torch.Tensor:
    """Concatenate each rank's tensor along dim 0, in rank order. Ranks
    may differ in the first dimension only (``MPI_Allgatherv``: the
    shapes are exchanged first, then every rank's rows padded to the
    longest); a 0-dim tensor gathers as one row."""
    key = _auto_name("Allgather", name)
    coord = _coord(plane)
    if coord is not None:
        return coord.collective("allgather", _rows(tensor), key,
                                plane=plane)
    _, finish = _allgather(tensor, False)
    return finish()


@runtime.maps_peer_failures
def allgather_ragged(tensor: torch.Tensor, valid_size: int, max_size: int,
                     name: Optional[str] = None):
    """Variable-first-dim allgather in fixed shapes: each rank holds
    ``tensor`` of at most ``max_size`` rows, of which the first
    ``valid_size`` are real. Returns ``(gathered, sizes)``: ``gathered``
    is ``[size · max_size, ...]`` with each rank's block zero past its
    ``valid_size``; ``sizes`` the per-rank valid sizes (int32)."""
    del name
    n = tensor.shape[0]
    if n > max_size:
        raise ValueError(
            f"Mismatched ALLGATHER tensor shapes: tensor has {n} rows but "
            f"max_size is {max_size}; allgather_ragged cannot truncate "
            f"(grow max_size or slice the input)")
    vs = int(valid_size)
    if not 0 <= vs <= max_size:
        raise ValueError(
            f"Mismatched ALLGATHER tensor shapes: valid_size {vs} is "
            f"outside [0, max_size={max_size}]")
    t = tensor.detach()
    block = t.new_zeros((max_size,) + tuple(t.shape[1:]))
    rows = min(vs, n)
    block[:rows] = t[:rows]
    parts = [torch.empty_like(block) for _ in range(runtime.size())]
    dist.all_gather(parts, block)
    size_t = torch.tensor([vs], dtype=torch.int32, device=t.device)
    sizes = [torch.empty_like(size_t) for _ in range(runtime.size())]
    dist.all_gather(sizes, size_t)
    return torch.cat(parts), torch.cat(sizes)


@runtime.maps_peer_failures
def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None,
              plane: str = "auto") -> torch.Tensor:
    """Every rank receives the root's tensor."""
    _check_root(root_rank)
    key = _auto_name("Broadcast", name)
    coord = _coord(plane)
    if coord is not None:
        return coord.collective("broadcast", tensor, key,
                                root_rank=root_rank, plane=plane)
    out = _own_copy(tensor)
    dist.broadcast(_bytes(out), src=root_rank)
    return out


@runtime.maps_peer_failures
def alltoall(tensor: torch.Tensor, split_axis: int = 0,
             concat_axis: int = 0, name: Optional[str] = None,
             plane: str = "auto") -> torch.Tensor:
    """All-to-all: dim 0 splits into ``size`` equal blocks, and rank
    ``r`` receives block ``r`` of every rank, concatenated in rank
    order."""
    if split_axis != 0 or concat_axis != 0:
        raise NotImplementedError(
            "eager alltoall supports split_axis=0/concat_axis=0; transpose "
            "first")
    key = _auto_name("Alltoall", name)
    coord = _coord(plane)
    if coord is not None:
        return coord.collective("alltoall", tensor, key, plane=plane)
    n = runtime.size()
    t = tensor.detach().contiguous()
    if t.dim() < 1 or t.shape[0] % n:
        raise ValueError(
            f"alltoall needs a first dimension divisible by the world size "
            f"{n}; got shape {tuple(t.shape)}")
    raw = t.reshape(n, -1).view(torch.uint8)
    out = torch.empty_like(raw)
    dist.all_to_all_single(out, raw)
    return out.view(t.dtype).reshape(t.shape)


@runtime.maps_peer_failures
def reducescatter(tensor: torch.Tensor, average: bool = False,
                  name: Optional[str] = None, op: Optional[Op] = None,
                  plane: str = "auto") -> torch.Tensor:
    """Reduce across ranks (SUM unless ``average`` or ``op``), then rank
    ``r`` keeps block ``r`` of the first dimension, which must divide by
    the world size."""
    resolved = _resolve(average, op)
    key = _auto_name("Reducescatter", name)
    coord = _coord(plane)
    if coord is not None:
        return coord.collective("reducescatter", tensor, key, op=resolved,
                                plane=plane)
    n = runtime.size()
    t = tensor.detach()
    if t.dim() < 1 or t.shape[0] % n:
        raise ValueError(
            f"reducescatter needs a first dimension divisible by the world "
            f"size {n}; got shape {tuple(t.shape)}")
    carrier = _CARRIERS.get(t.dtype, {}).get(resolved)
    src = t.to(carrier[0]) if carrier else t.contiguous()
    out = src.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=_REDUCE_OPS[resolved])
    return _finish(out, resolved, n, carrier[1] if carrier else None)


# -- async handles -------------------------------------------------------------
# A handle holds the collective's ``async_op=True`` work; synchronize()
# waits on it and returns the result. Handles may be redeemed in any
# order; on NCCL the wait makes the current stream wait for the
# collective. In a coordinated world the handle is the plane's
# CoordHandle: submits in flight together are fused by the coordinator.

@runtime.maps_peer_failures
def allreduce_async_(tensor: torch.Tensor, average: bool = True,
                     name: Optional[str] = None, op: Optional[Op] = None,
                     plane: str = "auto"):
    """Non-blocking :func:`allreduce`; returns a handle for
    :func:`synchronize`."""
    resolved = _resolve(average, op)
    key = _auto_name("Allreduce", name)
    coord = _coord(plane)
    if coord is not None:
        return coord.submit("allreduce", tensor, key, op=resolved,
                            plane=plane)
    work, buf, result_dtype = _start_reduce(_own_copy(tensor), resolved,
                                            None, True)
    n = runtime.size()
    return _Handle(work, lambda: _finish(buf, resolved, n, result_dtype))


@runtime.maps_peer_failures
def allgather_async_(tensor: torch.Tensor, name: Optional[str] = None,
                     plane: str = "auto"):
    """Non-blocking :func:`allgather` (the shape exchange runs before it
    returns; the data moves asynchronously); returns a handle."""
    key = _auto_name("Allgather", name)
    coord = _coord(plane)
    if coord is not None:
        return coord.submit("allgather", _rows(tensor), key, plane=plane)
    return _Handle(*_allgather(tensor, True))


@runtime.maps_peer_failures
def broadcast_async_(tensor: torch.Tensor, root_rank: int = 0,
                     name: Optional[str] = None, plane: str = "auto"):
    """Non-blocking :func:`broadcast`; returns a handle."""
    _check_root(root_rank)
    key = _auto_name("Broadcast", name)
    coord = _coord(plane)
    if coord is not None:
        return coord.submit("broadcast", tensor, key, root_rank=root_rank,
                            plane=plane)
    out = _own_copy(tensor)
    work = dist.broadcast(_bytes(out), src=root_rank, async_op=True)
    return _Handle(work, lambda: out)


@runtime.maps_peer_failures
def synchronize(handle):
    """Block until an async handle's collective completes; returns its
    result. Handles may be synchronized in any order."""
    return handle.wait()


# -- object collectives ---------------------------------------------------------
# Picklable host objects (resume epochs, config dicts, vocabularies) ride
# the collectives as uint8 payloads: on the world's device in a plain
# world, as host bytes through the coordinator in a coordinated one (the
# JAX package's two named rounds, ``.len`` then ``.bytes``).

def _payload(obj) -> torch.Tensor:
    return torch.frombuffer(bytearray(pickle.dumps(obj)),
                            dtype=torch.uint8).to(runtime.device())


@runtime.maps_peer_failures
def broadcast_object(obj=None, root_rank: int = 0,
                     name: Optional[str] = None):
    """Every rank receives the root's picklable object (other ranks may
    pass anything). Two broadcasts: the payload length, then the bytes;
    a world of one returns ``obj`` with no collective."""
    _check_root(root_rank)
    if runtime.size() == 1:
        return obj
    if runtime.world().coord is not None:
        return _coord_broadcast_object(obj, root_rank, name)
    dev = runtime.device()
    payload = _payload(obj) if runtime.rank() == root_rank else None
    length = torch.tensor([0 if payload is None else payload.numel()],
                          dtype=torch.int64, device=dev)
    dist.broadcast(length, src=root_rank)
    if payload is None:
        payload = torch.empty(int(length), dtype=torch.uint8, device=dev)
    dist.broadcast(payload, src=root_rank)
    return pickle.loads(payload.cpu().numpy().tobytes())


@runtime.maps_peer_failures
def allgather_object(obj, name: Optional[str] = None) -> list:
    """Every rank's picklable object, in rank order, on every rank (the
    ragged payloads ride the variable-first-dim :func:`allgather`)."""
    if runtime.size() == 1:
        return [obj]
    if runtime.world().coord is not None:
        return _coord_allgather_object(obj, name)
    payload = _payload(obj)
    lens = allgather(torch.tensor([payload.numel()], dtype=torch.int64,
                                  device=payload.device)).tolist()
    blob = allgather(payload).cpu().numpy().tobytes()
    out, off = [], 0
    for n in lens:
        out.append(pickle.loads(blob[off:off + n]))
        off += n
    return out


def _coord_broadcast_object(obj, root_rank: int, name: Optional[str]):
    base = _auto_name("BroadcastObject", name)
    payload = (torch.frombuffer(bytearray(pickle.dumps(obj)),
                                dtype=torch.uint8)
               if runtime.rank() == root_rank
               else torch.zeros(0, dtype=torch.uint8))
    n = broadcast(torch.tensor([payload.numel()], dtype=torch.int32),
                  root_rank=root_rank, name=base + ".len")
    length = int(n[0])
    buf = torch.zeros(length, dtype=torch.uint8)
    buf[:payload.numel()] = payload[:length]
    out = broadcast(buf, root_rank=root_rank, name=base + ".bytes")
    return pickle.loads(out.numpy().tobytes())


def _coord_allgather_object(obj, name: Optional[str]) -> list:
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                               dtype=torch.uint8).reshape(-1, 1)
    base = _auto_name("AllgatherObject", name)
    lens = allgather(torch.tensor([payload.shape[0]], dtype=torch.int32),
                     name=base + ".len")
    blob = allgather(payload, name=base + ".bytes").numpy().tobytes()
    out, off = [], 0
    for n in lens.tolist():
        out.append(pickle.loads(blob[off:off + n]))
        off += n
    return out


@runtime.maps_peer_failures
def grouped_allreduce(tensors: Sequence[torch.Tensor], average: bool = True,
                      name: Optional[str] = None,
                      fusion_threshold: Optional[int] = None
                      ) -> List[torch.Tensor]:
    """Allreduce a list of tensors as fused flat buckets
    (:func:`~.fusion.fused_allreduce`). In a coordinated world every
    tensor is submitted at once under ``<name>.<i>`` and the coordinator
    fuses the responses (its threshold is ``HOROVOD_FUSION_THRESHOLD``;
    ``fusion_threshold`` plans the process group's buckets only)."""
    from .fusion import fused_allreduce
    if runtime.world().coord is not None:
        base = _auto_name("GroupedAllreduce", name)
        handles = [allreduce_async_(t, average=average, name=f"{base}.{i}")
                   for i, t in enumerate(tensors)]
        return [synchronize(h) for h in handles]
    return fused_allreduce(tensors, average=average,
                           fusion_threshold=fusion_threshold)

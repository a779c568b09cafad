"""``DistributedOptimizer``, ZeRO-1, and the parameter/optimizer-state
broadcasts.

Port of the JAX package's ``optimizer.py``: ``DistributedOptimizer``
(:583-740) wraps any ``torch.optim.Optimizer``; its ``step()`` exchanges
the ``.grad`` of every parameter, bucket by bucket in the order of
``named_parameters``, and then runs the wrapped step. The exchange is the
fused all-reduce (:func:`.ops.fusion.fused_allreduce`, with its
``accum_steps`` prescale and ``wire_dtype``; ``allreduce_gradients``
:788 is the exchange alone) or, with ``zero=True``, ZeRO-1
(``partition_optimizer`` :275): a fused reduce-scatter, the wrapped
optimizer's update of this rank's flat shard of every bucket, and an
all-gather of the updated shards back into the parameters. With
``overlap=True`` each bucket's collective starts during the backward
(:class:`.ops.fusion.OverlapExchange`). On a mesh (``mesh=``,
``param_specs=``) the exchange runs each bucket over its own group: the
spec-grouped all-reduce, or the hybrid ZeRO plane over dp
(``partition_optimizer(mesh=)``). ``ZeroShardedState`` (:113),
``zero_to_canonical`` (:166) and ``zero_from_canonical`` (:205) move a
ZeRO state to and from its world- and mesh-agnostic form (2-D on a
hybrid mesh: the global leaves of each bucket). ``broadcast_parameters``
(the counterpart of ``broadcast_global_variables`` :877) sends rank 0's
parameters AND buffers (BatchNorm running statistics) to every rank;
``broadcast_optimizer_state`` (:895) does the same for the optimizer's
state and hyperparameters, and ``broadcast_global_variables`` (:877) for
a whole training state (params, buffers, optimizer state, step).
``Compression`` (:61) is the reference's gradient compression:
``Compression.bf16`` rides the bf16 wire format of the exchange.

Bucket order is the plan's contract: every rank must hand the same
parameters in the same order. A parameter whose ``.grad`` is None takes
part as zeros, so every rank runs the same plan.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import itertools
import math
from typing import (Any, Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch
import torch.distributed as dist

from . import runtime
from .ops.collectives import Op, broadcast_object
from .ops.fusion import (OverlapExchange, ZeroGroups, ZeroPlan, _all_finite,
                         _fold, _fuse, _fuse_bucket, _Handle,
                         _prescale_array, _reduce_bucket, _scatter_bucket,
                         _unfuse_buckets, emit_order, fold_finite,
                         fused_allgather_params, fused_allreduce,
                         fused_reduce_scatter, plan_buckets, plan_exchange,
                         plan_grad_sync, plan_schedule, plan_zero,
                         resolve_wire_dtype, shard_params, zero_groups)
from .ops.sparse import IndexedSlices, allreduce_indexed_slices
from .utils import config as _config

NamedParams = Sequence[Tuple[str, torch.nn.Parameter]]


class Compression:
    """Gradient compression for the exchange (the JAX package's
    ``Compression``, :61). ``Compression.bf16`` puts float gradients wider
    than 16 bits on the wire as bfloat16 and restores their dtype after;
    in this port it IS the bf16 wire format (``wire_dtype="bf16"``): the
    same bucket-level path, f32 scales and f32 results. On the all-reduce
    plane it cannot be combined with an explicit ``wire_dtype``; on the
    ZeRO plane it is accepted as the alias of ``wire_dtype="bf16"``, as
    in the JAX package."""

    class none:  # noqa: N801 — enum-style namespace
        @staticmethod
        def compress(t):
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t

    class bf16:  # noqa: N801
        @staticmethod
        def compress(t):
            if (torch.is_tensor(t) and t.is_floating_point()
                    and t.element_size() > 2):
                return t.to(torch.bfloat16), t.dtype
            return t, None

        @staticmethod
        def decompress(t, ctx):
            return t.to(ctx) if ctx is not None else t


def _wire_of(compression, wire_dtype, zero: bool):
    """The wire dtype of ``DistributedOptimizer(compression=,
    wire_dtype=)``, with the JAX package's rules (:642, :721)."""
    wire = resolve_wire_dtype(wire_dtype if wire_dtype is not None
                              else _config.wire_dtype_default())
    if compression is Compression.none:
        return wire
    if compression is not Compression.bf16:
        raise ValueError(
            f"unsupported compression {compression!r}: Compression.none "
            f"or Compression.bf16 (or wire_dtype='bf16'/'fp8')")
    if not zero and wire is not None:
        raise ValueError(
            "compression= and wire_dtype= both set: pick one (wire_dtype "
            "is the recommended form)")
    if wire is not None and wire != torch.bfloat16:
        raise ValueError(
            f"compression=Compression.bf16 (the bf16 wire alias) conflicts "
            f"with wire_dtype={wire_dtype!r} — set wire_dtype alone")
    return torch.bfloat16


_PROCESS_GROUP_REFUSAL = (
    "{0}= over a process_group: the JAX package has no process-group "
    "argument, and its route to {0} on part of the world is mesh= — pass "
    "DistributedOptimizer(mesh=, param_specs=, {0}=True), which runs "
    "each bucket over its own group of the mesh")


def _prescale_of(accum_steps: int) -> Optional[float]:
    return None if accum_steps <= 1 else 1.0 / accum_steps


@runtime.maps_peer_failures
def allreduce_gradients(params: Iterable[torch.nn.Parameter],
                        average: bool = True,
                        fusion_threshold: Optional[int] = None,
                        group=None, accum_steps: int = 1,
                        wire_dtype=None, return_finite: bool = False,
                        sparse_as_dense: bool = False,
                        grad_order: Optional[Sequence[int]] = None):
    """Replace each parameter's ``.grad`` with its average (or sum) over
    ``group`` (the world when None) through the fused bucket allreduce,
    in the order given. ``accum_steps > 1`` divides by the local
    microbatch count (the caller's ``.grad`` holds a SUM over that many
    backward passes) as a prescale fused into each bucket; ``wire_dtype``
    and ``grad_order`` pass through to :func:`~.ops.fusion.
    fused_allreduce`. A sparse COO gradient (``nn.Embedding(sparse=
    True)``) rides the two-allgather path of :class:`~.ops.sparse.
    IndexedSlices` and stays sparse, unless ``sparse_as_dense`` densifies
    it into the buckets. ``return_finite=True`` returns the world-wide
    all-finite flag (a 0-dim bool tensor) read from the reduced buckets;
    None otherwise."""
    params = list(params)
    prescale = _prescale_of(accum_steps)
    if sparse_as_dense:
        for p in params:
            if p.grad is not None and p.grad.is_sparse:
                p.grad = p.grad.to_dense()
    sparse = [i for i, p in enumerate(params)
              if p.grad is not None and p.grad.is_sparse]
    if sparse and group is not None:
        raise ValueError("sparse gradients are exchanged over the world "
                         "only; pass sparse_as_dense=True")
    dense = sorted(set(range(len(params))) - set(sparse))
    if grad_order is not None and sparse:
        to_dense = {i: k for k, i in enumerate(dense)}
        grad_order = [to_dense[i] for i in grad_order if i in to_dense]
    grads = [params[i].grad if params[i].grad is not None
             else torch.zeros_like(params[i]) for i in dense]
    out = fused_allreduce(
        grads, average=average, fusion_threshold=fusion_threshold,
        prescale=prescale, group=group, wire_dtype=wire_dtype,
        return_finite=return_finite, grad_order=grad_order)
    reduced, finite = out if return_finite else (out, None)
    with torch.no_grad():
        for i, g, r in zip(dense, grads, reduced):
            if params[i].grad is None:
                params[i].grad = r.clone()
            else:
                g.copy_(r)
    for i in sparse:
        s = IndexedSlices.from_sparse_coo(params[i].grad)
        if prescale is not None:
            s = IndexedSlices(s.values * prescale, s.indices, s.dense_shape)
        r = allreduce_indexed_slices(s, average=average)
        if return_finite:
            # The gathered slices carry every rank's raw values.
            finite = finite & torch.isfinite(r.values).all()
        params[i].grad = r.to_sparse_coo()
    return finite


# -- ZeRO-1: the wrapped optimizer over flat shards ------------------------------

# Optimizers whose update of element i reads only element i's gradient,
# state and parameter: the only ones that may run on flat bucket shards
# (per-tensor logic — norms, factored moments — would see shards instead).
_ELEMENTWISE = (torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW,
                torch.optim.Adamax, torch.optim.NAdam, torch.optim.RAdam,
                torch.optim.RMSprop, torch.optim.Adagrad,
                torch.optim.Adadelta, torch.optim.Rprop)


def _shard_optimizer(optimizer: torch.optim.Optimizer,
                     shards: List[torch.Tensor]) -> torch.optim.Optimizer:
    """``optimizer``'s class and hyperparameters, rebuilt over the flat
    shards. Refuses, eagerly, what cannot run elementwise on them."""
    cls = type(optimizer)
    if cls not in _ELEMENTWISE:
        raise ValueError(
            f"zero=True runs the wrapped optimizer on flat bucket shards, "
            f"which needs an elementwise update; {cls.__name__} is not one "
            f"of {[c.__name__ for c in _ELEMENTWISE]}")
    if len(optimizer.param_groups) != 1:
        raise ValueError(
            f"zero=True needs one parameter group (a flat bucket shard "
            f"mixes the parameters of every group, so per-group "
            f"hyperparameters cannot apply); got "
            f"{len(optimizer.param_groups)}")
    if optimizer.state:
        raise ValueError("zero=True rebuilds the wrapped optimizer over "
                         "flat shards: wrap it before its first step")
    hyper = {k: v for k, v in optimizer.param_groups[0].items()
             if k != "params"}
    accepted = inspect.signature(cls).parameters
    inner = cls(shards, **{k: v for k, v in hyper.items() if k in accepted})
    rebuilt = {k: v for k, v in inner.param_groups[0].items()
               if k != "params"}
    if rebuilt != hyper:
        raise ValueError(f"{cls.__name__} could not be rebuilt over the "
                         f"shards with the same hyperparameters: {hyper} "
                         f"became {rebuilt}")
    return inner


@dataclasses.dataclass
class ZeroShardedState:
    """A ZeRO optimizer's state: ``inner[i]`` is the wrapped optimizer's
    state of bucket ``i``'s flat shard (``{"exp_avg": [shard_len], ...,
    "step": scalar}``), ``plan`` the layout and ``mesh`` the mesh a
    hybrid plan shards over (None: the world). In the canonical form
    (:func:`zero_to_canonical`) every shard tensor is the bucket's whole
    flat vector instead — on a hybrid mesh the concatenation of its
    GLOBAL leaves —, the same at every world size and mesh shape of one
    set of axis names."""

    inner: List[Dict[str, Any]]
    plan: ZeroPlan
    mesh: Any = None


def _shard_keys(st: Mapping[str, Any], n: int) -> List[str]:
    return sorted(k for k, v in st.items()
                  if torch.is_tensor(v) and tuple(v.shape) == (n,))


def _zero_mesh(state: ZeroShardedState):
    """The mesh of a hybrid state with non-scatter axes (None where the
    1-D form applies: no such axis)."""
    if not state.plan.hybrid or not state.plan.nonscatter:
        return None
    if state.mesh is None:
        raise ValueError(
            "a hybrid ZeRO state with the non-scatter axes "
            f"{state.plan.nonscatter} needs its mesh (ZeroShardedState."
            f"mesh): take it from DistributedOptimizer.zero_state()")
    return state.mesh


def _canonical_2d(stacked: torch.Tensor, plan: ZeroPlan, i: int,
                  mesh) -> torch.Tensor:
    """The canonical vectors of bucket ``i`` (one row per state key)
    from this rank's ``stacked`` ``[keys, shard_len]``: one all-gather
    over the rank's slice along the scatter axis and the bucket's shard
    axes, the gathered blocks laid into the JAX stacked layout and taken
    apart into the global leaves (:func:`~.ops.fusion.
    zero_unstack_global`)."""
    from .ops.fusion import ns_index, zero_unstack_global
    s = plan.shard_len(i)
    key = mesh.key((plan.scatter_axis,) + plan.bucket_shard_axes(i))
    sizes = [mesh.shape[a] for a in key]
    n = math.prod(sizes)
    gathered = stacked[None]
    if n > 1:
        gathered = stacked.new_empty((n,) + tuple(stacked.shape))
        dist.all_gather_into_tensor(gathered.view(-1),
                                    stacked.contiguous().view(-1),
                                    group=mesh.group(key))
    gathered = gathered.cpu()
    if plan.bucket_ns(i) == 1:
        # Every shard axis has size 1: the rank's blocks are the global
        # leaves, so the dp rows in order are the canonical vector.
        return gathered.transpose(0, 1).reshape(stacked.shape[0], -1)[
            :, :plan.sizes[i]]
    out = []
    for k in range(stacked.shape[0]):
        full = gathered.new_zeros(plan.shard_shapes()[i])
        for idx, coord in enumerate(itertools.product(
                *(range(m) for m in sizes))):
            coords = dict(zip(key, coord))
            c = ns_index(plan, i, coords)
            full[coords[plan.scatter_axis], c * s:(c + 1) * s] = \
                gathered[idx, k]
        out.append(torch.cat([g.reshape(-1) for g in
                              zero_unstack_global(full, plan, i)]))
    return torch.stack(out)


@runtime.maps_peer_failures
def zero_to_canonical(state: ZeroShardedState,
                      group=None) -> ZeroShardedState:
    """The world-agnostic form of a ZeRO state: every shard tensor
    becomes the bucket's flat UNPADDED vector (on the CPU), byte for byte
    the JAX package's canonical form of the same plan and values; scalars
    (a step count) pass through. On a hybrid mesh that is the 2-D form:
    the concatenation of the bucket's GLOBAL leaves, the same at every
    (dp, tp) split of the mesh's axis names. One process per GPU holds
    only its own shard, so this all-gathers: one all-gather per bucket
    (its state tensors stacked) over ``group`` (the world) or, on a
    hybrid mesh, over the rank's slice along dp and the bucket's shard
    axes; every rank must call it."""
    plan = state.plan
    mesh = _zero_mesh(state)
    out = []
    for i, st in enumerate(state.inner):
        s = plan.shard_len(i)
        keys = _shard_keys(st, s)
        canon = {k: (v.detach().cpu().clone() if torch.is_tensor(v) else v)
                 for k, v in st.items() if k not in keys}
        if keys:
            stacked = torch.stack([st[k].detach() for k in keys])
            if mesh is not None:
                rows = _canonical_2d(stacked, plan, i, mesh)
                for k_i, k in enumerate(keys):
                    canon[k] = rows[k_i].clone()
                out.append(canon)
                continue
            gathered = stacked[None]
            if plan.nshards > 1:
                gathered = stacked.new_empty(
                    (plan.nshards,) + tuple(stacked.shape))
                dist.all_gather_into_tensor(gathered.view(-1),
                                            stacked.view(-1), group=group)
            for k_i, k in enumerate(keys):
                canon[k] = gathered[:, k_i].reshape(-1)[:plan.sizes[i]] \
                    .cpu().clone()
        out.append(canon)
    return ZeroShardedState(inner=out, plan=plan, mesh=state.mesh)


def zero_from_canonical(canonical: ZeroShardedState,
                        template: ZeroShardedState,
                        rank: Optional[int] = None) -> ZeroShardedState:
    """Re-shard a canonical ZeRO state onto ``template``'s plan and
    world: each flat vector is zero-padded to the template bucket's
    padded length and the shard at ``rank`` (this process's dp
    coordinate by default) sliced out (CPU tensors;
    :meth:`DistributedOptimizer.load_zero_state` places them). On a
    hybrid mesh the vector is split into the bucket's global leaves,
    stacked for the template's mesh (:func:`~.ops.fusion.
    zero_stack_global`) and this rank's block taken. A state saved at
    one world size or (dp, tp) split restores at another; the bucket
    plan (the model, ``HOROVOD_FUSION_THRESHOLD`` and the mesh's axis
    names) must be the saving run's."""
    from .ops.fusion import ns_index, zero_stack_global
    plan = template.plan
    mesh = _zero_mesh(template)
    if rank is None:
        rank = (template.mesh.coords[plan.scatter_axis]
                if plan.hybrid and template.mesh is not None
                else runtime.rank())
    if len(canonical.inner) != len(plan.buckets):
        raise ValueError(
            f"ZeRO state mismatch: the checkpoint has "
            f"{len(canonical.inner)} buckets, this world's plan "
            f"{len(plan.buckets)} — HOROVOD_FUSION_THRESHOLD, the model "
            f"and the mesh AXIS NAMES must match the saving run")
    sizes = plan.canonical_sizes()
    out = []
    for i, st in enumerate(canonical.inner):
        s, size = plan.shard_len(i), sizes[i]
        shard = {}
        for k, v in st.items():
            if not torch.is_tensor(v) or v.dim() == 0:
                shard[k] = v
                continue
            flat = torch.as_tensor(v).reshape(-1)
            if flat.numel() != size:
                raise ValueError(
                    f"ZeRO shard length mismatch: checkpoint leaf {k!r} of "
                    f"bucket {i} has {flat.numel()} elements, this world's "
                    f"bucket expects {size} — the fusion bucket plan "
                    f"differs (HOROVOD_FUSION_THRESHOLD, the model and the "
                    f"mesh AXIS NAMES must match the saving run; dp/tp "
                    f"size reshapes are fine)")
            if mesh is not None and plan.bucket_ns(i) > 1:
                leaves: List[Optional[torch.Tensor]] = [None] * len(
                    plan.shapes)
                off = 0
                for j in plan.buckets[i]:
                    n = int(math.prod(plan.global_shapes[j]))
                    leaves[j] = flat[off:off + n].reshape(
                        plan.global_shapes[j])
                    off += n
                c = ns_index(plan, i, mesh.coords)
                shard[k] = zero_stack_global(leaves, plan, i)[
                    rank, c * s:(c + 1) * s].clone()
                continue
            pad = plan.padded[i] - size
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            shard[k] = flat[rank * s:(rank + 1) * s].clone()
        out.append(shard)
    return ZeroShardedState(inner=out, plan=plan, mesh=template.mesh)


class _ZeroUpdate:
    """The update half of ZeRO-1: the wrapped optimizer over this rank's
    flat shard of every bucket (``shards``, in the bucket's dtype), which
    it refreshes from the parameters before each update, and the
    all-gather of the updated shards back into the parameters."""

    def __init__(self, optimizer, params: List[torch.Tensor], plan: ZeroPlan,
                 rank: int, groups: ZeroGroups, mesh=None):
        self.params, self.plan, self.rank = params, plan, rank
        self.groups, self.mesh = groups, mesh
        self.shards = shard_params(params, plan, rank)
        self.inner = _shard_optimizer(optimizer, self.shards)

    def _snapshot(self) -> Dict:
        return {id(p): {k: v.clone() if torch.is_tensor(v) else v
                        for k, v in self.inner.state[p].items()}
                for p in self.shards if p in self.inner.state}

    def _restore(self, saved: Dict) -> None:
        for p in self.shards:
            if id(p) in saved:
                self.inner.state[p] = saved[id(p)]
            else:
                self.inner.state.pop(p, None)

    def update(self, shard_grads: Sequence[torch.Tensor],
               local_finite: Optional[torch.Tensor] = None):
        """One update from the reduced shard gradients. With
        ``local_finite`` (the guard): the world-wide verdict rides the
        gather (:func:`~.ops.fusion.fused_allgather_params`), is read on
        the host once, and a non-finite step puts the shards' optimizer
        state back (a snapshot taken only while the guard is armed) and
        leaves the parameters untouched. Returns the verdict or None."""
        shard_params(self.params, self.plan, self.rank, out=self.shards)
        saved = self._snapshot() if local_finite is not None else None
        for p, g in zip(self.shards, shard_grads):
            p.grad = g.reshape(-1)
        self.inner.step()
        for p in self.shards:
            p.grad = None
        out = fused_allgather_params(self.shards, self.plan,
                                     and_finite=local_finite,
                                     group=self.groups.scatter)
        leaves, finite = out if local_finite is not None else (out, None)
        if finite is not None and not bool(finite):   # one host read
            self._restore(saved)
            return finite, False
        with torch.no_grad():
            for p, v in zip(self.params, leaves):
                p.copy_(v.view(p.shape))
        return finite, True

    def state(self) -> ZeroShardedState:
        return ZeroShardedState(
            inner=[dict(self.inner.state.get(p, {})) for p in self.shards],
            plan=self.plan, mesh=self.mesh)

    def load(self, state: ZeroShardedState) -> None:
        if state.plan.buckets != self.plan.buckets \
                or state.plan.sizes != self.plan.sizes:
            raise ValueError("ZeRO state mismatch: its bucket plan is not "
                             "this optimizer's")
        group = self.inner.param_groups[0]
        on_device = group.get("capturable") or group.get("fused")
        for p, st in zip(self.shards, state.inner):
            new = {}
            for k, v in st.items():
                if torch.is_tensor(v) and v.dim() == 1:
                    if v.numel() != p.numel():
                        raise ValueError(
                            f"ZeRO state mismatch: {k!r} holds {v.numel()} "
                            f"elements, this rank's shard {p.numel()}")
                    v = v.to(device=p.device, dtype=p.dtype)
                elif torch.is_tensor(v):
                    v = v.to(p.device if on_device else "cpu")
                new[k] = v
            self.inner.state[p] = new


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
    f32 scales and f32 results; ``compression=Compression.bf16`` is the
    same bf16 wire (:class:`Compression`). ``sparse_as_dense`` densifies sparse COO
    gradients into the buckets; without it they ride the two-allgather
    sparse path (the all-reduce plane only).

    ``zero=True`` is ZeRO-1 (``partition_optimizer`` in the JAX
    package): the wrapped optimizer is rebuilt, with its class and
    hyperparameters, over this rank's flat f32 shard of every bucket
    (:func:`~.ops.fusion.plan_zero`), so its state holds ``Σ shard_len``
    elements per state tensor; ``step()`` reduce-scatters the gradients,
    updates the shards and all-gathers them into the parameters, which
    end bit-identical on every rank. Only an elementwise optimizer with
    one parameter group and no state yet can be rebuilt so (refused
    eagerly otherwise). With ``mesh=`` and ``param_specs=`` it is the
    hybrid plane (the JAX package's ``partition_optimizer(mesh=)``): the
    plan is made on the parameters' GLOBAL shapes (``global_shapes``,
    default: each block's sharded dimensions times their axis sizes),
    the state shards over the mesh's ``dp`` axis — the shard count is
    its size and this rank's shard is at its dp coordinate — for
    sharded and replicated leaves alike, every other axis not in
    ``skip_axes`` is a non-scatter axis, each bucket is reduce-scattered
    over the rank's dp group with its ``1/denom`` prescaled in, a
    bucket replicated across non-scatter axes is summed over them on its
    shard, and the updated shards are all-gathered over dp. A rank of a
    tp-sharded bucket holds 1/(dp·tp) of its global state, a rank of a
    replicated one 1/dp. The guard's verdict is folded over the
    non-scatter axes with one scalar MIN, then rides the dp all-gather.

    ``mesh=`` and ``param_specs=`` without ``zero`` are the spec-grouped
    all-reduce plane (the JAX package's ``_grouped_allreduce``): each
    parameter's gradient sync is its :class:`~.ops.fusion.GradSync`
    (:func:`~.ops.fusion.plan_grad_sync` of its spec over the mesh,
    minus ``skip_axes``), leaves fuse only within a group, and each
    bucket runs one sum all-reduce over its group's process group
    (:meth:`~.parallel.mesh.Mesh.group`), prescaled by ``1/denom`` (with
    ``accum_steps``' ``1/N`` and ``wire_dtype`` as on the world plane).
    The groups are created at construction, in plan order, so every
    rank must build the optimizer alike. A bucket reduced over less than
    the reduce set (the mesh's axes minus ``skip_axes``; the world when
    nothing is skipped) leaves its all-finite flag local to its group:
    the guard's verdict is then folded over the reduce set with one
    scalar MIN, the only collective the guard adds (a caller that skips
    an axis folds over it itself, as the pipelined step does over pp).

    ``process_group`` averages over one group instead of the world, on
    the all-reduce plane only: the JAX package has no such argument, and
    its route to ZeRO or overlap on part of the world is ``mesh=``.

    ``overlap`` (default ``HVD_OVERLAP``) starts each bucket's collective
    during the backward, when its last gradient lands, once the step has
    :meth:`arm`-ed it. The first armed backward emits in flatten order
    and records the order gradients land in; rank 0's record is broadcast
    once over the world (``grad_order``, ``grad_order_source``), so every
    group sees the same order, and from then on the world all-reduce
    plane groups its buckets along it while the ZeRO and spec-grouped
    planes keep their plan's buckets and emit them in readiness order,
    each on its own group. On those two planes a step that never arms
    (the pipelined one, whose gradients come out of its schedule whole)
    starts every bucket in plan order before waiting on the first: the
    same collectives, bitwise the same result.

    Every other attribute — ``param_groups``, ``state``, ``state_dict``
    … — is the wrapped optimizer's (with ``zero=True``, the one over the
    shards: :meth:`zero_state` and :func:`zero_to_canonical` give its
    state in bucket form)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[NamedParams] = None,
                 average: bool = True,
                 fusion_threshold: Optional[int] = None,
                 process_group=None, accum_steps: int = 1,
                 wire_dtype=None, *, zero: bool = False,
                 overlap: Optional[bool] = None,
                 sparse_as_dense: bool = False, mesh=None,
                 param_specs=None, compression=Compression.none,
                 skip_axes: Tuple[str, ...] = (), global_shapes=None):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if mesh is not None:
            if param_specs is None:
                raise ValueError(
                    "DistributedOptimizer(mesh=...) requires param_specs= — "
                    "the spec tree keys the per-leaf collective plan")
            if not average:
                raise ValueError(
                    "the spec-grouped plane defines averaging semantics via "
                    "per-group denominators — average=False has no meaning "
                    "there")
            if sparse_as_dense:
                raise ValueError("the spec-grouped (mesh=) plane supports "
                                 "dense gradients only")
            if process_group is not None:
                raise ValueError("mesh= and process_group= both set: the "
                                 "mesh's plan picks each bucket's group")
        if process_group is not None and zero:
            raise ValueError(_PROCESS_GROUP_REFUSAL.format("zero"))
        self.average = average
        self.fusion_threshold = fusion_threshold
        # The 1-D world's view of the gradient plan (the JAX package's
        # ``update_fn.exchange_plan`` stamp): the same buckets and
        # denominators a host-plane executor would read.
        self.exchange_plan = functools.partial(
            plan_exchange, fusion_threshold=fusion_threshold)
        self.process_group = process_group
        self.accum_steps = accum_steps
        self.sparse_as_dense = sparse_as_dense
        self.compression = compression
        self.wire_dtype = _wire_of(compression, wire_dtype, bool(zero))
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
        self._params = [p for _, p in named_parameters]
        self.zero = bool(zero)
        self._zero = None
        self.mesh = mesh
        self.param_specs = None if param_specs is None else list(param_specs)
        self._grouped = None
        if mesh is not None and len(self.param_specs) != len(self._params):
            raise ValueError(
                f"param_specs has {len(self.param_specs)} specs for "
                f"{len(self._params)} parameters — they must mirror "
                f"named_parameters")
        if mesh is not None and not self.zero:
            self._grouped = _GroupedPlan(self._params, self.param_specs,
                                         mesh, fusion_threshold, skip_axes)
        if self.zero:
            nshards = runtime.size() if mesh is None else int(
                mesh.shape.get("dp", 1))
            plan = plan_zero(self._params, nshards, fusion_threshold,
                             specs=param_specs, mesh=mesh,
                             skip_axes=skip_axes,
                             global_shapes=global_shapes)
            rank = runtime.rank() if mesh is None \
                else mesh.coords[plan.scatter_axis]
            self._zero = _ZeroUpdate(optimizer, self._params, plan, rank,
                                     zero_groups(plan, mesh), mesh)
            optimizer = self._zero.inner
        self.optimizer = optimizer
        self.overlap = False
        self._overlap: Optional[OverlapExchange] = None
        self.grad_order: Optional[Tuple[int, ...]] = None
        self.grad_order_source: Optional[str] = None
        if overlap is None:
            overlap = _config.overlap_enabled()
        if overlap:
            self.enable_overlap()

    @property
    def plan(self) -> Optional[ZeroPlan]:
        """The ZeRO bucket plan (None on the all-reduce plane)."""
        return self._zero.plan if self._zero is not None else None

    @property
    def _op(self) -> Op:
        return Op.AVERAGE if self.average else Op.SUM

    # -- backward-overlapped emission ------------------------------------

    def enable_overlap(self) -> None:
        """Register the per-parameter hooks of the overlapped exchange
        (idempotent); the step then :meth:`arm`-s it backward by
        backward."""
        if self._overlap is not None:
            return
        if self.process_group is not None:
            raise ValueError(_PROCESS_GROUP_REFUSAL.format("overlap"))
        if self._grouped is not None:
            buckets = self._grouped.buckets
            start = self._grouped.start_fn(self)
        elif self.zero:
            buckets = self.plan.buckets
            start = self._start_scatter
        else:
            buckets = plan_schedule(self._params, None,
                                    self.fusion_threshold).buckets
            start = self._start_reduce
        self._overlap = OverlapExchange(self._params, start, self._grad_of,
                                        buckets, range(len(buckets)))
        self.overlap = True

    def arm(self, prescale: Optional[float] = None) -> None:
        """Emit the buckets of the next backward as they complete, each
        scaled by ``prescale`` (in-step accumulation's ``1/N``, folded
        into the bucket's prescale). A no-op without overlap."""
        if self._overlap is not None:
            self._overlap.arm(prescale)

    def _grad_of(self, p: torch.Tensor) -> torch.Tensor:
        g = p.grad
        if g is None:
            return torch.zeros_like(p)
        if g.is_sparse:
            if not self.sparse_as_dense:
                raise ValueError(
                    "a sparse gradient cannot ride the fused buckets of "
                    "zero=True or overlap=True: pass sparse_as_dense=True")
            return g.to_dense()
        return g

    def _start_reduce(self, b: int, members, prescale):
        return _reduce_bucket(
            members, self._op,
            _fold(prescale, _prescale_of(self.accum_steps)),
            self.wire_dtype, None, async_op=True)

    def _start_scatter(self, b: int, members, prescale):
        groups = self._zero.groups
        return _scatter_bucket(
            _fuse_bucket(members, self.plan, b), self.plan, b, self.average,
            _fold(prescale, _prescale_of(self.accum_steps)),
            self.wire_dtype, groups.scatter, async_op=True,
            extra_group=groups.extra[b])

    def _collect(self):
        """``(flat results in plan order, the buckets)`` of an armed
        overlapped backward, or None when none is armed. The first one
        also plans the schedule along rank 0's landing order."""
        if self._overlap is None or not self._overlap.armed:
            return None
        buckets = self._overlap.buckets
        flats = self._overlap.collect()
        if self.grad_order_source is None:
            self._plan_probed()
        return flats, buckets

    def _plan_probed(self) -> None:
        order = self._overlap.landing_order()
        if runtime.size() > 1:
            order = broadcast_object(order, root_rank=0)
        self.grad_order = order
        self.grad_order_source = "flatten" if order is None else "probed"
        if order is None:
            return
        if self.zero or self._grouped is not None:
            # Membership is the plan's: only the emission order follows
            # the landing order.
            buckets = self._overlap.buckets
            self._overlap.set_schedule(buckets, emit_order(buckets, order))
        else:
            buckets = plan_schedule(self._params, order,
                                    self.fusion_threshold).buckets
            self._overlap.set_schedule(buckets, range(len(buckets)))

    # -- the exchange and the update -------------------------------------

    def _exchange(self, return_finite: bool):
        """The all-reduce plane's exchange: reduced gradients in
        ``.grad``; the world-wide all-finite flag or None."""
        if self._grouped is not None:
            return self._grouped.exchange(self, return_finite)
        got = self._collect()
        if got is None:
            order = self.grad_order if self.overlap else None
            return allreduce_gradients(
                self._params, average=self.average,
                fusion_threshold=self.fusion_threshold,
                group=self.process_group, accum_steps=self.accum_steps,
                wire_dtype=self.wire_dtype, return_finite=return_finite,
                sparse_as_dense=self.sparse_as_dense, grad_order=order)
        flats, buckets = got
        reduced = _unfuse_buckets(flats, buckets, self._params)
        with torch.no_grad():
            for p, r in zip(self._params, reduced):
                p.grad = r
        if not return_finite:
            return None
        return _all_finite(flats, self._params[0].device)

    def _scatter(self, return_finite: bool):
        """The ZeRO plane's reduce-scatter: this rank's reduced shard of
        every bucket, and its rank-local all-finite flag (or None)."""
        got = self._collect()
        groups = self._zero.groups
        if got is None:
            emit = emit_order(self.plan.buckets, self.grad_order) \
                if self.overlap else None
            out = fused_reduce_scatter(
                [self._grad_of(p) for p in self._params], self.plan,
                average=self.average,
                prescale=_prescale_of(self.accum_steps),
                return_finite=return_finite, wire_dtype=self.wire_dtype,
                emit_order=emit, groups=groups)
            return out if return_finite else (out, None)
        shards, _ = got
        if not return_finite:
            return shards, None
        return shards, fold_finite(_all_finite(shards, shards[0].device),
                                   groups.fold)

    @runtime.maps_peer_failures
    def synchronize(self, return_finite: bool = False):
        """The gradient exchange alone: every ``.grad`` becomes the world
        average. On the ZeRO plane that is the step's reduce-scatter and
        an all-gather of the reduced shards. With ``return_finite`` it
        returns the world-wide all-finite flag of the reduced gradients
        (no extra collective)."""
        if not self.zero:
            return self._exchange(return_finite)
        shards, local = self._scatter(return_finite)
        out = fused_allgather_params(shards, self.plan, and_finite=local,
                                     group=self._zero.groups.scatter)
        grads, finite = out if return_finite else (out, None)
        with torch.no_grad():
            for p, g in zip(self._params, grads):
                p.grad = g.reshape(p.shape).clone()
        return finite

    @runtime.maps_peer_failures
    def step(self, closure=None):
        if not self.zero:
            self.synchronize()
            return self.optimizer.step(closure)
        if closure is not None:
            raise ValueError("zero=True takes no closure: the update runs "
                             "on flat shards, not on the parameters")
        shards, _ = self._scatter(False)
        self._zero.update(shards)
        return None

    def guarded_step(self) -> Tuple[torch.Tensor, bool]:
        """The step of the bad-step guard: exchange, and update only if
        every rank's gradients are finite (one host read of the flag).
        On the ZeRO plane the update of the shards runs first and is
        undone when the verdict, which rides the all-gather, is False.
        Returns the world-wide flag (a 0-dim bool tensor) and whether the
        update was applied."""
        if not self.zero:
            finite = self.synchronize(return_finite=True)
            applied = bool(finite)      # the guard's one host read
            if applied:
                self.optimizer.step()
            return finite, applied
        shards, local = self._scatter(True)
        return self._zero.update(shards, local)

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Clear the gradients. A backward armed for overlap whose
        exchange never ran leaves collectives in flight: they are waited
        on and dropped here, so no work is left pending."""
        if self._overlap is not None:
            self._overlap.drain()
        self.optimizer.zero_grad(set_to_none=set_to_none)
        if self.zero:
            for p in self._params:
                if set_to_none:
                    p.grad = None
                elif p.grad is not None:
                    p.grad.zero_()

    # -- ZeRO state ---------------------------------------------------------

    def zero_state(self) -> ZeroShardedState:
        """This rank's ZeRO state (references to the live tensors)."""
        if self._zero is None:
            raise ValueError("zero_state() needs zero=True")
        return self._zero.state()

    def load_zero_state(self, state: ZeroShardedState) -> None:
        """Load a rank's ZeRO state (:func:`zero_from_canonical`)."""
        if self._zero is None:
            raise ValueError("load_zero_state() needs zero=True")
        self._zero.load(state)

    def __getattr__(self, name):
        # Only reached for attributes this wrapper does not define.
        return getattr(self.__dict__["optimizer"], name)


class _GroupedPlan:
    """The spec-grouped all-reduce plane's plan: per parameter its
    :class:`~.ops.fusion.GradSync`, the buckets (fused within a sync
    group, in parameter order) and each bucket's process group (None
    where the sync sums over no axis)."""

    def __init__(self, params, specs, mesh, fusion_threshold, skip_axes):
        self.syncs = plan_grad_sync(specs, mesh, skip_axes=skip_axes)
        self.buckets = plan_buckets(params, fusion_threshold,
                                    groups=self.syncs)
        self.groups = []
        reduce_set = tuple(a for a in mesh.axis_names if a not in skip_axes)
        partial = False
        for b in self.buckets:
            axes = self.syncs[b[0]].psum
            self.groups.append(mesh.group(axes) if axes else None)
            partial = partial or axes != reduce_set
        # The group the guard's verdict folds over (None: the flags of
        # the reduced buckets already agree across the reduce set).
        self.fold_group = None
        if partial and mesh.subset_size(reduce_set) > 1:
            self.fold_group = mesh.group(reduce_set)

    def start(self, opt, b: int, members, prescale=None):
        """Start bucket ``b``'s sum over its group (asynchronously; the
        wire format runs synchronously) with its ``1/denom``, the
        optimizer's ``1/accum_steps`` and ``prescale`` folded into one
        prescale. A bucket that sums over no axis is scaled in place of
        its collective."""
        group = self.groups[b]
        denom = self.syncs[self.buckets[b][0]].denom
        scale = _fold(1.0 / denom if denom > 1 else None,
                      _prescale_of(opt.accum_steps), prescale)
        if group is None:
            flat = _prescale_array(_fuse([m.detach() for m in members]),
                                   scale)
            return _Handle(None, lambda: flat)
        return _reduce_bucket(members, Op.SUM, scale, opt.wire_dtype, group,
                              async_op=True)

    def start_fn(self, opt):
        """The overlapped exchange's ``start`` for this plan."""
        return lambda b, members, prescale: self.start(opt, b, members,
                                                       prescale)

    def exchange(self, opt, return_finite: bool):
        """Sum each bucket over its group with its ``1/denom`` (and the
        optimizer's ``1/accum_steps``) prescaled in; the reduced
        gradients land in ``.grad``. An armed overlapped backward has
        started the buckets already; with overlap and no armed backward
        every bucket is started, in the schedule's order, before the
        first is waited on. Returns the world-wide all-finite flag
        (folded with one scalar MIN when a bucket summed over less than
        the reduce set), or None."""
        params = opt._params
        got = opt._collect()
        if got is not None:
            flats = got[0]
        else:
            order = emit_order(self.buckets, opt.grad_order) \
                if opt.overlap else range(len(self.buckets))
            flats = [None] * len(self.buckets)
            handles = {}
            for b in order:
                handles[b] = self.start(
                    opt, b, [opt._grad_of(params[j]) for j in self.buckets[b]])
                if not opt.overlap:
                    flats[b] = handles.pop(b).wait()
            for b in order:
                if b in handles:
                    flats[b] = handles.pop(b).wait()
        reduced = _unfuse_buckets(flats, self.buckets, params)
        with torch.no_grad():
            # Into the gradients' own storage, as the world plane does:
            # the flat buckets are freed here, not held to the next step.
            for p, r in zip(params, reduced):
                if p.grad is None or p.grad.is_sparse:
                    p.grad = r.clone()
                else:
                    p.grad.copy_(r)
        finite = None
        if return_finite:
            finite = _all_finite(flats, params[0].device)
        del flats, reduced
        if finite is None:
            return None
        return fold_finite(finite, self.fold_group)


def partition_optimizer(optimizer: torch.optim.Optimizer,
                        named_parameters: Optional[NamedParams] = None,
                        **kwargs) -> DistributedOptimizer:
    """ZeRO-1 sharded updates of ``optimizer`` (the JAX package's
    ``partition_optimizer``): ``DistributedOptimizer(optimizer,
    named_parameters, zero=True, **kwargs)``."""
    return DistributedOptimizer(optimizer, named_parameters, zero=True,
                                **kwargs)


def _tensors_of(params) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if isinstance(params, Mapping):
        return list(params.items())
    return [(str(n), t) for n, t in params]


@runtime.maps_peer_failures
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


@runtime.maps_peer_failures
def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Give every rank ``root_rank``'s optimizer state (per-parameter
    tensors such as momentum buffers, and the hyperparameters of each
    group). A rank that has no state yet for a parameter gets it."""
    if getattr(optimizer, "zero", False):
        raise ValueError(
            "a ZeRO optimizer's state is rank-sharded: each rank holds its "
            "own shard, so there is nothing to broadcast — move it with "
            "zero_to_canonical / zero_from_canonical")
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


@runtime.maps_peer_failures
def broadcast_global_variables(variables, root_rank: int = 0):
    """Give every rank ``root_rank``'s training state, in place, and
    return it (the JAX package's ``broadcast_global_variables``, :877;
    the reference's ``hvd.broadcast_global_variables``, used right after
    initialization or a checkpoint restore).

    ``variables`` is a training state — an object with ``model`` (or a
    ``params`` mapping), ``optimizer`` and ``step``, whose parameters and
    buffers (BatchNorm statistics), optimizer state and hyperparameters
    and step are broadcast — or a module, state dict or ``(name, tensor)``
    pairs (:func:`broadcast_parameters`). A ZeRO optimizer's state is
    rank-sharded by design: only its hyperparameters are broadcast."""
    model = getattr(variables, "model", None)
    params = getattr(variables, "params", None) if model is None else model
    opt = getattr(variables, "optimizer", None)
    if params is None and opt is None:
        broadcast_parameters(variables, root_rank)
        return variables
    if params is not None:
        broadcast_parameters(params, root_rank)
    if opt is not None:
        if getattr(opt, "zero", False):
            groups = broadcast_object(
                [{k: v for k, v in g.items() if k != "params"}
                 for g in opt.param_groups], root_rank=root_rank)
            for g, hyper in zip(opt.param_groups, groups):
                g.update(hyper)
        else:
            broadcast_optimizer_state(opt, root_rank)
    if hasattr(variables, "step"):
        variables.step = broadcast_object(int(variables.step),
                                          root_rank=root_rank)
    return variables


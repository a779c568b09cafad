"""The named mesh over the world: dp / pp / ep / sp / tp.

Port of the JAX package's ``parallel/mesh.py``: ``create_hybrid_mesh``
(:31), ``axis_size`` (:70) and the per-leaf reference of the gradient
sync rule, ``grad_sync_by_spec`` (:105).

Axes, outermost to innermost, in the JAX order ``(dp, pp, ep, sp, tp)``:

- ``dp`` — data parallel (the gradient average over replicas);
- ``pp`` — pipeline parallel (stage-to-stage sends);
- ``ep`` — expert parallel (the MoE dispatch's all-to-all);
- ``sp`` — sequence parallel (ring or Ulysses attention);
- ``tp`` — tensor parallel (Megatron column/row matmuls).

The rank layout is row-major over that order, so tp varies fastest: one
tp group is neighbouring ranks (on one host, neighbouring GPUs), and the
dp axis is outermost. ``create_hybrid_mesh`` keeps tp, sp and ep only
when their size is above 1, as the JAX helper does (a named ``sp`` axis
routes attention through the ring even at size 1), and keeps dp and pp
at size 1 too, so a one-stage pipeline on one GPU is a mesh of its own.
:func:`make_mesh` keeps every axis it is given, whatever its size: the
counterpart of a JAX ``Mesh(devices.reshape(shape), names)`` built by
hand.

Each axis has one ``torch.distributed`` process group per slice of the
mesh along it (``groups[axis]``: the ranks that differ from this one in
that axis only). The gradient-sync plan also sums over SETS of axes (a
replicated leaf over ``(dp, tp)``, a tp-sharded one over ``(dp,)``):
:meth:`Mesh.group` returns the group of this rank's slice along a set of
axes, creating the groups of every slice on first use. Creating a group
is collective over the whole world, so every rank must ask for the same
sets in the same order — the plans are built alike on every rank, and
ask in plan order. A set that spans the world is the default group.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import runtime

AXES = ("dp", "pp", "ep", "sp", "tp")

_KNOBS = {"dp": "dp= (bench --mesh, examples --dp)",
          "pp": "pp= (bench --pp/--mesh, examples --pp)",
          "ep": "ep= (set n_experts to the ep size)",
          "sp": "sp= (examples --sp)",
          "tp": "tp= (bench --tp/--mesh, examples --tp)"}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the mesh.

    ``shape`` maps each axis to its size and ``coords`` to this rank's
    index along it; ``ranks[axis]`` are the global ranks of this rank's
    group along ``axis`` in index order, and ``groups[axis]`` is that
    process group."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    ranks: Dict[str, Tuple[int, ...]]
    groups: Dict[str, object]
    _subsets: Dict[Tuple[str, ...], Tuple[Tuple[int, ...], object]] = \
        dataclasses.field(default_factory=dict, repr=False)

    def key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """``axes`` as a tuple in mesh order (unknown names raise)."""
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not on this mesh "
                             f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def subset_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in self.key(axes))

    def group(self, axes: Sequence[str]):
        """The process group of this rank's slice along ``axes``. The
        first call for a set of axes creates the groups of every slice
        (collective over the world: every rank must make the same calls
        in the same order); a set that spans the world is the default
        group."""
        key = self.key(axes)
        if len(key) == 1 and key[0] in self.groups:
            return self.groups[key[0]]
        got = self._subsets.get(key)
        if got is None:
            got = _make_groups(self, key)
            self._subsets[key] = got
        return got[1]


def axis_size(mesh: Mesh, name: str) -> int:
    """Size of ``name`` on ``mesh``; 1 for a canonical axis the mesh does
    not carry. A name that is neither on the mesh nor in :data:`AXES`
    raises: a typo ('dpp') must not read as an absent axis of size 1."""
    if name in mesh.shape:
        return int(mesh.shape[name])
    if name not in AXES:
        raise ValueError(
            f"unknown mesh axis {name!r}: this mesh has "
            f"{tuple(mesh.axis_names)} and the canonical axis names are "
            f"{AXES} (absent canonical axes have size 1)")
    return 1


def _strides(mesh_shape: Dict[str, int], names: Sequence[str]
             ) -> Dict[str, int]:
    out, s = {}, 1
    for a in reversed(names):
        out[a] = s
        s *= mesh_shape[a]
    return out


def _slice_ranks(mesh, key, coords) -> Tuple[int, ...]:
    stride = _strides(mesh.shape, mesh.axis_names)
    base = sum(coords[a] * stride[a] for a in mesh.axis_names
               if a not in key)
    return tuple(base + sum(i * stride[a] for a, i in zip(key, idx))
                 for idx in itertools.product(
                     *(range(mesh.shape[a]) for a in key)))


def _make_groups(mesh, key) -> Tuple[Tuple[int, ...], object]:
    """Create the group of every slice along ``key`` (in row-major order
    of the other axes' coordinates, alike on every rank) and return this
    rank's ``(ranks, group)``."""
    world = runtime.world()
    n = math.prod(mesh.shape[a] for a in key)
    mine = _slice_ranks(mesh, key, mesh.coords)
    if n == world.size:
        return mine, dist.group.WORLD
    others = [a for a in mesh.axis_names if a not in key]
    handle = None
    for idx in itertools.product(*(range(mesh.shape[a]) for a in others)):
        coords = dict(zip(others, idx), **{a: 0 for a in key})
        ranks = _slice_ranks(mesh, key, coords)
        g = dist.new_group(list(ranks))
        if ranks == mine:
            handle = g
    return mine, handle


def make_mesh(axes: Dict[str, int]) -> Mesh:
    """The mesh of ``axes`` (axis name -> size; names from :data:`AXES`,
    laid out in that order whatever the dict's order) over the
    initialized world, keeping every named axis, of any size. Every rank
    must call it, in the same order as its other process-group
    constructions: it creates one group per axis slice collectively (an
    axis spanning the whole world reuses the default group)."""
    for name, n in axes.items():
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r}: the axis names "
                             f"are {AXES}")
        if n < 1:
            raise ValueError(f"{name}={n}: axis sizes must be >= 1")
    names = tuple(a for a in AXES if a in axes)
    shape = {a: int(axes[a]) for a in names}
    total = math.prod(shape.values())
    world = runtime.world()
    if total != world.size:
        detail = ", ".join(f"{a}={shape[a]} via {_KNOBS[a]}" for a in names
                           if shape[a] != 1) or "all axes at size 1"
        raise ValueError(
            f"mesh {shape} needs {total} ranks; the world has {world.size}: "
            f"the axis sizes ({detail}) must multiply to the world size "
            f"(the launcher's -np, one process per GPU)")
    stride = _strides(shape, names)
    coords = {a: (world.rank // stride[a]) % shape[a] for a in names}
    mesh = Mesh(axis_names=names, shape=shape, coords=coords, ranks={},
                groups={})
    for a in names:
        ranks, handle = _make_groups(mesh, (a,))
        mesh.ranks[a], mesh.groups[a] = ranks, handle
    return mesh


def create_hybrid_mesh(dp: int = 1, tp: int = 1, pp: int = 1, sp: int = 1,
                       ep: int = 1) -> Mesh:
    """Build the named mesh over the initialized world, whose size must
    be ``dp·pp·ep·sp·tp``: dp and pp are always kept, tp, sp and ep only
    when above 1 (the JAX helper's rule for them). The size error names
    the knob of each axis. Every rank must call it (see
    :func:`make_mesh`)."""
    sizes = {"dp": dp, "pp": pp, "ep": ep, "sp": sp, "tp": tp}
    for name, n in sizes.items():
        if n < 1:
            raise ValueError(f"{name}={n}: axis sizes must be >= 1")
    return make_mesh({a: n for a, n in sizes.items()
                      if a in ("dp", "pp") or n > 1})


def dp_mesh() -> Mesh:
    """The world as a mesh with one ``dp`` axis (the JAX helper's mesh
    at ``dp=size``, where every other axis is dropped): the mesh of the
    LM's data-parallel step and its spec-grouped ZeRO plan."""
    world = runtime.world()
    return Mesh(axis_names=("dp",), shape={"dp": world.size},
                coords={"dp": world.rank},
                ranks={"dp": tuple(range(world.size))},
                groups={"dp": dist.group.WORLD})


def spec_axes(spec) -> set:
    """Mesh axis names a spec names (a tuple per dimension: an axis name,
    a tuple of names, or None)."""
    axes = set()
    for s in (spec or ()):
        if s is not None:
            axes.update((s,) if isinstance(s, str) else s)
    return axes


def grad_sync_by_spec(grads: Sequence[torch.Tensor], specs: Sequence,
                      mesh: Mesh, *, skip_axes: Tuple[str, ...] = (),
                      wire_dtype=None) -> List[torch.Tensor]:
    """The per-leaf executable reference of the gradient sync rule (JAX
    ``grad_sync_by_spec``): each gradient is averaged over every mesh
    axis its leaf is replicated across (not in its spec, not in
    ``skip_axes``), and a tp-sharded leaf's is further divided by the tp
    size. Every production plane runs the fused spec-grouped plan
    (:func:`~..ops.fusion.plan_grad_sync`, one collective per bucket of
    a group); this walk, one collective per leaf, is what the plan's
    membership and denominators are pinned against in tests.

    The tp division undoes the factor the row-parallel all-reduce's
    backward (a sum all-reduce, :func:`~.tp.row_parallel`) puts on every
    tp-sharded weight's gradient; replicated leaves need none, their
    per-rank partials being summed by the average itself. ``wire_dtype``
    runs each average on the reduced-precision wire of the fused planes
    (the ``1/world`` applied in f32 before the one cast). Returns new
    tensors; every rank must call it with the same specs."""
    from ..ops.fusion import _wire_applies, _wire_sum, resolve_wire_dtype
    wire = resolve_wire_dtype(wire_dtype)
    out = []
    for spec, g in zip(specs, grads):
        leaf_axes = spec_axes(spec)
        over = tuple(a for a in mesh.axis_names
                     if a not in leaf_axes and a not in skip_axes)
        g = g.detach().clone()
        if over:
            group = mesh.group(over)
            n = mesh.subset_size(over)
            if _wire_applies(g.dtype, wire):
                g = _wire_sum(g.reshape(-1), wire, group,
                              prescale=1.0 / n).view(g.shape)
            else:
                dist.all_reduce(g, group=group)
                g = g / n
        if "tp" in leaf_axes and "tp" in mesh.shape:
            g = g / mesh.shape["tp"]
        out.append(g)
    return out


def _dims(spec):
    """``(dim, axis)`` of each sharded dimension of a parameter spec (one
    axis name per dimension, or None)."""
    return [(d, a) for d, a in enumerate(spec or ()) if a is not None]


def local_slice(x, spec, mesh: Mesh):
    """This rank's block of the global array or tensor ``x`` under
    ``spec`` (per dimension the mesh axis it is split over, or None): a
    view or a slice, no copy."""
    for d, a in _dims(spec):
        if a not in mesh.shape:
            continue
        n, i = mesh.shape[a], mesh.coords[a]
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                             f"split over {a}={n}")
        step = x.shape[d] // n
        idx = [slice(None)] * x.ndim
        idx[d] = slice(i * step, (i + 1) * step)
        x = x[tuple(idx)]
    return x


def gather_global(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The global tensor from every rank's block ``t`` under ``spec``:
    one all-gather over each sharded dimension's axis group (blocks in
    axis-index order). Collective: every rank of the mesh must call it,
    leaf by leaf in the same order."""
    t = t.detach()
    for d, a in _dims(spec):
        if a not in mesh.shape or mesh.shape[a] == 1:
            continue
        parts = [torch.empty_like(t) for _ in range(mesh.shape[a])]
        dist.all_gather(parts, t.contiguous(), group=mesh.groups[a])
        t = torch.cat(parts, dim=d)
    return t


def batch_block(x: torch.Tensor, mesh: Mesh,
                batch_axes: Optional[Tuple[str, ...]] = None,
                seq_axis: Optional[str] = "sp") -> torch.Tensor:
    """This rank's block of a global ``[B, T, ...]`` batch under the
    transformer family's batch spec: rows split over ``batch_axes``
    (default: the mesh's ``dp`` and ``ep``, dp outer) and the sequence
    over ``seq_axis`` when the mesh has it. Raises when a size does not
    divide."""
    if batch_axes is None:
        batch_axes = tuple(a for a in ("dp", "ep") if a in mesh.shape)
    nb = math.prod(mesh.shape[a] for a in batch_axes)
    ib = 0
    for a in batch_axes:
        ib = ib * mesh.shape[a] + mesh.coords[a]
    B = x.shape[0]
    if B % nb:
        raise ValueError(f"batch of {B} rows does not split over "
                         f"{batch_axes} = {nb} ranks")
    x = x[ib * (B // nb):(ib + 1) * (B // nb)]
    if seq_axis is not None and seq_axis in mesh.shape:
        ns, js = mesh.shape[seq_axis], mesh.coords[seq_axis]
        T = x.shape[1]
        if T % ns:
            raise ValueError(f"sequence of {T} does not split over "
                             f"{seq_axis} = {ns} ranks")
        x = x[:, js * (T // ns):(js + 1) * (T // ns)]
    return x

"""The dp × pp mesh over the world.

Port of the JAX package's ``parallel/mesh.py`` ``create_hybrid_mesh``
(:36) for the two axes the pipelined LM uses. Ranks are laid out with dp
outermost and pp innermost, as the JAX helper orders its axes: rank =
dp_index·pp + pp_index, so the stages of one pipeline are neighbouring
ranks (on one host, neighbouring GPUs). Each axis gets one
``torch.distributed`` process group per slice of the mesh along it: a
rank's ``dp`` group holds the ranks with its pp index (they hold the same
stage), its ``pp`` group the ranks with its dp index (one pipeline).

Unlike the JAX helper, an axis of size 1 is kept, so a one-stage pipeline
on one GPU (dp=1 × pp=1) is a mesh of its own: the JAX step computes the
same function on a hand-built ``Mesh`` with a size-1 ``pp`` axis. The tp,
sp and ep axes come with their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch.distributed as dist

from .. import runtime

AXES = ("dp", "pp")


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


def create_hybrid_mesh(dp: int = 1, pp: int = 1) -> Mesh:
    """Build the ``(dp, pp)`` mesh over the initialized world, whose size
    must be ``dp·pp``. Every rank must call it, in the same order as its
    other process-group constructions: it creates the axis groups
    collectively (an axis spanning the whole world reuses the default
    group)."""
    for name, n in (("dp", dp), ("pp", pp)):
        if n < 1:
            raise ValueError(f"{name}={n}: axis sizes must be >= 1")
    world = runtime.world()
    if dp * pp != world.size:
        raise ValueError(f"mesh dp={dp} x pp={pp} needs {dp * pp} ranks; "
                         f"the world has {world.size}")
    rank = world.rank
    coords = {"dp": rank // pp, "pp": rank % pp}
    members = {
        "dp": [tuple(d * pp + p for d in range(dp)) for p in range(pp)],
        "pp": [tuple(d * pp + p for p in range(pp)) for d in range(dp)],
    }
    ranks, groups = {}, {}
    for axis in AXES:
        for grp in members[axis]:
            if len(grp) == world.size:
                handle = dist.group.WORLD
            else:
                handle = dist.new_group(list(grp))
            if rank in grp:
                ranks[axis], groups[axis] = grp, handle
    return Mesh(axis_names=AXES, shape={"dp": dp, "pp": pp},
                coords=coords, ranks=ranks, groups=groups)


def dp_mesh() -> Mesh:
    """The world as a mesh with one ``dp`` axis (the JAX helper's mesh
    at ``dp=size``, where every other axis is dropped): the mesh of the
    LM's data-parallel step and its spec-grouped ZeRO plan."""
    world = runtime.world()
    return Mesh(axis_names=("dp",), shape={"dp": world.size},
                coords={"dp": world.rank},
                ranks={"dp": tuple(range(world.size))},
                groups={"dp": dist.group.WORLD})

"""Environment-variable configuration of the port.

A copy of the parts of the JAX package's ``utils/config.py`` that the
port needs (that package's ``__init__`` imports JAX, so it is not
imported here). The names and defaults are the same:

* ``HOROVOD_FUSION_THRESHOLD`` — the tensor-fusion bucket size in bytes,
  64 MiB by default; 0 disables fusion (one bucket per tensor).
* ``HVD_GUARD_NONFINITE`` — the default of the bad-step guard
  (:func:`guard_nonfinite`).
* ``HVD_WIRE_DTYPE`` — the default low-precision wire format of the
  gradient exchange (:func:`wire_dtype_default`).
* ``HVD_ZERO`` and ``HVD_OVERLAP`` — the defaults of ZeRO-1 sharded
  updates (:func:`zero_enabled`) and of backward-overlapped bucket
  collectives (:func:`overlap_enabled`).
* The launcher's process environment: rank from ``HVD_RANK`` /
  ``PMI_RANK`` / ``OMPI_COMM_WORLD_RANK``, size from ``HVD_SIZE`` /
  ``PMI_SIZE`` / ``OMPI_COMM_WORLD_SIZE``, local rank from
  ``HVD_LOCAL_RANK`` / ``OMPI_COMM_WORLD_LOCAL_RANK`` — the first one set
  wins, and a process started by hand is rank 0 of a world of 1.
"""

from __future__ import annotations

import os

# Default tensor-fusion threshold: 64 MiB.
DEFAULT_FUSION_THRESHOLD: int = 64 * 1024 * 1024


def _int_env(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _flag(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes", "on")


def fusion_threshold_bytes() -> int:
    """``HOROVOD_FUSION_THRESHOLD`` (bytes; 0 disables fusion)."""
    return _int_env("HOROVOD_FUSION_THRESHOLD", DEFAULT_FUSION_THRESHOLD)


def guard_nonfinite() -> bool:
    """``HVD_GUARD_NONFINITE`` — default for the bad-step guard
    (``make_train_step(guard_nonfinite=...)``): skip the optimizer update
    (params, optimizer state and BatchNorm running statistics
    bit-unchanged) whenever any rank's gradients carry NaN/Inf. Off unless
    set to 1/true/yes/on."""
    return _flag("HVD_GUARD_NONFINITE")


def wire_dtype_default():
    """``HVD_WIRE_DTYPE`` — default low-precision wire format for gradient
    collectives (``DistributedOptimizer(wire_dtype=...)``): ``bf16`` or
    ``fp8`` (e4m3, per-bucket dynamic scaling); empty/``fp32`` means full
    precision. Resolution and validation live in
    :func:`horovod_tpu_torch.ops.fusion.resolve_wire_dtype`."""
    raw = os.environ.get("HVD_WIRE_DTYPE", "").strip().lower()
    return raw or None


def zero_enabled() -> bool:
    """``HVD_ZERO`` — default for ZeRO-1 sharded optimizer updates
    (``create_train_state(zero=...)`` / ``make_train_step(zero=...)``):
    the gradient exchange becomes reduce-scatter + all-gather over the
    fused buckets and each rank holds 1/size() of the optimizer state.
    Off unless set to 1/true/yes/on."""
    return _flag("HVD_ZERO")


def overlap_enabled() -> bool:
    """``HVD_OVERLAP`` — default for backward-overlapped bucket
    collectives (``make_train_step(overlap=...)``): each bucket's
    collective starts as soon as the backward has produced its last
    gradient, in a fixed emission order. Off unless set to
    1/true/yes/on."""
    return _flag("HVD_OVERLAP")


_RANK_VARS = ("HVD_RANK", "PMI_RANK", "OMPI_COMM_WORLD_RANK")
_SIZE_VARS = ("HVD_SIZE", "PMI_SIZE", "OMPI_COMM_WORLD_SIZE")
_LOCAL_RANK_VARS = ("HVD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")


def _first_env(names, default: int) -> int:
    for n in names:
        v = os.environ.get(n)
        if v is not None and v != "":
            try:
                return int(v)
            except ValueError:
                continue
    return default


def launcher_rank(default: int = 0) -> int:
    return _first_env(_RANK_VARS, default)


def launcher_size(default: int = 1) -> int:
    return _first_env(_SIZE_VARS, default)


def launcher_local_rank(default: int = 0) -> int:
    return _first_env(_LOCAL_RANK_VARS, default)

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
* ``HVD_MAX_BAD_STEPS`` — the Trainer's budget of consecutive skipped
  steps (:func:`max_bad_steps`).
* ``HOROVOD_TIMELINE`` (:func:`timeline_path`), ``HVD_RESTART_EPOCH``
  (:func:`restart_epoch`) and ``HVD_METRICS_PORT`` (:func:`metrics_port`)
  — the telemetry plane and the fault injector's epoch gate.
* The launcher's process environment: rank from ``HVD_RANK`` /
  ``PMI_RANK`` / ``OMPI_COMM_WORLD_RANK``, size from ``HVD_SIZE`` /
  ``PMI_SIZE`` / ``OMPI_COMM_WORLD_SIZE``, local rank from
  ``HVD_LOCAL_RANK`` / ``OMPI_COMM_WORLD_LOCAL_RANK`` — the first one set
  wins, and a process started by hand is rank 0 of a world of 1.
* ``HVD_DEVICE`` — the device ``init()`` takes when its caller names
  none (:func:`device_default`; the launcher's ``--cpu`` exports
  ``cpu``).
* The coordination plane: ``HVD_COORD_ADDR`` (:func:`coordinator_address`)
  and ``HOROVOD_STALL_CHECK_TIME`` (:func:`stall_warning_secs`, 60 s by
  default).
* The launcher's and elastic recovery's own knobs: ``HVD_ELASTIC_DIR``
  (:func:`elastic_dir`), ``HVD_RESTART_BACKOFF_MAX``
  (:func:`restart_backoff_max`) and ``HVD_CHIPS_PER_HOST``
  (:func:`visible_gpus`).
"""

from __future__ import annotations

import os

# Default tensor-fusion threshold: 64 MiB.
DEFAULT_FUSION_THRESHOLD: int = 64 * 1024 * 1024

# Seconds a collective may wait for its last rank before the coordinator
# warns of a stall.
DEFAULT_STALL_WARNING_SECS: float = 60.0


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


# Consecutive skipped (non-finite) steps tolerated before Trainer.fit
# raises NonFiniteGradError.
DEFAULT_MAX_BAD_STEPS: int = 5


def max_bad_steps() -> int:
    """``HVD_MAX_BAD_STEPS`` — consecutive bad-step budget of
    ``Trainer.fit`` (default 5, floor 1): a NaN burst shorter than this is
    absorbed by skipped steps alone; a longer one raises
    :class:`~horovod_tpu_torch.exceptions.NonFiniteGradError`."""
    return max(1, _int_env("HVD_MAX_BAD_STEPS", DEFAULT_MAX_BAD_STEPS))


def timeline_path():
    """``HOROVOD_TIMELINE`` — path of the Chrome-tracing file, written by
    rank 0 only (None when unset)."""
    return os.environ.get("HOROVOD_TIMELINE") or None


def stall_warning_secs() -> float:
    """``HOROVOD_STALL_CHECK_TIME`` — seconds before the coordinator warns
    that a collective waits on a subset of ranks (60 by default)."""
    raw = os.environ.get("HOROVOD_STALL_CHECK_TIME")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return DEFAULT_STALL_WARNING_SECS


def coordinator_address():
    """``HVD_COORD_ADDR`` — ``host:port`` of the coordination plane's
    rank-0 coordinator (the launcher exports it), or None."""
    return os.environ.get("HVD_COORD_ADDR") or None


def restart_epoch() -> int:
    """``HVD_RESTART_EPOCH`` — which (re)launch of the world this is (0 on
    the first launch or when unset); the fault injector's ``@epoch``
    gate reads it."""
    try:
        return int(os.environ.get("HVD_RESTART_EPOCH", "0") or 0)
    except ValueError:
        return 0


def metrics_port() -> int:
    """``HVD_METRICS_PORT`` — base port of the per-rank metrics HTTP
    listeners (rank *r* serves ``GET /metrics`` on ``base + r``;
    :mod:`horovod_tpu_torch.obs.http`). 0/unset disables."""
    return max(0, _int_env("HVD_METRICS_PORT", 0))


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


def device_default() -> str:
    """``HVD_DEVICE`` — the device ``runtime.init()`` uses when its caller
    passes none: ``cuda`` (the default) or ``cpu`` (what the launcher's
    ``--cpu`` exports, the counterpart of the JAX package's
    ``JAX_PLATFORMS=cpu``). Any other value raises ``ValueError``."""
    raw = os.environ.get("HVD_DEVICE", "").strip().lower() or "cuda"
    if raw not in ("cuda", "cpu"):
        raise ValueError(f"HVD_DEVICE={raw!r}: expected 'cuda' or 'cpu'")
    return raw


def elastic_dir():
    """``HVD_ELASTIC_DIR`` — the default directory of
    ``elastic.ElasticState`` commits (None when unset)."""
    return os.environ.get("HVD_ELASTIC_DIR") or None


# Cap of the launcher's exponential restart backoff, in seconds.
DEFAULT_RESTART_BACKOFF_MAX: float = 30.0


def restart_backoff_max() -> float:
    """``HVD_RESTART_BACKOFF_MAX`` — the cap, in seconds, of the
    launcher's jittered exponential backoff between restarts (default 30,
    clamped at 0; an unparsable value takes the default)."""
    raw = os.environ.get("HVD_RESTART_BACKOFF_MAX", "")
    try:
        cap = float(raw or DEFAULT_RESTART_BACKOFF_MAX)
    except ValueError:
        cap = DEFAULT_RESTART_BACKOFF_MAX
    return max(0.0, cap)


def visible_gpus() -> int:
    """The GPUs this host offers its ranks (0 when none).

    Never creates a CUDA context: the launcher would otherwise hold
    memory on every card it then hands to a rank. In order: the
    ``HVD_CHIPS_PER_HOST`` override, the entries of a set
    ``CUDA_VISIBLE_DEVICES`` (set and empty: none), the
    ``/dev/nvidia<N>`` device nodes this process may open (a container
    can show the nodes of cards its device cgroup denies it)."""
    import glob
    override = os.environ.get("HVD_CHIPS_PER_HOST")
    if override:
        try:
            return max(1, int(override))
        except ValueError:
            pass
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip()])
    n = 0
    for node in glob.glob("/dev/nvidia[0-9]*"):
        try:
            os.close(os.open(node, os.O_RDWR))
        except OSError:
            continue
        n += 1
    return n

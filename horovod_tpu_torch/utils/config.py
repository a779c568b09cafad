"""Environment-variable configuration of the port.

A copy of the parts of the JAX package's ``utils/config.py`` that the
port needs (that package's ``__init__`` imports JAX, so it is not
imported here). The names and defaults are the same:

* ``HOROVOD_FUSION_THRESHOLD`` — the tensor-fusion bucket size in bytes,
  64 MiB by default; 0 disables fusion (one bucket per tensor).
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


def fusion_threshold_bytes() -> int:
    """``HOROVOD_FUSION_THRESHOLD`` (bytes; 0 disables fusion)."""
    return _int_env("HOROVOD_FUSION_THRESHOLD", DEFAULT_FUSION_THRESHOLD)


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

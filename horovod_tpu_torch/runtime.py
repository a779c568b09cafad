"""The world: one process per GPU over ``torch.distributed``.

Port of the JAX package's ``runtime.py`` (``init``/``shutdown``/``size``/
``rank``/``local_rank``) in its env-world form — the reference's own
"1 process = 1 chip" mode, which is Horovod's "1 process = 1 GPU". Rank,
size and local rank come from the launcher's environment
(:mod:`.utils.config`); each process drives ``cuda:local_rank`` and the
collectives run on NCCL. ``init(device="cpu")`` builds the same world on
gloo for CPU runs and tests.

A world of one needs no rendezvous: its process group is built over an
in-memory ``HashStore``. Larger worlds rendezvous through ``env://``
(``MASTER_ADDR``/``MASTER_PORT``). A process group the caller built
before ``init`` is adopted as it is, and left to its owner at
``shutdown``.
"""

from __future__ import annotations

import dataclasses
import datetime
import threading
from typing import Optional

import torch
import torch.distributed as dist

from .device import DeviceLike, resolve_device
from .utils import config as _config


@dataclasses.dataclass(frozen=True)
class World:
    """The initialized world of this process."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str
    owns_group: bool


_world: Optional[World] = None
_lock = threading.Lock()


def init(device: DeviceLike = "cuda", *,
         timeout: Optional[datetime.timedelta] = None) -> World:
    """Initialize the world. Idempotent: a second call returns the world
    the first one built.

    ``device="cuda"`` (the default) binds this process to
    ``cuda:local_rank`` and uses NCCL, raising when CUDA is missing;
    ``device="cpu"`` uses gloo. ``timeout`` bounds the rendezvous and
    every collective (``torch.distributed``'s default otherwise)."""
    global _world
    with _lock:
        if _world is not None:
            return _world
        if dist.is_initialized():
            rank_ = dist.get_rank()
            size_ = dist.get_world_size()
        else:
            rank_ = _config.launcher_rank()
            size_ = _config.launcher_size()
        local = _config.launcher_local_rank(default=rank_)
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(dev)
            backend = "nccl"
        else:
            backend = "gloo"
        owns = not dist.is_initialized()
        if owns:
            if not 0 <= rank_ < size_:
                raise ValueError(f"rank {rank_} is outside a world of "
                                 f"size {size_}")
            kw = dict(rank=rank_, world_size=size_)
            if timeout is not None:
                kw["timeout"] = timeout
            if size_ == 1:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        **kw)
            else:
                dist.init_process_group(backend, init_method="env://",
                                        **kw)
        else:
            backend = dist.get_backend()
        _world = World(rank=rank_, size=size_, local_rank=local,
                       device=dev, backend=backend, owns_group=owns)
        return _world


def shutdown() -> None:
    """Tear the world down (destroying the process group if ``init``
    built it). Safe to call more than once."""
    global _world
    with _lock:
        if _world is None:
            return
        if _world.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        _world = None


def is_initialized() -> bool:
    return _world is not None


def world() -> World:
    if _world is None:
        raise ValueError("horovod_tpu_torch has not been initialized; "
                         "call horovod_tpu_torch.init() first")
    return _world


def size() -> int:
    return world().size


def rank() -> int:
    return world().rank


def local_rank() -> int:
    return world().local_rank


def device() -> torch.device:
    """The device this process's world drives."""
    return world().device

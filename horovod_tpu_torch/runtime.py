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

``init()`` without a device reads ``HVD_DEVICE`` (``cuda`` unless the
launcher's ``--cpu`` exported ``cpu``), the counterpart of the JAX
package's ``JAX_PLATFORMS=cpu``; there is no silent fallback to the CPU.

A dead or silent peer surfaces as the framework's errors, mapped in one
place (:func:`peer_failures`) on the collectives' path: what gloo raises
when a peer's socket closes becomes :class:`~.exceptions.
WorkerFailureError`, a collective that waited past the process group's
timeout (gloo's, or NCCL's watchdog) :class:`~.exceptions.StalledError`,
any other ``torch.distributed`` failure :class:`~.exceptions.
TransportError` — the errors ``elastic.run_with_recovery`` recovers
from.

``init`` also brings the telemetry plane up, as the reference's does:
the flight recorder's init event and fatal-signal dump, the world-shape
gauges of the process-default metrics registry, the per-rank
``/metrics`` listener when ``HVD_METRICS_PORT`` is set, and the
Chrome-trace timeline on rank 0 when ``HOROVOD_TIMELINE`` is set.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import re
import threading
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from .device import DeviceLike, resolve_device
from .exceptions import StalledError, TransportError, WorkerFailureError
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
    timeline: Any = None        # Timeline writer (rank 0 only)


_world: Optional[World] = None
_lock = threading.Lock()
# Per-rank metrics HTTP listener (HVD_METRICS_PORT; obs.http).
_metrics_listener = None


def init(device: DeviceLike = None, *,
         timeout: Optional[datetime.timedelta] = None) -> World:
    """Initialize the world. Idempotent: a second call returns the world
    the first one built.

    ``device="cuda"`` binds this process to ``cuda:local_rank`` and uses
    NCCL, raising when CUDA is missing; ``device="cpu"`` uses gloo. With
    no ``device``, ``HVD_DEVICE`` decides (``cuda`` when unset).
    ``timeout`` bounds the rendezvous and every collective
    (``torch.distributed``'s default otherwise)."""
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
        dev = resolve_device(_config.device_default() if device is None
                             else device)
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
        timeline = None
        tl_path = _config.timeline_path()
        if tl_path and rank_ == 0:
            from .utils.timeline import Timeline
            timeline = Timeline(tl_path)
        _world = World(rank=rank_, size=size_, local_rank=local,
                       device=dev, backend=backend, owns_group=owns,
                       timeline=timeline)
        _start_observability(_world)
        return _world


def _start_observability(w: World) -> None:
    """The flight recorder's init event and fatal-signal dump, the
    world-shape gauges, the ``/metrics`` listener (when
    ``HVD_METRICS_PORT`` asks for one) and the timeline's crash flush."""
    global _metrics_listener
    from .obs import flightrec, http as _obs_http
    from .obs.registry import registry as _registry
    flightrec.install_signal_dump()
    flightrec.record("init", rank=w.rank, world=w.size)
    reg = _registry()
    reg.gauge("hvd_world_size",
              "Number of ranks (chips) in the world").set(w.size)
    reg.gauge("hvd_rank", "This process's rank").set(w.rank)
    if _metrics_listener is None:
        _metrics_listener = _obs_http.start_from_env(w.rank)
    if w.timeline is not None:
        flightrec.add_crash_hook(w.timeline.flush)


def shutdown(error: Optional[BaseException] = None) -> None:
    """Tear the world down (destroying the process group if ``init``
    built it). Safe to call more than once. ``error=`` marks a failure
    path: the flight recorder's ring is dumped first, and a dead peer
    cannot hang the teardown (an NCCL group is aborted, not destroyed:
    its destroy would wait on work the dead peer never finishes; gloo's
    destroy returns at once)."""
    global _world, _metrics_listener
    from .obs import flightrec
    if error is not None:
        flightrec.record("shutdown_error", error=repr(error))
        flightrec.dump(reason=f"runtime.shutdown(error={error!r})")
        flightrec.run_crash_hooks()
    with _lock:
        if _world is None:
            return
        if _metrics_listener is not None:
            _metrics_listener.stop()
            _metrics_listener = None
        if _world.timeline is not None:
            flightrec.remove_crash_hook(_world.timeline.flush)
            _world.timeline.close()
        if _world.owns_group and dist.is_initialized():
            if error is not None and _world.backend == "nccl":
                dist.distributed_c10d._abort_process_group()
            else:
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


def process_index() -> int:
    """This process's index: one process per GPU, so :func:`rank`."""
    return world().rank


def process_count() -> int:
    """The number of processes: one per GPU, so :func:`size`."""
    return world().size


def device() -> torch.device:
    """The device this process's world drives."""
    return world().device


# -- a dead or silent peer ----------------------------------------------------

_TIMEOUT = re.compile(r"timed? ?out|timing out|timeout", re.I)
_PEER_GONE = re.compile(r"connection (reset|closed)|closed by peer|"
                        r"broken pipe|remote process", re.I)


def _peer_error(e: RuntimeError):
    """The framework error a ``torch.distributed`` failure stands for, or
    None when ``e`` is not one. Gloo raises a plain ``RuntimeError`` from
    its transport (``gloo/transport/...``, "Application timeout caused
    pair closure"); NCCL and the stores raise ``DistBackendError``,
    ``DistNetworkError`` and ``DistStoreError``."""
    msg = str(e)
    if not (isinstance(e, dist.DistError) or "gloo/transport" in msg
            or "pair closure" in msg):
        return None
    where = (f"rank {_world.rank} of a world of {_world.size}"
             if _world is not None else "this rank")
    if _TIMEOUT.search(msg):
        return StalledError(
            f"a collective on {where} waited past the process group's "
            f"timeout (a peer is wedged or gone): {msg}")
    if isinstance(e, dist.DistNetworkError) or _PEER_GONE.search(msg):
        return WorkerFailureError(
            f"worker failure: a peer of {where} closed its connection "
            f"in a collective (it died or was torn down): {msg}")
    return TransportError(f"collective failed on {where}: {msg}")


@contextlib.contextmanager
def peer_failures():
    """Re-raise a dead or silent peer's ``torch.distributed`` failure as
    :class:`WorkerFailureError`, :class:`StalledError` or
    :class:`TransportError` (the original chained); every other error
    passes through unchanged."""
    try:
        yield
    except RuntimeError as e:
        mapped = _peer_error(e)
        if mapped is None:
            raise
        raise mapped from e


def maps_peer_failures(fn: Callable) -> Callable:
    """Decorate an entry point that runs collectives with
    :func:`peer_failures`."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with peer_failures():
            return fn(*args, **kwargs)
    return wrapper

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

A world of more than one rank whose environment names a coordinator
(``HVD_COORD_ADDR``, which the launcher exports) is a coordinated world:
``init`` also brings the host coordination plane up
(:class:`~.coord.client.CoordClient` as ``World.coord``), and the public
eager collectives are negotiated by name at the rank-0 coordinator
(:mod:`.ops.collectives`). The gradient exchange, the bulk parameter
broadcasts and every call that passes a ``group=`` stay on the process
group: that is the device plane. In a coordinated world a dead peer seen
on the process group is named from the coordinator's abort, which knows
which rank died.

``init`` also brings the telemetry plane up, as the reference's does:
the flight recorder's init event and fatal-signal dump, the world-shape
gauges of the process-default metrics registry, the per-rank
``/metrics`` listener when ``HVD_METRICS_PORT`` is set, and the
Chrome-trace timeline on rank 0 when ``HOROVOD_TIMELINE`` is set (in a
coordinated world the native coordinator owns that file).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import re
import threading
import time
import warnings
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
    coord: Any = None           # CoordClient of a coordinated world
    #: The bound, in seconds, on a collective of the world's group: the
    #: ``timeout`` given to :func:`init`, else the group's own.
    timeout_s: float = 0.0


#: The world's data-parallel axis: ``axis_name=AXIS`` on a model's
#: BatchNorm reduces its batch statistics over every rank of the world
#: (the JAX package's mesh-axis name, kept as the same string).
AXIS: str = "hvd"

_world: Optional[World] = None
_lock = threading.Lock()
# Per-rank metrics HTTP listener (HVD_METRICS_PORT; obs.http).
_metrics_listener = None


def init(device: DeviceLike = None, *,
         timeout: Optional[datetime.timedelta] = None,
         coordinator: Optional[bool] = None) -> World:
    """Initialize the world. Idempotent: a second call returns the world
    the first one built.

    ``device="cuda"`` binds this process to ``cuda:local_rank`` and uses
    NCCL, raising when CUDA is missing; ``device="cpu"`` uses gloo. With
    no ``device``, ``HVD_DEVICE`` decides (``cuda`` when unset).
    ``timeout`` bounds the rendezvous and every collective
    (``torch.distributed``'s default otherwise); an adopted group keeps
    its own. Either way ``World.timeout_s`` holds the bound.

    ``coordinator=None`` brings the coordination plane up when the world
    has more than one rank and ``HVD_COORD_ADDR`` is set; ``True``
    requires it (``ValueError`` in a world of one, ``TransportError``
    without an address); ``False`` keeps a plain world. A failed build
    or start of the plane raises: it never leaves a plain world
    instead."""
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
        if coordinator is None:
            coordinator = (size_ > 1
                           and _config.coordinator_address() is not None)
        elif coordinator and size_ == 1:
            raise ValueError(
                "init(coordinator=True) requires a multi-process world; "
                "single-controller mode has no cross-process negotiation "
                "to coordinate")
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
        timeout_s = (timeout.total_seconds() if owns and timeout is not None
                     else _group_timeout_s(backend))
        coord = None
        if coordinator:
            from .coord.client import CoordClient
            try:
                coord = CoordClient.from_env(rank_, size_)
            except BaseException:
                if owns:
                    dist.destroy_process_group()
                raise
        timeline = None
        tl_path = _config.timeline_path()
        if tl_path and rank_ == 0 and coord is None:
            # In a coordinated world the native coordinator writes the
            # timeline; a second writer would corrupt the file.
            from .utils.timeline import Timeline
            timeline = Timeline(tl_path)
        _world = World(rank=rank_, size=size_, local_rank=local,
                       device=dev, backend=backend, owns_group=owns,
                       timeline=timeline, coord=coord,
                       timeout_s=timeout_s)
        _start_observability(_world)
        return _world


#: The bound assumed for a group whose timeout torch does not expose.
DEFAULT_TIMEOUT_S = 60.0


def _group_timeout_s(backend: str) -> float:
    """The default group's collective timeout in seconds, as its backend
    holds it (:data:`DEFAULT_TIMEOUT_S` where this torch does not say)."""
    dev = torch.device("cuda" if backend == "nccl" else "cpu")
    try:
        opts = dist.group.WORLD._get_backend(dev).options
        return float(opts._timeout.total_seconds())
    except (AttributeError, RuntimeError):
        return DEFAULT_TIMEOUT_S


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
        if _world.coord is not None:
            try:
                _world.coord.shutdown()
            except Exception as e:  # noqa: BLE001 — teardown must finish
                # A dead coordinator must not wedge the teardown: the
                # process group and the world reset below still run.
                warnings.warn(
                    f"coordination-plane shutdown failed (coordinator "
                    f"already dead?): {e!r} — continuing world teardown")
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

#: How long a rank that saw a peer's connection close on the process
#: group waits for the coordinator's abort, which names the dead rank
#: (a killed process's sockets close at once, so the abort follows within
#: milliseconds).
PEER_NAMING_WAIT_S = 2.0


def _coord_abort(wait_s: float) -> Optional[str]:
    """The coordinator's abort message of a coordinated world (it names
    the dead rank), waiting up to ``wait_s`` for it; None in a plain world
    or when no abort came."""
    coord = _world.coord if _world is not None else None
    if coord is None:
        return None
    deadline = time.monotonic() + wait_s
    while not coord.aborted():
        if time.monotonic() >= deadline:
            return None
        time.sleep(0.01)
    msg = coord.abort_message()
    return coord._abort_record(msg) if msg else None


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
        named = _coord_abort(0.0)
        if named is not None:
            return WorkerFailureError(f"{named} (seen on {where} as: {msg})")
        return StalledError(
            f"a collective on {where} waited past the process group's "
            f"timeout (a peer is wedged or gone): {msg}")
    if isinstance(e, dist.DistNetworkError) or _PEER_GONE.search(msg):
        named = _coord_abort(PEER_NAMING_WAIT_S)
        if named is not None:
            return WorkerFailureError(f"{named} (seen on {where} as: {msg})")
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

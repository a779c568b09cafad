"""Input pipeline: this rank's shard of each global batch, staged ahead on
the device.

Port of the two functions of the JAX package's ``data.py`` that the
Trainer needs: :func:`shard_iterator` (:112) and
:func:`prefetch_to_device` (:126). A batch is a tuple, list or dict of
arrays (numpy or torch) whose leading axis is the global batch; this
rank keeps the contiguous ``rows/size()`` block at ``rank()``, as the
JAX world's leading-axis split does. The dataset loaders and synthetic
sets are ``ROADMAP.md`` Queue 1 item 14.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from . import runtime
from .device import DeviceLike
from .utils import timeline as _tl


def _tree_map(fn: Callable, batch: Any) -> Any:
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    return fn(batch)


def _world_device() -> Optional[torch.device]:
    return runtime.device() if runtime.is_initialized() else None


def shard_batch(batch: Any, rank: Optional[int] = None,
                size: Optional[int] = None) -> Any:
    """This rank's rows of a global host batch, as CPU tensors: the
    leading axis split into ``size`` (default ``size()``) contiguous
    blocks, block ``rank`` (default ``rank()``) kept. Raises when the
    leading axis does not divide."""
    if size is None:
        size = runtime.size() if runtime.is_initialized() else 1
    if rank is None:
        rank = runtime.rank() if runtime.is_initialized() else 0

    def one(x):
        t = torch.as_tensor(x)
        rows = t.shape[0]
        if rows % size:
            raise ValueError(
                f"a global batch of {rows} rows does not split over "
                f"{size} ranks")
        n = rows // size
        return t[rank * n:(rank + 1) * n]
    return _tree_map(one, batch)


def shard_iterator(batches: Iterable,
                   device: DeviceLike = None) -> Iterator:
    """Yield this rank's shard of each global host batch, placed on
    ``device`` (default: the world's device; the host when no world is
    up). The copy is synchronous: :func:`prefetch_to_device` overlaps it
    with the step."""
    device = _world_device() if device is None else torch.device(device)
    for batch in batches:
        shard = shard_batch(batch)
        yield shard if device is None else _tree_map(
            lambda t: t.to(device), shard)


class _Sentinel:
    pass


_END = _Sentinel()

# Timeline-row pool: concurrent streams (train + eval) need DISTINCT rows
# so B/E events don't interleave, but sequential streams (one per epoch)
# reuse freed ids.
_h2d_rows = itertools.count()
_h2d_free: list = []
_h2d_lock = threading.Lock()


def prefetch_to_device(batches: Iterable, size: int = 2,
                       device: DeviceLike = None,
                       timeline: Optional[Any] = None) -> Iterator:
    """Iterate ``batches`` with a background thread staying ``size``
    batches ahead, each placed on ``device`` (default: the world's
    device; left where it is when no world is up).

    On a CUDA device the worker copies each batch from pinned host memory
    (a batch already on the card is only moved to ``device``) with
    ``non_blocking`` copies on a side stream and records an event;
    the consumer's stream waits on that event before the batch is handed
    out, so the copy of batch k+1 overlaps step k and is ordered before
    step k+1. Each placement is an ``H2D`` timeline phase (``timeline``
    defaults to the runtime's writer). Exceptions in the source re-raise
    at the consuming ``next()``. Abandoning the iterator early stops the
    worker, drops its staged batches and closes the source iterator."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = _world_device() if device is None else torch.device(device)
    return _prefetch_gen(batches, size, device, timeline)


def _prefetch_gen(batches: Iterable, size: int,
                  device: Optional[torch.device],
                  timeline: Optional[Any]) -> Iterator:
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    if timeline is None and runtime.is_initialized():
        timeline = runtime.world().timeline
    with _h2d_lock:
        row_id = _h2d_free.pop() if _h2d_free else next(_h2d_rows)
    row = f"input.h2d.{row_id}"
    cuda = device is not None and device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def _stage(x):
        t = torch.as_tensor(x)
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def _place(b):
        if device is None:
            return b, None
        with _tl.maybe_op(timeline, row, _tl.H2D):
            if not cuda:
                return _tree_map(lambda x: torch.as_tensor(x).to(device),
                                 b), None
            with torch.cuda.stream(side):
                placed = _tree_map(_stage, b)
                ready = torch.cuda.Event()
                ready.record(side)
            # Wait HERE, on the worker: a dequeued batch is resident, and
            # the H2D phase measures the copy, not its enqueue.
            ready.synchronize()
        return placed, ready

    def _put(item) -> bool:
        # Bounded put with a stop check: the consumer may vanish while the
        # queue is full; never block forever on any worker-side put.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill():
        try:
            for b in batches:
                if not _put(_place(b)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            _put(e)
            return
        _put(_END)

    t = threading.Thread(target=_fill, name="hvd-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, _Sentinel):
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)

                def _adopt(x):
                    # The caching allocator must not recycle the side
                    # stream's block while the step's stream still reads it.
                    x.record_stream(consumer)
                    return x
                batch = _tree_map(_adopt, batch)
            yield batch
    finally:
        stop.set()
        # Unblock a worker stuck in put() and drop staged batches.
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5)
        if not t.is_alive():
            with _h2d_lock:
                _h2d_free.append(row_id)
        close = getattr(batches, "close", None)
        if close is not None:
            close()


def batch_rows(batch: Any) -> int:
    """Rows of a batch's first leaf (0 for an empty batch)."""
    leaves = []
    _tree_map(leaves.append, batch)
    return int(np.shape(leaves[0])[0]) if leaves else 0

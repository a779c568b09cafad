"""Dynamic batching: request queue, power-of-two buckets, padding.

A copy of the JAX package's ``serve/batcher.py`` (framework-neutral host
code, numpy in and out; copied because the port never imports the JAX
package). Single requests arrive on a bounded queue and leave as padded
batches of a power-of-two bucket size, at most ``log2(max_batch) + 1``
shapes, each run once by ``warmup()``. A batch ships when it reaches
``max_batch`` or when its oldest request has waited
``batch_timeout_ms``. Padding replicates row 0, so a padded batch cannot
make NaN or Inf rows out of zeros in a model whose rows interact.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..exceptions import ServerClosedError, ServerOverloadedError


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """(1, 2, 4, …, max_batch). ``max_batch`` must be a power of two so
    the top bucket and the flush threshold coincide."""
    if max_batch < 1 or (max_batch & (max_batch - 1)):
        raise ValueError(f"max_batch must be a power of two, got {max_batch}")
    sizes = []
    b = 1
    while b <= max_batch:
        sizes.append(b)
        b *= 2
    return tuple(sizes)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (callers guarantee n <= max(buckets))."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the top bucket {buckets[-1]}")


def pad_rows(rows: Sequence[np.ndarray], bucket: int) -> np.ndarray:
    """Stack single-example rows into a [bucket, *item_shape] array,
    replicating row 0 into the padding slots."""
    n = len(rows)
    if not 0 < n <= bucket:
        raise ValueError(f"{n} rows do not fit bucket {bucket}")
    return np.stack(list(rows) + [rows[0]] * (bucket - n))


@dataclasses.dataclass
class Request:
    """One queued single-shot request (a single example)."""

    inputs: np.ndarray
    future: Any                      # concurrent.futures.Future
    enqueued_at: float               # time.monotonic()
    deadline_at: Optional[float]     # absolute monotonic deadline, or None
    # Filled by the engine at dispatch. ``executed_batch`` (only with
    # ``ServeConfig.record_executed_batch``: it pins the padded array for
    # the future's lifetime) is the [bucket, *item] program input and
    # ``row`` this request's row in it: ``apply_fn(variables,
    # executed_batch)[row]`` is bitwise the served output.
    bucket: Optional[int] = None
    executed_batch: Optional[np.ndarray] = None
    row: Optional[int] = None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_at is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline_at


class RequestQueue:
    """Bounded FIFO with the dynamic-batching dequeue policy.

    ``put`` is non-blocking admission control: a full queue raises
    :class:`ServerOverloadedError` immediately (shedding load at the door
    beats queueing requests that will only expire). Queued items need an
    ``enqueued_at`` (``time.monotonic()``) attribute.
    """

    def __init__(self, max_queue: int):
        self._cv = threading.Condition()
        self._q: deque = deque()
        self._max = int(max_queue)
        self._closed = False
        # Requests a consumer took with ``hold=True`` and still owns (the
        # generation engine's held line). They left the deque but have
        # not been served, so they still count against ``max_queue``.
        self._external = 0

    def __len__(self) -> int:
        with self._cv:
            return len(self._q)

    def put(self, req: Any) -> int:
        """Admit ``req``; returns the resulting queue depth."""
        with self._cv:
            if self._closed:
                raise ServerClosedError("inference server is shut down")
            if len(self._q) + self._external >= self._max:
                raise ServerOverloadedError(
                    f"request queue full ({self._max}); retry after backoff")
            self._q.append(req)
            self._cv.notify()
            return len(self._q)

    def release_held(self, n: int = 1) -> None:
        """Return ``n`` ``hold=True`` tickets (the requests were served,
        failed, or expired) — frees their admission capacity."""
        with self._cv:
            self._external = max(0, self._external - n)

    def take_batch(self, max_batch: int, batch_timeout_ms: float, *,
                   hold: bool = False,
                   idle_s: Optional[float] = None) -> Optional[List[Any]]:
        """Block until a batch is due, then return it (an empty list
        means the queue was closed and fully drained). A batch is due
        when ``max_batch`` requests are queued or the oldest has waited
        ``batch_timeout_ms``; a closed queue flushes immediately.
        ``hold=True`` keeps the returned requests counted against
        ``max_queue`` until :meth:`release_held` hands each ticket back.
        ``idle_s`` bounds the wait of an empty queue: None is returned
        when nothing arrived within it (a tp leader's heartbeat tick).
        """
        deadline_of_oldest = None
        idle_until = (None if idle_s is None
                      else time.monotonic() + float(idle_s))
        with self._cv:
            while True:
                if self._q:
                    now = time.monotonic()
                    if deadline_of_oldest is None:
                        deadline_of_oldest = (self._q[0].enqueued_at
                                              + batch_timeout_ms / 1e3)
                    if (len(self._q) >= max_batch
                            or now >= deadline_of_oldest
                            or self._closed):
                        batch = [self._q.popleft()
                                 for _ in range(min(max_batch,
                                                    len(self._q)))]
                        if hold:
                            self._external += len(batch)
                        self._cv.notify_all()
                        return batch
                    self._cv.wait(deadline_of_oldest - now)
                else:
                    deadline_of_oldest = None
                    if self._closed:
                        return []
                    if idle_until is None:
                        self._cv.wait()
                        continue
                    left = idle_until - time.monotonic()
                    if left <= 0:
                        return None
                    self._cv.wait(left)

    def close(self) -> None:
        """Stop admission; queued requests stay for the consumer."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def drain_pending(self) -> List[Any]:
        """Evict and return everything still queued (non-drain shutdown)."""
        with self._cv:
            self._closed = True
            pending = list(self._q)
            self._q.clear()
            self._cv.notify_all()
            return pending

"""Bounded request queue and power-of-two buckets.

A copy of the JAX package's ``serve/batcher.py`` pieces the generation
engine uses (``RequestQueue``, ``bucket_for``) — framework-neutral host
code, copied because the port never imports the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, Sequence

from ..exceptions import ServerClosedError, ServerOverloadedError


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (callers guarantee n <= max(buckets))."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds the top bucket {buckets[-1]}")


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
                   hold: bool = False) -> List[Any]:
        """Block until a batch is due, then return it (an empty list
        means the queue was closed and fully drained). A batch is due
        when ``max_batch`` requests are queued or the oldest has waited
        ``batch_timeout_ms``; a closed queue flushes immediately.
        ``hold=True`` keeps the returned requests counted against
        ``max_queue`` until :meth:`release_held` hands each ticket back.
        """
        deadline_of_oldest = None
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
                    self._cv.wait()

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

"""The readiness contract every serving engine of the port shares.

A copy of ``ReadinessMixin`` from the JAX package's ``serve/engine.py``
(the single-shot batching ``Engine`` there belongs to a later slice).
"""

from __future__ import annotations

from typing import Tuple


class ReadinessMixin:
    """The /healthz readiness contract: a triple ``(ready, status,
    queue_depth)`` — ``(False, "warming", ...)`` until :meth:`warmup`
    completes (a cold engine answers, but a load balancer should not
    route to it), ``(False, "draining", ...)`` once shutdown began,
    ``(True, "ok", ...)`` otherwise. Hosts provide ``_warmed``/``_closed``
    flags and a ``_queue`` with ``__len__``."""

    _warmed = False
    _closed = False

    def health(self) -> Tuple[bool, str, int]:
        if self._closed:
            return False, "draining", len(self._queue)
        if not self._warmed:
            return False, "warming", len(self._queue)
        return True, "ok", len(self._queue)

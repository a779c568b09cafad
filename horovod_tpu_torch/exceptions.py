"""Serving error taxonomy of the PyTorch port.

A copy of the serving errors of the JAX package's ``exceptions.py``: the
port must not import that package (its ``__init__`` imports JAX), so the
classes live here with the same names and meanings.
"""


class HorovodError(Exception):
    """Base class for all framework errors."""


class ServerOverloadedError(HorovodError):
    """The server's admission queue is full.

    Raised synchronously by ``submit`` when the bounded request queue is
    at capacity. Callers should treat it as retryable after backoff (HTTP
    503 semantics; the bundled HTTP front end maps it exactly there).
    """


class DeadlineExceededError(HorovodError):
    """A queued request's deadline expired before execution.

    Delivered through the request's handle (never raised on the engine
    thread): expired requests are dropped at dequeue so a stale request
    cannot occupy a decode slot that an in-deadline request needs. Maps
    to HTTP 504 in the bundled front end.
    """


class ServerClosedError(HorovodError):
    """The server is shut down (or shutting down).

    Raised by ``submit`` after ``shutdown()`` began, and delivered to any
    still-pending handles when a shutdown is NOT a graceful drain
    (``shutdown(drain=False)``). Distinct from
    :class:`ServerOverloadedError` because it is terminal, not retryable.
    """

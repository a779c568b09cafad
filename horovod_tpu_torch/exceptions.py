"""Error taxonomy of the PyTorch port.

A copy of the JAX package's ``exceptions.py``: the port must not import
that package (its ``__init__`` imports JAX), so the classes live here with
the same names, bases, constructor arguments and meanings — the world and
collective errors, the checkpoint integrity errors, the bad-step budget,
and the serving errors.
"""


class HorovodError(Exception):
    """Base class for all framework errors."""


class NotInitializedError(HorovodError):
    """Raised when the process API is used before ``init()``."""

    def __init__(self, what: str = "Horovod-TPU"):
        super().__init__(
            f"{what} has not been initialized; use horovod_tpu_torch.init().")


class FailedPreconditionError(HorovodError):
    """Cross-rank inconsistency detected during collective negotiation."""


class TransportError(HorovodError):
    """Failure in the host coordination transport."""


class WorkerFailureError(TransportError):
    """A rank (or the coordinator) died or went silent; the world aborted.

    Subclasses :class:`TransportError`: worker death is detected on the
    transport plane, and ``except TransportError`` handlers must keep
    catching a dead rank."""


class CheckpointCorruptError(HorovodError):
    """A checkpoint's bytes do not match its integrity manifest.

    Raised by the verify half of the checkpoint integrity plane
    (:func:`horovod_tpu_torch.parallel.checkpoint.verify_checkpoint`):
    every save writes a per-leaf checksum manifest beside the bytes, and a
    restore that finds a truncated file, a flipped bit, or a
    structure/dtype/shape mismatch raises this instead of resuming from
    poisoned state. The message names the checkpoint path and the first
    offending leaf."""

    def __init__(self, path: str, detail: str = ""):
        self.path = path
        self.detail = detail
        msg = f"checkpoint {path} failed integrity verification"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class CheckpointTimeoutError(HorovodError):
    """An async checkpoint write did not become durable within the
    caller's deadline (:meth:`horovod_tpu_torch.trainer.AsyncCheckpointer.
    wait` with ``timeout=``). The write itself is not cancelled: a later
    ``wait()`` observes whatever it eventually did."""


class NonFiniteGradError(HorovodError):
    """Too many consecutive non-finite-gradient steps.

    The bad-step guard (``make_train_step(guard_nonfinite=True)``) skips
    the update whenever any rank's gradients carry a NaN/Inf, leaving the
    state bit-unchanged. ``Trainer.fit`` counts consecutive skips; after
    ``HVD_MAX_BAD_STEPS`` of them it raises this: a persistent NaN source
    is not going to fix itself."""


class StalledError(HorovodError):
    """A collective waited past the hard stall deadline (strict mode,
    ``HOROVOD_STALL_TIMEOUT``)."""


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

"""The single-shot inference engine: bucketed batches over a warm model.

Port of the JAX package's ``serve/engine.py``:

* **Buckets.** Requests are coalesced into power-of-two batches
  (:mod:`.batcher`); each bucket is one input shape, and
  :meth:`Engine.warmup` runs every bucket once before traffic (the
  reference's per-bucket compile cache: here cuDNN's autotuner, the
  caching allocator and the first launches are warm instead), so no
  request pays a first run.
* **Backpressure.** A bounded admission queue
  (:class:`~..exceptions.ServerOverloadedError` at the door),
  per-request deadlines dropped at dequeue
  (:class:`~..exceptions.DeadlineExceededError` through the future),
  a graceful drain on shutdown.
* **Observability.** The :class:`~.metrics.ServeMetrics` snapshot and
  histograms, and the serving phases ``QUEUE → PAD → XLA_EXECUTE →
  RESPOND`` (the reference's names) on the
  :class:`~..utils.timeline.Timeline` (row ``serve``, op kind
  ``INFERENCE``).

The dispatch loop is one background thread, as in the reference: one
device program per batch leaves nothing to overlap on the host, and one
consumer keeps the queue's FIFO order. ``apply_fn(variables, batch)``
runs under ``torch.inference_mode()`` on a ``[bucket, *item_shape]``
tensor on the engine's device.

Under a tp mesh (``variables`` a model on one) every rank
builds the engine with the same arguments: the tp group's rank 0 serves,
and sends each padded batch through the step plane (:mod:`.tp_plane`)
to the other ranks, which run ``apply_fn`` on it with their shards (its
row-parallel sums need every rank) and answer nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..exceptions import (DeadlineExceededError, ServerClosedError,
                          ServerOverloadedError)
from .batcher import (Request, RequestQueue, bucket_for, bucket_sizes,
                      pad_rows)
from .metrics import ServeMetrics
from .tp_plane import TpRole, plane_for

# Serving phases on the timeline, in emission order: QUEUE is the wait
# assembling the batch (flush policy), PAD the host-side bucket and
# stack, XLA_EXECUTE the device program with both transfers (the
# reference's name), RESPOND the future delivery.
SERVE_PHASES = ("QUEUE", "PAD", "XLA_EXECUTE", "RESPOND")
_TIMELINE_ROW = "serve"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (all host-side; buckets are the only shape surface).

    ``max_batch`` must be a power of two: it is both the top bucket and
    the flush threshold. ``batch_timeout_ms`` bounds the head-of-line
    wait. ``default_deadline_ms`` (None = no deadline) applies to
    requests that carry none. ``record_executed_batch`` keeps the padded
    batch each request ran in on its :class:`~.batcher.Request`
    (``future.request.executed_batch``), so a caller can rerun the exact
    program input (the bitwise contract); it pins up to a
    ``[max_batch, *item]`` array per retained future.
    """

    max_batch: int = 32
    batch_timeout_ms: float = 5.0
    max_queue: int = 256
    default_deadline_ms: Optional[float] = None
    record_executed_batch: bool = False


class ReadinessMixin:
    """The /healthz readiness contract every serving engine of the port
    shares: a triple ``(ready, status, queue_depth)`` —
    ``(False, "warming", ...)`` until :meth:`warmup` completes (a cold
    engine answers, but a load balancer should not route to it),
    ``(False, "draining", ...)`` once shutdown began, ``(True, "ok",
    ...)`` otherwise. Hosts provide ``_warmed``/``_closed`` flags and a
    ``_queue`` with ``__len__``."""

    _warmed = False
    _closed = False

    def health(self) -> Tuple[bool, str, int]:
        if self._closed:
            return False, "draining", len(self._queue)
        if not self._warmed:
            return False, "warming", len(self._queue)
        return True, "ok", len(self._queue)

    def load(self) -> int:
        """Dispatch pressure: queued requests plus rows mid-execution
        (:meth:`_active_rows`) — the numbers ``/metrics`` exports as
        ``hvd_queue_depth`` and ``hvd_active_slots``."""
        return len(self._queue) + self._active_rows()

    def _active_rows(self) -> int:
        """Rows mid-execution: 0 for the single-shot engine (a batch is
        in flight for milliseconds); the generation engine counts its
        live decode slots and held requests."""
        return 0


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def _to_host(t: Any) -> np.ndarray:
    """An output leaf as numpy (bf16 widened to f32, exactly: numpy has
    no bfloat16)."""
    if torch.is_tensor(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


class Engine(ReadinessMixin, TpRole):
    """In-process dynamic-batching inference server.

    Args:
      apply_fn: ``apply_fn(variables, batch) -> outputs``, e.g.
        ``lambda m, x: m(x, train=False)`` for a port model. ``batch``
        is a ``[bucket, *item_shape]`` tensor on ``device``; outputs may
        be any tree (dicts, lists, tuples) of tensors with a leading
        batch axis.
      variables: what ``apply_fn`` reads its weights from (a model, a
        dict of tensors), already on ``device``.
      item_shape / item_dtype: shape and numpy dtype of ONE example (no
        batch axis), fixed per engine: the buckets' shapes depend on it.
      config: :class:`ServeConfig`.
      timeline: a :class:`~..utils.timeline.Timeline` to receive the
        serving phases; defaults to the runtime's when
        ``horovod_tpu_torch.init()`` ran with ``HOROVOD_TIMELINE`` set.
      device: where batches run; ``"cuda"`` (the default) raises on a
        host without CUDA.

    When ``variables`` is a model on a tp mesh (``variables.mesh``) with
    tp above 1, the tp group's rank 0 serves and the other ranks follow
    (the module docstring): there :meth:`submit` raises ``ValueError``
    naming the leader and :meth:`wait` blocks until the leader shuts
    down.

    A served row comes back as numpy (bf16 outputs widened to f32).
    """

    def __init__(self, apply_fn: Callable, variables: Any,
                 item_shape: Tuple[int, ...], item_dtype: Any = np.float32,
                 config: ServeConfig = ServeConfig(),
                 timeline: Optional[Any] = None, *,
                 device: DeviceLike = "cuda"):
        self._plane = plane_for(getattr(variables, "mesh", None), "Engine")
        self._device = resolve_device(device)
        self._apply = apply_fn
        self._variables = variables
        self._item_shape = tuple(item_shape)
        self._item_dtype = np.dtype(item_dtype)
        self._cfg = config
        self._buckets = bucket_sizes(config.max_batch)
        self._queue = RequestQueue(config.max_queue)
        self._metrics = ServeMetrics()
        # Buckets that have run once (warmup or traffic): the
        # reference's compiled buckets, under their own lock for stats().
        self._run_ids: set = set()
        self._stats_lock = threading.Lock()
        if timeline is None:
            from .. import runtime
            if runtime.is_initialized():
                timeline = runtime.world().timeline
        self._timeline = timeline
        self._closed = False
        self._warmed = False
        if self.is_leader:
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            name="hvd-torch-serve-dispatch",
                                            daemon=True)
        else:
            # A follower runs ``apply_fn`` on each batch the leader sends,
            # the outputs left on the device.
            self._thread = threading.Thread(
                target=self._follow, name="hvd-torch-tp-follower",
                args=(lambda op, args: self._apply_batch(args["batch"]),
                      self._device), daemon=True)
        self._thread.start()

    # -- the device program ------------------------------------------------

    def _apply_batch(self, batch: np.ndarray) -> Any:
        """``apply_fn`` on the padded host batch, on this rank."""
        x = torch.from_numpy(batch).to(self._device)
        with torch.inference_mode():
            return self._apply(self._variables, x)

    def _execute(self, bucket: int, batch: np.ndarray) -> Any:
        """``apply_fn`` on the padded host batch (sent to the tp
        followers first); the outputs as numpy (the copy back waits for
        the device)."""
        plane = self._plane
        if plane is None:
            out = self._apply_batch(batch)
        else:
            out = plane.run("apply", {"batch": batch},
                            lambda: self._apply_batch(batch))
        out_np = _tree_map(_to_host, out)
        with self._stats_lock:
            self._run_ids.add(bucket)
        return out_np

    def warmup(self) -> Tuple[int, ...]:
        """Run every bucket once before traffic (on zeros), so that
        cuDNN's autotuning, the allocator's growth and the first launches
        of each shape happen at deploy time, not under load; checks that
        outputs carry a leading batch axis. Returns the buckets warmed.
        On a tp leader every rank runs them."""
        self._leader_only("warmup()")
        for b in self._buckets:
            out = self._execute(
                b, np.zeros((b,) + self._item_shape, self._item_dtype))
            for leaf in _leaves(out):
                if not getattr(leaf, "shape", (0,))[:1] == (b,):
                    raise ValueError(
                        f"apply_fn output leaf shape {leaf.shape} has no "
                        f"leading batch axis of {b}; the engine cannot "
                        f"split it back into per-request rows")
        self._warmed = True
        return self._buckets

    # -- client API --------------------------------------------------------

    def submit(self, inputs: Any,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one example; returns a future resolving to its output
        row (a numpy tree). Raises :class:`ServerOverloadedError` when
        the queue is full, :class:`ServerClosedError` after shutdown.
        The :class:`~.batcher.Request` is ``future.request``. On a tp
        follower it raises ``ValueError`` naming the leader."""
        self._leader_only("submit()")
        x = np.asarray(inputs, self._item_dtype)
        if x.shape != self._item_shape:
            raise ValueError(
                f"request shape {x.shape} != engine item shape "
                f"{self._item_shape} (one example per request)")
        if deadline_ms is None:
            deadline_ms = self._cfg.default_deadline_ms
        now = time.monotonic()
        req = Request(inputs=x, future=Future(), enqueued_at=now,
                      deadline_at=(None if deadline_ms is None
                                   else now + deadline_ms / 1e3))
        req.future.request = req
        try:
            depth = self._queue.put(req)   # raises Closed
        except ServerOverloadedError as e:
            self._metrics.on_overload()
            # The 503's backoff hint: time for the full queue to drain
            # at the measured service rate.
            e.retry_after_ms = self._metrics.retry_after_ms(
                len(self._queue))
            raise
        self._metrics.on_submit(depth)
        return req.future

    def infer(self, inputs: Any, deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None) -> Any:
        """Synchronous :meth:`submit` (+ ``future.result(timeout)``)."""
        return self.submit(inputs, deadline_ms).result(timeout)

    def stats(self) -> Dict:
        """The ``/stats`` snapshot (``buckets_compiled``: the buckets that
        have run, the reference's key)."""
        snap = self._metrics.snapshot()
        snap["buckets"] = list(self._buckets)
        with self._stats_lock:
            snap["buckets_compiled"] = sorted(self._run_ids)
        snap["max_queue"] = self._cfg.max_queue
        snap["batch_timeout_ms"] = self._cfg.batch_timeout_ms
        snap["device"] = str(self._device)
        return self._tp_stats(snap)

    def prom_collect(self):
        """This engine's ``(meta, samples)`` in Prometheus terms:
        everything :meth:`stats` knows plus the latency histograms,
        labelled ``engine="predict"``
        (:func:`~.metrics.collect_stats`)."""
        from .metrics import collect_stats
        return collect_stats(self.stats(), self._metrics.registry,
                             engine="predict")

    def prom_metrics(self) -> str:
        """Prometheus text exposition of :meth:`prom_collect` (the
        ``/metrics`` body when this engine serves alone)."""
        from ..obs.registry import render
        return render(*self.prom_collect())

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the engine. ``drain=True`` serves everything already
        queued first; ``drain=False`` fails pending futures with
        :class:`ServerClosedError`. On a tp leader the loop's end
        releases the followers; on a follower it waits up to ``timeout``
        for that. Idempotent."""
        if self._shutdown_follower(timeout):
            return
        if self._closed:
            return
        self._closed = True
        if drain:
            self._queue.close()
        else:
            self._fail_pending()
        self._thread.join(timeout)
        # A drain that outlasts the join (a wedged device batch) must not
        # leave clients blocked in future.result(): fail what is still
        # queued; the stuck batch's futures stay with its dispatcher.
        if self._thread.is_alive():
            self._fail_pending()

    def _fail_pending(self) -> None:
        cancelled = 0
        for req in self._queue.drain_pending():
            # A client may have cancel()ed a queued future already.
            if not req.future.done():
                req.future.set_exception(ServerClosedError(
                    "server shut down before execution"))
                cancelled += 1
        if cancelled:
            self._metrics.on_shutdown_cancel(cancelled)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)

    # -- dispatch ----------------------------------------------------------

    @staticmethod
    def _phase(tl, name: str):
        """A serving phase as a scoped timeline activity (no-op without a
        timeline); QUEUE stays hand-bracketed in the loop, since a queue
        closing mid-wait must abort its op, not end it."""
        if tl is None:
            return contextlib.nullcontext()
        return tl.activity(_TIMELINE_ROW, name)

    def _dispatch_loop(self):
        tl = self._timeline
        plane = self._plane
        while True:
            if tl:
                tl.start(_TIMELINE_ROW, "INFERENCE")
                tl.activity_start(_TIMELINE_ROW, "QUEUE")
            # A tp leader's idle wait is bounded by the plane's heartbeat.
            batch = self._queue.take_batch(
                self._cfg.max_batch, self._cfg.batch_timeout_ms,
                idle_s=plane.beat_s if plane is not None else None)
            if tl:
                tl.activity_end(_TIMELINE_ROW)
            if batch is None:
                if tl:
                    tl.abort(_TIMELINE_ROW)
                plane.beat()
                continue
            if not batch:               # closed + drained
                if tl:
                    tl.abort(_TIMELINE_ROW)
                self._stop_followers()
                return
            try:
                self._run_batch(batch, tl)
            except Exception as e:  # noqa: BLE001 — deliver, don't die
                if tl:
                    tl.abort(_TIMELINE_ROW, error=repr(e))
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

    def _run_batch(self, batch, tl):
        now = time.monotonic()
        live = []
        for req in batch:
            # Claiming the future (PENDING -> RUNNING) fences a client's
            # cancel(): a future cancelled while queued is dropped here.
            if not req.future.set_running_or_notify_cancel():
                continue
            if req.expired(now):
                self._metrics.on_deadline_expired(
                    (now - req.enqueued_at) * 1e3)
                req.future.set_exception(DeadlineExceededError(
                    f"deadline expired after "
                    f"{(now - req.enqueued_at) * 1e3:.1f} ms in queue"))
            else:
                live.append(req)
        if not live:
            if tl:
                tl.end(_TIMELINE_ROW)
            return
        with self._phase(tl, "PAD"):
            bucket = bucket_for(len(live), self._buckets)
            padded = pad_rows([r.inputs for r in live], bucket)
            for i, req in enumerate(live):
                req.bucket, req.row = bucket, i
                if self._cfg.record_executed_batch:
                    req.executed_batch = padded
        with self._phase(tl, "XLA_EXECUTE"):
            t0 = time.monotonic()
            out_np = self._execute(bucket, padded)
            exec_ms = (time.monotonic() - t0) * 1e3
        with self._phase(tl, "RESPOND"):
            done = time.monotonic()
            self._metrics.on_batch(bucket, len(live), exec_ms,
                                   len(self._queue))
            for i, req in enumerate(live):
                req.future.set_result(
                    _tree_map(lambda a, i=i: a[i], out_np))
                self._metrics.on_response(
                    (done - req.enqueued_at) * 1e3,
                    (t0 - req.enqueued_at) * 1e3)
        if tl:
            tl.end(_TIMELINE_ROW, output=_leaves(out_np)[0])

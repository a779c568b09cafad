"""Serving counters and latency quantiles of the generation engine.

The subset of the JAX package's ``serve/metrics.py`` ``ServeMetrics`` that
``GenerationEngine`` calls, with the same snapshot keys: request,
overload, deadline and batch counters, and bounded-reservoir percentiles
of request latency, queue wait, decode-step time, time to first token and
per-stream decode rate. The Prometheus exposition and the per-tenant
series belong to later slices.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

from ..version import __version__


class _Reservoir:
    """Fixed-size uniform reservoir of float samples (Vitter's algorithm
    R), self-locking. The RNG is private, so sampling never perturbs
    user-visible randomness."""

    def __init__(self, capacity: int = 4096, seed: int = 0):
        self._cap = int(capacity)
        self._seen = 0
        self._vals: List[float] = []
        self._rng = random.Random(seed)
        self._rlock = threading.Lock()

    def add(self, value: float) -> None:
        with self._rlock:
            self._seen += 1
            if len(self._vals) < self._cap:
                self._vals.append(value)
                return
            j = self._rng.randrange(self._seen)
            if j < self._cap:
                self._vals[j] = value

    def quantile(self, q: float) -> Optional[float]:
        with self._rlock:
            vals = sorted(self._vals)
        if not vals:
            return None
        idx = min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))
        return vals[idx]


class ServeMetrics:
    """Thread-safe serving counters + latency recorders (one lock: the
    submitting threads and the engine loop race on every counter)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.requests_total = 0
        self.responses_total = 0
        self.rejected_overload = 0
        self.rejected_slots_full = 0
        self.rejected_blocks_exhausted = 0
        self.expired_deadline = 0
        self.cancelled_shutdown = 0
        self.batches_total = 0
        self.batch_rows_total = 0       # decode slots executed (incl. idle)
        self.batch_live_rows_total = 0  # live streams in those slots
        self.execute_seconds_total = 0.0
        self.queue_depth = 0
        self.generations_total = 0
        self.tokens_generated_total = 0
        self._request_ms = _Reservoir()
        self._queue_ms = _Reservoir(seed=1)
        self._execute_ms = _Reservoir(seed=2)
        self._ttft_ms = _Reservoir(seed=3)
        self._tps_user = _Reservoir(seed=4)

    def on_submit(self, queue_depth: int) -> None:
        with self._lock:
            self.requests_total += 1
            self.queue_depth = queue_depth

    def on_overload(self, reason: str = "slots_full") -> None:
        """``reason`` names the scarce resource: ``"slots_full"`` or
        ``"blocks_exhausted"``."""
        with self._lock:
            self.rejected_overload += 1
            if reason == "blocks_exhausted":
                self.rejected_blocks_exhausted += 1
            else:
                self.rejected_slots_full += 1

    def on_deadline_expired(self, queue_ms: float) -> None:
        with self._lock:
            self.expired_deadline += 1
            self._queue_ms.add(queue_ms)

    def on_shutdown_cancel(self, n: int) -> None:
        with self._lock:
            self.cancelled_shutdown += n

    def on_batch(self, bucket: int, live_rows: int, execute_ms: float,
                 queue_depth: int) -> None:
        """One decode step over ``bucket`` slots, ``live_rows`` of them
        generating."""
        with self._lock:
            self.batches_total += 1
            self.batch_rows_total += bucket
            self.batch_live_rows_total += live_rows
            self.execute_seconds_total += execute_ms / 1e3
            self.queue_depth = queue_depth
            self._execute_ms.add(execute_ms)

    def on_response(self, request_ms: float, queue_ms: float) -> None:
        with self._lock:
            self.responses_total += 1
            self._request_ms.add(request_ms)
            self._queue_ms.add(queue_ms)

    def on_first_token(self, ttft_ms: float) -> None:
        """Time to first token: submit → the prefill's sampled token."""
        with self._lock:
            self._ttft_ms.add(ttft_ms)

    def on_tokens(self, n: int = 1) -> None:
        with self._lock:
            self.tokens_generated_total += n

    def on_generation_end(self, n_tokens: int, seconds: float) -> None:
        """One finished stream: records its decode rate (first token →
        last token, per stream — not aggregate throughput)."""
        tps = ((n_tokens - 1) / seconds
               if n_tokens > 1 and seconds > 0 else None)
        with self._lock:
            self.generations_total += 1
            if tps is not None:
                self._tps_user.add(tps)

    def retry_after_ms(self, queue_depth: int) -> float:
        """Backoff hint for an overload rejection: how long until the
        current queue drains at the measured service rate, clamped to
        [50 ms, 30 s]; 1 s before the first response."""
        with self._lock:
            done = self.responses_total
            uptime = time.monotonic() - self._t0
        if done > 0 and uptime > 0:
            hint = (queue_depth + 1) / (done / uptime) * 1e3
        else:
            hint = 1000.0
        return min(30000.0, max(50.0, hint))

    def snapshot(self) -> Dict:
        """The ``/stats`` dict: plain ints/floats/None only (json-ready)."""
        with self._lock:
            fill = (self.batch_live_rows_total / self.batch_rows_total
                    if self.batch_rows_total else None)
            return {
                "uptime_seconds": time.monotonic() - self._t0,
                "horovod_tpu_torch_version": __version__,
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "rejected_overload": self.rejected_overload,
                "rejected_slots_full": self.rejected_slots_full,
                "rejected_blocks_exhausted": self.rejected_blocks_exhausted,
                "expired_deadline": self.expired_deadline,
                "cancelled_shutdown": self.cancelled_shutdown,
                "batches_total": self.batches_total,
                "batch_fill_ratio": fill,
                "batch_rows_total": self.batch_rows_total,
                "batch_live_rows_total": self.batch_live_rows_total,
                "execute_seconds_total": self.execute_seconds_total,
                "queue_depth": self.queue_depth,
                "latency_ms": {
                    "request_p50": self._request_ms.quantile(0.50),
                    "request_p99": self._request_ms.quantile(0.99),
                    "queue_p50": self._queue_ms.quantile(0.50),
                    "queue_p99": self._queue_ms.quantile(0.99),
                    "execute_p50": self._execute_ms.quantile(0.50),
                    "execute_p99": self._execute_ms.quantile(0.99),
                    "ttft_p50": self._ttft_ms.quantile(0.50),
                    "ttft_p99": self._ttft_ms.quantile(0.99),
                },
                "generation": {
                    "generations_total": self.generations_total,
                    "tokens_generated_total": self.tokens_generated_total,
                    "ttft_p50": self._ttft_ms.quantile(0.50),
                    "ttft_p99": self._ttft_ms.quantile(0.99),
                    "tokens_per_sec_user_p50": self._tps_user.quantile(0.50),
                    "tokens_per_sec_user_p99": self._tps_user.quantile(0.99),
                },
            }

"""Serving counters and latency quantiles of the generation engine.

The subset of the JAX package's ``serve/metrics.py`` ``ServeMetrics`` that
``GenerationEngine`` calls, with the same snapshot keys: request,
overload (split ``slots_full`` / ``blocks_exhausted`` / ``tenant_quota``),
deadline and batch counters, the prefix-cache, host-tier, chunked-prefill,
speculation and preemption counters, bounded-reservoir percentiles of
request latency, queue wait, decode-step time, time to first token,
per-stream decode rate and the speculation step's draft and verify
times, and the per-tenant split (``tenants``: TTFT, tokens, generations,
preemptions and the SLO burn of each tenant, evicted tenants folded into
``retired``). The Prometheus exposition (the ``hvd_tenant_*`` series
among it) comes with the ``/metrics`` route.
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
        self.rejected_tenant_quota = 0
        self.expired_deadline = 0
        self.cancelled_shutdown = 0
        self.batches_total = 0
        self.batch_rows_total = 0       # decode slots executed (incl. idle)
        self.batch_live_rows_total = 0  # live streams in those slots
        self.execute_seconds_total = 0.0
        self.queue_depth = 0
        self.generations_total = 0
        self.tokens_generated_total = 0
        self.prefix_hits_total = 0
        self.prefix_misses_total = 0
        self.prefix_hit_blocks_total = 0
        self.prefix_lookup_blocks_total = 0
        self.kv_offload_blocks_total = 0
        self.kv_prefetch_blocks_total = 0
        self.prefill_chunks_total = 0
        self.prefill_chunks_skipped_total = 0
        self.spec_steps_total = 0
        self.spec_draft_tokens_total = 0      # proposed by the drafter
        self.spec_accepted_tokens_total = 0   # proposals that reached streams
        self.spec_emitted_tokens_total = 0    # all tokens out of spec steps
        self._request_ms = _Reservoir()
        self._queue_ms = _Reservoir(seed=1)
        self._execute_ms = _Reservoir(seed=2)
        self._ttft_ms = _Reservoir(seed=3)
        self._tps_user = _Reservoir(seed=4)
        self._spec_draft_ms = _Reservoir(seed=5)
        self._spec_verify_ms = _Reservoir(seed=6)
        self._prefetch_ms = _Reservoir(seed=7)
        # Preemption plane: evictions and their verdicts (resumed +
        # exhausted <= preemptions while an evicted stream replays).
        self.preemptions_total = 0
        self.preempt_resumed_total = 0
        self.preempt_exhausted_total = 0
        # Per-tenant recorders, created on the first tenant-stamped
        # event; engines without an AdapterRegistry stamp none.
        self._tenants: Dict[str, Dict] = {}

    def on_submit(self, queue_depth: int) -> None:
        with self._lock:
            self.requests_total += 1
            self.queue_depth = queue_depth

    def on_overload(self, reason: str = "slots_full") -> None:
        """``reason`` names the scarce resource: ``"slots_full"``,
        ``"blocks_exhausted"`` or ``"tenant_quota"``;
        ``rejected_overload`` stays the total."""
        with self._lock:
            self.rejected_overload += 1
            if reason == "blocks_exhausted":
                self.rejected_blocks_exhausted += 1
            elif reason == "tenant_quota":
                self.rejected_tenant_quota += 1
            else:
                self.rejected_slots_full += 1

    def on_deadline_expired(self, queue_ms: float,
                            tenant: Optional[str] = None) -> None:
        """``tenant`` also counts the expiry against the tenant's SLO
        burn (a deadline miss burns, target or no target)."""
        with self._lock:
            self.expired_deadline += 1
            self._queue_ms.add(queue_ms)
            if tenant is not None:
                self._tenant(tenant)["deadline_miss_total"] += 1

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

    def _tenant(self, name: str) -> Dict:
        """The per-tenant recorder bundle (caller holds ``self._lock``)."""
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = {
                "generations_total": 0, "tokens_generated_total": 0,
                "first_tokens_total": 0, "ttft_slo_miss_total": 0,
                "deadline_miss_total": 0, "preemptions_total": 0,
                "slo_ttft_target_ms": None,
                "_ttft": _Reservoir(seed=5), "_tps": _Reservoir(seed=6)}
        return t

    @staticmethod
    def _burn(t: Dict) -> float:
        """SLO burn fraction of one tenant: misses over outcomes, a
        deadline miss counting in both (an expired request never had a
        first token)."""
        misses = t["ttft_slo_miss_total"] + t["deadline_miss_total"]
        outcomes = t["first_tokens_total"] + t["deadline_miss_total"]
        return misses / outcomes if outcomes else 0.0

    def on_first_token(self, ttft_ms: float, tenant: Optional[str] = None,
                       slo_ms: Optional[float] = None) -> None:
        """Time to first token: submit → the prefill's sampled token.
        ``tenant`` also records the per-tenant split; ``slo_ms`` is the
        tenant's TTFT target (a first token past it is one SLO miss)."""
        with self._lock:
            self._ttft_ms.add(ttft_ms)
            if tenant is not None:
                t = self._tenant(tenant)
                t["_ttft"].add(ttft_ms)
                t["first_tokens_total"] += 1
                if slo_ms is not None:
                    t["slo_ttft_target_ms"] = float(slo_ms)
                    if ttft_ms > slo_ms:
                        t["ttft_slo_miss_total"] += 1

    def on_tokens(self, n: int = 1, tenant: Optional[str] = None) -> None:
        with self._lock:
            self.tokens_generated_total += n
            if tenant is not None:
                self._tenant(tenant)["tokens_generated_total"] += n

    def on_preempt(self, outcome: str,
                   tenant: Optional[str] = None) -> None:
        """One preemption event: ``"evicted"`` (``tenant`` is the evicted
        stream's), ``"resumed"`` (its replay caught up) or
        ``"exhausted"`` (evicted past the retry budget)."""
        if outcome not in ("evicted", "resumed", "exhausted"):
            raise ValueError(
                f"preempt outcome must be 'evicted', 'resumed' or "
                f"'exhausted', got {outcome!r}")
        with self._lock:
            if outcome == "evicted":
                self.preemptions_total += 1
                if tenant is not None:
                    self._tenant(tenant)["preemptions_total"] += 1
            elif outcome == "resumed":
                self.preempt_resumed_total += 1
            else:
                self.preempt_exhausted_total += 1

    def slo_burn(self, tenant: str) -> float:
        """The tenant's SLO burn fraction (0.0 when unknown)."""
        with self._lock:
            t = self._tenants.get(tenant)
            return self._burn(t) if t is not None else 0.0

    def forget_tenant(self, tenant: str) -> None:
        """The tenant's adapter was evicted: fold its counters into the
        one ``"retired"`` bundle and drop its recorders, so tenant churn
        cannot grow the per-tenant state without bound."""
        if tenant == "retired":
            return
        with self._lock:
            t = self._tenants.pop(tenant, None)
            if t is None:
                return
            r = self._tenant("retired")
            for k in ("generations_total", "tokens_generated_total",
                      "first_tokens_total", "ttft_slo_miss_total",
                      "deadline_miss_total", "preemptions_total"):
                r[k] += t[k]

    def on_spec_step(self, proposed: int, accepted: int, emitted: int,
                     draft_ms: float, verify_ms: float) -> None:
        """One speculation-supervised decode step: ``proposed`` draft
        tokens across the batch, ``accepted`` of them emitted, plus the
        non-draft tokens, ``emitted`` in total. ``verify_ms`` is 0 for
        a no-draft step that fell through to the plain decode (its
        execute time lands in the batch reservoir either way)."""
        with self._lock:
            self.spec_steps_total += 1
            self.spec_draft_tokens_total += proposed
            self.spec_accepted_tokens_total += accepted
            self.spec_emitted_tokens_total += emitted
            self._spec_draft_ms.add(draft_ms)
            if verify_ms > 0:
                self._spec_verify_ms.add(verify_ms)

    def on_prefix(self, hit_blocks: int, prompt_blocks: int) -> None:
        """One prefix-cache lookup at admission: ``hit_blocks`` of the
        prompt's ``prompt_blocks`` full blocks were already resident."""
        with self._lock:
            if hit_blocks > 0:
                self.prefix_hits_total += 1
            else:
                self.prefix_misses_total += 1
            self.prefix_hit_blocks_total += hit_blocks
            self.prefix_lookup_blocks_total += prompt_blocks

    def on_kv_offload(self, n: int = 1) -> None:
        """``n`` cold registered-prefix blocks moved device -> host."""
        with self._lock:
            self.kv_offload_blocks_total += n

    def on_kv_prefetch(self, seconds: float, n: int = 1) -> None:
        """``n`` blocks landed host -> device; ``seconds`` is the
        stage-to-landing latency of the chain (admission staged the
        fetch, the engine loop's top applied it — never a decode
        step)."""
        with self._lock:
            self.kv_prefetch_blocks_total += n
            self._prefetch_ms.add(seconds * 1e3)

    def on_chunked_prefill(self, n_chunks: int, n_skipped: int) -> None:
        """One chunked prefill: ``n_chunks`` chunks ran and the prefix
        cache let it skip ``n_skipped`` more (the shared prefix it never
        recomputed)."""
        with self._lock:
            self.prefill_chunks_total += n_chunks
            self.prefill_chunks_skipped_total += n_skipped

    def on_generation_end(self, n_tokens: int, seconds: float,
                          tenant: Optional[str] = None) -> None:
        """One finished stream: records its decode rate (first token →
        last token, per stream — not aggregate throughput); ``tenant``
        also records the per-tenant split."""
        tps = ((n_tokens - 1) / seconds
               if n_tokens > 1 and seconds > 0 else None)
        with self._lock:
            self.generations_total += 1
            if tps is not None:
                self._tps_user.add(tps)
            if tenant is not None:
                t = self._tenant(tenant)
                t["generations_total"] += 1
                if tps is not None:
                    t["_tps"].add(tps)

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
                "rejected_tenant_quota": self.rejected_tenant_quota,
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
                    "prefix_hits_total": self.prefix_hits_total,
                    "prefix_misses_total": self.prefix_misses_total,
                    "prefix_hit_blocks_total": self.prefix_hit_blocks_total,
                    "prefix_lookup_blocks_total":
                        self.prefix_lookup_blocks_total,
                    "kv_offload_blocks_total": self.kv_offload_blocks_total,
                    "kv_prefetch_blocks_total":
                        self.kv_prefetch_blocks_total,
                    "kv_prefetch_ms_p50": self._prefetch_ms.quantile(0.50),
                    "prefill_chunks_total": self.prefill_chunks_total,
                    "prefill_chunks_skipped_total":
                        self.prefill_chunks_skipped_total,
                    "preemptions_total": self.preemptions_total,
                    "preempt_resumed_total": self.preempt_resumed_total,
                    "preempt_exhausted_total":
                        self.preempt_exhausted_total,
                    "ttft_p50": self._ttft_ms.quantile(0.50),
                    "ttft_p99": self._ttft_ms.quantile(0.99),
                    "tokens_per_sec_user_p50": self._tps_user.quantile(0.50),
                    "tokens_per_sec_user_p99": self._tps_user.quantile(0.99),
                },
                # Speculation: acceptance over proposed drafts and the
                # effective tokens a step (> 1.0: beating one-token decode).
                "spec": {
                    "steps_total": self.spec_steps_total,
                    "draft_tokens_total": self.spec_draft_tokens_total,
                    "accepted_tokens_total":
                        self.spec_accepted_tokens_total,
                    "emitted_tokens_total":
                        self.spec_emitted_tokens_total,
                    "accept_rate": (
                        self.spec_accepted_tokens_total
                        / self.spec_draft_tokens_total
                        if self.spec_draft_tokens_total else None),
                    "tokens_per_step": (
                        self.spec_emitted_tokens_total
                        / self.spec_steps_total
                        if self.spec_steps_total else None),
                    "draft_ms_p50": self._spec_draft_ms.quantile(0.50),
                    "draft_ms_p99": self._spec_draft_ms.quantile(0.99),
                    "verify_ms_p50": self._spec_verify_ms.quantile(0.50),
                    "verify_ms_p99": self._spec_verify_ms.quantile(0.99),
                },
                # Per-tenant split: the numbers a per-tenant SLO is
                # written against (empty without tenant-stamped events).
                "tenants": {
                    name: {
                        "generations_total": t["generations_total"],
                        "tokens_generated_total":
                            t["tokens_generated_total"],
                        "first_tokens_total": t["first_tokens_total"],
                        "ttft_slo_miss_total": t["ttft_slo_miss_total"],
                        "deadline_miss_total": t["deadline_miss_total"],
                        "preemptions_total": t["preemptions_total"],
                        "slo_ttft_target_ms": t["slo_ttft_target_ms"],
                        "slo_burn": self._burn(t),
                        "ttft_p50": t["_ttft"].quantile(0.50),
                        "ttft_p99": t["_ttft"].quantile(0.99),
                        "tokens_per_sec_user_p50":
                            t["_tps"].quantile(0.50),
                        "tokens_per_sec_user_p99":
                            t["_tps"].quantile(0.99),
                    } for name, t in sorted(self._tenants.items())},
            }

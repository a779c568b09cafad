"""Serving observability: counters, latency quantiles, batch fill, and
their Prometheus exposition.

Port of the JAX package's ``serve/metrics.py``, with the same snapshot
keys: request, overload (split
``slots_full`` / ``blocks_exhausted`` / ``tenant_quota``), deadline and
batch counters, the prefix-cache, host-tier, chunked-prefill,
speculation and preemption counters, bounded-reservoir percentiles of
request latency, queue wait, execute time, time to first token,
per-stream decode rate and the speculation step's draft and verify
times, and the per-tenant split (``tenants``; evicted tenants folded
into ``retired``). Each engine's :class:`ServeMetrics` also carries a
private :class:`~..obs.registry.MetricsRegistry` with the reference's
histograms and ``hvd_tenant_*`` series (names, help strings, buckets,
labels); :func:`collect_stats` maps a ``/stats`` snapshot onto the
stable ``hvd_*`` series and merges them, each sample labelled
``engine=``, for the ``/metrics`` route. :class:`FleetMetrics` is the
fleet router's own series: membership by state, dispatch by replica,
scale events, strands and failover outcomes, adapter and prefix
affinity, subprocess members.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..obs.registry import Meta, MetricsRegistry, Sample
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
    submitting threads and the engine loop race on every counter), and
    the engine's private Prometheus registry: two engines in one process
    must not share series. The reservoirs feed the ``/stats``
    percentiles; the histograms are what a scraper aggregates."""

    # Bucket bounds of the per-user decode rate (tokens/s): not a
    # latency, so the latency default would waste every bucket under 1.
    TPS_BUCKETS = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000)

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.registry = MetricsRegistry()
        self._h_request = self.registry.histogram(
            "hvd_request_seconds", "End-to-end request latency")
        self._h_queue = self.registry.histogram(
            "hvd_queue_seconds", "Time from submit to execution start")
        self._h_execute = self.registry.histogram(
            "hvd_execute_seconds", "Device batch execution time")
        self._h_ttft = self.registry.histogram(
            "hvd_generate_ttft_seconds",
            "Time to first token (submit to the prefill's sampled "
            "token)")
        self._h_tps = self.registry.histogram(
            "hvd_generate_tokens_per_sec_user",
            "Per-stream decode rate (first token to last)",
            buckets=self.TPS_BUCKETS)
        # Per-tenant series: one label, bounded by the resident adapters
        # + "base" + "retired", never by the user count.
        self._h_tenant_ttft = self.registry.histogram(
            "hvd_tenant_ttft_seconds",
            "Per-tenant time to first token", labels=("tenant",))
        self._h_tenant_tps = self.registry.histogram(
            "hvd_tenant_tokens_per_sec_user",
            "Per-tenant per-stream decode rate", labels=("tenant",),
            buckets=self.TPS_BUCKETS)
        self._c_tenant_generations = self.registry.counter(
            "hvd_tenant_generations_total",
            "Generation streams finished, by tenant", labels=("tenant",))
        self._c_tenant_tokens = self.registry.counter(
            "hvd_tenant_tokens_generated_total",
            "Tokens sampled, by tenant", labels=("tenant",))
        # SLO burn against the tenant's own targets: the series exist
        # only for tenants that declared an SLO or missed a deadline.
        self._c_tenant_slo_ttft_miss = self.registry.counter(
            "hvd_tenant_slo_ttft_miss_total",
            "First tokens later than the tenant's TTFT SLO target",
            labels=("tenant",))
        self._c_tenant_slo_deadline_miss = self.registry.counter(
            "hvd_tenant_slo_deadline_miss_total",
            "Requests expired past their deadline, by tenant",
            labels=("tenant",))
        self._g_tenant_slo_burn = self.registry.gauge(
            "hvd_tenant_slo_burn",
            "Fraction of the tenant's outcomes that burned its SLO "
            "(TTFT misses + deadline misses over completions + "
            "deadline misses)", labels=("tenant",))
        self._g_tenant_slo_target = self.registry.gauge(
            "hvd_tenant_slo_ttft_target_ms",
            "The tenant's configured TTFT SLO target",
            labels=("tenant",))
        self._h_spec_draft = self.registry.histogram(
            "hvd_spec_draft_seconds",
            "Host-side draft proposal time per spec step")
        self._h_spec_verify = self.registry.histogram(
            "hvd_spec_verify_seconds",
            "Verify-forward execution time per spec step")
        self._h_prefetch = self.registry.histogram(
            "hvd_kv_prefetch_seconds",
            "Host-to-device prefetch latency per block chain")
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
                self._refresh_burn(tenant)
        if tenant is not None:
            self._c_tenant_slo_deadline_miss.labels(tenant=tenant).inc()

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
        self._h_execute.observe(execute_ms / 1e3)

    def on_response(self, request_ms: float, queue_ms: float) -> None:
        with self._lock:
            self.responses_total += 1
            self._request_ms.add(request_ms)
            self._queue_ms.add(queue_ms)
        self._h_request.observe(request_ms / 1e3)
        self._h_queue.observe(queue_ms / 1e3)

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

    def _refresh_burn(self, tenant: str) -> None:
        """Re-publish the tenant's burn gauge (caller holds the lock)."""
        self._g_tenant_slo_burn.labels(tenant=tenant).set(
            self._burn(self._tenants[tenant]))

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
                missed = slo_ms is not None and ttft_ms > slo_ms
                if slo_ms is not None:
                    t["slo_ttft_target_ms"] = float(slo_ms)
                    self._g_tenant_slo_target.labels(
                        tenant=tenant).set(float(slo_ms))
                if missed:
                    t["ttft_slo_miss_total"] += 1
                self._refresh_burn(tenant)
        self._h_ttft.observe(ttft_ms / 1e3)
        if tenant is not None:
            self._h_tenant_ttft.labels(tenant=tenant).observe(ttft_ms / 1e3)
            if missed:
                self._c_tenant_slo_ttft_miss.labels(tenant=tenant).inc()

    def on_tokens(self, n: int = 1, tenant: Optional[str] = None) -> None:
        with self._lock:
            self.tokens_generated_total += n
            if tenant is not None:
                self._tenant(tenant)["tokens_generated_total"] += n
        if tenant is not None:
            self._c_tenant_tokens.labels(tenant=tenant).inc(n)

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
        one ``"retired"`` bundle and series and drop its recorders and
        labelled series, so tenant churn cannot grow the per-tenant state
        without bound (counters stay monotone through the fold; histogram
        children end)."""
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
        for metric in (self._c_tenant_generations, self._c_tenant_tokens,
                       self._c_tenant_slo_ttft_miss,
                       self._c_tenant_slo_deadline_miss):
            count = metric.labels(tenant=tenant).value
            metric.remove(tenant=tenant)
            if count > 0:
                metric.labels(tenant="retired").inc(count)
        self._h_tenant_ttft.remove(tenant=tenant)
        self._h_tenant_tps.remove(tenant=tenant)
        self._g_tenant_slo_burn.remove(tenant=tenant)
        self._g_tenant_slo_target.remove(tenant=tenant)

    def ttft_totals(self) -> Tuple[float, int]:
        """Cumulative ``(seconds_sum, count)`` of the TTFT histogram (what
        a scraper's ``rate(_sum)/rate(_count)`` differences)."""
        return self._h_ttft.sum, self._h_ttft.count

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
        self._h_spec_draft.observe(draft_ms / 1e3)
        if verify_ms > 0:
            self._h_spec_verify.observe(verify_ms / 1e3)

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
        self._h_prefetch.observe(seconds)

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
                self._h_tps.observe(tps)
            if tenant is not None:
                t = self._tenant(tenant)
                t["generations_total"] += 1
                if tps is not None:
                    t["_tps"].add(tps)
        if tenant is not None:
            self._c_tenant_generations.labels(tenant=tenant).inc()
            if tps is not None:
                self._h_tenant_tps.labels(tenant=tenant).observe(tps)

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
                # The reference's key: it feeds hvd_build_info.
                "horovod_tpu_version": __version__,
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


class FleetMetrics:
    """The fleet plane's own series, in a private registry (the engines'
    rule: two metric surfaces in one process must not collide), with
    the JAX package's names:

    * ``hvd_fleet_replicas{state=}``: membership by state (``ready``,
      ``warming``, ``draining``, ``dead``);
    * ``hvd_fleet_dispatch_total{replica=}``: requests routed to each
      replica (least-depth dispatch keeps these roughly level; a skew
      means a sick replica); a retired replica's count folds into
      ``replica="retired"``;
    * ``hvd_fleet_scale_events_total{direction=}``: autoscaler changes
      committed (``grow``, ``shrink``), pre-seeded at 0;
    * ``hvd_streams_stranded_total``: streams whose replica died (or
      aborted) with the stream in flight;
    * ``hvd_failover_total{outcome=}``: ``resumed`` (re-dispatched and
      the replayed prefix verified) or ``exhausted`` (the retry budget,
      the overload window, or a diverging replay), pre-seeded at 0 and
      kept apart from the overload counters. ``stranded`` can exceed
      ``resumed + exhausted``: a stranded stream that meets its own
      verdict mid-failover (deadline, fleet shutdown) is counted there;
    * lazily, on first use: ``hvd_fleet_adapters_resident``,
      ``hvd_fleet_adapter_dispatch_total{outcome=}``,
      ``hvd_fleet_prefix_dispatch_total{outcome=}`` and
      ``hvd_fleet_replica_procs`` (a thread-only, adapter-free fleet
      exposes none of them).
    """

    def __init__(self):
        self.registry = MetricsRegistry()
        self._g_replicas = self.registry.gauge(
            "hvd_fleet_replicas", "Fleet membership by replica state",
            labels=("state",))
        self._c_dispatch = self.registry.counter(
            "hvd_fleet_dispatch_total",
            "Requests dispatched to each replica", labels=("replica",))
        self._c_scale = self.registry.counter(
            "hvd_fleet_scale_events_total",
            "Autoscaler membership changes committed",
            labels=("direction",))
        for direction in ("grow", "shrink"):
            self._c_scale.labels(direction=direction)
        self._c_stranded = self.registry.counter(
            "hvd_streams_stranded_total",
            "Streams whose replica died with the stream in flight")
        self._c_failover = self.registry.counter(
            "hvd_failover_total",
            "Stranded-stream failover outcomes", labels=("outcome",))
        for outcome in ("resumed", "exhausted"):
            self._c_failover.labels(outcome=outcome)
        self._g_adapters = None
        self._c_adapter_dispatch = None
        self._c_prefix_dispatch = None
        self._g_procs = None
        self._replica_names: List[str] = []
        self._retired_names: set = set()
        # One lock over the dispatch fold: read, remove and re-add in
        # forget_replica must not interleave with an on_dispatch racing
        # a drain, or the raced increment is lost and the fleet total
        # goes backwards.
        self._fold_lock = threading.Lock()

    def on_dispatch(self, replica: str) -> None:
        with self._fold_lock:
            if replica in self._retired_names:
                # The dispatch raced an eviction: the request was served
                # there; credit the retired aggregate instead of
                # resurrecting a folded series nothing would fold again.
                replica = "retired"
            if replica not in self._replica_names:
                self._replica_names.append(replica)
            self._c_dispatch.labels(replica=replica).inc()

    def forget_replica(self, name: str) -> None:
        """A replica left the membership: fold its dispatch count into
        ``replica="retired"`` and drop its series. Names are never
        reused, so without the fold an autoscaling fleet would grow a
        dead series a cycle; the fleet total stays monotone and the
        cardinality at live replicas + 1."""
        with self._fold_lock:
            self._retired_names.add(name)
            if name not in self._replica_names:
                return
            count = self._c_dispatch.labels(replica=name).value
            self._c_dispatch.remove(replica=name)
            self._replica_names.remove(name)
            if count > 0:
                if "retired" not in self._replica_names:
                    self._replica_names.append("retired")
                self._c_dispatch.labels(replica="retired").inc(count)

    def set_adapters_resident(self, count: Optional[int]) -> None:
        """``hvd_fleet_adapters_resident``: distinct adapters resident
        across the live membership (None: no replica has a registry; the
        series stays absent until one does)."""
        if count is None and self._g_adapters is None:
            return
        if self._g_adapters is None:
            self._g_adapters = self.registry.gauge(
                "hvd_fleet_adapters_resident",
                "Distinct LoRA adapters resident across live replicas")
        self._g_adapters.set(int(count or 0))

    def set_replica_procs(self, count: int) -> None:
        """``hvd_fleet_replica_procs``: live members backed by a
        subprocess worker (engines exposing a ``pid``); absent from a
        thread-only fleet, so its presence is the topology signal."""
        if count <= 0 and self._g_procs is None:
            return
        if self._g_procs is None:
            self._g_procs = self.registry.gauge(
                "hvd_fleet_replica_procs",
                "Fleet members backed by a subprocess replica worker")
        self._g_procs.set(int(count))

    def on_adapter_dispatch(self, outcome: str) -> None:
        """One adapter-carrying dispatch: ``affine`` (the replica had the
        adapter resident) or ``miss`` (lazy-loaded on dispatch)."""
        if outcome not in ("affine", "miss"):
            raise ValueError(
                f"adapter dispatch outcome must be 'affine' or 'miss', "
                f"got {outcome!r}")
        if self._c_adapter_dispatch is None:
            self._c_adapter_dispatch = self.registry.counter(
                "hvd_fleet_adapter_dispatch_total",
                "Adapter-carrying dispatches by affinity outcome",
                labels=("outcome",))
            for o in ("affine", "miss"):
                self._c_adapter_dispatch.labels(outcome=o)
        self._c_adapter_dispatch.labels(outcome=outcome).inc()

    def adapter_dispatch_counts(self) -> Dict[str, int]:
        if self._c_adapter_dispatch is None:
            return {}
        return {o: int(self._c_adapter_dispatch.labels(outcome=o).value)
                for o in ("affine", "miss")}

    def on_prefix_dispatch(self, outcome: str) -> None:
        """One dispatch whose prompt carried a routable prefix digest:
        ``affine`` (the replica advertised it) or ``miss`` (it will
        prefill the prefix cold)."""
        if outcome not in ("affine", "miss"):
            raise ValueError(
                f"prefix dispatch outcome must be 'affine' or 'miss', "
                f"got {outcome!r}")
        if self._c_prefix_dispatch is None:
            self._c_prefix_dispatch = self.registry.counter(
                "hvd_fleet_prefix_dispatch_total",
                "Prefix-carrying dispatches by affinity outcome",
                labels=("outcome",))
            for o in ("affine", "miss"):
                self._c_prefix_dispatch.labels(outcome=o)
        self._c_prefix_dispatch.labels(outcome=outcome).inc()

    def prefix_dispatch_counts(self) -> Dict[str, int]:
        if self._c_prefix_dispatch is None:
            return {}
        return {o: int(self._c_prefix_dispatch.labels(outcome=o).value)
                for o in ("affine", "miss")}

    def on_stranded(self, n: int = 1) -> None:
        """``n`` streams were stranded by a replica's death or abort."""
        self._c_stranded.inc(n)

    def on_failover(self, outcome: str) -> None:
        """One stranded stream's failover verdict: ``resumed`` or
        ``exhausted``."""
        if outcome not in ("resumed", "exhausted"):
            raise ValueError(
                f"failover outcome must be 'resumed' or 'exhausted', "
                f"got {outcome!r}")
        self._c_failover.labels(outcome=outcome).inc()

    def failover_counts(self) -> Dict[str, int]:
        return {o: int(self._c_failover.labels(outcome=o).value)
                for o in ("resumed", "exhausted")}

    def stranded_count(self) -> int:
        return int(self._c_stranded.value)

    def on_scale(self, direction: str) -> None:
        if direction not in ("grow", "shrink"):
            raise ValueError(
                f"scale direction must be 'grow' or 'shrink', got "
                f"{direction!r}")
        self._c_scale.labels(direction=direction).inc()

    def set_replicas(self, counts: Dict[str, int]) -> None:
        """Refresh the membership gauge; every state is set (absent ones
        to 0), so a shrink shows as ready going down."""
        for state in ("ready", "warming", "draining", "dead"):
            self._g_replicas.labels(state=state).set(counts.get(state, 0))

    def dispatch_counts(self) -> Dict[str, int]:
        with self._fold_lock:
            return {name: int(self._c_dispatch.labels(replica=name).value)
                    for name in self._replica_names}

    def scale_counts(self) -> Dict[str, int]:
        return {d: int(self._c_scale.labels(direction=d).value)
                for d in ("grow", "shrink")}


# -- Prometheus exposition of the serving plane (the /metrics route) ---------
#
# Everything /stats knows, renamed onto the stable hvd_* series of the
# reference's inventory and merged with the ServeMetrics histograms. The
# map is explicit: series names are an API, and a renamed snapshot key
# must break here, not rename a series every dashboard keys on.

# snapshot key -> (series name, type, help)
_TOP = {
    "uptime_seconds": ("hvd_uptime_seconds", "gauge",
                       "Seconds since this engine's metrics started"),
    "requests_total": ("hvd_requests_total", "counter",
                       "Requests admitted to the queue"),
    "responses_total": ("hvd_responses_total", "counter",
                        "Requests answered successfully"),
    "rejected_overload": ("hvd_rejected_overload_total", "counter",
                          "Requests rejected at the door (all reasons)"),
    "expired_deadline": ("hvd_expired_deadline_total", "counter",
                         "Requests dropped at dequeue past deadline"),
    "cancelled_shutdown": ("hvd_cancelled_shutdown_total", "counter",
                           "Requests cancelled by non-drain shutdown"),
    "batches_total": ("hvd_batches_total", "counter",
                      "Device batches executed"),
    "batch_rows_total": ("hvd_batch_rows_total", "counter",
                         "Bucket slots executed (padding included)"),
    "batch_live_rows_total": ("hvd_batch_live_rows_total", "counter",
                              "Live request rows executed"),
    "batch_fill_ratio": ("hvd_batch_fill_ratio", "gauge",
                         "Live rows / executed rows (cumulative)"),
    "queue_depth": ("hvd_queue_depth", "gauge",
                    "Admission queue depth at last event"),
    "max_queue": ("hvd_max_queue", "gauge", "Admission queue capacity"),
    "max_slots": ("hvd_max_slots", "gauge", "Decode slots configured"),
    "max_len": ("hvd_max_len", "gauge", "KV positions per stream"),
    "active_slots": ("hvd_active_slots", "gauge",
                     "Streams mid-generation right now"),
    "peak_active_slots": ("hvd_peak_active_slots", "gauge",
                          "High-water concurrent streams"),
    "prefix_hit_rate": ("hvd_prefix_hit_rate", "gauge",
                        "Prefix-cache lookup hit rate"),
    "block_size": ("hvd_kv_block_size", "gauge",
                   "Tokens per KV block (paged layout)"),
    "adapters_resident": ("hvd_adapters_resident", "gauge",
                          "LoRA adapters resident in the device table"),
    "spec_k": ("hvd_spec_k", "gauge",
               "Max draft tokens per decode step (0 = speculation off)"),
}

_GENERATION = {
    "generations_total": ("hvd_generations_total", "counter",
                          "Generation streams finished"),
    "tokens_generated_total": ("hvd_tokens_generated_total", "counter",
                               "Tokens sampled across all streams"),
    "prefix_hits_total": ("hvd_prefix_hits_total", "counter",
                          "Prefix-cache lookups with >=1 resident block"),
    "prefix_misses_total": ("hvd_prefix_misses_total", "counter",
                            "Prefix-cache lookups with no resident block"),
    "prefix_hit_blocks_total": ("hvd_prefix_hit_blocks_total", "counter",
                                "Prompt blocks served from the prefix "
                                "cache"),
    "prefix_lookup_blocks_total": ("hvd_prefix_lookup_blocks_total",
                                   "counter",
                                   "Prompt blocks looked up"),
    "kv_offload_blocks_total": ("hvd_kv_offload_blocks_total", "counter",
                                "KV blocks offloaded device -> host"),
    "kv_prefetch_blocks_total": ("hvd_kv_prefetch_blocks_total", "counter",
                                 "KV blocks prefetched host -> device"),
    "prefill_chunks_total": ("hvd_prefill_chunks_total", "counter",
                             "Prefill scan chunks executed"),
    "prefill_chunks_skipped_total": ("hvd_prefill_chunks_skipped_total",
                                     "counter",
                                     "Prefill scan chunks skipped via "
                                     "prefix hits"),
    "preemptions_total": ("hvd_preemptions_total", "counter",
                          "Streams evicted from a decode slot by a "
                          "higher-priority admission"),
    "preempt_resumed_total": ("hvd_preempt_resumed_total", "counter",
                              "Preempted streams resumed "
                              "bit-identically"),
    "preempt_exhausted_total": ("hvd_preempt_exhausted_total", "counter",
                                "Preempted streams terminated on their "
                                "retry budget"),
}

_SPEC = {
    "steps_total": ("hvd_spec_steps_total", "counter",
                    "Decode steps supervised by speculation"),
    "draft_tokens_total": ("hvd_spec_draft_tokens_total", "counter",
                           "Draft tokens proposed"),
    "accepted_tokens_total": ("hvd_spec_accepted_tokens_total", "counter",
                              "Draft tokens accepted into streams"),
    "emitted_tokens_total": ("hvd_spec_emitted_tokens_total", "counter",
                             "Tokens emitted by speculation-supervised "
                             "steps"),
    "accept_rate": ("hvd_spec_accept_rate", "gauge",
                    "Accepted / proposed draft tokens (cumulative)"),
    "tokens_per_step": ("hvd_spec_tokens_per_step", "gauge",
                        "Effective tokens per decode step (cumulative)"),
}

_BLOCKS = {
    "total": ("hvd_kv_blocks_total", "gauge",
              "Usable KV blocks in the pool"),
    "free": ("hvd_kv_blocks_free", "gauge", "KV blocks free right now"),
    "used": ("hvd_kv_blocks_used", "gauge", "KV blocks allocated"),
    "registered_prefix_blocks": ("hvd_kv_prefix_registered_blocks",
                                 "gauge",
                                 "Blocks pinned by the prefix registry"),
}


def _number(v) -> bool:
    return v is not None and not isinstance(v, bool) \
        and isinstance(v, (int, float))


def collect_stats(snap: Dict, registry: MetricsRegistry,
                  engine: str) -> Tuple[Meta, List[Sample]]:
    """One engine's ``(meta, samples)`` for the exposition renderer
    (:func:`~..obs.registry.render`): the ``/stats`` snapshot mapped onto
    the stable series names, the rejection split as a labelled counter,
    the build info, and the registry's histograms and tenant series —
    every sample labelled ``engine=<engine>``, so two engines merge into
    one valid scrape."""
    labels = {"engine": engine}
    meta: Meta = {}
    samples: List[Sample] = []

    def emit(table: Dict, src: Dict) -> None:
        for key, (name, typ, help_) in table.items():
            v = src.get(key)
            if not _number(v):
                continue
            meta[name] = (typ, help_)
            samples.append((name, dict(labels), float(v)))

    emit(_TOP, snap)
    emit(_GENERATION, snap.get("generation") or {})
    emit(_SPEC, snap.get("spec") or {})
    blocks = snap.get("blocks") or {}
    emit(_BLOCKS, blocks)
    # The tier= split of the block gauges: the unlabelled series stay the
    # device pool; tier= samples count every block across the hierarchy.
    for dev_key, host_key in (("total", "host_total"), ("free", "host_free"),
                              ("used", "host_used")):
        if host_key not in blocks:
            continue
        name = _BLOCKS[dev_key][0]
        for tier, key in (("device", dev_key), ("host", host_key)):
            if _number(blocks.get(key)):
                samples.append((name, {**labels, "tier": tier},
                                float(blocks[key])))
    meta["hvd_rejected_total"] = (
        "counter", "Door rejections split by the scarce resource")
    for key, reason in (("rejected_slots_full", "slots_full"),
                        ("rejected_blocks_exhausted", "blocks_exhausted"),
                        ("rejected_tenant_quota", "tenant_quota")):
        if key in snap:
            samples.append(("hvd_rejected_total",
                            {**labels, "reason": reason}, float(snap[key])))
    version = snap.get("horovod_tpu_version")
    if version:
        meta["hvd_build_info"] = (
            "gauge", "Constant 1, labeled with the serving build")
        samples.append(("hvd_build_info",
                        {**labels, "version": str(version)}, 1.0))
    h_meta, h_samples = registry.collect(const_labels=labels)
    meta.update(h_meta)
    samples.extend(h_samples)
    return meta, samples

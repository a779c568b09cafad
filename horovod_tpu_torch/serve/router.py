"""Replica membership and admission routing for a serving fleet.

Port of the JAX package's ``serve/router.py``, with its names, defaults,
error messages, snapshot keys and metric series. One
:class:`~.generate.GenerationEngine` (or single-shot
:class:`~.engine.Engine`) is a *replica*: one decode batch over its own
slots and KV pool. :class:`FleetRouter` is one front door that owns
admission for the whole fleet and fans requests out to N replicas.

Design rules, each load-bearing:

* **The router is the single admission point, not a second buffer.**
  Every replica owns a bounded admission queue that rejects at the door;
  a router queue in front of those would strand requests when their
  replica dies and hide queue pressure from the autoscaler. Admission
  happens once, at :meth:`FleetRouter.submit`: the least-loaded READY
  replica, falling over to the next if its door is shut. The fleet
  rejects only when EVERY ready replica rejected.
* **Least-queue-depth dispatch reads the metrics the replicas already
  export.** :meth:`ReadinessMixin.load` is the number ``/metrics``
  publishes as ``hvd_queue_depth`` (+ active decode rows).
* **Readiness is the ``/healthz`` contract, per replica.** A ``warming``
  replica (built, ``warmup()`` still running) takes no traffic; a
  ``draining`` one takes no new traffic but finishes every stream it
  admitted, so a scale-down never loses an admitted stream.
* **Liveness is the replica's own probe.** A thread replica answers
  :meth:`~.generate.GenerationEngine.loop_alive` (loop death, or a loop
  alive but wedged mid-stream); a subprocess replica
  (:class:`~.proc_replica.ProcReplicaClient`) the same probe from its pid,
  a heartbeat file and ``/healthz``; ``liveness=`` takes any other
  verdict (:func:`~.fleet.heartbeat_liveness`). The router evicts on it.
* **A dead replica strands no stream: deterministic failover.** The
  router records every admitted generation stream's submission envelope
  (prompt, sampling and seed, max_new, eos, adapter, the ABSOLUTE
  deadline resolved at submit) and the tokens already relayed to the
  client. When a replica is declared dead (liveness verdict, loop death,
  or a stream-level engine failure), its in-flight streams are
  re-dispatched to surviving ready replicas and replayed from the
  envelope: seeded generation makes the replayed tokens bitwise the
  same, the already-emitted prefix is suppressed and VERIFIED token by
  token (a diverging replay fails loudly), so the client's one chunked
  HTTP response simply continues. The replay keeps the submit-time
  deadline. A per-stream retry budget with backoff bounds the churn: a
  stream that failed on its budget's worth of replicas ends with
  :class:`~..exceptions.FailoverExhaustedError`
  (``hvd_failover_total{outcome="exhausted"}``, apart from overload).
  Single-shot (``Future``) fleets keep fail-fast: only generation
  streams carry enough determinism to resume.

The router duck-types the engine surface (``submit``, ``generate``,
``infer``, ``stats``, ``health``, ``prom_collect``, ``warmup``,
``shutdown``), so :class:`~.server.HttpServer` mounts a fleet where it
mounts one engine: ``POST /generate`` routes through the router,
``GET /metrics`` merges every replica's samples (each with a
``replica=`` label) with the fleet series into ONE valid exposition,
``GET /healthz`` reports fleet readiness (>= 1 ready replica) with the
membership breakdown.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..exceptions import (DeadlineExceededError, FailoverExhaustedError,
                          PreemptedError, ReplicaTimeoutError,
                          ServerClosedError, ServerOverloadedError,
                          WorkerFailureError)
from ..obs import flightrec
from ..parallel.kv_blocks import prefix_route_digest
from .generate import GenerationHandle
from .metrics import FleetMetrics

_log = logging.getLogger("horovod_tpu_torch.serve.fleet")

# Replica states, in dispatch-priority order of meaning:
#   warming  — engine exists, warmup() not finished: takes NO traffic
#   ready    — routable
#   draining — scale-down in progress: finishes admitted streams, no new
#   dead     — liveness said gone (heartbeat abort / loop thread died)
REPLICA_STATES = ("ready", "warming", "draining", "dead")


class ReplicaHandle:
    """One fleet member: a name, an engine, and the membership verdicts
    the router needs (state, load, liveness).

    ``liveness`` is an optional zero-arg callable returning False once
    the replica's backing process is gone — for multi-process replicas
    this is the coord heartbeat plane
    (:func:`~.fleet.heartbeat_liveness`); thread replicas default to
    the engine's in-process probe
    (:meth:`~.generate.GenerationEngine.loop_alive` where the engine
    has one — it catches a loop that is alive but WEDGED mid-stream,
    ``stall_timeout_s`` being the staleness verdict — else the loop
    thread's plain aliveness). The handle never invents its own poller.
    """

    def __init__(self, name: str, engine: Any,
                 liveness: Optional[Callable[[], bool]] = None,
                 stall_timeout_s: float = 60.0):
        self.name = name
        self.engine = engine
        self._liveness = liveness
        self._stall_timeout = stall_timeout_s
        self._draining = False
        self._dead = False
        self._drain_thread: Optional[threading.Thread] = None

    def alive(self) -> bool:
        if self._dead:
            return False
        if self._liveness is not None:
            try:
                return bool(self._liveness())
            except Exception:  # noqa: BLE001 — a broken probe is "gone"
                return False
        # Thread replicas: the engine's own loop-beat probe where it has
        # one (thread death AND a beat stale past stall_timeout_s with
        # work pending both read dead) …
        la = getattr(self.engine, "loop_alive", None)
        if callable(la):
            try:
                return bool(la(self._stall_timeout))
            except Exception:  # noqa: BLE001 — a broken probe is "gone"
                return False
        # … else the loop thread is the ground truth — it only exits on
        # drain-complete or abort, both terminal.
        thread = getattr(self.engine, "_thread", None)
        if thread is not None and not thread.is_alive() \
                and not getattr(self.engine, "_closed", False):
            return False
        return True

    def state(self) -> str:
        if not self.alive():
            return "dead"
        if self._draining or getattr(self.engine, "_closed", False):
            return "draining"
        ready, _, _ = self.engine.health()
        return "ready" if ready else "warming"

    def load(self) -> int:
        """Dispatch pressure: queued + executing rows — the same number
        this replica's ``/metrics`` exports (``hvd_queue_depth`` +
        ``hvd_active_slots``).

        A generic stats-surface failure reads as the busy sentinel
        (route around it; the liveness plane owns the dead verdict on
        its own cadence). A transport TIMEOUT is different: for a
        subprocess replica it means the child may be HUNG, and the busy
        sentinel alone would route around a wedged process forever —
        so the handle marks the engine suspect and runs an immediate
        liveness check, turning a hung child into a dead handle within
        one poll."""
        try:
            return int(self.engine.load())
        except ReplicaTimeoutError:
            suspect = getattr(self.engine, "mark_suspect", None)
            if callable(suspect):
                try:
                    suspect()
                except Exception:  # noqa: BLE001 — advisory only
                    pass
            if not self.alive():
                self._dead = True
            return 1 << 30
        except Exception:  # noqa: BLE001 — a dying replica reads as busy
            return 1 << 30


class _FleetStream:
    """One tracked generation stream: the client-facing handle, the full
    submission envelope for deterministic replay, and the replay
    bookkeeping (tokens already relayed, the suppression cursor over
    them, the retry budget used). The pump thread owns all mutation
    after construction; the sweeper only reads ``inner`` (under the
    router's stream lock) to deliver a death verdict."""

    __slots__ = ("sid", "args", "kwargs", "deadline_at", "inner",
                 "client", "expect", "expect_i", "retries",
                 "replica", "unconfirmed")

    def __init__(self, sid: int, args: tuple, kwargs: dict,
                 deadline_at: Optional[float], inner: GenerationHandle):
        self.sid = sid
        self.args = args
        self.kwargs = kwargs                 # WITHOUT a rewritten deadline
        self.deadline_at = deadline_at       # absolute, resolved at submit
        self.inner = inner                   # current replica-side handle
        self.client = GenerationHandle()     # what the caller holds
        # (Tokens already relayed to the client live in
        # ``client._tokens`` — the pump is the only writer, so a second
        # copy here would just be an invariant to keep in sync.)
        self.expect: List[int] = []          # replay-suppression reference
        self.expect_i = 0
        self.retries = 0
        self.replica: Optional[str] = None   # current host replica name
        # Re-dispatches whose replayed prefix has not yet VERIFIED: the
        # "resumed" outcome is only counted once the replay catches up
        # to the client's emitted tokens — a diverging replay must count
        # exhausted, never both.
        self.unconfirmed = 0


class FleetRouter:
    """Admission router + replica membership for N serving engines.

    Args:
      engines: pre-built engines to wrap (replica names ``r0..rN-1``).
      factory: ``factory(name) -> engine`` for membership changes —
        required by :meth:`add_replica` (and therefore by the
        :class:`~.fleet.FleetAutoscaler`).
      initial: replicas to build from ``factory`` at construction.
      liveness_factory: optional ``liveness_factory(name) -> callable``
        wiring each new replica's liveness to the coord heartbeat plane
        (multi-process fleets); thread replicas leave it None.
      drain_timeout: seconds a drain-on-evict waits for the replica to
        finish its admitted streams before the handle is force-reaped.
      adapter_source: optional ``adapter_source(name) -> adapter tree``
        backing the adapter-affine dispatch's lazy-load path: a request
        whose adapter is resident on NO ready replica is dispatched
        least-load and the adapter hot-loaded there first (typically a
        closure over ``parallel.checkpoint.restore_adapter`` — the
        manifest-CRC walk then guards every lazy load). Without it, a
        non-resident adapter is a ``ValueError`` naming the remedy.
        Also the prewarm source on scale-up: :meth:`add_replica` seeds
        a grown replica's registry from the fleet's resident set.
      failover_retries: per-stream failover budget — how many SUCCESSFUL
        re-dispatches a stranded generation stream gets (i.e. how many
        replicas it may fail ON) before it terminates with
        ``failover_exhausted`` (never a retry storm). Overload
        rejections do not consume this budget — they wait.
      failover_backoff_s: floor/fallback sleep between failover
        re-dispatch attempts that hit overload; a ``retry_after_ms``
        hint on the rejection overrides it (capped at 2 s per nap).
      failover_overload_wait_s: wall-clock budget a stranded stream may
        spend waiting out fleet overload before it terminates with
        ``failover_exhausted`` (a stream with a deadline is additionally
        bounded by that deadline — load shedding must not convert a
        30 s-deadline stream into a terminal error 0.3 s after a
        replica death).
      stall_timeout_s: the in-process liveness probe's staleness
        verdict — an engine loop with work pending but no completed
        iteration for this long reads dead (must cover the engine's
        worst legitimate single iteration, e.g. a first prefill).
      poll_interval_s: period of the router's own membership sweep
        thread (started lazily with the first tracked generation
        stream, so fault detection does not depend on an autoscaler
        being attached); 0 disables — callers drive :meth:`poll`.
    """

    def __init__(self, engines: Optional[List[Any]] = None, *,
                 factory: Optional[Callable[[str], Any]] = None,
                 initial: int = 0,
                 liveness_factory: Optional[Callable] = None,
                 drain_timeout: float = 60.0,
                 adapter_source: Optional[Callable[[str], Any]] = None,
                 failover_retries: int = 3,
                 failover_backoff_s: float = 0.05,
                 failover_overload_wait_s: float = 30.0,
                 stall_timeout_s: float = 60.0,
                 poll_interval_s: float = 0.5):
        if failover_retries < 1:
            raise ValueError(
                f"failover_retries must be >= 1 (a stranded stream "
                f"needs at least one re-dispatch attempt), got "
                f"{failover_retries}")
        self._factory = factory
        self._liveness_factory = liveness_factory
        self._drain_timeout = drain_timeout
        self._adapter_source = adapter_source
        self._failover_retries = failover_retries
        self._failover_backoff = failover_backoff_s
        self._failover_overload_wait = failover_overload_wait_s
        self._stall_timeout = stall_timeout_s
        self._poll_interval = poll_interval_s
        self._lock = threading.Lock()
        self._metrics = FleetMetrics()
        self._replicas: List[ReplicaHandle] = []
        self._seq = 0
        self._closed = False
        self._t0 = time.monotonic()
        # The failover plane's stream registry: replica name -> live
        # tracked streams (generation fleets only; Future fleets are
        # not tracked). The sweeper thread starts with the first
        # tracked stream.
        self._streams_lock = threading.Lock()
        self._live_streams: Dict[str, Dict[int, _FleetStream]] = {}
        self._stream_seq = itertools.count()
        self._sweeper: Optional[threading.Thread] = None
        self._sweep_stop = threading.Event()
        # Final counter totals of replicas that LEFT the membership:
        # the fleet aggregates in stats() add these baselines so
        # cumulative fields (requests_total, tokens_generated_total,
        # prefix hits, rejections) never go BACKWARDS across a shrink —
        # the same monotonicity rule FleetMetrics.forget_replica keeps
        # for the dispatch counter.
        self._retired_totals: Dict[str, float] = {}
        self._retired_gen_totals: Dict[str, float] = {}
        self._retired_spec_totals: Dict[str, float] = {}
        self._retired_tenant_totals: Dict[str, Dict[str, float]] = {}
        # Fleet-wide concurrency high-water, sampled at dispatch and
        # stats boundaries. Summing per-replica peaks would add maxima
        # that never coincided (and the sum would DROP when a replica
        # retires) — a "peak" must be monotone and fleet-coincident.
        self._peak_active = 0
        for eng in engines or []:
            self._attach(eng)
        for _ in range(initial):
            if factory is None:
                raise ValueError(
                    "FleetRouter(initial=N) needs a factory= to build "
                    "replicas from")
            name = self._next_name()
            self._attach(factory(name), name=name)
        self._refresh_gauges()

    # -- membership --------------------------------------------------------

    def _next_name(self) -> str:
        name = f"r{self._seq}"
        self._seq += 1
        return name

    def _attach(self, engine: Any, name: Optional[str] = None
                ) -> ReplicaHandle:
        with self._lock:
            if name is None:
                name = self._next_name()
            liveness = (self._liveness_factory(name)
                        if self._liveness_factory else None)
            handle = ReplicaHandle(name, engine, liveness=liveness,
                                   stall_timeout_s=self._stall_timeout)
            self._replicas.append(handle)
        try:
            # Stamp the fleet name onto the engine: fault clauses
            # (replica_kill=<name>@stream=) and the flight recorder's
            # serving events key on it.
            engine.serve_name = name
        except Exception:  # noqa: BLE001 — duck-typed engines may refuse
            pass
        return handle

    def replicas(self) -> List[ReplicaHandle]:
        with self._lock:
            return list(self._replicas)

    def counts(self) -> Dict[str, int]:
        """Membership by state (``{"ready": ..., "warming": ...,
        "draining": ..., "dead": ...}``)."""
        out = {s: 0 for s in REPLICA_STATES}
        for h in self.replicas():
            out[h.state()] += 1
        return out

    def add_replica(self, warm: bool = True) -> ReplicaHandle:
        """Grow the fleet by one replica. The engine is built
        synchronously (allocations only); ``warmup()`` runs on a
        background thread, during which the replica reads ``warming``
        and takes no traffic. Scale-up is therefore hitless: current
        replicas keep serving while the newcomer warms."""
        if self._closed:
            raise ServerClosedError("fleet router is shut down")
        if self._factory is None:
            raise RuntimeError(
                "add_replica needs FleetRouter(factory=...) — the router "
                "cannot build engines it was never taught to build")
        with self._lock:
            name = self._next_name()
        handle = self._attach(self._factory(name), name=name)
        self._seed_adapters(handle)

        def _warm():
            try:
                handle.engine.warmup()
            except Exception as e:  # noqa: BLE001 — a failed warm = dead
                _log.warning("replica %s failed warmup: %r", handle.name, e)
                handle._dead = True
            self._refresh_gauges()

        if warm:
            t = threading.Thread(target=_warm,
                                 name=f"hvd-fleet-warm-{name}", daemon=True)
            t.start()
        self._refresh_gauges()
        return handle

    def _seed_adapters(self, handle: ReplicaHandle) -> None:
        """Adapter prewarming on scale-up: seed a grown replica's
        ``AdapterRegistry`` from the fleet's CURRENTLY resident adapter
        set — quotas carried along (a seeded copy must not mint a
        quota-free tenant) — instead of
        filling by affinity misses. Needs ``adapter_source=`` (the only
        way the router can mint adapter trees); without it, or for
        registry-less engines, the replica fills on demand as before.
        A replica SHARING another replica's registry is already warm
        and skipped."""
        if self._adapter_source is None:
            return
        load = getattr(handle.engine, "load_adapter", None)
        reg_new = getattr(handle.engine, "adapters", None)
        if not callable(load) or reg_new is None:
            return
        wanted: Dict[str, Optional[int]] = {}
        for h in self.replicas():
            reg = getattr(h.engine, "adapters", None)
            if reg is None:
                continue
            if reg is reg_new and h is not handle:
                return      # shared registry: already resident
            if reg is reg_new:
                continue    # the new replica itself
            try:
                for n in (reg.resident() or ()):
                    if n not in wanted:
                        wanted[n] = reg.quota(n)
            except Exception:  # noqa: BLE001 — a dying replica has no say
                continue
        try:
            already = set(reg_new.resident() or ())
        except Exception:  # noqa: BLE001
            already = set()
        for n, q in sorted(wanted.items()):
            if n in already:
                continue
            try:
                load(n, self._adapter_source(n), quota=q)
            except Exception as e:  # noqa: BLE001 — prewarm is best-effort
                _log.warning("adapter prewarm of %r on %s failed: %r",
                             n, handle.name, e)

    def remove_replica(self, name: Optional[str] = None) -> ReplicaHandle:
        """Shrink the fleet by one replica, drain-on-evict: the replica
        stops taking NEW traffic immediately, finishes every stream it
        already admitted (the engine's ``shutdown(drain=True)``
        contract), and only then leaves the membership — no admitted
        stream is ever lost on scale-down. Returns the draining handle
        (``handle._drain_thread.join()`` to wait)."""
        with self._lock:
            candidates = [h for h in self._replicas if not h._draining]
            if name is not None:
                candidates = [h for h in candidates if h.name == name]
            if not candidates:
                raise ValueError(
                    f"no evictable replica"
                    f"{' named ' + name if name else ''} "
                    f"(states: {[ (h.name, h.state()) for h in self._replicas ]})")
            # Prefer a READY replica with the least to drain; fall back
            # to whatever is left (a warming replica drains instantly).
            ready = [h for h in candidates if h.state() == "ready"]
            pool = ready or candidates
            handle = min(pool, key=lambda h: h.load())
            handle._draining = True

        def _drain():
            try:
                handle.engine.shutdown(drain=True,
                                       timeout=self._drain_timeout)
            except Exception as e:  # noqa: BLE001
                _log.warning("replica %s drain raised: %r", handle.name, e)
            self._retire(handle)
            self._refresh_gauges()

        t = threading.Thread(target=_drain,
                             name=f"hvd-fleet-drain-{handle.name}",
                             daemon=True)
        handle._drain_thread = t
        t.start()
        self._refresh_gauges()
        return handle

    def poll(self) -> Dict[str, int]:
        """One membership sweep (the autoscaler calls this every tick):
        evict replicas whose liveness verdict says gone — a dead replica
        cannot drain, so its streams fail fast instead of hanging their
        clients — and refresh the ``hvd_fleet_replicas`` gauges.
        Returns :meth:`counts` after the sweep."""
        for h in self.replicas():
            if h.state() == "dead":
                self._evict_dead(h)
        self._refresh_gauges()
        return self.counts()

    def _evict_dead(self, handle: ReplicaHandle) -> None:
        _log.warning("replica %s is dead (liveness verdict) — evicting "
                     "without drain", handle.name)
        handle._dead = True
        if not self._retire(handle):
            # A concurrent poller (the router's own sweeper racing an
            # autoscaler tick) won the eviction and already delivered
            # the death verdicts; a second pass could _fail a stream's
            # REPLACEMENT handle on a healthy replica.
            return
        # Strand-and-resume: deliver the death verdict through each
        # tracked stream's inner handle — the pump thread (possibly
        # parked in next_event on a handle that will never speak again)
        # wakes and runs the failover. Idempotent on streams that
        # already finished (_fail no-ops once done). Failing INSIDE the
        # streams lock pins each verdict to the handle the stream holds
        # while still registered under this replica: the pump's own
        # failover unregisters before it swaps ``inner``, so a verdict
        # can never land on a replacement handle.
        with self._streams_lock:
            stranded = list(self._live_streams.get(handle.name,
                                                   {}).values())
            for s in stranded:
                s.inner._fail(WorkerFailureError(
                    f"serving replica {handle.name} declared dead with "
                    f"stream {s.sid} in flight"))

        def _reap():
            try:
                handle.engine.shutdown(drain=False, timeout=5.0)
            except Exception:  # noqa: BLE001
                pass

        threading.Thread(target=_reap, name=f"hvd-fleet-reap-{handle.name}",
                         daemon=True).start()

    def _retire(self, handle: ReplicaHandle) -> bool:
        """Remove ``handle`` from membership, folding its final counter
        totals into the retired baselines so the fleet aggregates stay
        monotone (best-effort for a dead replica whose stats raise).
        Exactly-once: the fold happens only on the call that wins the
        membership removal — a drain completing while a liveness
        verdict evicts the same replica must not double-count its
        history. Returns True iff this call won the removal."""
        snap: Dict[str, Any] = {}
        try:
            snap = handle.engine.stats()
        except Exception:  # noqa: BLE001 — a dead replica keeps what it had
            pass
        with self._lock:
            if handle not in self._replicas:
                return False
            self._replicas.remove(handle)
            for key in self._COUNTER_KEYS:
                v = snap.get(key)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self._retired_totals[key] = (
                        self._retired_totals.get(key, 0) + v)
            for key in self._GEN_SUM_KEYS:
                v = (snap.get("generation") or {}).get(key)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self._retired_gen_totals[key] = (
                        self._retired_gen_totals.get(key, 0) + v)
            for key in self._SPEC_SUM_KEYS:
                v = (snap.get("spec") or {}).get(key)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self._retired_spec_totals[key] = (
                        self._retired_spec_totals.get(key, 0) + v)
            for tenant, tv in (snap.get("tenants") or {}).items():
                base = self._retired_tenant_totals.setdefault(tenant, {})
                for key in self._TENANT_SUM_KEYS:
                    v = tv.get(key)
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        base[key] = base.get(key, 0) + v
        self._metrics.forget_replica(handle.name)
        return True

    def _note_peak(self) -> None:
        """Sample the fleet's CURRENT total active streams into the
        high-water mark (called at dispatch and stats boundaries —
        approximate between samples; per-replica exact peaks stay in
        the nested snapshots)."""
        active = 0
        for h in self.replicas():
            try:
                active += h.engine._active_rows()
            except Exception:  # noqa: BLE001 — a dying replica counts 0
                pass
        with self._lock:
            # Compare+assign under the lock: two dispatch threads racing
            # the check-then-set could otherwise publish the SMALLER
            # sample last and regress the high-water.
            if active > self._peak_active:
                self._peak_active = active

    def adapters_resident(self) -> Optional[int]:
        """DISTINCT adapters resident across live replicas (the
        ``/healthz`` and fleet-line number), or None when no replica
        carries a registry (an adapter-free fleet)."""
        names: set = set()
        any_registry = False
        for h in self.replicas():
            fn = getattr(h.engine, "adapter_names", None)
            if not callable(fn):
                continue
            try:
                res = fn()
            except Exception:  # noqa: BLE001 — a dying replica counts 0
                continue
            if res is not None:
                any_registry = True
                names.update(res)
        return len(names) if any_registry else None

    def replica_metrics_endpoints(self) -> Dict[str, str]:
        """``{replica name: "host:port"}`` for every member whose engine
        serves its OWN ``/metrics`` (subprocess replicas). Advertised in
        the router's ``/healthz`` so a scraper
        (:class:`horovod_tpu_torch.obs.summary.FleetPoller`) can walk the
        children directly — federation, not proxying: the child samples
        are never relayed through the router's own render."""
        out: Dict[str, str] = {}
        for h in self.replicas():
            fn = getattr(h.engine, "metrics_endpoint", None)
            if not callable(fn):
                continue
            try:
                ep = fn()
            except Exception:  # noqa: BLE001 — booting/dying child = none
                continue
            if ep:
                out[h.name] = str(ep)
        return out

    def _refresh_gauges(self) -> None:
        self._metrics.set_replicas(self.counts())
        self._metrics.set_adapters_resident(self.adapters_resident())
        self._metrics.set_replica_procs(
            sum(1 for h in self.replicas()
                if getattr(h.engine, "pid", None) is not None))

    # -- dispatch ----------------------------------------------------------

    @staticmethod
    def _resident_names(handle: ReplicaHandle) -> Tuple[str, ...]:
        """A replica's resident adapters (empty for engines without a
        registry — they can never serve an adapter request)."""
        fn = getattr(handle.engine, "adapter_names", None)
        if not callable(fn):
            return ()
        try:
            return tuple(fn() or ())
        except Exception:  # noqa: BLE001 — a dying replica reads empty
            return ()

    @staticmethod
    def _resident_digests(handle: ReplicaHandle) -> frozenset:
        """A replica's advertised registered-prefix route digests
        (empty for engines without a prefix registry — they can never
        serve a prefix hit, so they never sort as prefix-affine)."""
        fn = getattr(handle.engine, "prefix_digests", None)
        if not callable(fn):
            return frozenset()
        try:
            return frozenset(fn() or ())
        except Exception:  # noqa: BLE001 — a dying replica reads empty
            return frozenset()

    def _prefix_affinity(self, ready: List[ReplicaHandle], tokens,
                         adapter: Optional[str]) -> Dict[str, bool]:
        """Which ready replicas already hold this prompt's first-block
        prefix (``{name: affine}``; a name is present only when routing
        was actually in play — the replica advertised digests AND the
        prompt had a routable first block at that replica's block size).
        Purely advisory: a stale digest costs one cache miss downstream,
        never a wrong byte, so errors and absences all read as
        non-affine."""
        affine: Dict[str, bool] = {}
        if tokens is None:
            return affine
        digest_cache: Dict[int, Optional[str]] = {}
        for h in ready:
            digests = self._resident_digests(h)
            if not digests:
                continue
            bs = getattr(h.engine, "route_block_size", None)
            if not isinstance(bs, int) or bs <= 0:
                continue
            if bs not in digest_cache:
                try:
                    digest_cache[bs] = prefix_route_digest(
                        tokens, bs, adapter)
                except Exception:  # noqa: BLE001 — advisory only
                    digest_cache[bs] = None
            d = digest_cache[bs]
            if d is None:
                continue
            affine[h.name] = d in digests
        return affine

    @staticmethod
    def _slo_burning(ready: List[ReplicaHandle],
                     adapter: Optional[str]) -> Dict[str, bool]:
        """Which ready replicas are currently burning this tenant's
        TTFT SLO (``{name: burning}``) — the engine's own
        ``slo_burn(tenant)`` fraction, > 0 meaning recent first tokens
        (or deadline expiries) missed the tenant's declared target
        there. Requests without an adapter are the ``"base"`` tenant.
        Purely advisory like prefix affinity: engines without the
        probe, tenants without an SLO, and a dying replica's read error
        all report not-burning (no key), so a fleet with no SLOs sorts
        exactly as before."""
        burning: Dict[str, bool] = {}
        tenant = adapter if adapter is not None else "base"
        for h in ready:
            fn = getattr(h.engine, "slo_burn", None)
            if not callable(fn):
                continue
            try:
                if fn(tenant) > 0.0:
                    burning[h.name] = True
            except Exception:  # noqa: BLE001 — advisory only
                continue
        return burning

    def _lazy_load(self, handle: ReplicaHandle, adapter: str) -> None:
        """The affinity-miss path: fetch the adapter from
        ``adapter_source`` and hot-load it into ``handle`` before the
        dispatch. Raises ``ValueError`` when this replica cannot take it
        (no source, no registry, table full) — the dispatch loop then
        fails over."""
        if adapter in self._resident_names(handle):
            return      # a concurrent submit already loaded it here
        if self._adapter_source is None:
            raise ValueError(
                f"adapter {adapter!r} is not resident on any ready "
                f"replica and the router has no adapter_source= to "
                f"lazy-load it from — load it on a replica or pass "
                f"adapter_source=")
        load = getattr(handle.engine, "load_adapter", None)
        if not callable(load):
            raise ValueError(
                f"replica {handle.name} cannot host adapters "
                f"(engine has no load_adapter)")
        # Propagate the tenant's quota from a replica that already hosts
        # it: a lazy load must not mint a quota-free copy of the adapter
        # (one saturated replica would otherwise let the tenant run
        # unlimited streams through every replica it seeds).
        quota = None
        for other in self.replicas():
            reg = getattr(other.engine, "adapters", None)
            if reg is None:
                continue
            try:
                if adapter in (reg.resident() or ()):
                    quota = reg.quota(adapter)
                    if quota is not None:
                        break
            except Exception:  # noqa: BLE001 — a dying replica has no say
                continue
        try:
            load(adapter, self._adapter_source(adapter), quota=quota)
        except RuntimeError:
            # Raced a concurrent submit that loaded the same adapter
            # (and already has a live stream refcounting its row, so the
            # registry refused our redundant reload): it IS resident —
            # the dispatch can proceed.
            if adapter not in self._resident_names(handle):
                raise

    def submit(self, *args, **kwargs):
        """Admit one request to the fleet: least-loaded READY replica
        first, failing over across the ready set. A request carrying
        ``adapter=`` dispatches adapter-AFFINE: ready replicas that
        already have the adapter resident come first (least-load
        tiebreak unchanged — their KV and warm state are equal, so
        load still orders within the resident set), the rest fall back
        to least-load + lazy hot-load via ``adapter_source``. Raises
        :class:`ServerOverloadedError` only when EVERY ready replica
        rejected (or none is ready yet — a warming fleet is a retryable
        condition; the error carries a ``retry_after_ms`` backoff hint,
        the minimum over the replicas' own drain estimates),
        :class:`ServerClosedError` once the router (or the whole
        membership) is shut down, ``ValueError`` when an adapter is
        resident nowhere and cannot be lazy-loaded.

        Generation fleets return a fleet-owned
        :class:`~.generate.GenerationHandle` backed by the
        deterministic-failover plane: the stream's envelope is recorded
        and a replica death mid-stream re-dispatches it, replaying
        bit-identically with the emitted prefix suppressed — the caller
        never sees the migration. Single-shot fleets return the
        replica's ``Future`` unchanged (no failover)."""
        if self._closed:
            raise ServerClosedError("fleet router is shut down")
        out, handle = self._dispatch(args, kwargs)
        if not isinstance(out, GenerationHandle):
            return out      # Future fleets: nothing deterministic to replay
        return self._track(out, handle, args, kwargs)

    def _dispatch(self, args: tuple, kwargs: dict,
                  avoid: Optional[str] = None):
        """One admission attempt over the current ready set (the shared
        core of :meth:`submit` and the failover replay). Returns
        ``(replica submit result, ReplicaHandle)`` or raises the fleet
        verdict. ``avoid`` demotes that replica to the END of the walk
        (a failover replay tries every OTHER door first, but a fleet
        whose only ready replica is the avoided one still gets it)."""
        adapter = kwargs.get("adapter")
        tokens = args[0] if args else kwargs.get("tokens")
        snapshot = self.replicas()
        ready = [h for h in snapshot if h.state() == "ready"]
        resident: Dict[str, bool] = {}
        # Prefix-affine routing: replicas already holding this prompt's
        # registered first block sort ahead of equally-ready peers —
        # adapter residency still outranks it (a lazy adapter load is
        # strictly costlier than a cold prefill), load still tiebreaks.
        affine = self._prefix_affinity(ready, tokens, adapter)
        # SLO-aware dispatch: a replica already BURNING this tenant's
        # TTFT SLO (its local burn fraction > 0) sorts after clean peers
        # — below affinity (warm state still wins: a cold prefill or
        # lazy adapter load would burn the SLO harder than a queue) but
        # above raw load, so equally-warm replicas shed a struggling
        # tenant toward doors that are still meeting its target.
        burning = self._slo_burning(ready, adapter)
        if adapter is not None:
            resident = {h.name: adapter in self._resident_names(h)
                        for h in ready}
            ready.sort(key=lambda h: (h.name == avoid,
                                      not resident[h.name],
                                      not affine.get(h.name, False),
                                      burning.get(h.name, False),
                                      h.load()))
        else:
            ready.sort(key=lambda h: (h.name == avoid,
                                      not affine.get(h.name, False),
                                      burning.get(h.name, False),
                                      h.load()))
        if not ready:
            warming = sum(1 for h in snapshot if h.state() == "warming")
            if warming:
                err = ServerOverloadedError(
                    f"no ready replicas yet ({warming} warming) — retry "
                    f"after backoff")
                err.retry_after_ms = 1000.0   # a warm-up, not a queue
                raise err
            if self._factory is not None:
                # An open router with a factory is one autoscaler tick
                # away from a below-min refill — a terminal "closed"
                # here would tell well-behaved clients to stop retrying
                # a fleet about to heal.
                err = ServerOverloadedError(
                    "no live replicas right now (the fleet can refill) "
                    "— retry after backoff")
                err.retry_after_ms = 1000.0
                raise err
            raise ServerClosedError(
                "fleet has no live replicas (all drained or dead)")
        last: Optional[BaseException] = None
        hosting_error: Optional[ValueError] = None
        saw_backpressure = False
        lazy_loaded = False
        hints: List[float] = []
        for h in ready:
            if adapter is not None and not resident.get(h.name):
                if lazy_loaded:
                    # At most ONE lazy load per dispatch: a burst that
                    # overloads the freshly-loaded replica must read as
                    # retryable overload, not replicate the adapter into
                    # every table on the failover walk (rows are never
                    # auto-evicted — proliferation would turn transient
                    # backpressure into permanently full tables). Spread
                    # stays demand-driven: each retry may seed one more
                    # replica while the resident set stays saturated.
                    continue
                try:
                    self._lazy_load(h, adapter)
                    lazy_loaded = True
                except ValueError as e:
                    # This replica can't take the adapter (no source /
                    # no registry / table full): fail over.
                    last = hosting_error = e
                    continue
            try:
                out = h.engine.submit(*args, **kwargs)
            except ServerOverloadedError as e:
                last = e
                saw_backpressure = True
                ra = getattr(e, "retry_after_ms", None)
                if isinstance(ra, (int, float)):
                    hints.append(float(ra))
                continue
            except ServerClosedError as e:
                # Raced a drain decision between the snapshot and the
                # submit: that replica's door is shut, not the fleet's.
                last = e
                saw_backpressure = True
                continue
            except ValueError as e:
                if adapter is None:
                    raise
                # An adapter submit can lose an evict race: the adapter
                # was resident when this loop snapshotted residency, and
                # gone by the time submit retained it. Other replicas may
                # still host it — fail over instead of erroring the
                # request terminally. (A genuinely malformed request
                # raises the same ValueError on EVERY replica with no
                # backpressure seen, and surfaces below unchanged.)
                last = hosting_error = e
                continue
            self._metrics.on_dispatch(h.name)
            if adapter is not None:
                self._metrics.on_adapter_dispatch(
                    "affine" if resident.get(h.name) else "miss")
            if affine:
                # Routing was in play (>= 1 replica advertised digests
                # and the prompt was routable): record the outcome.
                self._metrics.on_prefix_dispatch(
                    "affine" if affine.get(h.name) else "miss")
            self._note_peak()
            return out, h
        if adapter is not None and hosting_error is not None \
                and not saw_backpressure:
            # EVERY ready replica failed to even HOST the adapter — a
            # config problem, not backpressure; retrying would never
            # help. (If any hosting-capable replica merely rejected on
            # load, the condition IS retryable — fall through to the
            # overload below.)
            raise hosting_error
        err = ServerOverloadedError(
            f"all {len(ready)} ready replicas rejected the request "
            f"(last: {last}) — grow the fleet or shed load")
        # The fleet-level backoff hint: the SOONEST any replica expects
        # to drain its queue (the client only needs one door to open).
        err.retry_after_ms = min(hints) if hints else 1000.0
        raise err

    # -- deterministic stream failover --------------------------------------

    def _track(self, inner: GenerationHandle, handle: ReplicaHandle,
               args: tuple, kwargs: dict) -> GenerationHandle:
        """Wrap a freshly-dispatched generation stream in the failover
        plane: record its envelope (with the deadline resolved to an
        ABSOLUTE instant — the clock a replay must NOT reset), register
        it under its host replica, and start the relay pump. Returns
        the client-facing handle."""
        now = time.monotonic()
        deadline_ms = kwargs.get("deadline_ms")
        if deadline_ms is None:
            # The engine would apply its own default relative to ITS
            # submit time; resolve it here so a replay keeps the
            # original clock instead of restarting the default.
            cfg = getattr(handle.engine, "_cfg", None)
            deadline_ms = getattr(cfg, "default_deadline_ms", None)
        stream = _FleetStream(
            sid=next(self._stream_seq), args=args, kwargs=dict(kwargs),
            deadline_at=(None if deadline_ms is None
                         else now + deadline_ms / 1e3),
            inner=inner)
        self._register(stream, handle.name)
        self._confirm_membership(stream, handle)
        flightrec.record("serve_dispatch", stream=stream.sid,
                         replica=handle.name)
        self._ensure_sweeper()
        # One relay thread per in-flight stream: bounded by the fleet's
        # admission capacity (every stream lives in some replica's
        # bounded queue/slots — the no-second-buffer rule), never by
        # request rate.
        threading.Thread(target=self._pump, args=(stream,),
                         name=f"hvd-fleet-stream-{stream.sid}",
                         daemon=True).start()
        return stream.client

    def _confirm_membership(self, stream: _FleetStream,
                            handle: ReplicaHandle) -> None:
        """Close the dispatch→register race with an eviction: a replica
        declared dead between the submit that admitted this stream and
        its registration was retired BEFORE ``_evict_dead`` snapshotted
        the streams to strand, so nobody else will ever deliver its
        death verdict (membership removal is exactly-once, and the
        reaper may have drained the engine's queue before the submit
        landed). ``_retire`` removes membership FIRST, so either the
        eviction sees our registration or we see the eviction here —
        there is no interleaving that misses both. Idempotent against
        every competing verdict (``_fail`` no-ops on a done handle; a
        drained replica's finished stream already has its events
        queued)."""
        with self._lock:
            present = handle in self._replicas
        if not present:
            stream.inner._fail(WorkerFailureError(
                f"serving replica {handle.name} left the membership "
                f"while stream {stream.sid} was being dispatched to "
                f"it"))

    def _register(self, stream: _FleetStream, name: str) -> None:
        with self._streams_lock:
            stream.replica = name
            self._live_streams.setdefault(name, {})[stream.sid] = stream

    def _unregister(self, stream: _FleetStream) -> None:
        with self._streams_lock:
            if stream.replica is not None:
                m = self._live_streams.get(stream.replica)
                if m is not None:
                    m.pop(stream.sid, None)
                    if not m:
                        self._live_streams.pop(stream.replica, None)
            stream.replica = None

    def _ensure_sweeper(self) -> None:
        """Start the router's own membership sweep (lazily, with the
        first tracked stream): liveness verdicts must fire even when no
        autoscaler polls this router — a static 2-replica fleet still
        promises failover."""
        if self._sweeper is not None or self._poll_interval <= 0:
            return
        with self._lock:
            if self._sweeper is not None or self._closed:
                return
            self._sweeper = threading.Thread(
                target=self._sweep_loop, name="hvd-fleet-sweep",
                daemon=True)
        self._sweeper.start()

    def _sweep_loop(self) -> None:
        while not self._sweep_stop.wait(self._poll_interval):
            if self._closed:
                return
            try:
                self.poll()
            except Exception:  # noqa: BLE001 — a bad sweep must not stop
                _log.exception("fleet membership sweep failed")

    def _pump(self, stream: _FleetStream) -> None:
        """Relay one stream's events from its current replica handle to
        the client handle, surviving replica deaths: replica-level
        failures trigger :meth:`_failover` (which swaps ``stream.inner``
        and the relay continues), request-level verdicts (deadline,
        malformed input) pass through. During a replay the suppression
        cursor swallows — and VERIFIES — the already-emitted prefix, so
        the client never sees a duplicate or diverging token."""
        client = stream.client
        while True:
            kind, val = stream.inner.next_event()
            if kind == "token":
                if stream.expect_i < len(stream.expect):
                    want = stream.expect[stream.expect_i]
                    stream.expect_i += 1
                    if val != want:
                        # Bit-identity is the contract failover stands
                        # on; a diverging replay must fail loudly, never
                        # mis-continue a stream the client half-has.
                        self._diverged(stream, client, FailoverExhaustedError(
                            f"stream {stream.sid}: replayed token "
                            f"{stream.expect_i - 1} diverged "
                            f"({val} != {want}) — deterministic replay "
                            f"broken, refusing to continue the stream"))
                        return
                    if stream.expect_i == len(stream.expect):
                        self._confirm_resumes(stream)
                    continue    # suppressed: the client already has it
                self._confirm_resumes(stream)   # 0-token-prefix resumes
                client._emit(val)
            elif kind == "done":
                if stream.expect_i < len(stream.expect):
                    # The replay finished BEFORE reproducing the prefix
                    # the client already holds — divergence by omission,
                    # as terminal as a wrong token.
                    self._diverged(stream, client, FailoverExhaustedError(
                        f"stream {stream.sid}: replay finished after "
                        f"{stream.expect_i} of {len(stream.expect)} "
                        f"already-emitted tokens — deterministic replay "
                        f"broken, refusing to continue the stream"))
                    return
                self._confirm_resumes(stream)
                self._unregister(stream)
                info = dict(val)
                info["failovers"] = stream.retries
                client._finish(info)
                return
            else:   # ("error", exc)
                if isinstance(val, DeadlineExceededError):
                    # The REQUEST's own verdict, not the replica's: the
                    # deadline is absolute — a replay would expire at
                    # the same instant, so there is nothing to resume.
                    # (A malformed request, by contrast, is rejected at
                    # SUBMIT time, synchronously, and never reaches the
                    # pump — an error event from a replica that already
                    # ADMITTED the stream is the replica's fault
                    # whatever the exception type, and fails over.)
                    self._unregister(stream)
                    client._fail(val)
                    return
                if self._closed:
                    # Fleet shutdown cancelled it — not a strand.
                    self._unregister(stream)
                    client._fail(val)
                    return
                # PreemptedError (the replica's priority plane evicted
                # this stream past its LOCAL retry budget,
                # ``preempted_exhausted``) deliberately falls through to
                # failover: the verdict is one replica's congestion, not
                # the stream's fault — another replica may have priority
                # headroom, and the replay is the same bit-identical
                # suppressed-prefix machinery preemption resume uses.
                if not self._failover(stream, val):
                    return      # terminal: the client was failed

    def _confirm_resumes(self, stream: _FleetStream) -> None:
        """The replayed prefix has fully VERIFIED: count the pending
        re-dispatches as ``resumed`` outcomes. Deferred from the
        re-dispatch itself so a diverging replay counts ``exhausted``
        alone — the outcome labels partition verdicts, never overlap."""
        while stream.unconfirmed:
            stream.unconfirmed -= 1
            self._metrics.on_failover("resumed")

    def _diverged(self, stream: _FleetStream, client: GenerationHandle,
                  err: FailoverExhaustedError) -> None:
        stream.unconfirmed = 0      # these re-dispatches did NOT resume
        self._unregister(stream)
        self._metrics.on_failover("exhausted")
        client._fail(err)

    def _failover(self, stream: _FleetStream, cause: BaseException) -> bool:
        """Re-dispatch a stranded stream onto a surviving replica,
        replaying its envelope with the emitted prefix suppressed.
        Returns True when the stream resumed (the pump continues on the
        new ``stream.inner``), False when it terminated. Bounded by the
        per-stream retry budget — only a SUCCESSFUL re-dispatch consumes
        it (the budget counts replicas the stream may fail ON) — and,
        for overload rejections, by the ``failover_overload_wait_s``
        wall clock with hint-driven naps. Either bound exhausting (or a
        terminal hosting error on every replica) fails the client with
        :class:`FailoverExhaustedError` — counted as
        ``hvd_failover_total{outcome="exhausted"}``, never a loop."""
        prev = stream.replica
        self._unregister(stream)
        if stream.client.done():
            return False
        self._metrics.on_stranded()
        flightrec.record("serve_failover", stream=stream.sid,
                         replica=prev, cause=repr(cause))
        last: BaseException = cause
        overload_t0: Optional[float] = None
        while stream.retries < self._failover_retries:
            if self._closed:
                stream.client._fail(ServerClosedError(
                    f"fleet shut down while failing over stream "
                    f"{stream.sid}"))
                return False
            if stream.deadline_at is not None \
                    and time.monotonic() >= stream.deadline_at:
                # The ORIGINAL absolute deadline — replay never resets
                # the clock, so expiry during failover is the same
                # verdict the stream would have met in a queue.
                stream.client._fail(DeadlineExceededError(
                    f"deadline expired while failing over stream "
                    f"{stream.sid} (stranded on {prev}: {cause!r})"))
                return False
            kwargs = dict(stream.kwargs)
            if stream.deadline_at is not None:
                kwargs["deadline_ms"] = max(
                    1.0, (stream.deadline_at - time.monotonic()) * 1e3)
            try:
                # Avoid the replica the stream just failed on: a SICK
                # but alive replica (loop errors every stream, thread
                # survives) empties its own queue, so a plain least-load
                # pick would hand the stream straight back and burn the
                # whole budget on one broken member while healthy
                # replicas sit idle.
                out, handle = self._dispatch(stream.args, kwargs,
                                             avoid=prev)
            except ServerOverloadedError as e:
                # The FLEET's condition, not this stream's fault:
                # waiting out overload spends the overload wall clock,
                # never the re-dispatch budget (a 3-retry stream must
                # not turn terminal 3 naps after a replica death just
                # because the survivors were momentarily full). The nap
                # honors the rejection's own ``retry_after_ms`` hint,
                # floored at the configured backoff, capped at 2 s and
                # at the stream's remaining deadline.
                last = e
                now = time.monotonic()
                if overload_t0 is None:
                    overload_t0 = now
                elif now - overload_t0 >= self._failover_overload_wait:
                    break       # waited the whole overload budget
                ra = getattr(e, "retry_after_ms", None)
                nap = (float(ra) / 1e3
                       if isinstance(ra, (int, float)) and ra > 0
                       else self._failover_backoff)
                nap = min(2.0, max(nap, self._failover_backoff))
                if stream.deadline_at is not None:
                    nap = min(nap, max(0.0, stream.deadline_at - now))
                time.sleep(nap)
                continue
            except ServerClosedError as e:
                stream.client._fail(e)
                return False
            except ValueError as e:
                # Terminal hosting/config error on every replica (the
                # _dispatch contract) — more attempts cannot help.
                last = e
                break
            if not isinstance(out, GenerationHandle):
                last = TypeError(
                    f"failover re-dispatch returned {type(out).__name__},"
                    f" not a generation stream")
                break
            stream.retries += 1
            stream.inner = out
            stream.expect = list(stream.client._tokens)
            stream.expect_i = 0
            # "resumed" is NOT counted yet: the pump confirms it once
            # the replayed prefix verifies against the client's tokens.
            stream.unconfirmed += 1
            self._register(stream, handle.name)
            self._confirm_membership(stream, handle)
            flightrec.record("serve_failover_resumed", stream=stream.sid,
                             replica=handle.name, attempt=stream.retries,
                             suppressed=len(stream.expect))
            _log.warning(
                "stream %d: failed over %s -> %s (attempt %d, replaying "
                "%d emitted tokens suppressed) after %r", stream.sid,
                prev, handle.name, stream.retries, len(stream.expect),
                cause)
            return True
        stream.unconfirmed = 0      # nothing re-dispatched stuck
        self._metrics.on_failover("exhausted")
        # A stream stranded by PREEMPTION (not replica death) carries
        # the engine's terminal reason through the fleet verdict: the
        # client distinguishes "the fleet is priority-congested for my
        # class" (back off, or raise priority) from "replicas kept
        # dying" (page the operator).
        reason = ("preempted_exhausted"
                  if isinstance(cause, PreemptedError) else "exhausted")
        err = FailoverExhaustedError(
            f"stream {stream.sid} could not be resumed "
            f"({reason}; re-dispatched {stream.retries} time(s); "
            f"stranded on {prev} by {cause!r}; last: {last!r}) — "
            f"re-submit from scratch")
        err.reason = reason
        stream.client._fail(err)
        return False

    def generate(self, tokens, timeout: Optional[float] = None, **kw):
        """Synchronous generation through the fleet (submit + result)."""
        return self.submit(tokens, **kw).result(timeout)

    def infer(self, inputs, deadline_ms: Optional[float] = None,
              timeout: Optional[float] = None):
        """Synchronous single-shot inference through a fleet of
        :class:`~.engine.Engine` replicas (the ``/predict`` path)."""
        return self.submit(inputs, deadline_ms=deadline_ms).result(timeout)

    # -- lifecycle ---------------------------------------------------------

    def warmup(self) -> Tuple[str, ...]:
        """Warm every current replica (sequentially — deploy-time code;
        mid-run growth warms on its own thread via
        :meth:`add_replica`). Returns the replica names warmed."""
        warmed = []
        for h in self.replicas():
            if h.state() == "warming":
                h.engine.warmup()
            warmed.append(h.name)
        self._refresh_gauges()
        return tuple(warmed)

    def shutdown(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the fleet. ``drain=True`` finishes every admitted stream
        on every replica (drained concurrently) first. Idempotent."""
        if self._closed:
            return
        self._closed = True
        # Stop the membership sweeper FIRST and wait for it: a daemon
        # thread left sleeping into interpreter teardown can abort the
        # process from the C++ runtime's static destructors.
        self._sweep_stop.set()
        if self._sweeper is not None:
            self._sweeper.join(timeout)
        handles = self.replicas()
        threads = []
        for h in handles:
            t = threading.Thread(
                target=lambda h=h: h.engine.shutdown(drain=drain,
                                                     timeout=timeout),
                name=f"hvd-fleet-stop-{h.name}", daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout)
        for h in handles:
            if h._drain_thread is not None:
                h._drain_thread.join(timeout)
        self._refresh_gauges()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)

    # -- health / stats / metrics ------------------------------------------

    def health(self) -> Tuple[bool, str, int]:
        """Fleet-level ``/healthz``: ready iff >= 1 replica is ready.
        Status mirrors the per-engine vocabulary (``ok`` / ``warming`` /
        ``draining``) so load balancers need no new parser; the per-state
        breakdown lives in :meth:`fleet_health`."""
        c = self.counts()
        # Exclude dead replicas from the depth sum: their load() reads
        # as the 1<<30 dispatch-ordering sentinel, which would turn the
        # /healthz queue_depth into a nonsense spike until the next
        # membership sweep evicts them.
        depth = sum(h.load() for h in self.replicas()
                    if h.state() != "dead")
        if self._closed:
            return False, "draining", depth
        if c["ready"] >= 1:
            return True, "ok", depth
        if c["warming"] >= 1:
            return False, "warming", depth
        return False, "draining", depth

    def fleet_health(self) -> Dict[str, int]:
        """Membership breakdown for the ``/healthz`` body."""
        return self.counts()

    def ttft_totals(self) -> Tuple[float, int]:
        """Fleet-cumulative ``(ttft_seconds_sum, count)`` summed from
        each replica's ``hvd_generate_ttft_seconds`` histogram — the
        rate()-able pair the autoscaler differences between polls."""
        s, n = 0.0, 0
        for h in self.replicas():
            m = getattr(h.engine, "_metrics", None)
            if m is None or not hasattr(m, "ttft_totals"):
                continue
            ds, dn = m.ttft_totals()
            s += ds
            n += dn
        return s, n

    # /stats keys summed across replicas (the fleet-aggregate view the
    # bench and dashboards read; per-replica truth nests under
    # "replicas"). Percentile fields cannot be summed and are omitted —
    # scrape the histograms for fleet quantiles. _COUNTER_KEYS are the
    # CUMULATIVE subset: a retiring replica's final values fold into the
    # retired baseline so they never go backwards across a shrink;
    # gauges (queue depth, slots) reflect live membership only.
    _COUNTER_KEYS = ("requests_total", "responses_total",
                     "rejected_overload", "rejected_slots_full",
                     "rejected_blocks_exhausted", "rejected_tenant_quota",
                     "expired_deadline",
                     "cancelled_shutdown", "batches_total",
                     "batch_rows_total", "batch_live_rows_total")
    # (peak_active_slots is NOT summed: the fleet peak is the router's
    # own sampled high-water — see _note_peak.)
    _GAUGE_KEYS = ("queue_depth", "active_slots", "max_slots")
    _SUM_KEYS = _COUNTER_KEYS + _GAUGE_KEYS
    _GEN_SUM_KEYS = ("generations_total", "tokens_generated_total",
                     "prefix_hits_total", "prefix_misses_total",
                     "prefix_hit_blocks_total", "prefix_lookup_blocks_total",
                     "kv_offload_blocks_total", "kv_prefetch_blocks_total",
                     "prefill_chunks_total", "prefill_chunks_skipped_total",
                     "preemptions_total", "preempt_resumed_total",
                     "preempt_exhausted_total")
    # Per-tenant counters summed across replicas (+ retired baselines —
    # same monotonicity rule); tenant percentile fields cannot be summed
    # and stay in the nested per-replica snapshots (scrape the
    # hvd_tenant_* histograms for fleet-wide tenant quantiles). The
    # fleet-wide SLO burn is RECOMPUTED from these summed counters in
    # stats() — averaging per-replica burn fractions would weight an
    # idle replica's one miss equally with a busy replica's thousand
    # hits.
    _TENANT_SUM_KEYS = ("generations_total", "tokens_generated_total",
                        "first_tokens_total", "ttft_slo_miss_total",
                        "deadline_miss_total", "preemptions_total")
    # Speculative-decoding counters summed across replicas (+ retired
    # baselines). The derived ratios (accept_rate, tokens_per_step) are
    # recomputed fleet-wide from the summed counters — averaging
    # per-replica ratios would weight idle replicas equally with busy
    # ones. Timing percentiles stay per-replica (scrape the
    # hvd_spec_*_seconds histograms for fleet quantiles).
    _SPEC_SUM_KEYS = ("steps_total", "draft_tokens_total",
                      "accepted_tokens_total", "emitted_tokens_total")

    def stats(self) -> Dict:
        """The fleet ``/stats`` snapshot: aggregate counters at the top
        (same key names as one engine, so existing consumers keep
        reading), per-replica snapshots under ``"replicas"``, and the
        fleet plane (membership, dispatch, scale events) under
        ``"fleet"``."""
        self._note_peak()
        per: Dict[str, Dict] = {}
        states: Dict[str, str] = {}
        for h in self.replicas():
            try:
                per[h.name] = h.engine.stats()
            except Exception as e:  # noqa: BLE001 — a dying replica's
                per[h.name] = {"error": repr(e)}   # stats must not 500 /stats
            states[h.name] = h.state()
        snap: Dict[str, Any] = {
            "uptime_seconds": time.monotonic() - self._t0,
            "kv_layout": None,
            "max_len": None,
        }
        with self._lock:
            retired = dict(self._retired_totals)
            retired_gen = dict(self._retired_gen_totals)
            retired_spec = dict(self._retired_spec_totals)
            retired_tenants = {t: dict(v) for t, v in
                               self._retired_tenant_totals.items()}
        for key in self._SUM_KEYS:
            vals = [p.get(key) for p in per.values()
                    if isinstance(p.get(key), (int, float))]
            snap[key] = sum(vals) + retired.get(key, 0) if (
                vals or key in retired) else 0
        gen: Dict[str, Any] = {}
        for key in self._GEN_SUM_KEYS:
            vals = [p.get("generation", {}).get(key) for p in per.values()
                    if isinstance(p.get("generation", {}).get(key),
                                  (int, float))]
            gen[key] = sum(vals) + retired_gen.get(key, 0)
        snap["generation"] = gen
        snap["peak_active_slots"] = self._peak_active
        rows, live = snap.get("batch_rows_total", 0), snap.get(
            "batch_live_rows_total", 0)
        snap["batch_fill_ratio"] = (live / rows) if rows else None
        for p in per.values():
            if snap["kv_layout"] is None and "kv_layout" in p:
                snap["kv_layout"] = p["kv_layout"]
            if "max_len" in p:
                snap["max_len"] = max(snap["max_len"] or 0, p["max_len"])
        blocks = [p["blocks"] for p in per.values() if "blocks" in p]
        if blocks and len(blocks) == len(per):
            snap["blocks"] = {k: sum(b.get(k, 0) for b in blocks)
                              for k in blocks[0]}
            sizes = {p.get("block_size") for p in per.values()}
            if len(sizes) == 1:
                snap["block_size"] = sizes.pop()
        hits, misses = gen.get("prefix_hits_total", 0), gen.get(
            "prefix_misses_total", 0)
        snap["prefix_hit_rate"] = (hits / (hits + misses)
                                   if hits + misses else None)
        # Speculative-decoding fleet aggregate: engines always emit a
        # "spec" block (zeros when speculation is off), so this mirrors
        # the single-engine shape; absent only for an empty fleet with
        # no retired history.
        spec_snaps = [p.get("spec") for p in per.values()
                      if isinstance(p.get("spec"), dict)]
        if spec_snaps or retired_spec:
            spec: Dict[str, Any] = {}
            for key in self._SPEC_SUM_KEYS:
                vals = [s.get(key) for s in spec_snaps
                        if isinstance(s.get(key), (int, float))]
                spec[key] = sum(vals) + retired_spec.get(key, 0)
            prop = spec.get("draft_tokens_total", 0)
            spec["accept_rate"] = (
                spec.get("accepted_tokens_total", 0) / prop
                if prop else None)
            steps = spec.get("steps_total", 0)
            spec["tokens_per_step"] = (
                spec.get("emitted_tokens_total", 0) / steps
                if steps else None)
            snap["spec"] = spec
            ks = [p.get("spec_k") for p in per.values()
                  if isinstance(p.get("spec_k"), int)]
            snap["spec_k"] = max(ks) if ks else 0
        # Per-tenant counter aggregates (multi-tenant adapters): summed
        # across live replicas plus retired baselines, keyed exactly as
        # one engine's snapshot keys them.
        tenants: Dict[str, Dict[str, float]] = {
            t: dict(v) for t, v in retired_tenants.items()}
        for p in per.values():
            for name, tv in (p.get("tenants") or {}).items():
                agg = tenants.setdefault(name, {})
                for key in self._TENANT_SUM_KEYS:
                    v = tv.get(key)
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        agg[key] = agg.get(key, 0) + v
        # Fleet-wide SLO burn per tenant, recomputed from the summed
        # counters (see _TENANT_SUM_KEYS): misses over SLO-scoped
        # outcomes, exactly the per-engine ServeMetrics._burn formula.
        fleet_slo: Dict[str, float] = {}
        for name, agg in tenants.items():
            outcomes = (agg.get("first_tokens_total", 0)
                        + agg.get("deadline_miss_total", 0))
            if outcomes:
                burn = (agg.get("ttft_slo_miss_total", 0)
                        + agg.get("deadline_miss_total", 0)) / outcomes
                agg["slo_burn"] = burn
                if burn > 0:
                    fleet_slo[name] = burn
        if tenants:
            snap["tenants"] = tenants
        k = self.adapters_resident()
        if k is not None:
            snap["adapters_resident"] = k
        snap["replicas"] = per
        adapter_dispatch = self._metrics.adapter_dispatch_counts()
        prefix_dispatch = self._metrics.prefix_dispatch_counts()
        snap["fleet"] = {
            "replicas": len(per),
            "states": states,
            **{f"n_{s}": n for s, n in self.counts().items()},
            "dispatch_total": self._metrics.dispatch_counts(),
            "scale_events": self._metrics.scale_counts(),
            "failover_total": self._metrics.failover_counts(),
            "streams_stranded_total": self._metrics.stranded_count(),
            **({"adapter_dispatch": adapter_dispatch}
               if adapter_dispatch else {}),
            **({"prefix_dispatch": prefix_dispatch}
               if prefix_dispatch else {}),
            # Tenants currently burning their SLO fleet-wide (burn > 0)
            # — the at-a-glance overload triage block; per-tenant detail
            # (targets, misses, percentiles) lives under "tenants".
            **({"slo_burning": fleet_slo} if fleet_slo else {}),
        }
        return snap

    def prom_collect(self):
        """The fleet's ``(meta, samples)``: every replica's samples with
        a ``replica=`` label added, merged with the fleet-plane series
        (``hvd_fleet_replicas{state=}``,
        ``hvd_fleet_dispatch_total{replica=}``,
        ``hvd_fleet_scale_events_total{direction=}``) — ONE render is
        one valid exposition (grouped by metric name, single ``# TYPE``
        each; the reason this cannot be string concatenation)."""
        self._refresh_gauges()
        meta: Dict = {}
        samples: List = []
        for h in self.replicas():
            try:
                m, s = h.engine.prom_collect()
            except Exception:  # noqa: BLE001 — scrape what still answers
                continue
            meta.update(m)
            samples.extend((name, {**labels, "replica": h.name}, v)
                           for name, labels, v in s)
        m, s = self._metrics.registry.collect()
        meta.update(m)
        samples.extend(s)
        return meta, samples

    def prom_metrics(self) -> str:
        """Prometheus text exposition of :meth:`prom_collect` (the
        fleet ``/metrics`` body)."""
        from ..obs.registry import render
        return render(*self.prom_collect())

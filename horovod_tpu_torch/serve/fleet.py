"""The serving fleet's control loop: queue-depth autoscaling over
:class:`~.router.FleetRouter` membership, and :func:`heartbeat_liveness`.

Port of the JAX package's ``serve/fleet.py`` (the same knobs, defaults,
validation messages and decisions). The control discipline:

* **Hysteresis** — a watermark must be breached on ``breach_up`` /
  ``breach_down`` CONSECUTIVE polls before anything moves, and the
  high/low watermarks are kept apart, so load between them is a stable
  fixed point: no grow/shrink oscillation across one threshold.
* **One pending change at a time** — while any replica is ``warming``
  (a grow in flight) or ``draining`` (a shrink in flight) the loop
  observes but does not decide: two changes in flight would make the
  pressure signal unattributable.
* **Cooldown** — after a committed change the loop holds for
  ``cooldown_s``, so the new membership's effect is measured before the
  next decision.
* **Min/max caps** — the serving analog of ``-np``/``--max-np``.

The signal is the telemetry the replicas already export: queue depth per
ready replica (``hvd_queue_depth`` + ``hvd_active_slots``,
:meth:`~.router.ReplicaHandle.load`) as the primary watermark, and the
fleet's interval-mean TTFT differenced from the
``hvd_generate_ttft_seconds`` histogram (what a scraper's
``rate(sum)/rate(count)`` computes) as a secondary grow trigger: a fleet
can be latency-sick before its queues are deep.

Scale-down goes through :meth:`~.router.FleetRouter.remove_replica`
(drain-on-evict: the retiring replica finishes every admitted stream);
scale-up is hitless (the new replica reads ``warming`` and takes no
traffic until its warmup finishes).

Liveness: thread replicas answer the engine's own
:meth:`~.generate.GenerationEngine.loop_alive` (loop death, or a wedged
loop); subprocess replicas (:class:`~.proc_replica.ProcReplicaClient`)
answer the same probe (a dead pid reads dead within one poll, an
unreachable child on the two-strike ``/healthz`` rule) and the
``aborted()`` surface that :func:`heartbeat_liveness` reads. Every
:meth:`FleetAutoscaler.poll_once` starts with
:meth:`~.router.FleetRouter.poll`, whose eviction of a dead replica
strands-and-resumes its streams; the router's own sweep thread delivers
the same verdict on a static fleet, and the autoscaler's below-min refill
restores the lost capacity. Both paths are idempotent.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from .router import FleetRouter


def heartbeat_liveness(client) -> Callable[[], bool]:
    """Replica liveness from a heartbeat plane's verdict: the
    ``ReplicaHandle(liveness=)`` callable, alive until ``client.aborted()``
    says the member is gone (and gone once the probe itself raises).

    ``client`` is anything with an ``aborted()`` surface: a
    :class:`~.proc_replica.ProcReplicaClient` (its pid, its heartbeat file
    and a two-strike ``/healthz`` probe), or, once the port has the
    host coordination plane, the coordinator client whose heartbeat
    timeouts abort the world with the dead member named.
    """

    def alive() -> bool:
        try:
            return not client.aborted()
        except Exception:  # noqa: BLE001 — an unreachable plane is "gone"
            return False

    return alive


class FleetAutoscaler:
    """Closed-loop replica-count controller for a :class:`FleetRouter`.

    Args:
      router: the fleet to scale; must have been built with a
        ``factory=`` (growth needs to mint replicas).
      min_replicas / max_replicas: membership caps (warming counts
        toward the cap — a grow in flight is a replica).
      high_watermark: grow when queued-work-per-ready-replica exceeds
        this for ``breach_up`` consecutive polls.
      low_watermark: shrink when it stays below this for
        ``breach_down`` consecutive polls. Keep ``low < high`` — the
        band between them is the stable region (enforced).
      ttft_high_ms: optional secondary grow trigger — the fleet's
        interval-mean TTFT (histogram delta between polls) above this
        counts as a high breach even with shallow queues.
      breach_up / breach_down: consecutive-poll hysteresis counts.
      cooldown_s: minimum seconds between committed membership changes.
      interval_s: poll period of :meth:`start`'s background thread.
      pressure_fn: test/override hook — zero-arg callable replacing the
        default queue-depth-per-ready-replica signal.
      clock: time source (injectable for tests; ``time.monotonic``).

    The decision core is :meth:`poll_once` — one observation + at most
    one membership change — so tests drive the loop deterministically
    without threads or sleeps; :meth:`start` just calls it on a timer.
    """

    def __init__(self, router: FleetRouter, *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 high_watermark: float = 8.0, low_watermark: float = 1.0,
                 ttft_high_ms: Optional[float] = None,
                 breach_up: int = 2, breach_down: int = 2,
                 cooldown_s: float = 5.0, interval_s: float = 1.0,
                 pressure_fn: Optional[Callable[[], float]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1 (a fleet of zero serves "
                f"nothing), got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) must be >= min_replicas "
                f"({min_replicas})")
        if not low_watermark < high_watermark:
            raise ValueError(
                f"low_watermark ({low_watermark}) must be < "
                f"high_watermark ({high_watermark}) — the band between "
                f"them is what prevents grow/shrink oscillation")
        if breach_up < 1 or breach_down < 1:
            raise ValueError("breach counts must be >= 1")
        if getattr(router, "_factory", None) is None:
            # Fail fast: without a factory every grow (and the below-min
            # refill) would raise per-tick inside the loop forever — a
            # misconfiguration only discoverable by reading logs.
            raise ValueError(
                "FleetAutoscaler needs a router built with factory= — "
                "it cannot grow a fleet it was never taught to build "
                "replicas for")
        self._router = router
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.high = high_watermark
        self.low = low_watermark
        self.ttft_high_ms = ttft_high_ms
        self.breach_up = breach_up
        self.breach_down = breach_down
        self.cooldown_s = cooldown_s
        self.interval_s = interval_s
        self._pressure_fn = pressure_fn
        self._clock = clock
        self._up = 0
        self._down = 0
        self._last_change: Optional[float] = None
        self._prev_ttft = router.ttft_totals()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signals -----------------------------------------------------------

    def pressure(self) -> float:
        """Queued-plus-executing work per READY replica — the primary
        watermark signal (``pressure_fn`` overrides)."""
        if self._pressure_fn is not None:
            return float(self._pressure_fn())
        loads = [h.load() for h in self._router.replicas()
                 if h.state() == "ready"]
        if not loads:
            return 0.0
        return sum(loads) / len(loads)

    def _ttft_breach(self) -> bool:
        if self.ttft_high_ms is None:
            return False
        s, n = self._router.ttft_totals()
        ps, pn = self._prev_ttft
        self._prev_ttft = (s, n)
        if n <= pn:
            return False
        mean_ms = (s - ps) / (n - pn) * 1e3
        return mean_ms > self.ttft_high_ms

    # -- the control loop --------------------------------------------------

    def poll_once(self) -> Optional[str]:
        """One control tick: sweep membership (liveness evictions), read
        the signals, and commit at most one scale action. Returns
        ``"grow"`` / ``"shrink"`` when a change was committed, None
        otherwise."""
        counts = self._router.poll()
        live = counts["ready"] + counts["warming"] + counts["draining"]
        pending = counts["warming"] > 0 or counts["draining"] > 0
        # A fleet evicted below its floor (dead replicas) is refilled
        # regardless of pressure — min_replicas is a liveness promise.
        if not pending and live < self.min_replicas:
            self._commit("grow")
            return "grow"
        p = self.pressure()
        ttft_hot = self._ttft_breach()   # every poll: keeps the TTFT
        if pending:                      # delta window one-poll wide
            # One membership change at a time: while a
            # change is in flight the loop only observes. Breaches are
            # NOT counted here — _commit zeroed the counters, so the
            # first decision about the settled fleet is built from
            # breach_up/_down fresh polls of the membership that would
            # actually be scaled (a warmup longer than the cooldown
            # would otherwise cascade a second grow off measurements of
            # the fleet it replaced).
            return None
        if p > self.high or ttft_hot:
            self._up += 1
            self._down = 0
        elif p < self.low:
            self._down += 1
            self._up = 0
        else:
            # The stable band: decay both counters — breaches must be
            # CONSECUTIVE (the hysteresis contract).
            self._up = 0
            self._down = 0
        now = self._clock()
        if (self._last_change is not None
                and now - self._last_change < self.cooldown_s):
            return None
        if self._up >= self.breach_up and live < self.max_replicas:
            self._commit("grow")
            return "grow"
        if self._down >= self.breach_down and live > self.min_replicas:
            self._commit("shrink")
            return "shrink"
        return None

    def _commit(self, direction: str) -> None:
        if direction == "grow":
            self._router.add_replica()
        else:
            self._router.remove_replica()
        self._router._metrics.on_scale(direction)
        self._last_change = self._clock()
        self._up = 0
        self._down = 0

    # -- thread lifecycle --------------------------------------------------

    def start(self) -> "FleetAutoscaler":
        self._thread = threading.Thread(target=self._run,
                                        name="hvd-fleet-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — a bad tick must not kill
                import logging      # the loop; the next tick retries
                logging.getLogger("horovod_tpu_torch.serve.fleet").exception(
                    "autoscaler tick failed")

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

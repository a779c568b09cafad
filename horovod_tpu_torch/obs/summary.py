"""Fleet view: scrape every rank's ``/metrics`` and print ONE line.

A copy of the JAX package's ``obs/summary.py``. The launcher watches exit
codes only; ``--metrics-summary`` turns the per-rank listeners
(:mod:`.http`) into a view of the job: scrape ``base_port + r`` for
every rank, aggregate, one line.

Aggregation, per series NAME (labels ignored: each rank's registry
carries its own ``rank`` label):

* counters (``*_total``) sum across ranks — the fleet's throughput;
* ``hvd_global_step`` reports min/max — a spread is a straggler;
* everything is cumulative, so the poller keeps the previous sample and
  prints rates (steps/s, samples/s, tokens/s) from the delta.

The poller also speaks serving: pointed at a
:class:`~horovod_tpu_torch.serve.router.FleetRouter`'s ``/metrics``
(``tpurun_torch -np 1 --metrics-summary --metrics-port <serving
port>``), the scrape carries ``hvd_fleet_replicas`` and the line turns
replica-centric — ``fleet: K/N replicas ready | depth=… |
ttft_p50<=…ms`` — with the TTFT quantile estimated from the fleet-summed
``hvd_generate_ttft_seconds`` buckets, and the subprocess replicas'
endpoints that the router's ``/healthz`` advertises scraped too.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

from .registry import parse_exposition


def scrape_exposition(host: str, port: int,
                      timeout: float = 2.0) -> Optional[Dict]:
    """One endpoint's fully parsed ``/metrics``
    (``{(name, sorted-label-items): value}``), or None when
    unreachable. The label-preserving form — the serving-fleet summary
    needs the ``state=`` / ``le=`` breakdowns that name-summing
    destroys."""
    url = f"http://{host}:{port}/metrics"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            text = resp.read().decode("utf-8", "replace")
    except (urllib.error.URLError, OSError, ValueError):
        return None
    return parse_exposition(text)


def scrape(host: str, port: int, timeout: float = 2.0) -> Optional[Dict]:
    """One rank's parsed ``/metrics`` (series-name → summed value), or
    None when unreachable (a dead/not-yet-up rank is a datum, not an
    error)."""
    parsed = scrape_exposition(host, port, timeout)
    if parsed is None:
        return None
    out: Dict[str, float] = {}
    for (name, _labels), v in parsed.items():
        out[name] = out.get(name, 0.0) + v
    return out


class FleetPoller:
    """Stateful aggregator: each :meth:`line` call scrapes all ranks and
    renders one operator-facing summary, with rates computed against the
    previous poll."""

    def __init__(self, host: str, base_port: int, world: int,
                 timeout: float = 2.0, ranks=None):
        """``ranks``: the rank indices to scrape (default all of
        ``range(world)``). A multi-host launcher passes its own rank
        block: the other hosts' listeners are not on this loopback."""
        self.host = host
        self.base_port = int(base_port)
        self.world = int(world)
        self.timeout = timeout
        self._ranks = None if ranks is None else list(ranks)
        self._prev: Optional[Dict[str, float]] = None
        self._prev_t: Optional[float] = None
        # The labeled parses behind the last sample() — kept so the
        # serving-mode line reuses ONE scrape per poll instead of
        # re-fetching every endpoint (None when sample() was shimmed).
        self._last_labeled: Optional[List[Optional[Dict]]] = None
        # Structured verdict of the last line() — what the one-shot CLI
        # keys its exit code on (never parse the prose back).
        self.last_mode: Optional[str] = None      # "training"|"serving"
        self.last_up: int = 0                     # endpoints that answered

    def set_world(self, world: int) -> None:
        """Scrape another world size from the next poll on (explicit
        ``ranks`` clamp to it)."""
        self.world = int(world)

    def ranks(self) -> List[int]:
        if self._ranks is None:
            return list(range(self.world))
        return [r for r in self._ranks if r < self.world]

    def sample(self) -> List[Optional[Dict]]:
        self._last_labeled = [
            scrape_exposition(self.host, self.base_port + r, self.timeout)
            for r in self.ranks()]
        out: List[Optional[Dict]] = []
        for parsed in self._last_labeled:
            if parsed is None:
                out.append(None)
                continue
            summed: Dict[str, float] = {}
            for (name, _labels), v in parsed.items():
                summed[name] = summed.get(name, 0.0) + v
            out.append(summed)
        return out

    def _advertised_endpoints(self) -> List[Tuple[str, int]]:
        """Subprocess-replica ``/metrics`` endpoints advertised by the
        scraped router's ``/healthz`` ``replica_metrics`` breakdown
        (``{name: "host:port"}``) — a subprocess fleet's samples live at
        the CHILDREN's endpoints (the router deliberately does not relay
        them), so a summary that only reads the router's port would
        report a process fleet as generating nothing. A not-ready
        ``/healthz`` answers 503 with the same JSON body; read it
        through the HTTPError. Deduplicated, order-stable."""
        seen: Dict[Tuple[str, int], None] = {}
        for r in self.ranks():
            url = f"http://{self.host}:{self.base_port + r}/healthz"
            try:
                with urllib.request.urlopen(url,
                                            timeout=self.timeout) as resp:
                    text = resp.read()
            except urllib.error.HTTPError as e:
                try:
                    text = e.read()
                except (OSError, ValueError):
                    continue
            except (urllib.error.URLError, OSError, ValueError):
                continue
            try:
                body = json.loads(text.decode("utf-8", "replace"))
            except ValueError:
                continue
            for ep in (body.get("replica_metrics") or {}).values():
                host, _, port = str(ep).rpartition(":")
                try:
                    seen.setdefault((host or self.host, int(port)), None)
                except ValueError:
                    continue
        return list(seen)

    def _serving_line(self, now: float, totals: Dict[str, float]) -> str:
        """The serving-fleet flavor of :meth:`line`: a scrape that
        carries ``hvd_fleet_replicas`` is a :class:`~horovod_tpu_torch.
        serve.router.FleetRouter` endpoint, not a training rank — summarize
        replicas/depth/TTFT instead of steps. TTFT p50 comes from the
        fleet-summed ``hvd_generate_ttft_seconds`` histogram (cumulative
        bucket counts sum across replicas, so the quantile estimate is
        fleet-wide — the thing per-replica reservoirs can never give).
        Reuses the labeled parses the triggering :meth:`sample` already
        fetched — one scrape per endpoint per poll (the fallback
        re-fetch only fires when sample() was replaced by a shim)."""
        labeled = self._last_labeled
        if labeled is None:
            labeled = [scrape_exposition(self.host, self.base_port + r,
                                         self.timeout)
                       for r in self.ranks()]
        merged: Dict = {}
        for parsed in labeled:
            for key, v in (parsed or {}).items():
                merged[key] = merged.get(key, 0.0) + v
        # Subprocess fleets: walk each child endpoint the router's
        # /healthz advertises — ONE scrape per endpoint per poll,
        # folded into BOTH views of this poll (`merged`
        # feeds the labeled breakdowns, `totals` feeds the rate deltas
        # and becomes `_prev`, so the walk must land in each or
        # tokens/s would read zero forever on a process fleet).
        for host, port in self._advertised_endpoints():
            child = scrape_exposition(host, port, self.timeout)
            if child is None:
                continue
            for key, v in child.items():
                merged[key] = merged.get(key, 0.0) + v
                name = key[0]
                totals[name] = totals.get(name, 0.0) + v
        states = {dict(labels).get("state"): v
                  for (name, labels), v in merged.items()
                  if name == "hvd_fleet_replicas"}
        ready = int(states.get("ready", 0))
        total = ready + int(states.get("warming", 0)) \
            + int(states.get("draining", 0))
        depth = sum(v for (name, _), v in merged.items()
                    if name == "hvd_queue_depth")
        parts = [f"fleet: {ready}/{total} replicas ready",
                 f"depth={int(depth)}"]
        # Adapter residency (multi-tenant serving): the router-level
        # distinct count — present only when some replica carries a
        # registry, read from the SAME labeled parse as everything else
        # (one scrape per endpoint per poll).
        for (name, _labels), v in merged.items():
            if name == "hvd_fleet_adapters_resident":
                parts.append(f"adapters={int(v)} resident")
                break
        # Prefix-cache effectiveness: hit share of all prefix lookups,
        # from the SAME merged parse (one scrape per endpoint per poll)
        # — shown only once some lookup happened, so a
        # fleet without prefix reuse keeps its old line.
        hits = sum(v for (name, _), v in merged.items()
                   if name == "hvd_prefix_hits_total")
        lookups = hits + sum(v for (name, _), v in merged.items()
                             if name == "hvd_prefix_misses_total")
        if lookups > 0:
            parts.append(f"prefix={100.0 * hits / lookups:.0f}%")
        buckets: Dict[str, float] = {}
        for (name, labels), v in merged.items():
            if name == "hvd_generate_ttft_seconds_bucket":
                le = dict(labels).get("le", "+Inf")
                buckets[le] = buckets.get(le, 0.0) + v
        n = buckets.get("+Inf", 0.0)
        if n > 0:
            bounds = sorted((float(le), c) for le, c in buckets.items()
                            if le != "+Inf")
            p50 = next((b for b, c in bounds if c >= n / 2.0), None)
            parts.append("ttft_p50<={:.1f}ms".format(p50 * 1e3)
                         if p50 is not None else "ttft_p50>last_bucket")
        else:
            parts.append("ttft_p50=n/a")
        for direction in ("grow", "shrink"):
            key = ("hvd_fleet_scale_events_total",
                   (("direction", direction),))
            if key in merged:
                parts.append(f"{direction}_events {int(merged[key])}")
        # `totals` is line()'s name-summed view of the SAME scrape —
        # rebuilt nowhere (three drifting copies of the summing loop is
        # how a future series fix misses one).
        if self._prev is not None and self._prev_t is not None:
            dt = max(1e-9, now - self._prev_t)
            if "hvd_tokens_generated_total" in totals:
                rate = (totals["hvd_tokens_generated_total"]
                        - self._prev.get("hvd_tokens_generated_total",
                                         0.0)) / dt
                parts.append(f"tokens/s {max(0.0, rate):.1f}")
        self._prev, self._prev_t = totals, now
        return " | ".join(parts)

    def line(self) -> str:
        samples = self.sample()
        now = time.monotonic()
        up = [s for s in samples if s is not None]
        totals: Dict[str, float] = {}
        for s in up:
            for k, v in s.items():
                totals[k] = totals.get(k, 0.0) + v
        self.last_up = len(up)
        self.last_mode = ("serving" if "hvd_fleet_replicas" in totals
                          else "training")
        if self.last_mode == "serving":
            # The scraped port is a serving fleet's /metrics, not a
            # training rank's — switch to the replica-centric summary.
            return self._serving_line(now, totals)
        steps = [s.get("hvd_global_step") for s in up
                 if s.get("hvd_global_step") is not None]
        n_polled = len(samples)
        scope = ("" if self._ranks is None or n_polled == self.world
                 else " (this node)")
        parts = [f"fleet: {len(up)}/{n_polled} ranks up{scope}"]
        if steps:
            lo, hi = int(min(steps)), int(max(steps))
            parts.append(f"step {lo}" if lo == hi
                         else f"step {lo}..{hi} (straggler spread "
                              f"{hi - lo})")
        if self._prev is not None and self._prev_t is not None:
            dt = max(1e-9, now - self._prev_t)
            for key, label in (("hvd_steps_total", "steps/s"),
                               ("hvd_samples_total", "samples/s"),
                               ("hvd_tokens_generated_total", "tokens/s")):
                if key in totals:
                    rate = (totals[key] - self._prev.get(key, 0.0)) / dt
                    parts.append(f"{label} {max(0.0, rate):.1f}")
        for key, label in (("hvd_bad_steps_total", "bad_steps"),
                           ("hvd_commits_total", "commits"),
                           ("hvd_restores_total", "restores"),
                           ("hvd_resizes_total", "resizes")):
            if key in totals:
                parts.append(f"{label} {int(totals[key])}")
        self._prev, self._prev_t = totals, now
        return " | ".join(parts)

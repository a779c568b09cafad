"""Fleet view: scrape every rank's ``/metrics`` and print ONE line.

A copy of the JAX package's ``obs/summary.py`` (``scrape_exposition``,
``scrape``, ``FleetPoller``'s training line). The launcher watches exit
codes only; ``--metrics-summary`` turns the per-rank listeners
(:mod:`.http`) into a view of the job: scrape ``base_port + r`` for
every rank, aggregate, one line.

Aggregation, per series NAME (labels ignored: each rank's registry
carries its own ``rank`` label):

* counters (``*_total``) sum across ranks — the fleet's throughput;
* ``hvd_global_step`` reports min/max — a spread is a straggler;
* everything is cumulative, so the poller keeps the previous sample and
  prints rates (steps/s, samples/s, tokens/s) from the delta.

Pointed at a serving fleet's ``/metrics`` (a scrape carrying
``hvd_fleet_replicas``), the JAX poller prints a replica-centric line;
that line needs the serving fleet's ``/metrics``, ``ROADMAP.md`` Queue 1
item 12, and raises until then.
"""

from __future__ import annotations

import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from .registry import parse_exposition


def scrape_exposition(host: str, port: int,
                      timeout: float = 2.0) -> Optional[Dict]:
    """One endpoint's fully parsed ``/metrics``
    (``{(name, sorted-label-items): value}``), or None when
    unreachable."""
    url = f"http://{host}:{port}/metrics"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            text = resp.read().decode("utf-8", "replace")
    except (urllib.error.URLError, OSError, ValueError):
        return None
    return parse_exposition(text)


def _by_name(parsed: Dict) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for (name, _labels), v in parsed.items():
        out[name] = out.get(name, 0.0) + v
    return out


def scrape(host: str, port: int, timeout: float = 2.0) -> Optional[Dict]:
    """One rank's parsed ``/metrics`` (series name → summed value), or
    None when unreachable (a dead or not-yet-up rank is a datum, not an
    error)."""
    parsed = scrape_exposition(host, port, timeout)
    return None if parsed is None else _by_name(parsed)


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
        # The structured verdict of the last line(): what the one-shot
        # CLI keys its exit code on.
        self.last_mode: Optional[str] = None      # "training"|"serving"
        self.last_up: int = 0                     # endpoints that answered

    def set_world(self, world: int) -> None:
        """Scrape another world size from the next poll on."""
        self.world = int(world)

    def ranks(self) -> List[int]:
        if self._ranks is None:
            return list(range(self.world))
        return [r for r in self._ranks if r < self.world]

    def sample(self) -> List[Optional[Dict]]:
        return [scrape(self.host, self.base_port + r, self.timeout)
                for r in self.ranks()]

    def _serving_line(self, now: float, totals: Dict[str, float]) -> str:
        raise NotImplementedError(
            "the serving fleet's summary line reads the serving router's "
            "/metrics, which is not ported yet: ROADMAP.md Queue 1 item 12")

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

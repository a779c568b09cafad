"""One telemetry plane for training (a copy of the JAX package's ``obs``).

* :mod:`.registry` — lock-light counters/gauges/histograms with
  Prometheus text exposition; the process-default registry is the
  training plane's shared namespace (metric names are API, letter for
  letter the reference's).
* :mod:`.http` — the per-rank ``GET /metrics`` listener
  (``HVD_METRICS_PORT``, port + rank, 0 disables), started by
  ``runtime.init()``.
* :mod:`.flightrec` — the crash-safe flight recorder: a bounded ring of
  recent structured events dumped to ``hvd_flightrec.rank{N}.json`` when
  a rank dies badly.

* :mod:`.summary` — the launcher's ``--metrics-summary`` fleet line:
  every rank's ``/metrics`` scraped and aggregated into one line (the
  serving fleet's line is ``ROADMAP.md`` Queue 1 item 12).
"""

from . import flightrec  # noqa: F401
from .flightrec import FlightRecorder  # noqa: F401
from .http import MetricsListener  # noqa: F401
from .registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    escape_label_value,
    parse_exposition,
    registry,
    render,
)

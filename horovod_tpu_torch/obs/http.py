"""Per-rank metrics HTTP listener: ``GET /metrics`` in Prometheus text.

A copy of the JAX package's ``obs/http.py`` (framework-neutral):

* ``HVD_METRICS_PORT=<base>`` — rank *r* listens on ``base + r`` (one
  process per GPU). ``0``/unset disables. Started by ``runtime.init()``,
  stopped by ``runtime.shutdown()``.
* ``HVD_METRICS_HOST`` — bind address (default ``0.0.0.0`` so a scraper
  on another host can reach it; the port is read-only text).

The handler renders the process-default registry
(:func:`horovod_tpu_torch.obs.registry`) with a ``rank`` const label, so
one fleet view needs no per-rank relabeling config.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .registry import registry as _default_registry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    render: Callable[[], str] = None     # installed by MetricsListener

    def log_message(self, *a):  # scrapes are not log-worthy
        pass

    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        if path in ("/metrics", ""):
            try:
                body = type(self).render().encode()
            except Exception as e:  # noqa: BLE001 — scrape must not 500-loop
                self.send_response(500)
                self.end_headers()
                self.wfile.write(f"render failed: {e!r}".encode())
                return
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_response(404)
            self.end_headers()


class MetricsListener:
    """Serve a render callback over HTTP on a background thread.
    ``port=0`` binds an ephemeral port (read ``.port`` back) — the
    test-friendly default."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1", *,
                 render: Optional[Callable[[], str]] = None):
        if render is None:
            render = _default_registry().render
        handler = type("BoundMetricsHandler", (_Handler,),
                       {"render": staticmethod(render)})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"hvd-metrics-{self.port}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def start_from_env(rank: int) -> Optional[MetricsListener]:
    """Start the per-rank listener if ``HVD_METRICS_PORT`` asks for one
    (port = base + rank; 0/unset disables). A bind failure warns and
    returns None — metrics must never kill training."""
    import os
    import warnings
    from ..utils import config as _config
    base = _config.metrics_port()
    if not base:
        return None
    host = os.environ.get("HVD_METRICS_HOST") or "0.0.0.0"
    port = base + int(rank)

    def _render():
        return _default_registry().render(
            const_labels={"rank": str(rank)})

    try:
        return MetricsListener(port, host, render=_render)
    except OSError as e:
        warnings.warn(
            f"metrics listener could not bind {host}:{port} ({e}); "
            f"rank {rank} runs without a /metrics endpoint")
        return None

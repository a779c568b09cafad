"""Thin HTTP front end over the serving engines.

Port of the JAX package's ``serve/server.py`` (stdlib ``http.server``
only): the single-shot :class:`~.engine.Engine` (``engine=``) and the
:class:`~.generate.GenerationEngine` (``generate=``), either or both,
with the engines' backpressure contract mapped onto HTTP status codes:

* ``POST /predict`` with ``{"inputs": <nested list>, "deadline_ms"}`` →
  200 ``{"outputs": ...}`` from ``engine``;
* ``POST /generate`` with ``{"tokens": [...], "max_new_tokens",
  "temperature", "top_k", "seed", "eos", "deadline_ms", "stream",
  "adapter"}`` (``adapter``: the tenant's resident LoRA fine-tune) → 200
  with **chunked** streaming from ``generate``: one JSON line per sampled
  token (``{"token": 17}``) the moment the engine emits it, then a final
  ``{"done": true, "finish_reason": ..., ...}`` line; ``"stream": false``
  buffers into one JSON object. The stream starts only once the first
  token exists, so queue-time failures still get real status codes;
* overload → 503 (with ``retry_after_ms`` and ``Retry-After``),
  preempted past the retry budget → 503, deadline → 504, shut down →
  503 (not retryable), bad request or shape → 400;
* ``GET /stats`` → 200, the primary engine's snapshot (``engine`` when
  attached, else ``generate``), the generation snapshot nested under
  ``"generate"`` when both are;
* ``GET /metrics`` → 200, one Prometheus text exposition (0.0.4) of
  every attached engine, each sample labelled ``engine=`` (``predict``
  or ``generate``);
* ``GET /healthz`` → 200 when every attached engine is ready, 503 while
  one warms or drains; with an adapter registry the body also carries
  ``adapters_resident``.

Either slot also takes a :class:`~.router.FleetRouter`, which duck-types
the engine surface: ``POST /generate`` and ``/predict`` route through
its least-depth dispatch, ``GET /stats`` nests the replicas' snapshots
under ``"replicas"``, ``GET /metrics`` is one exposition whose replica
samples carry a ``replica=`` label beside the fleet series, and
``GET /healthz`` reports fleet readiness (>= 1 ready replica) with the
membership breakdown (``replicas``) and the subprocess replicas' own
``/metrics`` endpoints (``replica_metrics``) in its body.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..exceptions import (DeadlineExceededError, PreemptedError,
                          ServerClosedError, ServerOverloadedError)
from .generate import SamplingParams


class _Handler(BaseHTTPRequestHandler):
    # Installed by HttpServer: the single-shot Engine, the
    # GenerationEngine (either may be None).
    engine = None
    gen_engine = None
    # HTTP/1.1 for Transfer-Encoding: chunked (the /generate stream);
    # every non-chunked reply carries Content-Length, so keep-alive works.
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet: the engine's metrics are the log
        pass

    def _reply(self, code: int, payload: dict,
               headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _overloaded(self, e) -> None:
        body = {"error": str(e), "retryable": True}
        headers = None
        ra = getattr(e, "retry_after_ms", None)
        if isinstance(ra, (int, float)) and not isinstance(ra, bool):
            body["retry_after_ms"] = float(ra)
            headers = {"Retry-After": str(max(1, int(-(-ra // 1000))))}
        self._reply(503, body, headers)

    def _primary(self):
        """The engine whose health and stats lead: the single-shot engine
        when attached, else the generation engine."""
        return self.engine if self.engine is not None else self.gen_engine

    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        if path == "/stats":
            snap = self._primary().stats()
            if self.engine is not None and self.gen_engine is not None:
                snap["generate"] = self.gen_engine.stats()
            self._reply(200, snap)
        elif path == "/metrics":
            # The engines' samples merge before rendering (each carries
            # its engine= label): two renders concatenated would repeat
            # # TYPE lines, which the exposition format forbids.
            meta, samples = {}, []
            for eng in (self.engine, self.gen_engine):
                if eng is not None:
                    m, smp = eng.prom_collect()
                    meta.update(m)
                    samples.extend(smp)
            from ..obs.registry import render
            body = render(meta, samples).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/healthz":
            primary = self._primary()
            ready, status, depth = primary.health()
            if ready and self.gen_engine is not None \
                    and self.gen_engine is not primary:
                ready, status, depth = self.gen_engine.health()
            body = {"status": status, "queue_depth": depth}
            # A mounted FleetRouter (in either slot) adds its membership
            # breakdown, and the endpoints of the subprocess replicas,
            # which serve their own /metrics: the router never relays
            # those samples, a scraper (FleetPoller) walks them.
            for eng in (primary, self.gen_engine):
                fleet_health = getattr(eng, "fleet_health", None)
                if callable(fleet_health):
                    body["replicas"] = fleet_health()
                    endpoints = eng.replica_metrics_endpoints()
                    if endpoints:
                        body["replica_metrics"] = endpoints
                    break
            # Adapter-table residency: how many fine-tunes this endpoint
            # can serve now (absent without a registry); engines and
            # routers both answer it.
            for eng in (primary, self.gen_engine):
                fn = getattr(eng, "adapters_resident", None)
                if callable(fn):
                    k = fn()
                    if k is not None:
                        body["adapters_resident"] = int(k)
                        break
            self._reply(200 if ready else 503, body)
        else:
            self._reply(404, {"error": f"no such path {self.path}"})

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

    def _do_generate(self):
        if self.gen_engine is None:
            self._reply(404, {"error": "no generation engine attached"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(req, dict):
                raise ValueError(
                    f"body must be a JSON object, got {type(req).__name__}")
            tokens = [int(t) for t in req["tokens"]]
            sampling = SamplingParams(
                temperature=float(req.get("temperature", 0.0)),
                top_k=int(req.get("top_k", 0)),
                seed=int(req.get("seed", 0)))
            kw = {}
            if req.get("adapter") is not None:
                kw["adapter"] = str(req["adapter"])
            if req.get("max_new_tokens") is not None:
                kw["max_new_tokens"] = int(req["max_new_tokens"])
            if "eos" in req:
                kw["eos_id"] = (None if req["eos"] is None
                                else int(req["eos"]))
            if req.get("deadline_ms") is not None:
                kw["deadline_ms"] = float(req["deadline_ms"])
            stream = bool(req.get("stream", True))
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad request: {e!r}"})
            return
        streaming = False
        try:
            handle = self.gen_engine.submit(tokens, sampling=sampling, **kw)
            if not stream:
                self._reply(200, handle.result())
                return
            kind, val = handle.next_event()
            if kind == "error":
                raise val
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            streaming = True
            while True:
                if kind == "token":
                    self._chunk(json.dumps({"token": val}).encode() + b"\n")
                elif kind == "done":
                    done = dict(val)
                    done["done"] = True
                    self._chunk(json.dumps(done).encode() + b"\n")
                    break
                else:   # error after tokens already streamed: terminal line
                    self._chunk(json.dumps(
                        {"error": repr(val), "done": True}).encode() + b"\n")
                    break
                kind, val = handle.next_event()
            self._chunk(b"")    # 0-length chunk terminates the stream
        except ServerOverloadedError as e:
            self._overloaded(e)
        except DeadlineExceededError as e:
            self._reply(504, {"error": str(e)})
        except PreemptedError as e:
            # Preempted past the retry budget before the first token
            # (headers not sent yet): a retryable 503 with the typed repr.
            self._reply(503, {"error": repr(e), "retryable": True})
        except ServerClosedError as e:
            self._reply(503, {"error": str(e), "retryable": False})
        except ValueError as e:
            self._reply(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — the engine funnels its
            # failures into the handle; without this the client would see
            # a connection reset instead of a status code.
            if streaming:
                raise   # headers already sent: let the server close it
            self._reply(500, {"error": f"generation failed: {e!r}"})


    def do_POST(self):
        if self.path == "/generate":
            self._do_generate()
            return
        if self.path != "/predict" or self.engine is None:
            self._reply(404, {"error": f"no such path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(req, dict):
                raise ValueError(
                    f"body must be a JSON object, got {type(req).__name__}")
            x = np.asarray(req["inputs"])
            deadline_ms = req.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)   # "abc" -> 400 below
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad request: {e!r}"})
            return
        try:
            out = self.engine.infer(x, deadline_ms=deadline_ms)
            self._reply(200, {"outputs": np.asarray(out).tolist()})
        except ServerOverloadedError as e:
            self._overloaded(e)
        except DeadlineExceededError as e:
            self._reply(504, {"error": str(e)})
        except ServerClosedError as e:
            self._reply(503, {"error": str(e), "retryable": False})
        except ValueError as e:   # shape mismatch from Engine.submit
            self._reply(400, {"error": str(e)})


class HttpServer:
    """Serve an :class:`~.engine.Engine` (and/or a
    :class:`~.generate.GenerationEngine` via ``generate=``) over HTTP on
    a background thread, with the JAX package's signature. With both
    attached, ``/predict`` hits the single-shot engine and ``/generate``
    the generation engine; ``/healthz`` is ready only when every attached
    engine is, and ``/stats`` nests the generation snapshot under
    ``"generate"``. ``port=0`` binds an ephemeral port (read it back from
    ``.port``)."""

    def __init__(self, engine=None, host: str = "127.0.0.1", port: int = 0,
                 *, generate=None):
        if engine is None and generate is None:
            raise ValueError(
                "HttpServer needs an engine= and/or a generate= engine")
        for e in (engine, generate):
            if e is not None and not getattr(e, "is_leader", True):
                raise ValueError(
                    f"this engine is a tp follower (its leader is global "
                    f"rank {e.leader_rank}): followers answer no "
                    f"requests — run HttpServer on the leader only")
        handler = type("BoundHandler", (_Handler,),
                       {"engine": engine, "gen_engine": generate})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HttpServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="hvd-torch-serve-http",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

"""Thin HTTP front end over :class:`~.generate.GenerationEngine`.

Port of the generation routes of the JAX package's ``serve/server.py``
(stdlib ``http.server`` only), mapping the engine's backpressure contract
onto HTTP status codes:

* ``POST /generate`` with ``{"tokens": [...], "max_new_tokens",
  "temperature", "top_k", "seed", "eos", "deadline_ms", "stream",
  "adapter"}`` (``adapter``: the tenant's resident LoRA fine-tune) →
  200 with **chunked** streaming: one JSON line per sampled token
  (``{"token": 17}``) the moment the engine emits it, then a final
  ``{"done": true, "finish_reason": ..., ...}`` line. ``"stream": false``
  buffers into one JSON object. The stream starts only once the first
  token exists, so queue-time failures still get real status codes:
  overload → 503 (with ``retry_after_ms`` and ``Retry-After``), deadline
  → 504, shut down → 503 (not retryable), bad request → 400.
* ``GET /stats`` → 200, the engine's snapshot as JSON.
* ``GET /healthz`` → 200 when ready, 503 while warming or draining;
  with an adapter registry the body also carries ``adapters_resident``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..exceptions import (DeadlineExceededError, ServerClosedError,
                          ServerOverloadedError)
from .generate import SamplingParams


class _Handler(BaseHTTPRequestHandler):
    gen_engine = None            # installed by HttpServer
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

    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        if path == "/stats":
            self._reply(200, self.gen_engine.stats())
        elif path == "/healthz":
            ready, status, depth = self.gen_engine.health()
            body = {"status": status, "queue_depth": depth}
            # Adapter-table residency: how many fine-tunes this endpoint
            # can serve now (absent without a registry).
            k = self.gen_engine.adapters_resident()
            if k is not None:
                body["adapters_resident"] = int(k)
            self._reply(200 if ready else 503, body)
        else:
            self._reply(404, {"error": f"no such path {self.path}"})

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

    def do_POST(self):
        if self.path != "/generate":
            self._reply(404, {"error": f"no such path {self.path}"})
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


class HttpServer:
    """Serve a :class:`~.generate.GenerationEngine` over HTTP on a
    background thread. ``port=0`` binds an ephemeral port (read it back
    from ``.port``)."""

    def __init__(self, generate, host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundHandler", (_Handler,), {"gen_engine": generate})
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

"""Out-of-process fleet replicas: a subprocess worker and its HTTP client.

Port of the JAX package's ``serve/proc_replica.py``. A thread replica's
death is a flipped flag; a real replica's death is a SIGKILLed process.
This module carries the fault-tolerance plane (drain-on-evict, liveness
verdicts, deterministic stream failover) across the process boundary:

* **The worker** (``python -m horovod_tpu_torch.serve.proc_replica --spec
  <json>``) builds a :class:`~.generate.GenerationEngine` from a JSON
  spec (model dims, a weight seed, generation knobs, the device), mounts
  :class:`~.server.HttpServer` (``/generate``, ``/stats``, ``/healthz``,
  ``/metrics``) and reports readiness through an atomically written
  ready file. The weights are drawn from the seed by a
  ``torch.Generator`` on the spec's device, so every sibling child (and a
  parent that draws from the same seed on the same device) holds bitwise
  the same weights. The parent drives the lifecycle over the child's
  stdin: a ``{"shutdown": {"drain": ...}}`` line drains or aborts, stdin
  EOF aborts, and a ``getppid()`` watchdog exits a child whose parent is
  gone, so a child never outlives its parent.
* **The client** (:class:`ProcReplicaClient`) duck-types the engine
  surface :class:`~.router.ReplicaHandle` consumes (``submit``,
  ``generate``, ``stats``, ``health``, ``prom_collect``, ``warmup``,
  ``shutdown(drain=)``, ``loop_alive``) over HTTP, with connect and read
  timeouts and bounded retry with backoff. A transport failure on
  ``submit`` maps to the retryable overload path
  (:class:`~..exceptions.ServerOverloadedError`), never a silent loss;
  a stream is admitted only once the child's 200 arrives (the server
  holds its headers until the first event).

``loop_alive`` answers from the pid first (a dead pid reads dead within
one membership poll), then from a ``/healthz`` probe with a two-strike
tolerance (one strike once :meth:`ProcReplicaClient.mark_suspect`
fired). Failover needs no new code: the replay envelope (tokens, seed,
absolute deadline) ships across processes, and the router's pump relays
the replacement child's HTTP stream as it would a thread's queue.

The child's samples are not relayed through the router's ``/metrics``
(``prom_collect`` is empty): the router's ``/healthz`` advertises each
child's endpoint under ``replica_metrics``, and a scraper
(:class:`~..obs.summary.FleetPoller`) walks them, one scrape an endpoint
a poll. A subprocess replica costs an interpreter, the model's build and
its warmup, and an HTTP round trip a dispatch: the trade for isolation
(a crash cannot take the fleet); threads pack more replicas of a small
model into one host.

Kernels are built once, by the parent: a child loads the library the
build directory already holds (``ops._build``), so two processes never
compile at once.
"""

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..exceptions import (DeadlineExceededError, PreemptedError,
                          ReplicaTimeoutError, ServerClosedError,
                          ServerOverloadedError, WorkerFailureError)
from .generate import GenerationHandle

_DEFAULT = object()     # mirrors generate.submit's eos_id sentinel


class _ClientCfg:
    """The slice of :class:`~.generate.GenerationConfig` the router
    reads off an engine object (``_track`` resolves the default
    deadline through ``engine._cfg.default_deadline_ms``)."""

    def __init__(self, default_deadline_ms: Optional[float] = None):
        self.default_deadline_ms = default_deadline_ms


class ProcReplicaClient:
    """HTTP client for one subprocess replica, shaped like an engine.

    ``proc`` is the child's ``subprocess.Popen`` (None in tests that
    fake the server side — every proc-dependent path then degrades to
    HTTP-only semantics). ``port`` may be unknown at construction: the
    worker binds an ephemeral port and publishes it through
    ``ready_file``; until that lands the replica reads ``warming`` and
    takes no traffic.

    Transport contract: ``submit`` maps
    EVERY transport failure — connect refusal, connect timeout, a
    mid-body disconnect before the response status line — to
    :class:`ServerOverloadedError` with a ``retry_after_ms`` hint,
    after a bounded retry-with-backoff on errors raised while the
    request was still being sent (nothing admitted yet, so a retry
    cannot double-submit). An error AFTER the request was fully sent is
    not client-retried (the child may already hold the stream; a blind
    retry would double-execute) but still maps to the overload path:
    the router re-dispatches, the orphaned child stream — if any —
    burns slots, never client-visible state. No stream is recorded as
    admitted until the 200 status line arrives.
    """

    def __init__(self, name: str, proc: Optional[subprocess.Popen] = None,
                 *, host: str = "127.0.0.1", port: Optional[int] = None,
                 ready_file: Optional[str] = None,
                 connect_timeout_s: float = 2.0,
                 read_timeout_s: float = 120.0,
                 probe_timeout_s: float = 1.0,
                 submit_retries: int = 2,
                 backoff_s: float = 0.05,
                 backoff_cap_s: float = 0.5,
                 ready_timeout_s: float = 180.0,
                 heartbeat_timeout_s: float = 5.0,
                 default_deadline_ms: Optional[float] = None):
        self.name = name
        self.serve_name = name          # router re-stamps on _attach
        self._proc = proc
        self._host = host
        self._port = port
        self._ready_file = ready_file
        self._connect_timeout = connect_timeout_s
        self._read_timeout = read_timeout_s
        self._probe_timeout = probe_timeout_s
        self._submit_retries = max(0, int(submit_retries))
        self._backoff = backoff_s
        self._backoff_cap = backoff_cap_s
        self._ready_timeout = ready_timeout_s
        self._hb_file = (ready_file + ".hb") if ready_file else None
        self._hb_timeout = heartbeat_timeout_s
        self._cfg = _ClientCfg(default_deadline_ms)
        self._closed = False            # router reads this as "draining"
        self._suspect = False
        self._miss_streak = 0
        self._inflight: set = set()
        self._inflight_lock = threading.Lock()
        self._last_stats: Dict[str, Any] = {}

    # -- process / readiness plumbing ---------------------------------------

    @property
    def pid(self) -> Optional[int]:
        return None if self._proc is None else self._proc.pid

    def _ensure_port(self) -> bool:
        """Resolve the child's ephemeral port from the ready file (one
        successful read sticks). False while the child is still
        booting."""
        if self._port is not None:
            return True
        if self._ready_file is None:
            return False
        try:
            with open(self._ready_file) as f:
                info = json.load(f)
            self._port = int(info["port"])
            self._host = info.get("host", self._host)
        except (OSError, ValueError, KeyError):
            return False
        return True

    def metrics_endpoint(self) -> Optional[str]:
        """``"host:port"`` of the child's own ``/metrics`` — what the
        router advertises in ``/healthz`` ``replica_metrics`` for
        scrapers to walk (the federation path; see module docstring)."""
        if not self._ensure_port():
            return None
        return f"{self._host}:{self._port}"

    # -- HTTP plumbing ------------------------------------------------------

    def _get_json(self, path: str, timeout: float) -> Dict[str, Any]:
        """One GET round trip, JSON-decoded whatever the status code
        (``/healthz`` answers 503 with a meaningful body). Raises
        :class:`ReplicaTimeoutError` on a transport TIMEOUT (the
        hung-child signal ``ReplicaHandle.load`` keys eviction on),
        plain ``OSError``/``HTTPException`` on other transport
        failures."""
        if not self._ensure_port():
            raise RuntimeError(f"replica {self.name} not ready yet")
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            body = resp.read()
        except TimeoutError as e:
            raise ReplicaTimeoutError(
                f"replica {self.name} ({self._host}:{self._port}) timed "
                f"out after {timeout}s on GET {path}") from e
        finally:
            conn.close()
        return json.loads(body.decode("utf-8", "replace") or "{}")

    # -- engine surface: health / load / stats ------------------------------

    def health(self) -> Tuple[bool, str, int]:
        """The child's ``/healthz`` verdict. Never raises — the router
        walks ``state()`` over the whole membership, and one unreachable
        child must not 500 the fleet's ``/stats``; unreachable reads as
        not-ready (the liveness plane owns the dead verdict)."""
        if not self._ensure_port():
            return False, "booting", 0
        try:
            body = self._get_json("/healthz", self._probe_timeout)
        except Exception:  # noqa: BLE001 — unreachable = not ready
            return False, "unreachable", 0
        status = str(body.get("status", "unreachable"))
        return status == "ok", status, int(body.get("queue_depth", 0))

    def load(self) -> int:
        """Dispatch pressure (queued + executing rows) from the child's
        ``/stats``. A transport timeout raises
        :class:`ReplicaTimeoutError` so the handle can key the
        suspect-and-check eviction path; any other failure propagates
        and reads as the busy sentinel."""
        snap = self._get_json("/stats", self._probe_timeout)
        self._last_stats = snap
        return int(snap.get("queue_depth", 0)) \
            + int(snap.get("active_slots", 0))

    def stats(self) -> Dict[str, Any]:
        """The child's full ``/stats`` snapshot — or the LAST-KNOWN one
        when the child no longer answers: the router folds a retiring
        replica's final totals into its monotone baselines, and a child
        that exited after a clean drain should contribute what it last
        reported, not zeros."""
        try:
            snap = self._get_json("/stats", max(self._probe_timeout, 5.0))
        except Exception:  # noqa: BLE001 — dead child keeps what it had
            return dict(self._last_stats)
        self._last_stats = snap
        return snap

    def adapter_names(self) -> Optional[Tuple[str, ...]]:
        """Resident adapter names from the child's ``/stats``
        ``adapter_table`` block — the surface the router's
        adapter-affinity dispatch reads (``None`` = the child hosts no
        registry and can never take adapter traffic). Served from the
        stats cache (``load()`` refreshes it every dispatch walk); one
        fresh fetch when nothing is cached yet."""
        snap = self._last_stats
        if not snap:
            snap = self.stats()
        table = snap.get("adapter_table")
        if not isinstance(table, dict):
            return None
        return tuple(table.get("names") or ())

    def adapters_resident(self) -> Optional[int]:
        names = self.adapter_names()
        return None if names is None else len(names)

    def prefix_digests(self) -> Tuple[str, ...]:
        """Registered-prefix route digests from the child's ``/stats``
        — the surface the router's prefix-affine dispatch reads (empty
        = nothing registered, never affine). Served from the stats
        cache (``load()`` refreshes it every dispatch walk); one fresh
        fetch when nothing is cached yet."""
        snap = self._last_stats
        if not snap:
            snap = self.stats()
        digests = snap.get("prefix_digests")
        if not isinstance(digests, (list, tuple)):
            return ()
        return tuple(str(d) for d in digests)

    @property
    def route_block_size(self) -> Optional[int]:
        """The child's KV block size (the digest granularity), from the
        same cached ``/stats`` snapshot ``prefix_digests`` reads."""
        bs = self._last_stats.get("block_size")
        return bs if isinstance(bs, int) and bs > 0 else None

    def slo_burn(self, tenant: str) -> float:
        """The child's current SLO burn fraction for ``tenant`` (0.0
        when unknown) — the router's SLO-aware dispatch signal, read
        from the stats cache (``load()`` refreshes it every dispatch
        walk, so the signal is at most one walk stale; a fresh HTTP
        fetch per sort key would multiply the dispatch round trips by
        the fleet size)."""
        t = (self._last_stats.get("tenants") or {}).get(tenant)
        if not isinstance(t, dict):
            return 0.0
        burn = t.get("slo_burn")
        return float(burn) if isinstance(burn, (int, float)) else 0.0

    def _active_rows(self) -> int:
        """Best-effort active-slot count for the router's fleet peak
        sampling — read from the stats cache (a fresh HTTP fetch per
        dispatch-time peak sample would double the dispatch round
        trips)."""
        return int(self._last_stats.get("active_slots", 0))

    def prom_collect(self):
        """Empty on purpose — a subprocess replica's samples are scraped
        at ITS advertised ``/metrics`` endpoint, never relayed through
        the router render (see module docstring: federation, not
        proxying)."""
        return {}, []

    def prom_metrics(self) -> str:
        return ""

    # -- liveness -----------------------------------------------------------

    def mark_suspect(self) -> None:
        """A transport timeout on the stats surface
        tightens the next liveness probe to one strike — a hung child
        must be evicted within one poll, not routed around forever."""
        self._suspect = True

    def loop_alive(self, stall_timeout_s: float = 60.0) -> bool:
        """The liveness verdict ``ReplicaHandle.alive()`` consumes:
        process-exit detection first (a dead pid reads dead IMMEDIATELY
        — within one membership poll, no heartbeat wait), then a
        ``/healthz`` reachability probe with a two-strike tolerance so
        one dropped packet is not an eviction (one strike once
        :meth:`mark_suspect` fired). A child still booting (no port
        yet) is warming, not dead."""
        del stall_timeout_s     # the child's own loop_alive covers stall
        if self._proc is not None and self._proc.poll() is not None:
            return False
        if not self._ensure_port():
            return True         # booting: add_replica's warmup gates traffic
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=self._probe_timeout)
        try:
            conn.request("GET", "/healthz")
            conn.getresponse().read()
        except Exception:  # noqa: BLE001 — any transport failure = strike
            self._miss_streak += 1
            return not (self._suspect or self._miss_streak >= 2)
        finally:
            conn.close()
        self._miss_streak = 0
        self._suspect = False
        return True

    def _heartbeat_stale(self) -> bool:
        """True once the worker's heartbeat file has gone silent past
        the timeout. A missing file reads FRESH, not stale — the child
        may still be booting (warmup gates traffic either way), and an
        operator pointing at a worker predating the heartbeat plane
        must not have every replica read dead."""
        if self._hb_file is None:
            return False
        try:
            age = time.time() - os.path.getmtime(self._hb_file)
        except OSError:
            return False
        return age > self._hb_timeout

    def aborted(self) -> bool:
        """The ``CoordClient.aborted`` surface, so a subprocess replica
        wires onto the existing :func:`~.fleet.heartbeat_liveness` hook
        unchanged: gone once the child process exited, its heartbeat
        file went stale, or the ``/healthz`` probe's two-strike verdict
        fired (the probe still runs — the heartbeat catches a SIGSTOPed
        or wedged-before-accept child the HTTP path answers for)."""
        if self._proc is not None and self._proc.poll() is not None:
            return True
        if self._heartbeat_stale():
            return True
        return not self.loop_alive()

    # -- engine surface: submit / generate ----------------------------------

    def submit(self, tokens: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               sampling: Any = None,
               eos_id: Any = _DEFAULT,
               deadline_ms: Optional[float] = None,
               adapter: Optional[str] = None) -> GenerationHandle:
        """POST the request to the child's ``/generate`` (streaming) and
        return a local :class:`GenerationHandle` relaying the chunked
        token lines. Blocks until the response STATUS LINE — the server
        holds headers until the first event, so admission verdicts
        (overload 503 / closed 503 / deadline 504 / malformed 400)
        surface here as the same synchronous exceptions a thread engine
        raises, and no stream is recorded as admitted on any earlier
        failure."""
        if self._closed:
            raise ServerClosedError(
                f"replica {self.name} client is shut down")
        if not self._ensure_port():
            err = ServerOverloadedError(
                f"replica {self.name} is still booting — retry after "
                f"backoff")
            err.retry_after_ms = 500.0
            raise err
        body = {"tokens": [int(t) for t in tokens], "stream": True}
        if max_new_tokens is not None:
            body["max_new_tokens"] = int(max_new_tokens)
        if sampling is not None:
            body["temperature"] = float(sampling.temperature)
            body["top_k"] = int(sampling.top_k)
            body["seed"] = int(sampling.seed)
        if eos_id is not _DEFAULT:
            body["eos"] = eos_id
        if deadline_ms is not None:
            body["deadline_ms"] = float(deadline_ms)
        if adapter is not None:
            body["adapter"] = adapter
        payload = json.dumps(body).encode()
        conn, resp = self._post_generate(payload)
        if resp.status != 200:
            try:
                err_body = json.loads(
                    resp.read().decode("utf-8", "replace") or "{}")
            except ValueError:
                err_body = {}
            finally:
                conn.close()
            self._raise_status(resp.status, err_body)
        handle = GenerationHandle()
        with self._inflight_lock:
            self._inflight.add(handle)
        threading.Thread(target=self._relay, args=(conn, resp, handle),
                         name=f"hvd-proc-relay-{self.name}",
                         daemon=True).start()
        return handle

    def _post_generate(self, payload: bytes):
        """The transport half of :meth:`submit`: bounded
        retry-with-backoff on errors raised while SENDING (nothing
        admitted — retry is safe), one shot on the response wait (the
        child may hold the stream — double-submit is the router's call,
        via the overload path)."""
        delay = self._backoff
        last: Optional[BaseException] = None
        for attempt in range(self._submit_retries + 1):
            conn = http.client.HTTPConnection(self._host, self._port,
                                              timeout=self._connect_timeout)
            try:
                conn.request("POST", "/generate", payload,
                             {"Content-Type": "application/json"})
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                last = e
                if attempt < self._submit_retries:
                    time.sleep(min(delay, self._backoff_cap))
                    delay *= 2
                    continue
                raise self._overload_from(
                    e, f"transport error sending submit after "
                       f"{attempt + 1} attempt(s)") from e
            try:
                # Headers arrive with the child's FIRST event; give the
                # wait the stream read timeout, not the connect timeout.
                if conn.sock is not None:
                    conn.sock.settimeout(self._read_timeout)
                return conn, conn.getresponse()
            except (OSError, http.client.HTTPException) as e:
                # Request fully sent: the child may have admitted the
                # stream. NOT client-retried (a blind retry could
                # double-submit); the overload mapping hands the verdict
                # to the router's dispatch walk.
                conn.close()
                raise self._overload_from(
                    e, "connection lost awaiting the submit verdict "
                       "(request was sent — the child may hold an "
                       "orphaned stream)") from e
        raise self._overload_from(last, "submit transport failed")

    def _overload_from(self, cause: Optional[BaseException],
                       what: str) -> ServerOverloadedError:
        err = ServerOverloadedError(
            f"replica {self.name} ({self._host}:{self._port}): {what} "
            f"({cause!r}) — mapped to the retryable-overload path, never "
            f"a silent loss")
        err.retry_after_ms = max(100.0, self._backoff * 1e3)
        return err

    def _raise_status(self, status: int, body: Dict[str, Any]) -> None:
        msg = str(body.get("error", f"HTTP {status}"))
        if status == 503:
            if body.get("retryable", True):
                # (A PreemptedError repr can land here too — preempted
                # past the budget before the FIRST token. At submit time
                # that is retryable overload: the dispatch walk tries the
                # next door. Only the mid-stream error line keeps the
                # typed verdict, via _wire_error.)
                err = ServerOverloadedError(msg)
                ra = body.get("retry_after_ms")
                if isinstance(ra, (int, float)):
                    err.retry_after_ms = float(ra)
                raise err
            raise ServerClosedError(msg)
        if status == 504:
            raise DeadlineExceededError(msg)
        if status == 400:
            raise ValueError(msg)
        raise WorkerFailureError(
            f"replica {self.name}: HTTP {status}: {msg}")

    def _relay(self, conn, resp, handle: GenerationHandle) -> None:
        """Reader thread: chunked JSON lines → handle events. A
        transport death mid-stream fails the handle with
        :class:`WorkerFailureError` — exactly the verdict the router's
        pump converts into a failover; a DEADLINE error line stays a
        deadline (the stream's own verdict, never failed over)."""
        try:
            for raw in iter(resp.readline, b""):
                line = raw.strip()
                if not line:
                    continue
                ev = json.loads(line)
                if ev.get("done"):
                    if "error" in ev:
                        handle._fail(self._wire_error(str(ev["error"])))
                    else:
                        handle._finish(
                            {k: v for k, v in ev.items() if k != "done"})
                    return
                if "token" in ev:
                    handle._emit(int(ev["token"]))
            handle._fail(WorkerFailureError(
                f"replica {self.name} closed the stream before the done "
                f"line"))
        except (OSError, http.client.HTTPException, ValueError) as e:
            handle._fail(WorkerFailureError(
                f"replica {self.name} connection lost mid-stream: {e!r}"))
        finally:
            conn.close()
            with self._inflight_lock:
                self._inflight.discard(handle)

    def _wire_error(self, text: str) -> Exception:
        if text.startswith("DeadlineExceededError"):
            return DeadlineExceededError(text)
        if text.startswith("PreemptedError"):
            # Keep the preemption verdict typed across the wire: the
            # router fails it over like any strand, but a FLEET-level
            # exhaustion must still report terminal reason
            # "preempted_exhausted" (priority congestion), not replica
            # death.
            return PreemptedError(f"replica {self.name}: {text}")
        return WorkerFailureError(f"replica {self.name}: {text}")

    def generate(self, tokens, timeout: Optional[float] = None, **kw):
        """Synchronous convenience (submit + result), mirroring the
        engine surface."""
        return self.submit(tokens, **kw).result(timeout)

    # -- lifecycle ----------------------------------------------------------

    def warmup(self) -> Tuple[str, ...]:
        """Block until the child reports ready (the worker warms its
        engine BEFORE publishing the ready file, so "ready" means
        warmed). Raises :class:`WorkerFailureError` on child exit or
        timeout — ``add_replica``'s warm thread then marks the handle
        dead, same as a failed thread-replica warmup."""
        deadline = time.monotonic() + self._ready_timeout
        while time.monotonic() < deadline:
            if self._proc is not None and self._proc.poll() is not None:
                raise WorkerFailureError(
                    f"replica {self.name} worker exited rc="
                    f"{self._proc.returncode} before reporting ready")
            if self._ensure_port():
                ready, _, _ = self.health()
                if ready:
                    return ("proc-ready",)
            time.sleep(0.05)
        raise WorkerFailureError(
            f"replica {self.name} worker not ready after "
            f"{self._ready_timeout}s")

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the child. ``drain=True`` asks the worker to finish its
        admitted streams first and WAITS for the streams this client is
        still relaying (the router's drain-on-evict contract crosses
        the process boundary); ``drain=False`` aborts, escalating
        SIGTERM → SIGKILL if the control message does not land.
        Idempotent, and safe on an already-dead child."""
        self._closed = True
        deadline = time.monotonic() + max(0.1, timeout)
        if self._proc is not None and self._proc.poll() is None:
            try:
                msg = json.dumps({"shutdown": {
                    "drain": bool(drain), "timeout": float(timeout)}})
                self._proc.stdin.write(msg.encode() + b"\n")
                self._proc.stdin.flush()
                self._proc.stdin.close()
            except (OSError, ValueError, AttributeError):
                pass
        if drain:
            # The child finishes the streams; this side must keep
            # relaying them — return only once every in-flight handle
            # has its terminal event (or the drain window closes).
            while time.monotonic() < deadline:
                with self._inflight_lock:
                    if not self._inflight:
                        break
                time.sleep(0.02)
            self.stats()    # final totals for the router's retire fold
        if self._proc is None:
            return
        try:
            self._proc.wait(max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            self._proc.terminate()
            try:
                self._proc.wait(2.0)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(5.0)


# -- spawning ---------------------------------------------------------------


def _backend_flags() -> Dict[str, bool]:
    """This process's numerics flags of the card's math libraries: a
    child replica sets the same, so its GEMMs give a replayed stream the
    parent's bits (TF32 on an f32 product, cuBLAS's reduced-precision
    reductions, cuDNN's TF32 and algorithm choice)."""
    import torch
    m = torch.backends.cuda.matmul
    return {
        "matmul_allow_tf32": bool(m.allow_tf32),
        "matmul_allow_bf16_reduced_precision_reduction":
            bool(m.allow_bf16_reduced_precision_reduction),
        "matmul_allow_fp16_reduced_precision_reduction":
            bool(m.allow_fp16_reduced_precision_reduction),
        "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
        "cudnn_deterministic": bool(torch.backends.cudnn.deterministic),
        "cudnn_benchmark": bool(torch.backends.cudnn.benchmark),
    }


def _apply_backend_flags(flags: Optional[Dict[str, bool]]) -> None:
    """Set the flags :func:`_backend_flags` recorded (absent keys keep
    this process's defaults)."""
    if not flags:
        return
    import torch
    m = torch.backends.cuda.matmul
    for key, obj, attr in (
            ("matmul_allow_tf32", m, "allow_tf32"),
            ("matmul_allow_bf16_reduced_precision_reduction", m,
             "allow_bf16_reduced_precision_reduction"),
            ("matmul_allow_fp16_reduced_precision_reduction", m,
             "allow_fp16_reduced_precision_reduction"),
            ("cudnn_allow_tf32", torch.backends.cudnn, "allow_tf32"),
            ("cudnn_deterministic", torch.backends.cudnn, "deterministic"),
            ("cudnn_benchmark", torch.backends.cudnn, "benchmark")):
        if key in flags:
            setattr(obj, attr, bool(flags[key]))


def spawn_replica_factory(spec: Dict[str, Any], *,
                          host: str = "127.0.0.1",
                          python: Optional[str] = None,
                          run_dir: Optional[str] = None,
                          ready_timeout_s: float = 180.0,
                          client_kwargs: Optional[Dict[str, Any]] = None):
    """Build a ``factory(name) -> ProcReplicaClient`` for
    ``FleetRouter(factory=...)``: spawn, warm, drain, evict and the
    autoscaler work unchanged over subprocess replicas.

    ``spec`` is the JSON engine description the worker rebuilds from
    (see :func:`worker_main`): ``model`` (``TransformerConfig`` kwargs,
    dtypes as strings), ``seed`` (the weights' draw: the same seed, dims
    and device give bitwise the same weights in every child),
    ``generation`` (``GenerationConfig`` kwargs), optional ``device``
    (default ``"cuda"``; a child that cannot reach it exits and its
    ``warmup()`` raises), ``warmup`` (default True), ``spec``
    (speculative decoding, ``SpecConfig`` kwargs) and ``adapters``
    (seeded LoRA tenants and quotas, :func:`_build_adapters`: trees are
    drawn again in the child, never shipped as bytes). The factory adds
    this process's numerics flags (``torch_backends``) unless the spec
    names them. Each child inherits the environment (``HVD_FAULT_SPEC``
    reaches its loop; ``HVD_TORCH_BUILD_DIR`` its kernel library) and
    gets a flight-recorder directory of its own
    (``$HVD_FLIGHTREC_DIR/<name>``)."""
    base = dict(spec)
    kw = dict(client_kwargs or {})

    def factory(name: str) -> ProcReplicaClient:
        rd = run_dir or tempfile.mkdtemp(prefix="hvd-proc-")
        os.makedirs(rd, exist_ok=True)
        spec_path = os.path.join(rd, f"{name}.spec.json")
        ready_path = os.path.join(rd, f"{name}.ready.json")
        child_spec = dict(base)
        child_spec["name"] = name
        child_spec.setdefault("host", host)
        child_spec.setdefault("torch_backends", _backend_flags())
        with open(spec_path, "w") as f:
            json.dump(child_spec, f)
        cmd = [python or sys.executable, "-m",
               "horovod_tpu_torch.serve.proc_replica",
               "--spec", spec_path, "--ready-file", ready_path,
               "--parent-pid", str(os.getpid())]
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        client = ProcReplicaClient(
            name, proc, host=child_spec["host"], ready_file=ready_path,
            ready_timeout_s=ready_timeout_s,
            default_deadline_ms=(child_spec.get("generation")
                                 or {}).get("default_deadline_ms"), **kw)
        factory.clients[name] = client
        return client

    # Liveness for FleetRouter(liveness_factory=...): each spawned client
    # has the ``aborted`` surface (pid, heartbeat file, two-strike
    # /healthz), which heartbeat_liveness reads. Names this factory never
    # minted (thread replicas attached by hand) get None: the handle
    # falls back to the engine's own probe.
    factory.clients = {}

    def liveness_factory(name: str):
        client = factory.clients.get(name)
        if client is None:
            return None
        from .fleet import heartbeat_liveness
        return heartbeat_liveness(client)

    factory.liveness_factory = liveness_factory
    return factory


# -- the worker entrypoint --------------------------------------------------


def _arm_parent_watchdog(parent_pid: int, engine_ref: list,
                         poll_s: float = 1.0) -> None:
    """A child must not outlive its parent: when the parent dies (even by
    SIGKILL, where stdin EOF may never come), the child is reparented and
    ``getppid()`` changes; abort the engine and exit. ``engine_ref`` is a
    one-slot list filled once the engine exists."""
    def _watch():
        while True:
            if os.getppid() != parent_pid:
                eng = engine_ref[0] if engine_ref else None
                if eng is not None:
                    try:
                        eng.shutdown(drain=False, timeout=2.0)
                    except Exception:  # noqa: BLE001 — exiting anyway
                        pass
                os._exit(3)
            time.sleep(poll_s)
    threading.Thread(target=_watch, daemon=True,
                     name="hvd-proc-parent-watchdog").start()


def _arm_heartbeat(hb_file: str, period_s: float = 1.0) -> None:
    """The worker's liveness beat: rewrite ``hb_file`` every ``period_s``
    (tmp + atomic replace: the parent reads the file's mtime). A
    SIGKILLed or SIGSTOPed worker stops beating, and the parent's
    :meth:`ProcReplicaClient.aborted` verdict flips within the heartbeat
    timeout."""
    def _beat():
        while True:
            try:
                tmp = hb_file + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"ts": time.time(), "pid": os.getpid()}, f)
                os.replace(tmp, hb_file)
            except OSError:
                pass        # a full disk must not kill the worker
            time.sleep(period_s)
    threading.Thread(target=_beat, daemon=True,
                     name="hvd-proc-heartbeat").start()


def _resolve_dtype(name):
    import torch
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}
    if name not in table:
        raise ValueError(
            f"spec dtype must be one of {sorted(table)}, got {name!r}")
    return table[name]


def _build_adapters(mcfg, ad: Optional[Dict[str, Any]], device="cuda"):
    """The worker's adapter plane from the spec's ``"adapters"`` block:
    ``{"rank", "alpha", "capacity", "entries": [{"name", "seed",
    "b_scale", "quota", "weight", "priority", "slo_ttft_ms"}, ...]}``.
    Each tree is drawn from its entry's seed (``init_adapter`` with a
    ``torch.Generator`` on ``device`` seeded by it), not shipped as
    bytes, so a replacement child after a SIGKILL holds bitwise the same
    table. Per entry, all optional: ``quota`` caps the tenant's streams
    in flight, ``weight``/``priority`` its fair-scheduling class,
    ``slo_ttft_ms`` its TTFT target; the base tenant takes the same knobs
    as ``"base_quota"``, ``"base_weight"``, ``"base_priority"``,
    ``"base_slo_ttft_ms"``."""
    if not ad:
        return None
    entries = list(ad.get("entries") or [])
    if not entries:
        return None
    import torch

    from ..device import resolve_device
    from ..parallel.lora import LoraConfig, init_adapter
    from .adapters import AdapterRegistry

    dev = resolve_device(device)
    lora = LoraConfig(rank=int(ad.get("rank", 4)),
                      alpha=float(ad.get("alpha", 8.0)))
    reg = AdapterRegistry(mcfg, lora,
                          capacity=int(ad.get("capacity", len(entries))),
                          device=dev)
    for e in sorted(entries, key=lambda x: str(x.get("name"))):
        gen = torch.Generator(device=dev).manual_seed(int(e["seed"]))
        tree = init_adapter(gen, mcfg, lora,
                            b_scale=float(e.get("b_scale", 0.0)),
                            device=dev)
        q = e.get("quota")
        name = str(e["name"])
        reg.load(name, tree, quota=int(q) if q is not None else None)
        _apply_policy(reg, name, e.get("weight"), e.get("priority"),
                      e.get("slo_ttft_ms"))
    bq = ad.get("base_quota")
    if bq is not None:
        reg.set_quota("base", int(bq))
    _apply_policy(reg, "base", ad.get("base_weight"),
                  ad.get("base_priority"), ad.get("base_slo_ttft_ms"))
    return reg


def _apply_policy(reg, tenant: str, weight, priority, slo_ttft_ms) -> None:
    """Stamp one tenant's optional scheduling policy onto the registry
    (absent keys leave the engine's defaults: weight 1.0, priority 0, no
    SLO)."""
    if weight is not None:
        reg.set_weight(tenant, float(weight))
    if priority is not None:
        reg.set_priority(tenant, int(priority))
    if slo_ttft_ms is not None:
        reg.set_slo_ttft_ms(tenant, float(slo_ttft_ms))


def build_engine(spec: Dict[str, Any]):
    """The worker's engine from a spec (see
    :func:`spawn_replica_factory`): the model's weights drawn by a
    ``torch.Generator`` on the spec's ``device`` (default ``"cuda"``)
    seeded with ``seed``, the generation config, the optional speculative
    and adapter planes, the recorded numerics flags applied first. Raises
    when the device cannot be reached: a replica never falls back to
    another device."""
    import torch

    from ..device import resolve_device
    from ..parallel.transformer import Transformer, TransformerConfig
    from .generate import GenerationConfig, GenerationEngine
    from .spec import SpecConfig

    dev = resolve_device(spec.get("device", "cuda"))
    _apply_backend_flags(spec.get("torch_backends"))
    model_kw = dict(spec.get("model") or {})
    for key in ("dtype", "unembed_dtype"):
        if isinstance(model_kw.get(key), str):
            model_kw[key] = _resolve_dtype(model_kw[key])
    mcfg = TransformerConfig(**model_kw)
    gen = torch.Generator(device=dev).manual_seed(int(spec.get("seed", 0)))
    model = Transformer(mcfg, generator=gen, device=dev)
    gcfg = GenerationConfig(**(spec.get("generation") or {}))
    spec_cfg = (SpecConfig.from_spec(spec["spec"])
                if spec.get("spec") else None)
    registry = _build_adapters(mcfg, spec.get("adapters"), dev)
    return GenerationEngine(model, gcfg, device=dev, adapters=registry,
                            spec=spec_cfg)


def worker_main(argv: Optional[List[str]] = None) -> int:
    """The replica worker: spec → engine → warmup → HttpServer → ready
    file, then block on the stdin control channel until the parent says
    shutdown (or disappears)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve.proc_replica",
        description="Out-of-process serving replica worker")
    ap.add_argument("--spec", required=True,
                    help="path to the JSON engine spec")
    ap.add_argument("--ready-file", required=True,
                    help="path the worker writes its readiness/port to")
    ap.add_argument("--parent-pid", type=int, default=0,
                    help="parent pid for the orphan watchdog (0 = off)")
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    name = spec.get("name", "proc")
    # A flight-recorder directory a replica: every child dumps as rank 0,
    # so siblings sharing the parent's directory would overwrite each
    # other's post-mortems.
    base_dir = os.environ.get("HVD_FLIGHTREC_DIR")
    if base_dir:
        child_dir = os.path.join(base_dir, name)
        os.makedirs(child_dir, exist_ok=True)
        os.environ["HVD_FLIGHTREC_DIR"] = child_dir
    engine_ref: list = []
    if args.parent_pid:
        _arm_parent_watchdog(args.parent_pid, engine_ref)

    # The heavy imports after the watchdog is armed: a parent that dies
    # while the child imports torch must still reap it.
    from .server import HttpServer

    eng = build_engine(spec)
    eng.serve_name = name       # fault clauses and flightrec key on it
    engine_ref.append(eng)
    if spec.get("warmup", True):
        eng.warmup()
    srv = HttpServer(generate=eng, host=spec.get("host", "127.0.0.1"),
                     port=int(spec.get("port", 0)))
    srv.start()
    ready = {"ready": True, "pid": os.getpid(),
             "host": srv.host, "port": srv.port, "name": name}
    tmp = args.ready_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ready, f)
    os.replace(tmp, args.ready_file)    # atomic: no torn ready read
    _arm_heartbeat(args.ready_file + ".hb")
    print(f"[proc_replica] {name}: ready on {srv.host}:{srv.port} "
          f"(pid {os.getpid()}, {eng.stats()['device']})", flush=True)

    closed = False
    try:
        for raw in sys.stdin.buffer:
            try:
                msg = json.loads(raw)
            except ValueError:
                continue
            sd = msg.get("shutdown")
            if sd is not None:
                eng.shutdown(drain=bool(sd.get("drain", True)),
                             timeout=float(sd.get("timeout", 30.0)))
                closed = True
                break
    except KeyboardInterrupt:
        pass
    finally:
        if not closed:
            # stdin EOF: the parent died or dropped the pipe — abort,
            # never orphan (the watchdog's verdict too).
            eng.shutdown(drain=False, timeout=5.0)
        # Let in-flight handler threads flush their final chunks before
        # the listener goes away.
        time.sleep(0.2)
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())

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

**A replica that is a tp group.** With ``"tp": n > 1`` in the spec, a
replica is a tp world of ``n`` processes, one a device: rank 0, the
leader, runs the engine loop and the HTTP server; ranks 1..n-1, the
followers, follow it through the step plane (:mod:`.tp_plane`). The
factory gives each group a device set (``device_groups=``, or consecutive
sets of ``n`` of this host's GPUs), a fresh rendezvous on a free port of
``host`` and the launcher's environment contract (``HVD_RANK``,
``HVD_SIZE``, ``HVD_LOCAL_RANK`` = the rank's device index,
``HVD_RESTART_EPOCH``, ``MASTER_ADDR``, ``MASTER_PORT``, ``HVD_DEVICE``).
The world's backend follows the device set: NCCL over distinct GPUs,
gloo where ranks share a GPU (NCCL refuses two ranks on one device) and
on the CPU. The group is one :class:`ProcReplicaClient`, so the router,
its failover and the autoscaler need nothing new: the client talks HTTP
to the leader, and its liveness covers every rank (any rank's exit or
stale heartbeat reads the group dead). A group that loses a rank is torn
down whole: the leader exits once its step plane is down, a follower once
its leader is gone, and the client reaps every rank, SIGKILLing a
straggler. The JAX package drives a tp engine from one controller, so
there a group is one process; here it is ``n``.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
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


def _hb_path(ready_file: str, rank: int = 0) -> str:
    """The heartbeat file of a replica's rank ``rank`` (rank 0: the
    leader, or the one child of a tp = 1 replica)."""
    return ready_file + ".hb" if rank == 0 else f"{ready_file}.hb{rank}"


class ProcReplicaClient:
    """HTTP client for one subprocess replica, shaped like an engine.

    ``proc`` is the child's ``subprocess.Popen`` (None in tests that
    fake the server side — every proc-dependent path then degrades to
    HTTP-only semantics). ``port`` may be unknown at construction: the
    worker binds an ephemeral port and publishes it through
    ``ready_file``; until that lands the replica reads ``warming`` and
    takes no traffic.

    A tp group's client also holds its ``followers`` (the ``Popen`` of
    ranks 1..n-1, in rank order): the group reads dead once any rank's
    process exits or any rank's heartbeat file goes stale, and
    :meth:`shutdown` reaps every rank.

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
                 default_deadline_ms: Optional[float] = None,
                 followers: Sequence[subprocess.Popen] = ()):
        self.name = name
        self.serve_name = name          # router re-stamps on _attach
        self._proc = proc
        self._followers = list(followers)
        self.tp = 1 + len(self._followers)
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
        self._hb_files = ([_hb_path(ready_file, r) for r in range(self.tp)]
                          if ready_file else [])
        self._hb_timeout = heartbeat_timeout_s
        self._cfg = _ClientCfg(default_deadline_ms)
        self._closed = False            # router reads this as "draining"
        self._suspect = False
        self._miss_streak = 0
        self._inflight: set = set()
        self._inflight_lock = threading.Lock()
        self._last_stats: Dict[str, Any] = {}
        # Submits this client started, those awaiting their verdict, those
        # admitted, and the child's requests_total that is not theirs:
        # what load() adds for requests the child has not counted yet.
        self._submits = self._awaiting = self._admitted = 0
        self._foreign = 0

    # -- process / readiness plumbing ---------------------------------------

    @property
    def pid(self) -> Optional[int]:
        return None if self._proc is None else self._proc.pid

    @property
    def pids(self) -> List[int]:
        """Every rank's pid, in rank order (the leader's first)."""
        return [p.pid for p in self._procs()]

    def _procs(self) -> list:
        return ([] if self._proc is None else [self._proc]) + self._followers

    def _any_exited(self) -> bool:
        """Whether any rank's process has exited (the group is then
        dead: a tp world does not survive a lost rank)."""
        return any(p.poll() is not None for p in self._procs())

    def exited(self) -> bool:
        """Whether every rank's process has exited (its devices are
        free again)."""
        return all(p.poll() is not None for p in self._procs())

    def rank_heartbeats(self) -> List[Dict[str, Any]]:
        """Each rank's last heartbeat record, in rank order (``{}`` for a
        rank that has not beaten yet): its ``ts``, ``pid``, ``rank``,
        ``device``, kernel ``launches`` since it started and, on a GPU,
        ``peak_bytes`` (``torch.cuda.max_memory_allocated``)."""
        out = []
        for path in self._hb_files:
            try:
                with open(path) as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                out.append({})
        return out

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
        """Dispatch pressure: queued + executing rows from the child's
        ``/stats``, plus this client's submits the child has not counted
        yet (sent, awaiting their verdict, and not in its
        ``requests_total``), so that a burst of concurrent submits does
        not read an idle child over and over. A transport timeout raises
        :class:`ReplicaTimeoutError` so the handle can key the
        suspect-and-check eviction path; any other failure propagates
        and reads as the busy sentinel."""
        with self._inflight_lock:
            before = (self._submits, self._awaiting)
        snap = self._get_json("/stats", self._probe_timeout)
        self._last_stats = snap
        depth = int(snap.get("queue_depth", 0)) \
            + int(snap.get("active_slots", 0))
        counted = int(snap.get("requests_total", 0))
        with self._inflight_lock:
            if self._awaiting == 0:
                if before == (self._submits, 0):
                    # Nothing of ours was on the wire during the read:
                    # every request the child counted beyond our
                    # admitted ones came from elsewhere.
                    self._foreign = counted - self._admitted
                return depth
            ours = counted - self._foreign
            unseen = self._admitted + self._awaiting - ours
            return depth + max(0, min(self._awaiting, unseen))

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
        if self._any_exited():
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
        """True once any rank's heartbeat file has gone silent past the
        timeout. A missing file reads FRESH, not stale — the child may
        still be booting (warmup gates traffic either way), and an
        operator pointing at a worker predating the heartbeat plane
        must not have every replica read dead."""
        now = time.time()
        for path in self._hb_files:
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue
            if age > self._hb_timeout:
                return True
        return False

    def aborted(self) -> bool:
        """The ``CoordClient.aborted`` surface, so a subprocess replica
        wires onto the existing :func:`~.fleet.heartbeat_liveness` hook
        unchanged: gone once any rank's process exited, any rank's
        heartbeat file went stale, or the leader's ``/healthz`` probe's
        two-strike verdict fired (the probe still runs — the heartbeat
        catches a SIGSTOPed or wedged-before-accept child the HTTP path
        answers for)."""
        if self._any_exited():
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
        with self._inflight_lock:
            self._submits += 1
            self._awaiting += 1
        admitted = False
        try:
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
            admitted = True
        finally:
            with self._inflight_lock:
                self._awaiting -= 1
                self._admitted += admitted
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
            for rank, p in enumerate(self._procs()):
                if p.poll() is not None:
                    raise WorkerFailureError(
                        f"replica {self.name} worker"
                        f"{f' rank {rank}' if self.tp > 1 else ''} exited "
                        f"rc={p.returncode} before reporting ready")
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
        A tp group's leader releases its followers as its loop ends; the
        client then waits for every rank until the timeout and SIGKILLs
        any still alive. Idempotent, and safe on an already-dead child."""
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
        for p in self._followers:
            # Released by the leader's STOP, or failed by its death: a
            # follower exits on its own, given a moment past the leader.
            try:
                p.wait(max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(5.0)


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


#: Launcher variables a group's child must not inherit from this process
#: (it gets its own rank, size and rendezvous), and per-process listeners
#: that would collide across the children of one host.
_GROUP_ENV_DROP = ("HVD_RANK", "PMI_RANK", "OMPI_COMM_WORLD_RANK",
                   "HVD_SIZE", "PMI_SIZE", "OMPI_COMM_WORLD_SIZE",
                   "HVD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
                   "MASTER_ADDR", "MASTER_PORT", "HVD_COORD_ADDR",
                   "HVD_METRICS_PORT", "HOROVOD_TIMELINE")


def _spec_tp(spec: Dict[str, Any]) -> int:
    tp = spec.get("tp", 1)
    if isinstance(tp, bool) or not isinstance(tp, int) or tp < 1:
        raise ValueError(f"spec tp must be an int >= 1, got {tp!r}")
    return tp


def _device_name(d: Any) -> str:
    """``"cpu"`` or ``"cuda:<i>"`` (``ValueError`` for anything else: a
    group's device is named, never resolved later)."""
    name = str(d)
    if name == "cpu":
        return name
    head, _, idx = name.partition(":")
    if head == "cuda" and idx.isdigit():
        return f"cuda:{int(idx)}"
    raise ValueError(f"a group's device is 'cpu' or 'cuda:<i>', got {d!r}")


def group_backend(devices: Sequence[str]) -> str:
    """The backend of a tp world over ``devices``: NCCL where they are
    distinct GPUs, gloo where ranks share a GPU (NCCL refuses two ranks
    on one device) and on the CPU."""
    if all(d == "cpu" for d in devices):
        return "gloo"
    return "nccl" if len(set(devices)) == len(devices) else "gloo"


def check_group_spec(spec: Dict[str, Any],
                     device_groups: Optional[Sequence[Sequence[str]]] = None
                     ) -> Tuple[int, Optional[List[List[str]]]]:
    """Validate a replica spec's tp group in the parent, before anything
    is spawned: ``tp`` divides ``n_heads`` and ``d_ff``, the model is
    dense (``n_experts`` 0: serving runs on a tp mesh only), and every
    device set of ``device_groups`` has ``tp`` devices of one type.
    Returns ``(tp, device_groups normalized)``; raises ``ValueError``."""
    tp = _spec_tp(spec)
    model = spec.get("model") or {}
    if tp > 1 or device_groups is not None:
        if int(model.get("n_experts", 0) or 0):
            raise ValueError(
                f"a tp group serves a dense model: n_experts="
                f"{model['n_experts']} needs an ep axis, and serving runs "
                f"on a tp mesh only")
        for key in ("n_heads", "d_ff"):
            if key in model and int(model[key]) % tp:
                raise ValueError(f"spec tp={tp} must divide model {key}="
                                 f"{model[key]}")
    if tp > 1 and device_groups is None:
        dev = str(spec.get("device", "cuda"))
        if dev not in ("cuda", "cpu"):
            raise ValueError(
                f"spec device {dev!r} names one device; a tp={tp} group "
                f"needs one a rank: pass device_groups=, or device 'cuda' "
                f"(consecutive sets of this host's GPUs) or 'cpu'")
    if device_groups is None:
        return tp, None
    groups = []
    for g in device_groups:
        devs = [_device_name(d) for d in g]
        if len(devs) != tp:
            raise ValueError(f"device set {list(g)} has {len(devs)} "
                             f"devices; a tp={tp} group needs {tp}")
        if len({d == "cpu" for d in devs}) > 1:
            raise ValueError(f"device set {list(g)} mixes the CPU and "
                             f"GPUs")
        groups.append(devs)
    if not groups:
        raise ValueError("device_groups is empty")
    return tp, groups


class _DevicePlan:
    """Which device set each group of a factory takes: the explicit sets
    of ``device_groups`` in order, else ``"cpu"`` for every rank (a CPU
    spec), else consecutive sets of ``tp`` of this host's GPUs. A set is
    free once no group holds it or its group's processes have all
    exited; a grow with no free set raises (never another device)."""

    def __init__(self, tp: int, device: str,
                 groups: Optional[List[List[str]]]):
        self.tp = tp
        self._device = device
        self._groups = groups
        self._owner: Dict[int, ProcReplicaClient] = {}

    def _sets(self) -> Optional[List[List[str]]]:
        if self._groups is not None:
            return self._groups
        if self._device == "cpu":
            return None
        import torch
        n = torch.cuda.device_count()
        return [[f"cuda:{i * self.tp + r}" for r in range(self.tp)]
                for i in range(n // self.tp)]

    def take(self, name: str) -> Tuple[int, List[str]]:
        sets = self._sets()
        if sets is None:
            idx = len(self._owner)
            return idx, ["cpu"] * self.tp
        for idx, devs in enumerate(sets):
            held = self._owner.get(idx)
            if held is None or held.exited():
                return idx, devs
        raise RuntimeError(
            f"no free device set for replica {name}: the {len(sets)} "
            f"set(s) of {self.tp} device(s) ({sets}) are all held by live "
            f"groups ({sorted(c.name for c in self._owner.values())}); "
            f"pass more device_groups= or shrink first")

    def hold(self, idx: int, client: ProcReplicaClient) -> None:
        self._owner[idx] = client


def _free_port(host: str) -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def group_env(rank: int, tp: int, device: str, host: str,
              port: int) -> Dict[str, str]:
    """The environment of a group's rank ``rank``: this process's, minus
    the launcher and listener variables of :data:`_GROUP_ENV_DROP`, plus
    the launcher's contract: ``HVD_RANK``, ``HVD_SIZE``,
    ``HVD_LOCAL_RANK`` (the rank's device index on a GPU, its rank on the
    CPU), ``HVD_RESTART_EPOCH``, ``MASTER_ADDR``/``MASTER_PORT`` (the
    group's rendezvous) and ``HVD_DEVICE``; on the CPU an empty
    ``CUDA_VISIBLE_DEVICES`` and ``OMP_NUM_THREADS`` (unless set) as the
    launcher's ``--cpu`` exports them."""
    env = {k: v for k, v in os.environ.items() if k not in _GROUP_ENV_DROP}
    cpu = device == "cpu"
    env.update(HVD_RANK=str(rank), HVD_SIZE=str(tp),
               HVD_LOCAL_RANK=str(rank if cpu else
                                  int(device.partition(":")[2])),
               HVD_RESTART_EPOCH=os.environ.get("HVD_RESTART_EPOCH", "0"),
               MASTER_ADDR=host, MASTER_PORT=str(port),
               HVD_DEVICE="cpu" if cpu else "cuda")
    if cpu:
        env["CUDA_VISIBLE_DEVICES"] = ""
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 1) // tp)))
    return env


def spawn_replica_factory(spec: Dict[str, Any], *,
                          host: str = "127.0.0.1",
                          python: Optional[str] = None,
                          run_dir: Optional[str] = None,
                          ready_timeout_s: float = 180.0,
                          client_kwargs: Optional[Dict[str, Any]] = None,
                          device_groups: Optional[
                              Sequence[Sequence[str]]] = None):
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
    (``$HVD_FLIGHTREC_DIR/<name>``).

    ``tp`` in ``spec`` (default 1) makes each replica a tp group of that
    many processes (see the module docstring), on the device sets of
    ``device_groups`` (each a list of ``tp`` names, ``"cuda:<i>"`` or
    ``"cpu"``; successive groups take free sets in order) or, without
    it, ``"cpu"`` for every rank of a CPU spec and consecutive sets of
    ``tp`` of ``torch.cuda.device_count()`` GPUs otherwise. Optional
    ``world_timeout_s`` (default 60) is the group world's collective
    timeout: the step plane's one bound. The spec is checked here,
    before any spawn (:func:`check_group_spec`). At ``tp`` 1 without
    ``device_groups`` every replica is one child on ``device``, as
    before groups existed."""
    tp, groups = check_group_spec(spec, device_groups)
    base = dict(spec)
    kw = dict(client_kwargs or {})
    plan = (_DevicePlan(tp, str(spec.get("device", "cuda")), groups)
            if tp > 1 or groups is not None else None)

    def _paths(name: str) -> Tuple[str, str, Dict[str, Any]]:
        rd = run_dir or tempfile.mkdtemp(prefix="hvd-proc-")
        os.makedirs(rd, exist_ok=True)
        child_spec = dict(base)
        child_spec["name"] = name
        child_spec.setdefault("host", host)
        child_spec.setdefault("torch_backends", _backend_flags())
        ready_path = os.path.join(rd, f"{name}.ready.json")
        # A run directory reused across fleets: a stale ready, heartbeat
        # or arrival file of an earlier replica of this name would read
        # as this one's.
        for r in range(tp):
            for path in (_hb_path(ready_path, r),
                         f"{ready_path}.arrived{r}"):
                if os.path.exists(path):
                    os.remove(path)
        if os.path.exists(ready_path):
            os.remove(ready_path)
        return os.path.join(rd, f"{name}.spec.json"), ready_path, child_spec

    def _cmd(spec_path: str, ready_path: str) -> List[str]:
        return [python or sys.executable, "-m",
                "horovod_tpu_torch.serve.proc_replica",
                "--spec", spec_path, "--ready-file", ready_path,
                "--parent-pid", str(os.getpid())]

    def _client(name, child_spec, ready_path, proc, followers=()):
        return ProcReplicaClient(
            name, proc, host=child_spec["host"], ready_file=ready_path,
            ready_timeout_s=ready_timeout_s,
            default_deadline_ms=(child_spec.get("generation")
                                 or {}).get("default_deadline_ms"),
            followers=followers, **kw)

    def factory(name: str) -> ProcReplicaClient:
        spec_path, ready_path, child_spec = _paths(name)
        if plan is None:
            with open(spec_path, "w") as f:
                json.dump(child_spec, f)
            proc = subprocess.Popen(_cmd(spec_path, ready_path),
                                    stdin=subprocess.PIPE)
            client = _client(name, child_spec, ready_path, proc)
            factory.clients[name] = client
            return client
        idx, devices = plan.take(name)
        if tp == 1:
            child_spec["device"] = devices[0]
        child_spec.update(tp=tp, devices=devices,
                          backend=group_backend(devices))
        with open(spec_path, "w") as f:
            json.dump(child_spec, f)
        procs: List[subprocess.Popen] = []
        try:
            if tp == 1:
                procs.append(subprocess.Popen(_cmd(spec_path, ready_path),
                                              stdin=subprocess.PIPE))
            else:
                port = _free_port(child_spec["host"])
                for rank, dev in enumerate(devices):
                    procs.append(subprocess.Popen(
                        _cmd(spec_path, ready_path),
                        stdin=(subprocess.PIPE if rank == 0
                               else subprocess.DEVNULL),
                        env=group_env(rank, tp, dev, child_spec["host"],
                                      port)))
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise
        client = _client(name, child_spec, ready_path, procs[0], procs[1:])
        plan.hold(idx, client)
        factory.clients[name] = client
        return client

    # Liveness for FleetRouter(liveness_factory=...): each spawned client
    # has the ``aborted`` surface (every rank's pid and heartbeat file, a
    # two-strike /healthz on the leader), which heartbeat_liveness reads.
    # Names this factory never minted (thread replicas attached by hand)
    # get None: the handle falls back to the engine's own probe.
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


def _arm_heartbeat(hb_file: str, period_s: float = 1.0, *,
                   rank: int = 0, device=None) -> None:
    """The worker's liveness beat: rewrite ``hb_file`` every ``period_s``
    (tmp + atomic replace: the parent reads the file's mtime). A
    SIGKILLed or SIGSTOPed worker stops beating, and the parent's
    :meth:`ProcReplicaClient.aborted` verdict flips within the heartbeat
    timeout. Each beat also carries the rank, its device, the kernel
    launches this process made (``ops.LAUNCHES``) and, on a GPU, its peak
    allocated bytes (:meth:`ProcReplicaClient.rank_heartbeats`)."""
    from ..ops import LAUNCHES

    def record() -> Dict[str, Any]:
        rec = {"ts": time.time(), "pid": os.getpid(), "rank": rank,
               "device": None if device is None else str(device),
               "launches": LAUNCHES.snapshot()}
        if device is not None and device.type == "cuda":
            import torch
            rec["peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
        return rec

    def _beat():
        while True:
            try:
                tmp = hb_file + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(record(), f)
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


def _build_adapters(mcfg, ad: Optional[Dict[str, Any]], device="cuda",
                    mesh=None):
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
    ``"base_slo_ttft_ms"``. On a tp ``mesh`` every rank builds the
    registry and only the leader loads the tenants (their rows reach the
    followers with its next device call)."""
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
                          device=dev, mesh=mesh)
    if mesh is not None and mesh.coords.get("tp", 0) != 0:
        return reg
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


def build_engine(spec: Dict[str, Any], mesh=None):
    """The worker's engine from a spec (see
    :func:`spawn_replica_factory`): the model's weights drawn by a
    ``torch.Generator`` on the spec's ``device`` (default ``"cuda"``)
    seeded with ``seed``, the generation config, the optional speculative
    and adapter planes, the recorded numerics flags applied first. On a
    tp ``mesh`` every rank draws the global weights and keeps its blocks
    (``Transformer(mesh=)``). Raises when the device cannot be reached: a
    replica never falls back to another device."""
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
    model = Transformer(mcfg, generator=gen, device=dev, mesh=mesh)
    gcfg = GenerationConfig(**(spec.get("generation") or {}))
    spec_cfg = (SpecConfig.from_spec(spec["spec"])
                if spec.get("spec") else None)
    registry = _build_adapters(mcfg, spec.get("adapters"), dev, mesh=mesh)
    return GenerationEngine(model, gcfg, device=dev, adapters=registry,
                            spec=spec_cfg)


def _publish_ready(ready_file: str, info: Dict[str, Any]) -> None:
    tmp = ready_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f)
    os.replace(tmp, ready_file)     # atomic: no torn ready read


def _serve_stdin(eng, srv) -> int:
    """The leader's control channel: block on stdin until the parent says
    shutdown (or disappears: EOF aborts, never orphans), then stop the
    engine and the listener."""
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


#: How long a group's rank waits for the others to start (import torch
#: and the port) before the rendezvous.
_ARRIVE_TIMEOUT_S = 120.0


def _arrive(ready_file: str, rank: int, tp: int, limit_s: float) -> None:
    """Wait until every rank of the group has started (imported torch and
    the port), so that the rendezvous, bounded by the world's timeout,
    sees no start-up skew."""
    open(f"{ready_file}.arrived{rank}", "w").close()
    deadline = time.monotonic() + limit_s
    while not all(os.path.exists(f"{ready_file}.arrived{r}")
                  for r in range(tp)):
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank {rank}: the group's other ranks did "
                               f"not start within {limit_s} s")
        time.sleep(0.01)


def _arm_group_watchdog(eng, name: str, poll_s: float = 0.1) -> None:
    """The leader leaves a broken group: once its step plane is down (a
    follower died, or a device call failed after its descriptor went
    out), no call can run again, so the process exits after a moment for
    the HTTP handlers to send their streams' error lines. The followers
    then fail too, and the group is gone whole."""
    def _watch():
        while eng.plane_error is None:
            time.sleep(poll_s)
        time.sleep(0.5)
        print(f"[proc_replica] {name}: the tp group lost a rank "
              f"({eng.plane_error!r}); exiting", flush=True)
        os._exit(4)
    threading.Thread(target=_watch, daemon=True,
                     name="hvd-proc-group-watchdog").start()


def _group_worker(spec: Dict[str, Any], ready_file: str, name: str,
                  engine_ref: list) -> int:
    """One rank of a tp group replica (see the module docstring): join
    the group's world on this rank's device, build the engine on a tp
    mesh; the leader warms, serves HTTP, writes the ready file (every
    rank's pid and device) and reads the control channel; a follower
    beats and follows until the leader stops it (exit 0) or is gone
    (exit 1)."""
    import datetime

    import torch.distributed as dist

    from .. import runtime
    from ..device import resolve_device
    from ..parallel.mesh import create_hybrid_mesh
    from ..utils import config as _config
    from .server import HttpServer

    tp = _spec_tp(spec)
    rank = _config.launcher_rank()
    dev_name = spec["devices"][rank]
    resolve_device(dev_name)    # no CUDA here: exit before the rendezvous
    timeout = datetime.timedelta(
        seconds=float(spec.get("world_timeout_s", 60.0)))
    _arrive(ready_file, rank, tp, _ARRIVE_TIMEOUT_S)
    if spec["backend"] == "gloo" and dev_name != "cpu":
        # Ranks sharing a GPU: NCCL refuses two ranks on one device, so
        # the world is gloo, built here and adopted by init().
        dist.init_process_group("gloo", init_method="env://", rank=rank,
                                world_size=tp, timeout=timeout)
    world = runtime.init(device="cpu" if dev_name == "cpu" else "cuda",
                         timeout=timeout)
    if str(world.device) != dev_name or world.backend != spec["backend"]:
        raise RuntimeError(f"rank {rank} joined on {world.device} over "
                           f"{world.backend}, the plan says {dev_name} "
                           f"over {spec['backend']}")
    mesh = create_hybrid_mesh(tp=tp)
    ranks: List[Any] = [None] * tp
    dist.all_gather_object(ranks, {"rank": rank, "pid": os.getpid(),
                                   "device": dev_name})
    eng = build_engine(dict(spec, device=dev_name), mesh=mesh)
    eng.serve_name = name       # fault clauses and flightrec key on it
    engine_ref.append(eng)
    hb = _hb_path(ready_file, rank)
    if not eng.is_leader:
        _arm_heartbeat(hb, rank=rank, device=world.device)
        try:
            eng.wait()
        except BaseException as e:  # noqa: BLE001 — the group is gone
            print(f"[proc_replica] {name} rank {rank}: the tp group lost "
                  f"its leader ({e!r}); exiting", flush=True)
            os._exit(1)     # a world that lost a rank: no teardown
        runtime.shutdown()
        return 0
    if spec.get("warmup", True):
        eng.warmup()
    srv = HttpServer(generate=eng, host=spec.get("host", "127.0.0.1"),
                     port=int(spec.get("port", 0)))
    srv.start()
    _publish_ready(ready_file, {
        "ready": True, "pid": os.getpid(), "host": srv.host,
        "port": srv.port, "name": name, "tp": tp,
        "backend": world.backend, "ranks": ranks, "ready_at": time.time()})
    _arm_heartbeat(hb, rank=0, device=world.device)
    _arm_group_watchdog(eng, name)
    print(f"[proc_replica] {name}: ready on {srv.host}:{srv.port} (tp="
          f"{tp} over {world.backend}: "
          + ", ".join(f"rank {r['rank']} pid {r['pid']} {r['device']}"
                      for r in ranks) + ")", flush=True)
    rc = _serve_stdin(eng, srv)
    if eng.plane_error is not None:
        sys.stdout.flush()
        os._exit(rc)        # a world that lost a rank: no teardown
    runtime.shutdown()
    return rc


def worker_main(argv: Optional[List[str]] = None) -> int:
    """The replica worker: spec → engine → warmup → HttpServer → ready
    file, then block on the stdin control channel until the parent says
    shutdown (or disappears). With ``"tp" > 1`` in the spec it is one
    rank of a tp group (:func:`_group_worker`; rank and rendezvous from
    the launcher's environment)."""
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
    # A flight-recorder directory a replica: every child of a tp = 1
    # replica dumps as rank 0, so siblings sharing the parent's directory
    # would overwrite each other's post-mortems (a group's ranks dump
    # under their own ranks).
    base_dir = os.environ.get("HVD_FLIGHTREC_DIR")
    if base_dir:
        child_dir = os.path.join(base_dir, name)
        os.makedirs(child_dir, exist_ok=True)
        os.environ["HVD_FLIGHTREC_DIR"] = child_dir
    engine_ref: list = []
    if args.parent_pid:
        _arm_parent_watchdog(args.parent_pid, engine_ref)
    if _spec_tp(spec) > 1:
        return _group_worker(spec, args.ready_file, name, engine_ref)

    # The heavy imports after the watchdog is armed: a parent that dies
    # while the child imports torch must still reap it.
    from ..device import resolve_device
    from .server import HttpServer

    eng = build_engine(spec)
    eng.serve_name = name       # fault clauses and flightrec key on it
    engine_ref.append(eng)
    if spec.get("warmup", True):
        eng.warmup()
    srv = HttpServer(generate=eng, host=spec.get("host", "127.0.0.1"),
                     port=int(spec.get("port", 0)))
    srv.start()
    _publish_ready(args.ready_file, {
        "ready": True, "pid": os.getpid(), "host": srv.host,
        "port": srv.port, "name": name})
    _arm_heartbeat(_hb_path(args.ready_file),
                   device=resolve_device(spec.get("device", "cuda")))
    print(f"[proc_replica] {name}: ready on {srv.host}:{srv.port} "
          f"(pid {os.getpid()}, {eng.stats()['device']})", flush=True)
    return _serve_stdin(eng, srv)


if __name__ == "__main__":
    sys.exit(worker_main())

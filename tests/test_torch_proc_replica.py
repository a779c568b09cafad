"""Port parity: subprocess replicas (``serve/proc_replica.py``), mirroring
``tests/test_proc_replica.py`` on the port.

The client's and the router's contracts run against in-process scripted
HTTP servers standing in for the worker: a connect refusal on submit is
a bounded retryable overload; a disconnect after the request was sent
admits nothing and is not retried; the child's status codes map to the
engine's exceptions; the chunked stream relays tokens, a deadline line
stays a deadline and a broken stream is a ``WorkerFailureError``; a
drain waits for the streams being relayed; a dead pid is evicted without
a drain; a transport timeout on the stats surface marks the replica
suspect and reads dead in one check; the router advertises the child's
``/metrics`` and the fleet poller walks it; the spec's adapter plane is
drawn again from its seeds, bitwise.

One real drill (about 5 s on the CPU): two ``python -m
horovod_tpu_torch.serve.proc_replica`` children spawned from one tiny
spec (``"device": "cpu"``) serve streams bitwise each other's and an
in-process engine's built from the same spec; after a
``replica_proc_kill`` SIGKILLs one mid-stream, its streams resume on the
survivor token-identical (exact equality) to the uninterrupted run; the
children map no JAX library, and no child outlives the test.
"""

import http.server
import json
import os
import socket
import socketserver
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu_torch import serve
from horovod_tpu_torch.exceptions import (DeadlineExceededError,
                                          ReplicaTimeoutError,
                                          ServerClosedError,
                                          ServerOverloadedError,
                                          WorkerFailureError)
from horovod_tpu_torch.serve.proc_replica import (ProcReplicaClient,
                                                  _build_adapters,
                                                  build_engine,
                                                  spawn_replica_factory)
from horovod_tpu_torch.serve.router import FleetRouter, ReplicaHandle
from horovod_tpu_torch.testing import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _client(port, **kw):
    kw.setdefault("connect_timeout_s", 1.0)
    kw.setdefault("read_timeout_s", 5.0)
    kw.setdefault("probe_timeout_s", 0.3)
    kw.setdefault("backoff_s", 0.001)
    return ProcReplicaClient("r0", None, port=port, **kw)


def _free_port():
    """A port with nothing listening."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _ScriptedHandler(http.server.BaseHTTPRequestHandler):
    """Plays whatever its server's ``script`` says: the fake worker."""

    def log_message(self, *a):
        pass

    def do_GET(self):
        self.server.script(self, self.path)

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(length) or b"{}")
        self.server.script(self, self.path, body)

    def reply_json(self, status, obj):
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def stream_lines(self, lines, delay_s=0.0):
        """The worker's chunked /generate: 200, then one JSON line an
        event."""
        self.send_response(200)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        for obj in lines:
            data = json.dumps(obj).encode() + b"\n"
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()
            if delay_s:
                time.sleep(delay_s)


def _scripted_server():
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0),
                                          _ScriptedHandler)
    srv.daemon_threads = True
    srv.script = lambda h, path, body=None: h.reply_json(404, {})
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def scripted():
    """One scripted server a test: ``(port, set_script)``."""
    srv = _scripted_server()
    yield srv.server_address[1], lambda fn: setattr(srv, "script", fn)
    srv.shutdown()
    srv.server_close()


class TestSubmitTransport:
    def test_connect_refusal_maps_to_bounded_overload(self, monkeypatch):
        c = _client(_free_port(), submit_retries=2)
        sleeps = []
        monkeypatch.setattr(time, "sleep", sleeps.append)
        with pytest.raises(ServerOverloadedError) as ei:
            c.submit([1, 2, 3])
        assert ei.value.retry_after_ms > 0
        assert len(sleeps) == 2
        assert not c._inflight

    def test_mid_body_disconnect_admits_nothing(self):
        accepted = []

        def _server(sock):
            while True:
                try:
                    conn, _ = sock.accept()
                except OSError:
                    return
                accepted.append(1)
                try:
                    conn.settimeout(2.0)
                    while b"\r\n\r\n" not in conn.recv(65536):
                        pass
                except OSError:
                    pass
                conn.close()

        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        sock.listen(4)
        threading.Thread(target=_server, args=(sock,), daemon=True).start()
        try:
            c = _client(sock.getsockname()[1], submit_retries=3)
            with pytest.raises(ServerOverloadedError):
                c.submit([1, 2, 3], max_new_tokens=4)
            assert len(accepted) == 1      # sent once, never retried
            assert not c._inflight
        finally:
            sock.close()

    @pytest.mark.parametrize("status,body,exc", [
        (503, {"error": "full", "retryable": True, "retry_after_ms": 250.0},
         ServerOverloadedError),
        (503, {"error": "closed", "retryable": False}, ServerClosedError),
        (504, {"error": "late"}, DeadlineExceededError),
        (400, {"error": "bad tokens"}, ValueError),
        (500, {"error": "boom"}, WorkerFailureError)])
    def test_status_mapping(self, scripted, status, body, exc):
        port, set_script = scripted
        set_script(lambda h, p, b=None: h.reply_json(status, body))
        c = _client(port)
        with pytest.raises(exc):
            c.submit([1])
        assert not c._inflight

    def test_overload_hint_relayed_from_worker(self, scripted):
        port, set_script = scripted
        set_script(lambda h, p, b=None: h.reply_json(
            503, {"error": "full", "retryable": True,
                  "retry_after_ms": 321.0}))
        with pytest.raises(ServerOverloadedError) as ei:
            _client(port).submit([1])
        assert ei.value.retry_after_ms == 321.0

    def test_stream_relays_tokens_and_done(self, scripted):
        port, set_script = scripted
        set_script(lambda h, p, b=None: h.stream_lines([
            {"token": 5}, {"token": 6},
            {"tokens": [5, 6], "finish_reason": "length", "n_tokens": 2,
             "done": True}]))
        c = _client(port)
        h = c.submit([4], max_new_tokens=2)
        r = h.result(timeout=5)
        assert r["tokens"] == [5, 6] and r["finish_reason"] == "length"
        assert h._tokens == [5, 6]
        deadline = time.monotonic() + 2
        while c._inflight and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not c._inflight

    def test_midstream_disconnect_fails_handle_as_worker_failure(
            self, scripted):
        port, set_script = scripted
        set_script(lambda h, p, b=None: h.stream_lines([{"token": 9}]))
        h = _client(port).submit([8])
        with pytest.raises(WorkerFailureError):
            h.result(timeout=5)
        assert h._tokens == [9]

    @pytest.mark.parametrize("line,exc", [
        ("DeadlineExceededError('late')", DeadlineExceededError),
        ("PreemptedError('evicted')", serve.PreemptedError),
        ("RuntimeError('boom')", WorkerFailureError)])
    def test_error_lines_keep_their_type(self, scripted, line, exc):
        port, set_script = scripted
        set_script(lambda h, p, b=None: h.stream_lines([
            {"error": line, "done": True}]))
        with pytest.raises(exc):
            _client(port).submit([1]).result(timeout=5)

    def test_wire_protocol_carries_the_submit_kwargs(self, scripted):
        port, set_script = scripted
        seen = {}

        def script(h, p, b=None):
            seen.update(b)
            h.stream_lines([{"tokens": [], "finish_reason": "length",
                             "n_tokens": 0, "done": True}])
        set_script(script)
        c = _client(port)
        c.submit([1, 2], max_new_tokens=3, deadline_ms=500.0,
                 sampling=serve.SamplingParams(temperature=0.5, top_k=4,
                                               seed=7),
                 eos_id=None, adapter="a0").result(timeout=5)
        assert seen["tokens"] == [1, 2]
        assert seen["max_new_tokens"] == 3
        assert seen["deadline_ms"] == 500.0
        assert (seen["temperature"], seen["top_k"], seen["seed"]) \
            == (0.5, 4, 7)
        assert seen["adapter"] == "a0"
        assert "eos" in seen and seen["eos"] is None
        seen.clear()
        c.submit([3]).result(timeout=5)
        assert "eos" not in seen and "max_new_tokens" not in seen


class TestLifecycle:
    def test_shutdown_drain_waits_for_inflight_streams(self, scripted):
        port, set_script = scripted
        set_script(lambda h, p, b=None: h.stream_lines(
            [{"token": 1}, {"token": 2},
             {"tokens": [1, 2], "finish_reason": "length", "n_tokens": 2,
              "done": True}], delay_s=0.15))
        c = _client(port)
        h = c.submit([0])
        t0 = time.monotonic()
        c.shutdown(drain=True, timeout=10.0)
        assert h.done()
        assert time.monotonic() - t0 >= 0.2
        assert h.result(timeout=1)["tokens"] == [1, 2]
        with pytest.raises(ServerClosedError):
            c.submit([1])

    def test_shutdown_without_drain_does_not_wait(self, scripted):
        port, set_script = scripted
        set_script(lambda h, p, b=None: h.stream_lines(
            [{"token": 1}] * 8, delay_s=0.2))
        c = _client(port)
        c.submit([0])
        t0 = time.monotonic()
        c.shutdown(drain=False, timeout=10.0)
        assert time.monotonic() - t0 < 1.0

    def test_booting_client_reads_warming_not_dead(self):
        c = ProcReplicaClient("r9", None, ready_file="/nonexistent/rf")
        assert c.health() == (False, "booting", 0)
        assert c.loop_alive() is True
        assert c.metrics_endpoint() is None
        with pytest.raises(ServerOverloadedError):
            c.submit([1])

    def test_ready_file_and_stale_heartbeat(self, scripted, tmp_path):
        port, set_script = scripted
        set_script(lambda h, p, b=None: h.reply_json(
            200, {"status": "ok", "queue_depth": 0}))
        rf = tmp_path / "r0.ready.json"
        rf.write_text(json.dumps({"ready": True, "port": port,
                                  "host": "127.0.0.1"}))
        c = ProcReplicaClient("r0", None, ready_file=str(rf),
                              heartbeat_timeout_s=0.5)
        assert c.warmup() == ("proc-ready",)
        assert not c.aborted()              # no heartbeat file yet: fresh
        hb = tmp_path / "r0.ready.json.hb"
        hb.write_text("{}")
        assert not c.aborted()
        old = time.time() - 5
        os.utime(hb, (old, old))
        assert c.aborted()                  # silent past the timeout

    def test_warmup_raises_on_a_dead_child(self):
        c = ProcReplicaClient("r0", _FakeDeadProc(),
                              ready_file="/nonexistent/rf")
        with pytest.raises(WorkerFailureError, match="rc=-9"):
            c.warmup()


class _FakeDeadProc:
    """A Popen whose process has exited."""
    pid = 12345
    returncode = -9
    stdin = None

    def poll(self):
        return -9

    def wait(self, timeout=None):
        return -9


class TestRouterIntegration:
    def test_dead_pid_evicted_without_drain(self, scripted):
        port, set_script = scripted
        set_script(lambda h, p, b=None: h.reply_json(
            200, {"status": "ok", "queue_depth": 0}))
        c = _client(port)
        router = FleetRouter(engines=[c], poll_interval_s=0)
        assert router.counts()["ready"] == 1
        calls = []
        orig = c.shutdown
        c.shutdown = lambda drain=True, timeout=30.0: (
            calls.append(drain), orig(drain=drain, timeout=timeout))
        c._proc = _FakeDeadProc()
        router.poll()
        assert router.counts() == {"ready": 0, "warming": 0,
                                   "draining": 0, "dead": 0}
        deadline = time.monotonic() + 5
        while not calls and time.monotonic() < deadline:
            time.sleep(0.005)
        assert calls == [False]
        router.shutdown()

    def test_load_counts_submits_the_child_has_not_counted(self, scripted):
        port, set_script = scripted
        child = {"status": "ok", "queue_depth": 0, "active_slots": 0,
                 "requests_total": 0}
        arrived, release = threading.Event(), threading.Event()
        refuse = []

        def script(h, p, b=None):
            if p != "/generate":
                h.reply_json(200, child)
            elif refuse:
                h.reply_json(503, {"error": "full"})
            else:
                arrived.set()
                release.wait(5)
                h.stream_lines([{"token": 1}, {
                    "tokens": [1], "finish_reason": "length",
                    "n_tokens": 1, "done": True}])
        set_script(script)
        c = _client(port)
        assert c.load() == 0
        box = []
        t = threading.Thread(
            target=lambda: box.append(c.submit([4], max_new_tokens=1)))
        t.start()
        assert arrived.wait(5)
        assert c.load() == 1        # on the wire, not counted by the child
        child.update(queue_depth=1, requests_total=1)
        assert c.load() == 1        # counted by the child, once
        release.set()
        t.join(5)
        assert box[0].result(timeout=5)["tokens"] == [1]
        child.update(queue_depth=0)
        assert c.load() == 0
        # A refused submit leaves nothing pending.
        refuse.append(True)
        with pytest.raises(ServerOverloadedError):
            c.submit([4])
        assert c.load() == 0
        # Requests from elsewhere are the child's own count, not ours.
        child.update(queue_depth=2, requests_total=3)
        assert c.load() == 2

    def test_a_burst_spreads_over_idle_children(self):
        """Concurrent submits each see the ones before them on the wire,
        while the children's /stats still read idle: the router's
        least-load walk alternates instead of piling every stream on
        the first child."""
        release = threading.Event()
        arrivals = []
        servers = [_scripted_server() for _ in range(2)]

        def script_for(name):
            def script(h, p, b=None):
                if p != "/generate":
                    h.reply_json(200, {"status": "ok", "queue_depth": 0,
                                       "active_slots": 0,
                                       "requests_total": 0})
                    return
                arrivals.append(name)
                release.wait(5)
                h.stream_lines([{"token": 1}, {
                    "tokens": [1], "finish_reason": "length",
                    "n_tokens": 1, "done": True}])
            return script
        for name, srv in zip("ab", servers):
            srv.script = script_for(name)
        clients = [ProcReplicaClient(name, None, port=srv.server_address[1],
                                     probe_timeout_s=1.0)
                   for name, srv in zip("ab", servers)]
        router = FleetRouter(engines=clients, poll_interval_s=0)
        try:
            threads = []
            for i in range(4):
                t = threading.Thread(target=router.submit, args=([4],),
                                     kwargs={"max_new_tokens": 1})
                t.start()
                threads.append(t)
                deadline = time.monotonic() + 5
                while len(arrivals) <= i and time.monotonic() < deadline:
                    time.sleep(0.002)
            assert sorted(arrivals) == ["a", "a", "b", "b"]
            release.set()
            for t in threads:
                t.join(5)
        finally:
            release.set()
            router.shutdown()
            for srv in servers:
                srv.shutdown()
                srv.server_close()

    def test_load_timeout_marks_suspect_and_evicts_in_one_check(self):
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        sock.listen(8)
        try:
            c = _client(sock.getsockname()[1], probe_timeout_s=0.2)
            with pytest.raises(ReplicaTimeoutError):
                c.load()
            handle = ReplicaHandle("r0", c)
            assert handle.load() == 1 << 30
            assert c._suspect
            assert handle.state() == "dead"
        finally:
            sock.close()

    def test_generic_load_error_stays_busy_sentinel_not_dead(self):
        c = _client(_free_port())
        handle = ReplicaHandle("r0", c)
        assert handle.load() == 1 << 30
        assert not c._suspect

    def test_router_advertises_child_metrics_endpoints(self, scripted):
        port, set_script = scripted
        set_script(lambda h, p, b=None: h.reply_json(
            200, {"status": "ok", "queue_depth": 0}))
        c = _client(port)
        c._proc = type("_Live", (), {"pid": 4321,
                                     "poll": lambda self: None})()
        router = FleetRouter(engines=[c], poll_interval_s=0)
        assert router.replica_metrics_endpoints() \
            == {"r0": f"127.0.0.1:{port}"}
        # A subprocess member shows in the process gauge.
        body = router.prom_metrics()
        assert "hvd_fleet_replica_procs 1" in body
        with serve.HttpServer(generate=router) as srv:
            from urllib.request import urlopen
            hz = json.loads(urlopen(
                f"http://{srv.host}:{srv.port}/healthz").read())
        assert hz["replica_metrics"] == {"r0": f"127.0.0.1:{port}"}
        assert hz["replicas"]["ready"] == 1
        c._proc = None
        router.shutdown()

    def test_stats_returns_last_known_snapshot_after_death(self, scripted):
        port, set_script = scripted
        set_script(lambda h, p, b=None: h.reply_json(
            200, {"queue_depth": 1, "active_slots": 2,
                  "requests_total": 7}))
        c = _client(port)
        assert c.load() == 3
        c._port = _free_port()
        snap = c.stats()
        assert snap["requests_total"] == 7
        assert c._active_rows() == 2


class TestPollerWalksChildren:
    def test_fleet_line_sums_advertised_child_endpoints(self, scripted):
        from horovod_tpu_torch.obs.summary import FleetPoller

        child = _scripted_server()
        child_port = child.server_address[1]

        def child_script(h, path, body=None):
            data = (b"# TYPE hvd_tokens_generated_total counter\n"
                    b"hvd_tokens_generated_total 128\n")
            h.send_response(200)
            h.send_header("Content-Length", str(len(data)))
            h.end_headers()
            h.wfile.write(data)
        child.script = child_script

        router_port, set_script = scripted

        def router_script(h, path, body=None):
            if path == "/healthz":
                h.reply_json(200, {
                    "status": "ok", "queue_depth": 0,
                    "replica_metrics": {"r0": f"127.0.0.1:{child_port}"}})
                return
            data = (b"# TYPE hvd_fleet_replicas gauge\n"
                    b'hvd_fleet_replicas{state="ready"} 1\n')
            h.send_response(200)
            h.send_header("Content-Length", str(len(data)))
            h.end_headers()
            h.wfile.write(data)
        set_script(router_script)
        try:
            poller = FleetPoller("127.0.0.1", router_port, world=1,
                                 timeout=2.0)
            line = poller.line()
            assert poller.last_mode == "serving"
            assert "1/1 replicas ready" in line
            assert poller._prev["hvd_tokens_generated_total"] == 128.0
        finally:
            child.shutdown()
            child.server_close()


TINY = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, d_ff=32,
            dtype="float32", unembed_dtype="float32")


class TestAdapterPlane:
    def test_build_adapters_absent_block_is_none(self):
        assert _build_adapters(object(), None, "cpu") is None
        assert _build_adapters(object(), {}, "cpu") is None
        assert _build_adapters(object(), {"entries": []}, "cpu") is None

    def test_build_adapters_rederives_trees_and_quotas(self):
        """Trees come from seeds: the child's registry holds rows bitwise
        ``init_adapter`` drawn by a generator seeded the same way."""
        from horovod_tpu_torch.parallel.lora import LoraConfig, init_adapter
        from horovod_tpu_torch.parallel.transformer import TransformerConfig
        cfg = TransformerConfig(vocab=32, d_model=16, n_heads=2, n_layers=2,
                                d_ff=32, dtype=torch.float32,
                                unembed_dtype=torch.float32)
        reg = _build_adapters(cfg, {
            "rank": 2, "alpha": 8.0, "capacity": 3,
            "entries": [
                {"name": "a1", "seed": 101, "b_scale": 0.5, "quota": 2,
                 "weight": 2.0, "priority": 1, "slo_ttft_ms": 50.0},
                {"name": "a0", "seed": 100, "b_scale": 0.5},
            ],
            "base_quota": 7,
        }, "cpu")
        assert reg.resident() == ("a0", "a1")
        assert reg.capacity == 3
        assert (reg.quota("a1"), reg.quota("a0"), reg.quota("base")) \
            == (2, None, 7)
        assert (reg.weight("a1"), reg.priority("a1"),
                reg.slo_ttft_ms("a1")) == (2.0, 1, 50.0)
        ref = init_adapter(torch.Generator().manual_seed(101), cfg,
                           LoraConfig(rank=2, alpha=8.0), b_scale=0.5,
                           device="cpu")
        row = reg.index_of("a1")
        table = reg.table()
        for li, layer in enumerate(ref["layers"]):
            for t, ab in layer.items():
                for k in ("a", "b"):
                    got = table["layers"][li][t][k][row]
                    assert torch.equal(got, ab[k]), (li, t, k)

    def test_adapter_names_reads_child_stats_table(self, scripted):
        port, set_script = scripted
        set_script(lambda h, path, body=None: h.reply_json(200, {
            "adapter_table": {"names": ["a0", "a1"], "capacity": 2},
            "active_slots": 0}))
        c = _client(port)
        assert c.adapter_names() == ("a0", "a1")
        assert c.adapters_resident() == 2

    def test_adapter_names_none_without_registry(self, scripted):
        port, set_script = scripted
        set_script(lambda h, path, body=None: h.reply_json(200, {
            "active_slots": 0}))
        c = _client(port)
        assert c.adapter_names() is None
        assert c.adapters_resident() is None

    def test_adapter_names_served_from_stats_cache(self, scripted):
        port, set_script = scripted
        set_script(lambda h, path, body=None: h.reply_json(200, {
            "adapter_table": {"names": ["a0"]}}))
        c = _client(port)
        c.stats()
        set_script(lambda h, path, body=None: h.reply_json(500, {}))
        assert c.adapter_names() == ("a0",)

    def test_backend_flags_ride_the_spec(self):
        from horovod_tpu_torch.serve.proc_replica import (
            _apply_backend_flags, _backend_flags)
        flags = _backend_flags()
        m = torch.backends.cuda.matmul
        before = m.allow_tf32
        try:
            _apply_backend_flags({**flags, "matmul_allow_tf32": True})
            assert m.allow_tf32 is True
        finally:
            m.allow_tf32 = before
        assert _backend_flags() == flags


def _maps_jax(pid: int) -> bool:
    """Whether the process maps any JAX library (a ``jax`` import loads
    jaxlib's extension modules)."""
    with open(f"/proc/{pid}/maps") as f:
        return "jaxlib" in f.read()


class TestRealSubprocessDrill:
    def test_two_children_bitwise_then_proc_kill_resumes(
            self, monkeypatch, tmp_path):
        monkeypatch.setenv("PYTHONPATH", REPO)
        monkeypatch.setenv("HVD_FLIGHTREC_DIR", str(tmp_path / "fr"))
        # The children inherit the spec: r1 dies at its 4th admitted
        # stream (two come from the sibling check below). A 40 ms slow
        # step keeps each stream in flight past the next dispatch, so the
        # least-loaded walk alternates (r0, r1, r0, r1) on a loaded host
        # too and r1 reaches its 4th stream.
        monkeypatch.setenv("HVD_FAULT_SPEC",
                           "slow_step=40,replica_proc_kill=r1@stream=4")
        faults.reset()
        spec = {"model": TINY, "seed": 3, "device": "cpu",
                "generation": dict(max_slots=2, max_len=16,
                                   default_max_new_tokens=6)}
        # A loaded host answers slowly: probes get 5 s before a timeout
        # would mark a child suspect.
        factory = spawn_replica_factory(
            spec, run_dir=str(tmp_path), ready_timeout_s=60.0,
            client_kwargs={"probe_timeout_s": 5.0})
        router = FleetRouter(factory=factory,
                             liveness_factory=factory.liveness_factory,
                             poll_interval_s=0.05)
        prompts = [[int(t) for t in p] for p in
                   np.random.RandomState(7).randint(1, 32, size=(6, 4))]
        samplings = [None if i % 2 == 0 else
                     serve.SamplingParams(temperature=0.8, seed=40 + i)
                     for i in range(len(prompts))]
        try:
            router.add_replica(warm=False)
            router.add_replica(warm=False)
            for h in router.replicas():
                h.engine.warmup()
            c0, c1 = (factory.clients[n] for n in ("r0", "r1"))
            for c in (c0, c1):
                assert not _maps_jax(c.pid)
            # The siblings hold bitwise the same weights: the same streams.
            sib = [[c.generate(p, sampling=s, timeout=60)["tokens"]
                    for p, s in zip(prompts[:2], samplings[:2])]
                   for c in (c0, c1)]
            assert sib[0] == sib[1]
            # ... and so does an engine of this process from the spec.
            ref = build_engine(spec)
            try:
                want = [ref.generate(p, sampling=s, timeout=60)["tokens"]
                        for p, s in zip(prompts, samplings)]
            finally:
                ref.shutdown()
            assert sib[0] == want[:2]
            handles = [router.submit(p, sampling=s)
                       for p, s in zip(prompts, samplings)]
            results = [h.result(timeout=60) for h in handles]
            assert [r["tokens"] for r in results] == want
            counts = router._metrics.failover_counts()
            assert counts["resumed"] >= 1 and counts["exhausted"] == 0
            assert c1._proc.wait(10) == -9          # SIGKILLed
            router.poll()       # the dead pid reads dead in one sweep
            assert [h.name for h in router.replicas()] == ["r0"]
        finally:
            router.shutdown(timeout=10)
            for c in factory.clients.values():
                if c._proc.poll() is None:
                    c._proc.kill()
                c._proc.wait(10)
        assert all(c._proc.poll() is not None
                   for c in factory.clients.values())
        # The killed child's post-mortem, in its own directory.
        with open(tmp_path / "fr" / "r1" / "hvd_flightrec.rank0.json") as f:
            crash = [e for e in json.load(f)["events"]
                     if e["kind"] == "serve_crash"]
        assert crash and crash[0]["replica"] == "r1" and crash[0]["inflight"]

"""Port parity: the per-GPU launcher (``horovod_tpu_torch.launcher``),
``runtime``'s ``HVD_DEVICE`` default and peer-failure mapping, and the
fleet poller (``obs.summary``) against the JAX package, on the CPU.

* The same worker (it imports neither jax nor torch and prints its
  environment) under ``python -m horovod_tpu.launcher -np 3 --cpu`` and
  ``python -m horovod_tpu_torch.launcher -np 3 --cpu``: equal per-rank
  ``HVD_RANK``, ``HVD_SIZE``, ``HVD_LOCAL_RANK`` and ``HVD_RESTART_EPOCH``,
  and both export one ``HVD_COORD_ADDR`` on ``127.0.0.1``; the port's
  ranks also get ``MASTER_ADDR``/``MASTER_PORT`` (the rendezvous, on a
  port of its own), ``HVD_DEVICE=cpu`` and an empty
  ``CUDA_VISIBLE_DEVICES``.
* The two-port rule: ``--coord-port P`` puts the coordinator on P and the
  rendezvous on P + 1 (``--coordinator host:P`` likewise); a relaunch
  draws fresh ports for both.
* Equal exit codes: a rank exiting 3; SIGINT (130, never relaunched); a
  rank failing on epoch 0 only under ``--restarts 1`` (0, two epochs).
  Equal parser errors for the shared flags.
* The drills of ``tests/test_launcher.py`` and
  ``tests/test_fault_tolerance.py`` that need no coordinator, on gloo:
  three ranks; two launchers with ``--nnodes 2`` forming one world of 2; a
  killed rank tearing down a sibling blocked in a collective within
  ``FAILFAST_GRACE_SECS`` + 10 s; a SIGTERM-ignoring sibling killed;
  ``-np`` above the GPU count refused without ``--cpu``; ``--max-np``
  refused naming item 15.
* ``FleetPoller``'s training line equals JAX's on the same rank
  listeners; the one-shot ``--metrics-summary`` exit codes.
"""

import os
import signal
import subprocess
import sys
import time

import pytest
import torch.distributed as dist

from horovod_tpu import launcher as jlauncher
from horovod_tpu.obs import summary as jsummary
from horovod_tpu_torch import launcher, runtime
from horovod_tpu_torch.exceptions import (StalledError, TransportError,
                                          WorkerFailureError)
from horovod_tpu_torch.obs import http as obs_http
from horovod_tpu_torch.obs import summary
from horovod_tpu_torch.obs.registry import MetricsRegistry
from horovod_tpu_torch.utils import config

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_elastic_worker.py")
# One write per line: the ranks share the launcher's stdout pipe, and a
# write below PIPE_BUF is never interleaved with another.
ENV_SCRIPT = (
    "import os, sys\n"
    "keys = ('HVD_RANK', 'HVD_SIZE', 'HVD_LOCAL_RANK', 'HVD_RESTART_EPOCH',"
    " 'MASTER_ADDR', 'MASTER_PORT', 'HVD_DEVICE', 'CUDA_VISIBLE_DEVICES',"
    " 'HVD_COORD_ADDR')\n"
    "line = ' '.join(['ENV'] + [repr(os.environ.get(k)) for k in keys])\n"
    "os.write(1, (line + '\\n').encode())\n"
    "code = os.environ.get('EXIT_CODE_' + os.environ['HVD_RANK'] + '_'"
    " + os.environ['HVD_RESTART_EPOCH'], '0')\n"
    "sys.exit(int(code))\n")


def _run(pkg, args, env=None, timeout=90, **kw):
    full = dict(os.environ, PYTHONPATH="", HVD_RESTART_BACKOFF_MAX="0")
    full.update(env or {})
    return subprocess.run([sys.executable, "-m", f"{pkg}.launcher", *args],
                          cwd=ROOT, env=full, capture_output=True, text=True,
                          timeout=timeout, **kw)


def _env_lines(stdout):
    return sorted(tuple(eval(v) for v in ln.split()[1:])
                  for ln in stdout.splitlines() if ln.startswith("ENV "))


def test_rank_environment_matches_jax():
    cmd = ["-np", "3", "--cpu", sys.executable, "-c", ENV_SCRIPT]
    port, jax_ = _run("horovod_tpu_torch", cmd), _run("horovod_tpu", cmd)
    assert port.returncode == jax_.returncode == 0, port.stderr + jax_.stderr
    got, want = _env_lines(port.stdout), _env_lines(jax_.stdout)
    assert [ln[:4] for ln in got] == [ln[:4] for ln in want] == [
        (str(r), "3", str(r), "0") for r in range(3)]
    assert len({ln[5] for ln in got}) == 1          # one rendezvous port
    for ln in got:
        assert ln[4] == "127.0.0.1" and ln[6:8] == ("cpu", "")
    # One coordinator a world, exported as the JAX launcher exports it,
    # on a port of its own beside the rendezvous.
    for lines in (got, want):
        assert len({ln[8] for ln in lines}) == 1
        host, _, port = lines[0][8].partition(":")
        assert host == "127.0.0.1" and int(port) > 0
    assert got[0][8].partition(":")[2] != got[0][5]


def test_coordinator_and_rendezvous_take_two_ports():
    assert launcher.world_ports("10.0.0.1:4000", None) == (
        "10.0.0.1", 4000, 4001)
    assert launcher.world_ports("10.0.0.1", None) == (
        "10.0.0.1", launcher.DEFAULT_COORD_PORT,
        launcher.DEFAULT_COORD_PORT + 1)
    assert launcher.world_ports(None, 5000) == ("127.0.0.1", 5000, 5001)
    host, coord, rdzv = launcher.world_ports(None, None)
    assert host == "127.0.0.1" and coord != rdzv
    port = launcher._free_port()
    out = _run("horovod_tpu_torch", ["-np", "2", "--cpu", "--coord-port",
                                     str(port), sys.executable, "-c",
                                     ENV_SCRIPT])
    assert out.returncode == 0, out.stderr
    for ln in _env_lines(out.stdout):
        assert ln[8] == f"127.0.0.1:{port}" and ln[5] == str(port + 1)


def test_a_relaunch_draws_fresh_ports_for_both():
    port = launcher._free_port()
    out = _run("horovod_tpu_torch",
               ["-np", "2", "--cpu", "--restarts", "1", "--coord-port",
                str(port), sys.executable, "-c", ENV_SCRIPT],
               env={"EXIT_CODE_0_0": "5"})
    assert out.returncode == 0, out.stderr
    lines = _env_lines(out.stdout)
    first = {(ln[8], ln[5]) for ln in lines if ln[3] == "0"}
    second = {(ln[8], ln[5]) for ln in lines if ln[3] == "1"}
    assert first == {(f"127.0.0.1:{port}", str(port + 1))}
    assert len(second) == 1
    (coord, rdzv), = second
    assert coord != f"127.0.0.1:{port}" and rdzv != str(port + 1)
    assert coord.partition(":")[2] != rdzv


@pytest.mark.parametrize("case,env,restarts,want_rc,want_epochs", [
    ("rank_exits_3", {"EXIT_CODE_1_0": "3"}, 0, 3, {"0"}),
    ("fails_on_epoch_0_only", {"EXIT_CODE_0_0": "5"}, 1, 0, {"0", "1"}),
])
def test_exit_codes_match_jax(case, env, restarts, want_rc, want_epochs):
    cmd = ["-np", "2", "--cpu", "--restarts", str(restarts),
           sys.executable, "-c", ENV_SCRIPT]
    for pkg in ("horovod_tpu_torch", "horovod_tpu"):
        out = _run(pkg, cmd, env=env)
        assert out.returncode == want_rc, (pkg, out.stdout, out.stderr)
        assert {ln[3] for ln in _env_lines(out.stdout)} == want_epochs, \
            (pkg, out.stdout, out.stderr)
        assert out.stderr.count("tpurun: world failed") == \
            len(want_epochs) - 1, (pkg, out.stderr)


def _sigint_rc(pkg, worker):
    env = dict(os.environ, PYTHONPATH="", HVD_WORKER_MODE="park")
    p = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.launcher", "-np", "2", "--cpu",
         "--restarts", "1", sys.executable, *worker],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ready = 0
        deadline = time.monotonic() + 60
        while ready < 2 and time.monotonic() < deadline:
            ready += p.stdout.readline().endswith("READY\n")
        assert ready == 2, f"{pkg}: the workers never came up"
        p.send_signal(signal.SIGINT)
        t0 = time.monotonic()
        _, err = p.communicate(timeout=30)
        return p.returncode, time.monotonic() - t0, err
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_sigint_is_forwarded_and_never_relaunched():
    """Ranks that exit 0 on the forwarded SIGTERM: 130 from both
    launchers, no relaunch. Ranks that SIGTERM kills: still 130 from the
    port's (the JAX launcher returns the rank's -15, which exits as 241:
    ``ROADMAP.md`` Queue 3)."""
    park = [WORKER]
    bare = ["-c", "import os, time; os.write(1, b'rank: READY\\n'); "
                  "time.sleep(120)"]
    for pkg, worker in (("horovod_tpu_torch", park), ("horovod_tpu", park),
                        ("horovod_tpu_torch", bare)):
        rc, secs, err = _sigint_rc(pkg, worker)
        assert rc == 128 + signal.SIGINT, (pkg, rc, err)
        assert secs < launcher.TERMINATE_GRACE_SECS + 10, (pkg, secs)
        assert "relaunching" not in err, (pkg, err)


@pytest.mark.parametrize("argv", [
    [],
    ["-np", "2", "--cpu"],
    ["-np", "2", "--cpu", "--nnodes", "2", "true"],
    ["-np", "2", "--cpu", "--restarts", "-1", "true"],
    ["-np", "2", "--cpu", "--metrics-interval", "0", "true"],
])
def test_parser_errors_match_jax(argv, capsys):
    errors = []
    for main in (launcher.main, jlauncher.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1]
    assert errors[0].startswith("tpurun: error:")


def test_max_np_is_refused_naming_item_15(capsys):
    with pytest.raises(SystemExit) as e:
        launcher.main(["-np", "2", "--cpu", "--max-np", "4", "true"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--max-np" in err and "ROADMAP.md Queue 1 item 15" in err


def test_np_above_the_gpu_count_is_refused_without_cpu(tmp_path, capsys,
                                                       monkeypatch):
    monkeypatch.setenv("HVD_CHIPS_PER_HOST", "1")
    marker = tmp_path / "spawned"
    cmd = [sys.executable, "-c", f"open({str(marker)!r}, 'w')"]
    with pytest.raises(SystemExit) as e:
        launcher.main(["-np", "2", *cmd])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "-np 2 exceeds the 1 GPU(s)" in err and "--cpu" in err
    with pytest.raises(ValueError, match="exceeds the 1 GPU"):
        launcher.launch(2, cmd)
    assert not marker.exists()


def test_visible_gpus_never_touches_cuda(monkeypatch):
    monkeypatch.delenv("HVD_CHIPS_PER_HOST", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,3")
    assert config.visible_gpus() == 2
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert config.visible_gpus() == 0
    monkeypatch.setenv("HVD_CHIPS_PER_HOST", "4")
    assert config.visible_gpus() == 4
    monkeypatch.setenv("HVD_RESTART_BACKOFF_MAX", "-3")
    assert config.restart_backoff_max() == 0.0
    monkeypatch.setenv("HVD_RESTART_BACKOFF_MAX", "bogus")
    assert config.restart_backoff_max() == 30.0


# -- drills on gloo ----------------------------------------------------------------

def test_three_ranks():
    out = _run("horovod_tpu_torch", ["-np", "3", "--cpu", sys.executable,
                                     WORKER],
               env={"HVD_WORKER_MODE": "collectives"})
    assert out.returncode == 0, out.stdout + out.stderr
    for r in range(3):
        assert f"rank {r}/3: LAUNCHER OK" in out.stdout, out.stdout


def test_two_launchers_form_one_world():
    port = launcher._free_port()
    env = dict(os.environ, PYTHONPATH="", HVD_WORKER_MODE="collectives")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.launcher", "-np", "1",
         "--cpu", "--nnodes", "2", "--node-rank", str(i), "--coordinator",
         f"127.0.0.1:{port}", sys.executable, WORKER],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=90)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    assert "rank 0/2: LAUNCHER OK" in outs[0], outs[0]
    assert "rank 1/2: LAUNCHER OK" in outs[1], outs[1]


def test_killed_rank_tears_down_a_sibling_in_a_collective(tmp_path):
    """Rank 1 is SIGKILLed at step 3 while rank 0 waits for it in the
    step's all-reduce: the world must end (non-zero, no FINAL line) within
    FAILFAST_GRACE_SECS + 10 s of the kill, rank 0 naming the failure."""
    env = dict(os.environ, PYTHONPATH="", HVD_ELASTIC_DIR=str(tmp_path),
               HVD_FAULT_SPEC="rank=1:kill@step=3")
    p = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.launcher", "-np", "2",
         "--cpu", sys.executable, WORKER],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        t_kill = None
        lines = []
        for ln in p.stdout:
            lines.append(ln)
            if "[faults] rank 1: SIGKILL" in ln:
                t_kill = time.monotonic()
                break
        assert t_kill is not None, "".join(lines)
        rest, err = p.communicate(timeout=60)
        elapsed = time.monotonic() - t_kill
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode != 0
    assert elapsed < launcher.FAILFAST_GRACE_SECS + 10, elapsed
    assert "[elastic] world failure at step 3: worker failure" in err, err
    assert "FINAL" not in "".join(lines) + rest


def test_sigterm_ignoring_sibling_is_killed():
    script = (
        "import os, signal, time\n"
        "if os.environ['HVD_RANK'] == '0':\n"
        "    raise SystemExit(3)\n"
        "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
        "time.sleep(120)\n")
    t0 = time.monotonic()
    rc = launcher.launch(2, [sys.executable, "-c", script], cpu=True)
    assert rc == 3
    assert time.monotonic() - t0 < launcher.TERMINATE_GRACE_SECS + 15


# -- runtime: HVD_DEVICE and a dead peer's errors -------------------------------

def test_hvd_device_picks_the_cpu_world(monkeypatch):
    for var in ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HVD_DEVICE", "cpu")
    w = runtime.init()
    try:
        assert w.device.type == "cpu" and w.backend == "gloo"
    finally:
        runtime.shutdown()
    monkeypatch.setenv("HVD_DEVICE", "tpu")
    with pytest.raises(ValueError, match="HVD_DEVICE"):
        runtime.init()
    assert not runtime.is_initialized()


@pytest.mark.parametrize("error,want", [
    (RuntimeError("[third_party/gloo/gloo/transport/tcp/pair.cc:553] "
                  "Connection closed by peer [127.0.0.1]:9615"),
     WorkerFailureError),
    (RuntimeError("[third_party/gloo/gloo/transport/tcp/pair.cc:537] Read "
                  "error [127.0.0.1]:18152: Connection reset by peer"),
     WorkerFailureError),
    (RuntimeError("[third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:"
                  "78] Timed out waiting 5000ms for recv operation"),
     StalledError),
    (RuntimeError("Application timeout caused pair closure"), StalledError),
    (dist.DistBackendError("Watchdog caught collective operation timeout: "
                           "WorkNCCL(SeqNum=3, OpType=ALLREDUCE) ran for "
                           "600000 milliseconds before timing out"),
     StalledError),
    (dist.DistNetworkError("failed to recv, got 0 bytes"),
     WorkerFailureError),
    (dist.DistBackendError("NCCL error: invalid usage"), TransportError),
    (RuntimeError("mat1 and mat2 shapes cannot be multiplied"), None),
])
def test_peer_failures_map_to_the_framework_errors(error, want):
    with pytest.raises(want or type(error)) as e:
        with runtime.peer_failures():
            raise error
    if want is None:
        assert e.value is error
    else:
        assert type(e.value) is want and e.value.__cause__ is error
        assert str(error) in str(e.value)


# -- the fleet line -------------------------------------------------------------------

def test_fleet_line_matches_jax_and_one_shot_exit_codes(monkeypatch):
    monkeypatch.delenv("HVD_METRICS_PORT", raising=False)
    base = launcher._free_port()
    listeners = []
    try:
        for r, gstep in ((0, 7), (1, 9)):
            reg = MetricsRegistry()
            reg.gauge("hvd_global_step", "g").set(gstep)
            reg.counter("hvd_steps_total", "s").inc(gstep)
            reg.counter("hvd_commits_total", "c").inc(2)
            listeners.append(obs_http.MetricsListener(base + r,
                                                      render=reg.render))
        for world in (2, 3):
            got = summary.FleetPoller("127.0.0.1", base, world).line()
            want = jsummary.FleetPoller("127.0.0.1", base, world).line()
            assert got == want
        assert got.startswith("fleet: 2/3 ranks up | step 7..9 (straggler "
                              "spread 2)") and "commits 4" in got
        assert launcher.main(["-np", "2", "--metrics-summary",
                              "--metrics-port", str(base)]) == 0
    finally:
        for lst in listeners:
            lst.stop()
    assert launcher.main(["-np", "2", "--metrics-summary", "--metrics-port",
                          str(base)]) == 1
    assert launcher.main(["-np", "2", "--metrics-summary"]) == 2


def test_serving_fleet_line_names_item_12(monkeypatch):
    """Item 12's serving line: pointed at a fleet router's ``/metrics``,
    the poller prints JAX's replica-centric line, and the one-shot
    ``--metrics-summary`` exits 0 on it."""
    monkeypatch.delenv("HVD_METRICS_PORT", raising=False)
    reg = MetricsRegistry()
    states = reg.gauge("hvd_fleet_replicas", "m", labels=("state",))
    for state, n in (("ready", 2), ("warming", 1), ("draining", 0),
                     ("dead", 0)):
        states.labels(state=state).set(n)
    reg.gauge("hvd_queue_depth", "d").set(3)
    ttft = reg.histogram("hvd_generate_ttft_seconds", "t")
    for v in (0.004, 0.02, 0.03, 0.3):
        ttft.observe(v)
    reg.counter("hvd_fleet_scale_events_total", "s",
                labels=("direction",)).labels(direction="grow").inc()
    reg.counter("hvd_prefix_hits_total", "h").inc(3)
    reg.counter("hvd_prefix_misses_total", "m").inc(1)
    with obs_http.MetricsListener(launcher._free_port(),
                                  render=reg.render) as lst:
        got = summary.FleetPoller("127.0.0.1", lst.port, 1).line()
        want = jsummary.FleetPoller("127.0.0.1", lst.port, 1).line()
        assert got == want
        assert got.startswith("fleet: 2/3 replicas ready | depth=3 | "
                              "prefix=75% | ttft_p50<=")
        assert "grow_events 1" in got
        assert launcher.main(["-np", "1", "--metrics-summary",
                              "--metrics-port", str(lst.port)]) == 0

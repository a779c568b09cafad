"""A fleet of tp groups (``serve/proc_replica.py`` with ``"tp": n``): the
group spec and its device plan, group-wide liveness, failover across
groups and the autoscaler's growth by a group.

Without a world: a group client reads dead once any rank's process exits
or any rank's heartbeat goes stale; the spec's checks raise before any
process is spawned; the device plan hands each group a free set (NCCL
over distinct GPUs, gloo over a shared one or the CPU), with the
launcher's environment contract, and raises when none is free; ``tp``
1 spawns the one child of a replica before groups, whose streams are
bitwise an in-process engine's; a group on a GPU that this host lacks
exits and fails its warmup.

With two tp = 2 groups on the CPU: ``replica_proc_kill`` SIGKILLs
``r1``'s leader at its third stream, in rounds of two requests (one a
group), and the streams and the fleet's counts equal those of the JAX
package's ``FleetRouter`` over two of its engines under
``replica_kill=r1@stream=3`` on the same requests (its thread replicas
on the same weights, unsharded); a ``slow_step`` of
:data:`SLOW_STEP_MS` in both keeps each round's first stream in flight
while the second is dispatched. Then ``FleetAutoscaler`` grows the
fleet by a group under a burst: no request reaches the new group before
its ready file (written once every rank has run the leader's warmup),
every stream equals JAX's, and no rank outlives the shutdown.
"""

import json
import os
import signal
import subprocess
import threading
import time

import pytest
import torch

import torch_serve_common as common
from horovod_tpu.serve import router as jrouter
from horovod_tpu.testing import faults as jfaults
from horovod_tpu_torch.exceptions import WorkerFailureError
from horovod_tpu_torch.parallel.mesh import Mesh as TorchMesh
from horovod_tpu_torch.parallel.transformer import serving_tp
from horovod_tpu_torch.serve import (FleetAutoscaler, FleetRouter,
                                     SamplingParams)
from horovod_tpu_torch.serve import proc_replica
from horovod_tpu_torch.serve.proc_replica import (ProcReplicaClient,
                                                  build_engine,
                                                  check_group_spec,
                                                  group_backend,
                                                  spawn_replica_factory)
from horovod_tpu_torch.testing import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
WORLD_S = 10.0
SLOW_STEP_MS = 20
KILL = "replica_proc_kill=r1@stream=3"
JAX_KILL = "replica_kill=r1@stream=3"
FLEET_KEYS = ("dispatch_total", "failover_total", "streams_stranded_total")


# -- group liveness, without a world ------------------------------------------

def _sleeper():
    return subprocess.Popen(["sleep", "60"])


def test_aborted_once_a_follower_exits(tmp_path):
    leader, follower = _sleeper(), _sleeper()
    try:
        c = ProcReplicaClient("r0", leader, followers=[follower],
                              ready_file=str(tmp_path / "r0.ready.json"))
        assert c.tp == 2 and c.pids == [leader.pid, follower.pid]
        assert not c.aborted() and c.loop_alive()   # booting, all alive
        follower.kill()
        follower.wait()
        assert c.aborted() and not c.loop_alive()
        assert not c.exited()                       # the leader still runs
    finally:
        for p in (leader, follower):
            p.kill()
            p.wait()
    assert c.exited()


def test_aborted_once_a_follower_heartbeat_is_stale(tmp_path):
    rf = str(tmp_path / "r0.ready.json")
    leader, follower = _sleeper(), _sleeper()
    try:
        c = ProcReplicaClient("r0", leader, followers=[follower],
                              ready_file=rf, heartbeat_timeout_s=0.5)
        for path in (rf + ".hb", rf + ".hb1"):
            with open(path, "w") as f:
                json.dump({"ts": time.time()}, f)
        assert not c.aborted()
        old = time.time() - 5
        os.utime(rf + ".hb1", (old, old))       # the follower went silent
        assert c.aborted()
        assert c.rank_heartbeats()[1]["ts"] > 0
    finally:
        for p in (leader, follower):
            p.kill()
            p.wait()


# -- the spec's checks and the device plan ------------------------------------

class _FakeProc:
    """A spawned child as the factory sees it: alive until ``exit()``."""

    def __init__(self, cmd, stdin=None, env=None):
        self.cmd, self.env, self.code = cmd, env, None
        self.pid = 1000 + len(_FakeProc.made)
        self.stdin = None
        _FakeProc.made.append(self)

    def poll(self):
        return self.code

    def wait(self, timeout=None):
        return self.code

    def kill(self):
        self.code = -9

    def exit(self):
        self.code = 0


@pytest.fixture
def fake_spawn(monkeypatch, tmp_path):
    _FakeProc.made = []
    monkeypatch.setattr(proc_replica.subprocess, "Popen", _FakeProc)
    monkeypatch.setenv("HVD_METRICS_PORT", "9100")
    monkeypatch.setenv("HVD_RANK", "5")
    return tmp_path


def _spec(**kw):
    return common.tp_spec("paged", **kw)


def _planned(run_dir, name):
    """The device set and backend the factory wrote into a group's spec."""
    with open(run_dir / f"{name}.spec.json") as fh:
        spec = json.load(fh)
    assert spec["tp"] == len(spec["devices"])
    return spec["devices"], spec["backend"]


@pytest.mark.parametrize("change,match", [
    (dict(tp=3), "divide model n_heads"),
    (dict(tp=0), "int >= 1"),
    (dict(model=dict(common.TP_DIMS, n_experts=2)), "n_experts"),
    (dict(device="cuda:1"), "names one device"),
])
def test_spec_checks_raise_before_any_spawn(fake_spawn, change, match):
    with pytest.raises(ValueError, match=match):
        spawn_replica_factory(_spec(**change), run_dir=str(fake_spawn))
    assert _FakeProc.made == []


@pytest.mark.parametrize("groups,match", [
    ([["cuda:0"]], "needs 2"),
    ([["cpu", "cuda:0"]], "mixes"),
    ([["cuda:0", "gpu:1"]], "'cpu' or 'cuda:<i>'"),
    ([], "empty"),
])
def test_device_set_checks_raise_before_any_spawn(fake_spawn, groups,
                                                  match):
    with pytest.raises(ValueError, match=match):
        spawn_replica_factory(_spec(device="cuda"), device_groups=groups,
                              run_dir=str(fake_spawn))
    assert _FakeProc.made == []


def test_groups_take_free_sets_with_the_launchers_env(fake_spawn):
    f = spawn_replica_factory(
        _spec(device="cuda"), run_dir=str(fake_spawn),
        device_groups=[["cuda:0", "cuda:1"], ["cuda:2", "cuda:2"]])
    r0, r1 = f("r0"), f("r1")
    assert (r0.tp, r1.tp) == (2, 2)
    assert [_planned(fake_spawn, n) for n in ("r0", "r1")] \
        == [(["cuda:0", "cuda:1"], "nccl"), (["cuda:2", "cuda:2"], "gloo")]
    envs = [p.env for p in _FakeProc.made]
    assert [(e["HVD_RANK"], e["HVD_SIZE"], e["HVD_LOCAL_RANK"])
            for e in envs] == [("0", "2", "0"), ("1", "2", "1"),
                               ("0", "2", "2"), ("1", "2", "2")]
    assert all(e["HVD_DEVICE"] == "cuda" and e["MASTER_ADDR"] == "127.0.0.1"
               and "HVD_METRICS_PORT" not in e for e in envs)
    assert envs[0]["MASTER_PORT"] == envs[1]["MASTER_PORT"] \
        != envs[2]["MASTER_PORT"] == envs[3]["MASTER_PORT"]
    with pytest.raises(RuntimeError, match="no free device set"):
        f("r2")
    for p in _FakeProc.made[:2]:
        p.exit()                    # r0's ranks are gone: its set is free
    f("r3")
    assert _planned(fake_spawn, "r3") == (["cuda:0", "cuda:1"], "nccl")


def test_the_default_plan_carves_the_gpus(fake_spawn, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 5)
    f = spawn_replica_factory(_spec(device="cuda"), run_dir=str(fake_spawn))
    for n in ("r0", "r1"):
        f(n)
    assert [_planned(fake_spawn, n)[0] for n in ("r0", "r1")] \
        == [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]
    with pytest.raises(RuntimeError, match="no free device set"):
        f("r2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    g = spawn_replica_factory(_spec(device="cuda"), run_dir=str(fake_spawn))
    with pytest.raises(RuntimeError, match="no free device set"):
        g("r0")


def test_cpu_groups_need_no_plan(fake_spawn):
    f = spawn_replica_factory(_spec(), run_dir=str(fake_spawn))
    for n in ("r0", "r1", "r2"):
        f(n)
        assert _planned(fake_spawn, n) == (["cpu"] * 2, "gloo")
    env = _FakeProc.made[1].env
    assert (env["HVD_DEVICE"], env["CUDA_VISIBLE_DEVICES"]) == ("cpu", "")
    assert env["HVD_LOCAL_RANK"] == "1"


@pytest.mark.parametrize("devices,backend", [
    (["cpu"] * 4, "gloo"), (["cuda:0", "cuda:1"], "nccl"),
    (["cuda:0", "cuda:0"], "gloo"), (["cuda:3", "cuda:1", "cuda:3"], "gloo")])
def test_group_backend(devices, backend):
    assert group_backend(devices) == backend


def test_tp1_spawns_one_child_as_before(fake_spawn):
    spec = dict(common.tp_spec("paged"), tp=1)
    f = spawn_replica_factory(spec, run_dir=str(fake_spawn))
    c = f("r0")
    (p,) = _FakeProc.made
    assert p.env is None            # the parent's environment, unchanged
    assert p.cmd[1:] == ["-m", "horovod_tpu_torch.serve.proc_replica",
                         "--spec", str(fake_spawn / "r0.spec.json"),
                         "--ready-file", str(fake_spawn / "r0.ready.json"),
                         "--parent-pid", str(os.getpid())]
    assert c.tp == 1
    assert check_group_spec(spec) == (1, None)


def test_tp1_replicas_take_a_device_each(fake_spawn):
    f = spawn_replica_factory(_spec(tp=1), run_dir=str(fake_spawn),
                              device_groups=[["cuda:1"], ["cuda:0"]])
    for n in ("r0", "r1"):
        assert f(n).tp == 1
    assert [p.env for p in _FakeProc.made] == [None, None]
    assert [_planned(fake_spawn, n) for n in ("r0", "r1")] \
        == [(["cuda:1"], "nccl"), (["cuda:0"], "nccl")]
    with open(fake_spawn / "r1.spec.json") as fh:
        assert json.load(fh)["device"] == "cuda:0"
    with pytest.raises(RuntimeError, match="no free device set"):
        f("r2")


def test_serving_tp_names_the_factory():
    mesh = TorchMesh(axis_names=("dp", "tp"), shape={"dp": 2, "tp": 2},
                     coords={"dp": 0, "tp": 0}, ranks={}, groups={})
    with pytest.raises(ValueError, match="dp=2.*spawn_replica_factory"):
        serving_tp(mesh)


# -- real children: tp 1, and a group on a GPU this host lacks ----------------

@pytest.fixture
def child_env(monkeypatch, tmp_path):
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("HVD_FLIGHTREC_DIR", str(tmp_path / "fr"))
    monkeypatch.delenv("HVD_FAULT_SPEC", raising=False)
    faults.reset()
    return tmp_path


def test_tp1_child_streams_are_bitwise_an_engine_of_the_spec(child_env):
    spec = dict(common.tp_spec("paged"), tp=1)
    f = spawn_replica_factory(spec, run_dir=str(child_env),
                              ready_timeout_s=TIMEOUT)
    c = f("r0")
    try:
        ref = build_engine(dict(spec, tp=1))
        try:
            reqs = common.tp_requests(4)
            want = [ref.generate(t, timeout=TIMEOUT, sampling=None if s
                                 is None else SamplingParams(**s))["tokens"]
                    for t, s in reqs]
        finally:
            ref.shutdown()
        c.warmup()
        got = [c.generate(t, timeout=TIMEOUT, sampling=None if s is None
                          else SamplingParams(**s))["tokens"]
               for t, s in reqs]
        assert got == want
        assert "tp" not in c.stats()
    finally:
        c.shutdown(drain=False, timeout=10)
    assert c.exited()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA: the group's devices must be missing")
def test_a_group_on_a_missing_gpu_fails_its_warmup(child_env):
    f = spawn_replica_factory(
        _spec(device="cuda", world_timeout_s=5.0), run_dir=str(child_env),
        device_groups=[["cuda:0", "cuda:0"]], ready_timeout_s=TIMEOUT)
    c = f("r0")
    try:
        with pytest.raises(WorkerFailureError, match="exited"):
            c.warmup()
    finally:
        c.shutdown(drain=False, timeout=5)
    assert c.exited()


# -- failover across groups, and growth, against the JAX router --------------

def _rounds(router, reqs, sampling) -> list:
    """Two requests a round, the round served before the next: the first
    goes to the least loaded group (``r0`` on ties) and is in flight when
    the second is dispatched, so each group takes one while both live."""
    out = []
    for i in range(0, len(reqs), 2):
        hs = [router.submit(t, sampling=sampling(s))
              for t, s in reqs[i:i + 2]]
        out += [h.result(TIMEOUT)["tokens"] for h in hs]
    return out


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Two tp = 2 groups whose children inherit the kill clause."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PYTHONPATH", REPO)
    mp.setenv("OMP_NUM_THREADS", "1")
    mp.setenv("HVD_FLIGHTREC_DIR", str(tmp_path_factory.mktemp("fr")))
    mp.setenv("HVD_FAULT_SPEC", f"slow_step={SLOW_STEP_MS},{KILL}")
    faults.reset()
    factory = spawn_replica_factory(
        common.tp_spec("paged", world_timeout_s=WORLD_S),
        run_dir=str(tmp_path_factory.mktemp("run")), ready_timeout_s=TIMEOUT,
        client_kwargs={"probe_timeout_s": 5.0})
    router = FleetRouter(factory=factory, initial=2,
                         liveness_factory=factory.liveness_factory,
                         poll_interval_s=0.05)
    mp.delenv("HVD_FAULT_SPEC")     # the router process runs no loop
    try:
        yield router, factory
    finally:
        router.shutdown(timeout=10)
        for c in factory.clients.values():
            c.shutdown(drain=False, timeout=5)
        mp.undo()
        faults.reset()


@pytest.fixture(scope="module")
def jax_fleet(fleet):
    """JAX's router over two JAX engines (thread replicas, the weights
    unsharded) under the same clauses, in the same rounds."""
    tree = common.tp_tree(common.tp_model())
    reqs = common.tp_requests()
    mp = pytest.MonkeyPatch()
    mp.setenv("HVD_FAULT_SPEC", f"slow_step={SLOW_STEP_MS},{JAX_KILL}")
    jfaults.reset()
    engines = [common.jax_tp_engine(tree, "paged") for _ in range(2)]
    router = jrouter.FleetRouter(engines=engines, poll_interval_s=0.05)
    try:
        router.warmup()
        streams = _rounds(router, reqs, lambda s: common.jserve.
                          SamplingParams(**(s or {})))
        stats = router.stats()["fleet"]
    finally:
        router.shutdown()
        for e in engines:
            e.shutdown(drain=False)
        mp.undo()
        jfaults.reset()
    return reqs, streams, stats


def test_a_killed_leader_fails_over_as_jax_does(fleet, jax_fleet):
    router, factory = fleet
    reqs, want, jax_stats = jax_fleet
    router.warmup()
    c1 = factory.clients["r1"]
    got = _rounds(router, reqs, lambda s: None if s is None
                  else SamplingParams(**s))
    assert got == want
    fleet_stats = router.stats()["fleet"]
    assert {k: fleet_stats[k] for k in FLEET_KEYS} \
        == {k: jax_stats[k] for k in FLEET_KEYS}
    assert fleet_stats["streams_stranded_total"] == 1
    assert fleet_stats["failover_total"]["resumed"] == 1
    assert c1._proc.wait(WORLD_S) == -signal.SIGKILL
    # The leader's death takes its follower: the group is gone whole.
    deadline = time.monotonic() + WORLD_S + 5
    while not c1.exited() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert c1.exited()
    router.poll()
    assert [h.name for h in router.replicas()] == ["r0"]


def test_the_autoscaler_grows_by_a_group(fleet, jax_fleet):
    router, factory = fleet
    reqs, want, _ = jax_fleet
    scaler = FleetAutoscaler(router, min_replicas=1, max_replicas=2,
                             high_watermark=1.0, low_watermark=0.5,
                             breach_up=1, breach_down=1000, cooldown_s=0.0)
    submits = []    # (time, every rank alive, every heartbeat written)

    def watch(client):
        submit = client.submit

        def recorded(*a, **kw):
            submits.append((time.time(), not client._any_exited(),
                            all(b for b in client.rank_heartbeats())))
            return submit(*a, **kw)
        client.submit = recorded

    def burst(results):
        def serve(idx):
            t, s = reqs[idx]
            results[idx] = router.submit(
                t, sampling=None if s is None
                else SamplingParams(**s)).result(TIMEOUT)["tokens"]
        threads = [threading.Thread(target=serve, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        return threads

    # The burst on the one live group (r0, slowed by its inherited
    # slow_step) until the autoscaler grows; r2 warms while r0 serves.
    first, second = {}, {}
    threads = burst(first)
    deadline = time.monotonic() + TIMEOUT
    grown, decisions = None, []
    while router.counts()["ready"] < 2:
        assert time.monotonic() < deadline, (router.counts(), decisions)
        d = scaler.poll_once()
        if d is not None:
            decisions.append(d)
        if d == "grow" and grown is None:
            grown = router.replicas()[-1]
            watch(grown.engine)
        if grown is not None:
            assert grown.state() != "dead", \
                [p.poll() for p in grown.engine._procs()]
        time.sleep(0.02)
    assert decisions == ["grow"] and grown.name == "r2"
    for t in threads:
        t.join(TIMEOUT)
    # A second burst on both groups.
    for t in burst(second):
        t.join(TIMEOUT)
    assert [first[i] for i in range(len(reqs))] == want
    assert [second[i] for i in range(len(reqs))] == want
    c2 = factory.clients["r2"]
    with open(c2._ready_file) as fh:
        ready = json.load(fh)
    assert [r["pid"] for r in ready["ranks"]] == c2.pids
    assert submits, "the grown group served nothing"
    assert all(t >= ready["ready_at"] and alive and beating
               for t, alive, beating in submits), (ready["ready_at"],
                                                    submits)
    assert router.stats()["fleet"]["scale_events"]["grow"] == 1
    clients = list(factory.clients.values())
    router.shutdown(timeout=10)
    deadline = time.monotonic() + 20
    while not all(c.exited() for c in clients) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    assert all(c.exited() for c in clients)

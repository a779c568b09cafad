"""The coordination plane's failure paths and timeline, on the CPU: the
port's coordinated worlds (``tests/torch_coord_worker.py``), beside the
JAX package's where a text or a trace is compared.

* a SIGKILLed rank aborts the world: the survivor raises
  ``WorkerFailureError`` naming the dead rank, with JAX's text, and
  nothing hangs;
* ``rank=1:mute`` stops rank 1's heartbeats: the heartbeat abort
  (``HVD_HEARTBEAT_TIMEOUT`` = 2 s) names it; ``coord:mute`` stops the
  coordinator's acks and the clients abort on their own;
* under ``HOROVOD_STALL_TIMEOUT`` a collective one rank never announces
  raises ``StalledError``, and the stalled name is refused on reuse;
* ``coord:delay_ms`` sleeps in every submit;
* ``run_with_recovery`` under the launcher with ``--restarts 1``: rank 1
  killed at step 3, the world is relaunched and ends with the bits of an
  uninterrupted run, the failure named by the coordinator;
* a coordinated world's timeline (written by the native coordinator) has
  JAX's events, by name, phase and category, on the same script.

Every drill runs at once, each world under its own time limit.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from test_torch_coord import finish, load, spawn_world
from horovod_tpu_torch.coord import _build

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
HEARTBEAT = {"HVD_HEARTBEAT_TIMEOUT": "2"}
DELAY_MS, STEPS = 150, 8
LAUNCH_STEPS = 6

DRILLS = {
    # name: (pkg, scenario, env, rank_env, ranks to wait for)
    "kill": ("torch", "faults", {"HVD_FAULT_SPEC": "rank=1:kill@step=3"},
             None, None),
    "kill_jax": ("jax", "faults", {"HVD_FAULT_SPEC": "rank=1:kill@step=3"},
                 None, None),
    "mute": ("torch", "faults", dict(HEARTBEAT,
                                     HVD_FAULT_SPEC="rank=1:mute@step=2"),
             None, {0}),
    "coord_mute": ("torch", "faults", dict(
        HEARTBEAT, HVD_FAULT_SPEC="coord:mute@step=2",
        HVD_TEST_STEP_SLEEP="0.5"), None, None),
    "stall": ("torch", "stall", None,
              {0: {"HOROVOD_STALL_TIMEOUT": "1.5"}}, None),
    "delay": ("torch", "faults",
              {"HVD_FAULT_SPEC": f"coord:delay_ms={DELAY_MS}"}, None, None),
    "timeline": ("torch", "timeline", None, None, None),
    "timeline_jax": ("jax", "timeline", None, None, None),
}


def _launch_recovery(elastic_dir):
    env = dict(os.environ, PYTHONPATH="", HVD_TOTAL_STEPS=str(LAUNCH_STEPS),
               HVD_ELASTIC_DIR=str(elastic_dir), HVD_RESTART_BACKOFF_MAX="0",
               HVD_FAULT_SPEC="rank=1:kill@step=3")
    return subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.launcher", "-np", "2",
         "--cpu", "--restarts", "1", sys.executable,
         os.path.join(HERE, "torch_elastic_worker.py")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    _build.build()
    started = {}
    for name, (pkg, scenario, env, rank_env, wait) in DRILLS.items():
        out = tmp_path_factory.mktemp(name)
        env = dict(env or {})
        if scenario == "timeline":
            env["HOROVOD_TIMELINE"] = str(out / "timeline.json")
        env["HVD_FLIGHTREC_DIR"] = str(out)
        started[name] = (out, wait, spawn_world(pkg, 2, out, scenario,
                                                env=env, rank_env=rank_env))
    launched = _launch_recovery(tmp_path_factory.mktemp("elastic"))
    got = {}
    for name, (out, wait, procs) in started.items():
        got[name] = (out, finish(procs, timeout=90, wait_ranks=wait))
    try:
        got["launch"] = launched.communicate(timeout=120)
    finally:
        if launched.poll() is None:
            launched.kill()
            launched.wait()
    got["launch_rc"] = launched.returncode
    return got


def _outcome(drills, name, rank):
    out, procs = drills[name]
    assert os.path.exists(os.path.join(out, f"{DRILLS[name][0]}.{rank}"
                                       ".json")), procs[rank][1]
    return load(out, DRILLS[name][0], rank)


def test_killed_rank_aborts_the_world_naming_it(drills):
    _, procs = drills["kill"]
    assert procs[1][0] == -9, procs[1][1]            # SIGKILLed, not hung
    assert procs[0][0] == 0, procs[0][1]
    got = _outcome(drills, "kill", 0)
    assert got["outcome"] == "WorkerFailureError", got
    assert got["error"].startswith("worker failure: rank 1 disconnected"), \
        got["error"]
    want = _outcome(drills, "kill_jax", 0)
    assert got["error"] == want["error"]
    # The survivor dumped its flight recorder the moment the abort
    # surfaced, the diagnosis in its last "abort" event.
    with open(os.path.join(drills["kill"][0], "hvd_flightrec.rank0.json")) as f:
        rec = json.load(f)
    aborts = [e for e in rec["events"] if e.get("kind") == "abort"]
    assert aborts and aborts[-1]["error"] == got["error"], rec
    assert rec["reason"].startswith("coordinator abort: worker failure: "
                                    "rank 1")


def test_muted_rank_gets_the_heartbeat_abort(drills):
    _, procs = drills["mute"]
    assert procs[0][0] == 0, procs[0][1]
    got = _outcome(drills, "mute", 0)
    assert got["outcome"] == "WorkerFailureError", got
    assert re.match(r"worker failure: rank 1 went silent \(no heartbeat "
                    r"for [0-9.]+ s > HVD_HEARTBEAT_TIMEOUT=2 s",
                    got["error"]), got["error"]
    assert got["seconds"] < 2 + 10, got


def test_muted_coordinator_aborts_every_client(drills):
    _, procs = drills["coord_mute"]
    for rank in (0, 1):
        assert procs[rank][0] == 0, procs[rank][1]
        got = _outcome(drills, "coord_mute", rank)
        assert got["outcome"] == "WorkerFailureError", got
        assert got["error"].startswith(
            "coordinator failure: no heartbeat-ack from rank 0"), got["error"]


def test_strict_stall_raises_and_the_name_is_refused(drills):
    _, procs = drills["stall"]
    assert [rc for rc, _ in procs] == [0, 0], procs
    got = _outcome(drills, "stall", 0)
    assert got["first"].startswith(
        "StalledError: collective HorovodAllreduce_stall_x exceeded "
        "HOROVOD_STALL_TIMEOUT"), got["first"]
    assert got["reuse"].startswith(
        "ValueError: tensor name 'HorovodAllreduce_stall_x' previously "
        "raised StalledError"), got["reuse"]
    assert got["after"] == [2.0, 2.0]
    assert _outcome(drills, "stall", 1)["after"] == [2.0, 2.0]


def test_coord_delay_sleeps_in_every_submit(drills):
    for rank in (0, 1):
        got = _outcome(drills, "delay", rank)
        assert got["outcome"] == "done", got
        assert got["coord_delay_s"] >= STEPS * DELAY_MS / 1000.0, got


def test_recovery_under_the_launcher_matches_an_uninterrupted_run(drills):
    import torch_elastic_worker as worker
    stdout, stderr = drills["launch"]
    assert drills["launch_rc"] == 0, stdout + stderr
    assert ("[elastic] world failure at step 3: worker failure: rank 1 "
            "disconnected") in stderr, stderr
    assert stderr.count("tpurun: world failed") == 1
    assert "[elastic] recovery: resumed from committed step 3" in stdout
    w = np.zeros(8, np.float32)
    m = np.zeros(8, np.float32)
    for s in range(LAUNCH_STEPS):
        g = (worker.grad_for(s, 0) + worker.grad_for(s, 1)) / np.float32(2)
        w, m = w - np.float32(0.1) * g, m * np.float32(0.9) + g
    want = w.tobytes().hex() + m.tobytes().hex()
    params = dict(re.findall(r"rank (\d+)/\d+: PARAMS ([0-9a-f]+)", stdout))
    assert params == {"0": want, "1": want}


def _events(out):
    with open(os.path.join(out, "timeline.json")) as f:
        text = f.read().rstrip().rstrip(",")
    events = json.loads(text if text.endswith("]") else text + "]")
    # A tensor's name is its process's metadata ("M") event.
    return sorted((e["args"]["name"] if e.get("ph") == "M" else
                   e.get("name", ""), e.get("ph", ""), e.get("cat", ""))
                  for e in events)


def test_timeline_has_jax_events(drills):
    for name in ("timeline", "timeline_jax"):
        assert [rc for rc, _ in drills[name][1]] == [0, 0], drills[name][1]
    got, want = _events(drills["timeline"][0]), _events(
        drills["timeline_jax"][0])
    assert got == want
    names = {n for n, _, _ in got}
    assert {"HorovodAllreduce_tl_sum", "HorovodAllgather_tl_gather",
            "HorovodAllreduce_tl_ring", "ALLREDUCE_RING"} <= names, names

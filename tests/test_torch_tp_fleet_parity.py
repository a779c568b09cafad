"""Port parity: a fleet of tp groups serves the JAX engine's streams.

Two tp = 2 groups of subprocess replicas (``spawn_replica_factory`` with
``"tp": 2, "device": "cpu"``: four processes, two gloo worlds) behind
``FleetRouter``, in the contiguous and the paged layout (the paged one
on the K8 route, whose plain version runs on the CPU). The JAX package
runs its ``GenerationEngine`` on the same weights, unsharded (the port's
seeded draw, through ``convert.params_to_numpy``): JAX's engine does not
serve a sharded tree, so the groups are held to it as the one-world tp
engine's tests hold that engine. Sixteen requests, greedy and seeded in turns:

* every stream of both fleets is token-identical to JAX's, and the
  greedy positions' top-2 logit margins exceed :data:`TP_MARGIN`, far
  above the f32 difference of a tp sum's order;
* a follower of ``r0`` SIGKILLed after ``r0``'s third stream's first
  token: every stream still completes token-identical, the fleet counts
  its strands, each resumed and none exhausted, and the dead group's
  leader exits within the world's collective timeout plus
  :data:`EXIT_MARGIN_S`;
* after ``shutdown`` no rank of any group is alive, and no child maps a
  JAX library.
"""

import json
import os
import signal
import time

import pytest

import torch_serve_common as common
from horovod_tpu_torch.serve import FleetRouter, SamplingParams
from horovod_tpu_torch.serve.proc_replica import spawn_replica_factory
from horovod_tpu_torch.testing import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_S = 10.0          # each group's collective timeout
EXIT_MARGIN_S = 5.0     # the leader's exit past it (the reap, a teardown)
TIMEOUT = 120
SLOW_STEP_MS = 20
LAYOUTS = tuple(common.TP_LAYOUTS)


def _maps_jax(pid: int) -> bool:
    with open(f"/proc/{pid}/maps") as f:
        return "jaxlib" in f.read()


def _serve(router, requests) -> list:
    """Submit every request (each submit returns at the stream's first
    token) and return each stream's tokens."""
    handles = [router.submit(toks, sampling=None if s is None
                             else SamplingParams(**s))
               for toks, s in requests]
    return [h.result(TIMEOUT)["tokens"] for h in handles]


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """One fleet of two tp = 2 groups a layout, spawned first (they boot
    while the JAX side runs); every rank is reaped at the end."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PYTHONPATH", REPO)
    mp.setenv("OMP_NUM_THREADS", "1")
    mp.setenv("HVD_FLIGHTREC_DIR", str(tmp_path_factory.mktemp("fr")))
    # A slow step keeps each stream in flight past the next dispatch, so
    # the least-loaded walk spreads the requests over both groups.
    mp.setenv("HVD_FAULT_SPEC", f"slow_step={SLOW_STEP_MS}")
    faults.reset()
    out = {}
    try:
        for layout in LAYOUTS:
            factory = spawn_replica_factory(
                common.tp_spec(layout, world_timeout_s=WORLD_S),
                run_dir=str(tmp_path_factory.mktemp(layout)),
                ready_timeout_s=TIMEOUT,
                client_kwargs={"probe_timeout_s": 5.0})
            router = FleetRouter(factory=factory, initial=2,
                                 liveness_factory=factory.liveness_factory,
                                 poll_interval_s=0.05)
            out[layout] = (router, factory)
        mp.delenv("HVD_FAULT_SPEC")     # the children have it; JAX's
        faults.reset()                  # engines here run without it
        yield out
    finally:
        for router, factory in out.values():
            router.shutdown(timeout=10)
            for c in factory.clients.values():
                c.shutdown(drain=False, timeout=5)
        mp.undo()


@pytest.fixture(scope="module")
def reference(fleets):
    """JAX's streams for the requests in both layouts, the port's
    unsharded model and the requests."""
    model = common.tp_model()
    tree = common.tp_tree(model)
    reqs = common.tp_requests()
    want = {}
    for layout in LAYOUTS:
        eng = common.jax_tp_engine(tree, layout)
        try:
            hs = [eng.submit(t, sampling=common.jserve.SamplingParams(
                **(s or {}))) for t, s in reqs]
            want[layout] = [h.result(TIMEOUT)["tokens"] for h in hs]
        finally:
            eng.shutdown()
    return model, reqs, want


@pytest.fixture(scope="module")
def served(fleets, reference):
    """Each fleet's first round (its groups warmed first)."""
    _, reqs, _ = reference
    out = {}
    for layout, (router, _) in fleets.items():
        router.warmup()
        out[layout] = (_serve(router, reqs), router.stats()["fleet"])
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_group_streams_match_jax(served, reference, fleets, layout):
    model, reqs, want = reference
    got, fleet = served[layout]
    assert got == want[layout]
    # Both groups served, nothing failed over.
    assert set(fleet["dispatch_total"]) == {"r0", "r1"}
    assert all(n > 0 for n in fleet["dispatch_total"].values())
    assert fleet["streams_stranded_total"] == 0
    # Greedy tokens are not near-ties a tp sum's f32 order could flip.
    for (toks, s), stream in zip(reqs, want[layout]):
        if s is None:
            assert min(common.greedy_margins(model, toks, stream)) \
                > common.TP_MARGIN


@pytest.mark.parametrize("layout", LAYOUTS)
def test_each_group_is_a_tp_world_of_two(fleets, served, layout):
    _, factory = fleets[layout]
    for name in ("r0", "r1"):
        c = factory.clients[name]
        assert c.tp == 2
        with open(c._ready_file) as fh:
            ready = json.load(fh)
        assert (ready["tp"], ready["backend"]) == (2, "gloo")
        assert [(r["rank"], r["pid"], r["device"]) for r in ready["ranks"]] \
            == [(0, c.pids[0], "cpu"), (1, c.pids[1], "cpu")]
        tp = c.stats()["tp"]
        assert (tp["role"], tp["tp"], tp["backend"], tp["error"]) \
            == ("leader", 2, "gloo", None)
        assert tp["timeout_s"] == WORLD_S
        beats = c.rank_heartbeats()
        assert [b["rank"] for b in beats] == [0, 1]
        assert [b["pid"] for b in beats] == c.pids
        assert not any(_maps_jax(pid) for pid in c.pids)


def test_a_killed_follower_resumes_on_the_other_group(fleets, served,
                                                      reference):
    router, factory = fleets["paged"]
    _, reqs, want = reference
    c0 = factory.clients["r0"]
    follower, leader = c0.pids[1], c0._proc
    before = router.stats()["fleet"]
    seen, kill_t = [0], []
    submit = c0.submit

    def submit_then_kill(*a, **kw):
        h = submit(*a, **kw)
        seen[0] += 1
        if seen[0] == 3:        # r0's third stream has its first token
            os.kill(follower, signal.SIGKILL)
            kill_t.append(time.monotonic())
        return h
    c0.submit = submit_then_kill
    got = _serve(router, reqs)
    assert kill_t, "r0 took fewer than 3 streams"
    assert got == want["paged"]
    leader.wait(WORLD_S + EXIT_MARGIN_S)
    assert time.monotonic() - kill_t[0] <= WORLD_S + EXIT_MARGIN_S
    fleet = router.stats()["fleet"]
    stranded = (fleet["streams_stranded_total"]
                - before["streams_stranded_total"])
    fo = {k: v - before["failover_total"].get(k, 0)
          for k, v in fleet["failover_total"].items()}
    assert stranded >= 1
    assert fo["resumed"] == stranded and fo["exhausted"] == 0
    router.poll()
    assert [h.name for h in router.replicas()] == ["r1"]
    assert c0.exited() or c0.aborted()


def test_shutdown_leaves_no_rank_alive(fleets, served):
    clients = [c for _, f in fleets.values() for c in f.clients.values()]
    for router, _ in fleets.values():
        router.shutdown(timeout=10)
    deadline = time.monotonic() + 20
    while not all(c.exited() for c in clients) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    assert len(clients) == 4
    assert all(c.exited() for c in clients), \
        [(c.name, c.pids) for c in clients if not c.exited()]

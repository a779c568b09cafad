"""``ci.sh``'s serving digest drills on the port's serving bench, in
process and cut to CPU test size: per-tenant digests of a mixed-adapter
run equal each ``--adapter-only`` replay; an autoscaled fleet's digest
equals the single-replica run's; a fleet with a replica killed mid-stream
replays every stranded stream to the unkilled run's digests, greedy with
an adapter and seeded."""

import json
import os

import pytest

from horovod_tpu_torch import serve_bench as tsb
from horovod_tpu_torch.testing import faults


def _run(tmp_path, name, *argv):
    """``main`` with ``--json``; returns (per-point rows, fleet line)."""
    out = tmp_path / f"{name}.json"
    rc = tsb.main(["--device", "cpu", "--mode", "generate",
                   "--deadline-ms", "0", "--json", str(out)] + list(argv))
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert rc == 0, rows
    points = [r for r in rows if "stream_digest" in r]
    fleet = [r for r in rows if r.get("fleet")]
    return points, (fleet[-1] if fleet else None)


@pytest.fixture(autouse=True)
def _disarmed(monkeypatch):
    monkeypatch.delenv("HVD_FAULT_SPEC", raising=False)
    faults.reset()
    yield
    faults.reset()


def test_adapter_digests_match_single_tenant_replays(tmp_path):
    """``ci.sh:302-335``: two LoRA tenants and base through one engine;
    every tenant's streams bit-identical to a replay of the same schedule
    that submits only that tenant."""
    common = ("--qps", "40", "--duration", "0.5", "--gen-tokens", "8",
              "--adapters", "2")
    (mix,), _ = _run(tmp_path, "mix", *common)
    assert mix["completed"] == mix["sent"] and mix["failed"] == 0
    assert mix["adapters_resident"] == 2
    for t in ("base", "a0", "a1"):
        (solo,), _ = _run(tmp_path, t, *common, "--adapter-only", t)
        assert solo["completed"] == solo["sent"] == mix["tenant_sent"][t] > 0
        assert solo["stream_digests"][t] == mix["stream_digests"][t], t
        assert mix["tenants"][t]["generations_total"] == \
            mix["tenant_completed"][t]


def test_autoscaled_fleet_digest_equals_one_replica(tmp_path):
    """``ci.sh:262-300``: a burst through an autoscaled fleet (one
    replica growing toward three, then draining back) loses no stream
    and changes no token."""
    common = ("--qps", "400", "--duration", "0.15", "--slots", "1",
              "--gen-tokens", "24", "--max-queue", "2000")
    (ref,), _ = _run(tmp_path, "ref", *common)
    (row,), fleet = _run(tmp_path, "auto", *common, "--replicas", "3",
                         "--autoscale", "--scale-high", "2")
    assert row["completed"] == row["sent"] == ref["sent"]
    assert row["overload_drops"] == 0 and row["failed"] == 0
    assert fleet["scale_events"]["grow"] >= 1, fleet["scale_events"]
    assert fleet["drained_lost_streams"] == 0
    assert fleet["queue_depth_final"] == 0
    assert fleet["ready_final"] == fleet["min_replicas"] == 1
    assert row["stream_digest"] == ref["stream_digest"]


@pytest.mark.parametrize("traffic", [
    ("--adapters", "1", "--adapter-mix", "0,1"),
    ("--temperature", "0.7", "--top-k", "20")], ids=["greedy_adapter",
                                                     "seeded"])
def test_killed_replica_streams_replay_bit_identically(tmp_path, traffic):
    """``ci.sh:336-370``: replica r1's loop dies at its third stream; the
    router resumes every stranded stream on r0, and the per-tenant
    digests equal the unkilled single-replica run's."""
    common = ("--qps", "60", "--duration", "0.4", "--slots", "2",
              "--gen-tokens", "24") + traffic
    (ref,), _ = _run(tmp_path, "ref", *common)
    (row,), fleet = _run(tmp_path, "kill", *common, "--replicas", "2",
                         "--chaos", "replica_kill=r1@stream=3")
    assert os.environ.get("HVD_FAULT_SPEC") is None     # disarmed after
    assert row["completed"] == row["sent"] == ref["sent"]
    assert fleet["failover"]["resumed"] >= 1, fleet
    assert fleet["failover"].get("exhausted", 0) == 0
    assert fleet["drained_lost_streams"] == 0
    assert row["stream_digests"] == ref["stream_digests"]
    assert fleet["stream_digests"] == ref["stream_digests"]

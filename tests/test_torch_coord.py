"""Port parity: the host coordination plane (``horovod_tpu_torch.coord``)
against the JAX package's (``horovod_tpu.coord``), on the CPU.

One seeded script (``tests/torch_coord_worker.py parity``) runs in a JAX
coordinated world (one independent JAX process a rank, ``HVD_COORD_ADDR``,
as ``tests/test_coord.py`` spawns them) and in the port's (gloo ranks
that ``init()`` puts on the coordinator), at worlds of 1 (through the
``CoordClient`` itself: a world of one has no coordinated ``init``), 2
and 4; every world of one size runs at once. Held to each other:

* every result bitwise, with its dtype: f32, bf16, int32, uint8 and bool
  allreduces under SUM, AVERAGE, MIN, MAX and PRODUCT, ragged
  allgathers, broadcasts from the last rank, alltoall, reducescatter,
  the star and ring planes (``HOROVOD_RING_THRESHOLD`` = 64 KiB) and the
  per-call ``plane=`` override, async handles redeemed in reverse,
  ``broadcast_object`` and ``allgather_object``;
* the port's ``grouped_allreduce`` in a coordinated world: its tensors
  submitted at once and fused by the coordinator, bitwise one allreduce
  each;
* the error texts: dtype, shape, root, op and trailing-dim mismatches
  (``FailedPreconditionError`` on every rank, no hang), a non-root ring
  broadcast announced through the raw ABI, a name reused in flight, a
  float16 tensor;
* the ring-plane op counts.

Also: a port rank maps no JAX module and not the JAX package's
``libhvdcoord.so`` (``/proc/self/maps``); ``plan_exchange`` and the
optimizer's ``exchange_plan`` give JAX's buckets and denominators; a
plain world refuses ``plane="ring"`` with JAX's text; the names
``_auto_name`` makes.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.ops import collectives as jcoll
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu_torch import runtime
from horovod_tpu_torch.coord import _build
from horovod_tpu_torch.ops import collectives as tcoll
from horovod_tpu_torch.ops import fusion as tfusion

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_coord_worker.py")
SIZES = (1, 2, 4)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_world(pkg, size, out, scenario, env=None, rank_env=None):
    """Start ``size`` ranks of the worker; returns the processes."""
    port, mport = free_port(), free_port()
    procs = []
    for rank in range(size):
        e = dict(os.environ, HVD_RANK=str(rank), HVD_SIZE=str(size),
                 HVD_LOCAL_RANK=str(rank),
                 HVD_COORD_ADDR=f"127.0.0.1:{port}",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(mport),
                 HOROVOD_RING_THRESHOLD="65536", JAX_PLATFORMS="cpu",
                 HVD_DEVICE="cpu", CUDA_VISIBLE_DEVICES="",
                 OMP_NUM_THREADS="1", PYTHONPATH="")
        e.update(env or {})
        e.update((rank_env or {}).get(rank, {}))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, pkg, str(out), scenario], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish(procs, timeout, wait_ranks=None):
    """Collect ``(returncode, output)`` of each rank within ``timeout``
    seconds; every process still running then (or, with ``wait_ranks``,
    once those ranks are done) is killed, and its code is None."""
    deadline = time.monotonic() + timeout
    wait = [p for i, p in enumerate(procs)
            if wait_ranks is None or i in wait_ranks]
    try:
        for p in wait:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    outs = []
    for p in procs:
        killed = p.poll() is None
        if killed:
            p.kill()
        out, _ = p.communicate()
        outs.append((None if killed else p.returncode, out))
    return outs


def load(out, pkg, rank):
    with open(os.path.join(out, f"{pkg}.{rank}.json")) as f:
        info = json.load(f)
    npz = os.path.join(out, f"{pkg}.{rank}.npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            info["results"] = {k: z[k] for k in z.files}
    return info


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    _build.build()          # once, before the ranks race for the lock
    runs = []
    for size in SIZES:
        for pkg in ("jax", "torch"):
            out = tmp_path_factory.mktemp(f"{pkg}{size}")
            runs.append((pkg, size, out, spawn_world(pkg, size, out,
                                                     "parity")))
    got = {}
    for pkg, size, out, procs in runs:
        for rank, (rc, text) in enumerate(finish(procs, timeout=150)):
            assert rc == 0, f"{pkg} world {size} rank {rank}:\n{text}"
        got[(pkg, size)] = [load(out, pkg, r) for r in range(size)]
    return got


@pytest.mark.parametrize("size", SIZES)
def test_results_are_bitwise_jax(worlds, size):
    for rank in range(size):
        j, t = worlds[("jax", size)][rank], worlds[("torch", size)][rank]
        assert set(t["results"]) == set(j["results"])
        assert t["dtypes"] == j["dtypes"], (t["dtypes"], j["dtypes"])
        for key, want in j["results"].items():
            got = t["results"][key]
            assert got.shape == want.shape, (key, got.shape, want.shape)
            assert got.tobytes() == want.tobytes(), (rank, key)


@pytest.mark.parametrize("size", SIZES)
def test_error_texts_are_jax(worlds, size):
    for rank in range(size):
        j, t = worlds[("jax", size)][rank], worlds[("torch", size)][rank]
        assert t["errors"] == j["errors"], (rank, t["errors"], j["errors"])
        if size > 1:
            for key in ("shape", "dtype", "root", "op", "ag_trailing"):
                assert t["errors"][key].startswith(
                    "FailedPreconditionError: Mismatched"), t["errors"][key]
            assert "BROADCAST_RING" in t["errors"]["nonroot_ring_bcast"]
            assert "non-root" in t["errors"]["nonroot_ring_bcast"]
            assert t["errors"]["dup"].startswith("ValueError: tensor name")


@pytest.mark.parametrize("size", SIZES)
def test_ring_plane_counts_match(worlds, size):
    for rank in range(size):
        j, t = worlds[("jax", size)][rank], worlds[("torch", size)][rank]
        assert t["ring_ops"] == j["ring_ops"]
        assert t["ops_completed"] == j["ops_completed"]
        assert (t["ring_ops"] > 0) == (size > 1)


@pytest.mark.parametrize("size", [2, 4])
def test_grouped_allreduce_is_fused_by_the_coordinator(worlds, size):
    for info in worlds[("torch", size)]:
        assert info["port_only"]["grouped_bitwise"]
        responses, ops = info["port_only"]["grouped_fused"]
        assert ops == 6 and responses < ops, (responses, ops)


@pytest.mark.parametrize("size", SIZES)
def test_port_rank_maps_nothing_of_jax(worlds, size):
    want = os.path.realpath(_build.build())
    for info in worlds[("torch", size)]:
        assert info["jax_modules"] == []
        assert info["maps_jax"] == []
        assert [os.path.realpath(p) for p in info["maps_coord"]] == [want]


def test_the_build_goes_to_the_ports_directory():
    lib = _build.build()
    assert os.path.dirname(lib) == _build.build_dir()
    assert os.path.basename(lib).startswith("libhvdcoord-")
    assert "horovod_tpu/coord" not in lib.replace(os.sep, "/")
    assert _build.build() == lib            # cached: no second build


def _plain_port_world():
    if runtime.is_initialized():
        return False
    runtime.init(device="cpu")
    return True


def test_plain_world_refuses_a_plane_with_jax_text():
    with pytest.raises(ValueError) as want:
        jhvd.allreduce(np.ones(2, np.float32), plane="ring")
    owned = _plain_port_world()
    try:
        assert runtime.world().coord is None
        for fn in (tcoll.allreduce, tcoll.allgather, tcoll.broadcast):
            with pytest.raises(ValueError) as got:
                fn(torch.ones(2), plane="ring")
            assert str(got.value) == str(want.value)
        # "auto" is the plain world's own path.
        assert tcoll.allreduce(torch.ones(2), average=False,
                               plane="auto").tolist() == [1.0, 1.0]
    finally:
        if owned:
            runtime.shutdown()


def test_init_coordinator_true_in_a_world_of_one_is_refused():
    runtime.shutdown()          # a world an earlier test left up
    with pytest.raises(ValueError, match="requires a multi-process world"):
        runtime.init(device="cpu", coordinator=True)
    assert not runtime.is_initialized()


def test_coordinator_without_an_address_is_jax_transport_error(
        monkeypatch):
    from horovod_tpu.coord.client import CoordClient as JClient
    from horovod_tpu_torch.coord.client import CoordClient
    from horovod_tpu_torch.exceptions import TransportError
    monkeypatch.delenv("HVD_COORD_ADDR", raising=False)
    with pytest.raises(Exception) as want:
        JClient.from_env(1, 2)
    with pytest.raises(TransportError) as got:
        CoordClient.from_env(1, 2)
    assert str(got.value) == str(want.value)
    for addr in ("127.0.0.1:http", "127.0.0.1:70000"):
        monkeypatch.setenv("HVD_COORD_ADDR", addr)
        with pytest.raises(ValueError) as want:
            JClient.from_env(1, 2)
        with pytest.raises(ValueError) as got:
            CoordClient.from_env(1, 2)
        assert str(got.value) == str(want.value)


def test_auto_names_match_jax():
    jcoll._name_counter = tcoll._name_counter = 0
    for kind, name in [("Allreduce", None), ("Broadcast", "epoch.1"),
                       ("Allgather", None), ("BroadcastObject", "a b/c"),
                       ("Allreduce", "HorovodBroadcastObject_t_1.len")]:
        assert tcoll._auto_name(kind, name) == jcoll._auto_name(kind, name)


def _leaves():
    shapes = [((64, 32), "float32"), ((32,), "float32"), ((1000,), "int32"),
              ((8, 8, 3), "float32"), ((5000,), "float32"),
              ((16,), "bfloat16")]
    return shapes


@pytest.mark.parametrize("threshold", [0, 4096, 64 << 20])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_plan_exchange_matches_jax(threshold, world):
    import jax
    import jax.numpy as jnp
    jl = [jax.ShapeDtypeStruct(s, getattr(jnp, d)) for s, d in _leaves()]
    tl = [torch.empty(s, dtype=getattr(torch, d), device="meta")
          for s, d in _leaves()]
    jb, js = jfusion.plan_exchange(jl, world_size=world,
                                   fusion_threshold=threshold)
    tb, ts = tfusion.plan_exchange(tl, world_size=world,
                                   fusion_threshold=threshold)
    assert tb == [list(b) for b in jb]
    assert [(s.psum, s.shard, s.denom) for s in ts] == \
        [(s.psum, s.shard, s.denom) for s in js]


def test_optimizer_stamps_the_exchange_plan():
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu_torch.optimizer import DistributedOptimizer
    owned = _plain_port_world()
    try:
        model = torch.nn.Linear(8, 4)
        opt = DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(), fusion_threshold=64)
        jopt = jhvd.DistributedOptimizer(optax.sgd(0.1), fusion_threshold=64)
        leaves = [p.detach() for p in model.parameters()]
        jl = [jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
              for p in leaves]
        tb, ts = opt.exchange_plan(leaves, world_size=3)
        jb, js = jopt.update.exchange_plan(jl, world_size=3)
        assert tb == [list(b) for b in jb]
        assert [s.denom for s in ts] == [s.denom for s in js] == [3, 3]
    finally:
        if owned:
            runtime.shutdown()

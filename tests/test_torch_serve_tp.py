"""Serving under a tp mesh, within the port: the tp = 1 engine against the
plain one (bitwise), the single-shot engine on a tp = 2 world, the step
plane's bounds (a follower killed mid-round, the leader's shutdown, the
idle heartbeat), the refusals, the LoRA blocks of a tp rank, and the
repaired default device of ``init_adapter``.

The tp worlds are spawned gloo worlds (``torch_serve_tp_worker``); the
tp = 1 engine runs in this process on a world of one. Every wait is
bounded: the worlds' collective timeout, which the step plane takes as
its own, is :data:`PLANE_S` seconds here.
"""

import datetime
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_serve_tp_worker as worker
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu_torch import convert, runtime
from horovod_tpu_torch.parallel import lora as tlora
from horovod_tpu_torch.parallel import transformer as ttr
from horovod_tpu_torch.parallel.mesh import Mesh as TorchMesh
from horovod_tpu_torch.parallel.mesh import local_slice, make_mesh
from horovod_tpu_torch.serve import (GenerationConfig, GenerationEngine,
                                     SamplingParams)
from horovod_tpu_torch.serve.batcher import RequestQueue

DIMS = dict(vocab=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)
PLANE_S = 4.0
TIMEOUT = 60
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], [5, 6, 7, 8, 9, 10],
           [2, 7, 1, 8, 2, 8])
LAUNCHER_VARS = ("HVD_RANK", "PMI_RANK", "OMPI_COMM_WORLD_RANK", "HVD_SIZE",
                 "PMI_SIZE", "OMPI_COMM_WORLD_SIZE", "HVD_LOCAL_RANK",
                 "OMPI_COMM_WORLD_LOCAL_RANK")


def torch_config():
    return ttr.TransformerConfig(**DIMS, dtype=torch.float32,
                                 unembed_dtype=torch.float32)


@pytest.fixture(scope="module")
def tree():
    cfg = jtr.TransformerConfig(**DIMS, dtype=jnp.float32,
                                unembed_dtype=jnp.float32,
                                attn_backend="xla")
    params = jtr.init_params(jax.random.PRNGKey(0), cfg)
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  params)


@pytest.fixture(scope="module")
def worlds(tree, tmp_path_factory):
    """One world of 2 for the single-shot engine and the refusals, one
    whose follower dies mid-round; both start before any test runs."""
    rng = np.random.RandomState(3)
    single = dict(kind="single", dims=DIMS, tree=tree, T=8,
                  items=[rng.randint(0, DIMS["vocab"], (8,))
                         for _ in range(6)], timeout=PLANE_S)
    refuse = dict(kind="refuse", dims=DIMS, tree=tree, timeout=PLANE_S,
                  idle_s=1.5)
    kill = dict(kind="kill", dims=DIMS, tree=tree, timeout=PLANE_S,
                config=dict(max_slots=2, max_len=16),
                prompts=[list(p) for p in PROMPTS[:2]], max_new=8,
                kill_after_calls=10)
    return {"main": worker.start(2, [single, refuse],
                                 tmp_path_factory.mktemp("tp2"), timeout=90,
                                 world_s=PLANE_S),
            "kill": worker.start(2, [kill], tmp_path_factory.mktemp("kill"),
                                 timeout=90, allow_dead=(1,),
                                 world_s=PLANE_S)}


# -- (iv) tp = 1 is bitwise the plain engine ----------------------------------

@pytest.fixture(scope="module")
def one_rank(tree):
    mp = pytest.MonkeyPatch()
    for var in LAUNCHER_VARS:
        mp.delenv(var, raising=False)
    runtime.init(device="cpu", timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        mesh = make_mesh({"tp": 1})
        yield (convert.params_from_jax(tree, torch_config(), device="cpu"),
               convert.params_from_jax(tree, torch_config(), device="cpu",
                                       mesh=mesh))
    finally:
        runtime.shutdown()
        mp.undo()


def _streams(model, **kw):
    eng = GenerationEngine(model, GenerationConfig(
        max_slots=2, max_len=16, default_max_new_tokens=5, **kw),
        device="cpu")
    try:
        eng.warmup()
        hs = [eng.submit(p, sampling=SamplingParams(temperature=t, top_k=8,
                                                    seed=4))
              for p in PROMPTS for t in (0.0, 0.9)]
        out = [h.result(TIMEOUT)["tokens"] for h in hs]
        return out, eng.stats()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("layout", [
    {}, dict(kv_layout="paged", block_size=4, paged_kernel=True),
    dict(kv_layout="paged", block_size=4, prefix_reuse=True,
         chunked_prefill=True)])
def test_tp1_engine_is_bitwise_the_plain_engine(one_rank, layout):
    plain, tp1 = one_rank
    want, _ = _streams(plain, **layout)
    got, stats = _streams(tp1, **layout)
    assert got == want
    assert "tp" not in stats            # one rank: no step plane


def test_tp1_forwards_are_bitwise_the_plain_ones(one_rank):
    plain, tp1 = one_rank
    cfg = torch_config()
    toks = torch.tensor(PROMPTS[0], dtype=torch.int32)
    out = []
    for model in (plain, tp1):
        w = ttr.gen_weights(model)
        cache = ttr.init_kv_cache(cfg, 1, 16, device="cpu", mesh=model.mesh)
        with torch.no_grad():
            cache, pre = ttr.prefill(w, toks, cache, 0, cfg)
            _, dec = ttr.decode_step(w, toks[:1], cache,
                                     torch.tensor([11], dtype=torch.int32),
                                     cfg)
        out.append((pre, dec, cache["k"]))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_the_world_keeps_its_collective_timeout(one_rank):
    # The bound a tp engine's step plane takes: init(timeout=)'s, and an
    # adopted group's own as its backend reports it.
    assert runtime.world().timeout_s == TIMEOUT
    assert runtime._group_timeout_s("gloo") == TIMEOUT


# -- (v) the single-shot engine on a tp = 2 world -----------------------------

def test_single_engine_rows_are_their_batch_forward(worlds):
    leader, follower = worlds["main"].result()[0]
    assert leader["leader"] and not follower["leader"]
    assert len(leader["rows"]) == 6
    for row, again in zip(leader["rows"], leader["again"]):
        np.testing.assert_array_equal(row, again)
    for a, b in zip(leader["again"], follower["again"]):
        np.testing.assert_array_equal(a, b)


# -- (vi) bounds and refusals --------------------------------------------------

def test_a_killed_follower_fails_the_leaders_streams(worlds):
    leader, dead = worlds["kill"].result()[0]
    assert dead is None
    # A started stream fails with the group's error; one the death caught
    # before its first token is refused as a closed door, as is every
    # later request: the leader closed for good.
    assert any(leader["started"]), leader
    for err, started in zip(leader["errors"], leader["started"]):
        assert err in (("WorkerFailureError", "StalledError",
                        "TransportError") if started
                       else ("ServerClosedError",)), leader
    assert leader["waited"] < PLANE_S + 2.0, leader["waited"]
    assert leader["late"] == "ServerClosedError"
    assert leader["plane_error"] is not None


def test_shutdown_releases_the_followers(worlds):
    leader, follower = worlds["main"].result()[1]
    assert leader["beats"] >= 1         # the idle leader's heartbeat
    assert follower["stats"]["beats"] >= 1
    assert follower["released_s"] < PLANE_S
    assert follower["stats"]["role"] == "follower"
    # The plane's one bound is the world's collective timeout.
    assert follower["stats"]["timeout_s"] == PLANE_S
    assert follower["stats"]["error"] is None


@pytest.mark.parametrize("key", [f"{what}_{axis}"
                                 for axis in ("dp", "pp", "ep", "sp")
                                 for what in ("gen", "single", "cache")])
def test_a_mesh_beyond_tp_is_refused(worlds, key):
    for rank in worlds["main"].result()[1]:
        axis = key.rsplit("_", 1)[1]
        assert rank[key] is not None and rank[key].startswith("ValueError")
        assert f"{axis}=2" in rank[key]


def test_moe_is_refused(worlds):
    for rank in worlds["main"].result()[1]:
        assert rank["gen_moe"].startswith("NotImplementedError")


@pytest.mark.parametrize("key", ["submit", "warmup", "single_submit",
                                 "http", "http_single"])
def test_a_follower_serves_no_requests(worlds, key):
    follower = worlds["main"].result()[1][1]
    assert not follower["is_leader"]
    assert follower[key].startswith("ValueError")
    assert "rank 0" in follower[key]


def test_idle_queue_wait_is_bounded():
    q = RequestQueue(4)
    assert q.take_batch(1, 0.0, idle_s=0.05) is None
    q.close()
    assert q.take_batch(1, 0.0, idle_s=0.05) == []


# -- LoRA blocks on a tp rank --------------------------------------------------

def _rank_mesh(r, tp=2):
    return TorchMesh(axis_names=("tp",), shape={"tp": tp},
                     coords={"tp": r}, ranks={}, groups={})


@pytest.mark.parametrize("r", [0, 1])
def test_adapter_blocks_follow_the_weight_blocks(r):
    """Column targets take this rank's columns of B (wqkv's: its heads,
    the block the weight's spec takes), row targets its rows of A."""
    cfg, lcfg = torch_config(), tlora.LoraConfig(rank=2)
    adapter = tlora.init_adapter(torch.Generator().manual_seed(0), cfg,
                                 lcfg, b_scale=0.5, device="cpu")
    mesh = _rank_mesh(r)
    local = tlora.local_adapter(adapter, lcfg, mesh)
    specs = ttr.param_specs(cfg, mesh)["layers"][0]
    table = tlora.empty_adapter_table(cfg, lcfg, 1, device="cpu", mesh=mesh)
    for t in tlora.LORA_TARGETS:
        a, b = adapter["layers"][0][t]["a"], adapter["layers"][0][t]["b"]
        la, lb = local["layers"][0][t]["a"], local["layers"][0][t]["b"]
        if t in tlora.COLUMN_TARGETS:
            assert torch.equal(la, a)
            assert torch.equal(lb, local_slice(b, specs[t], mesh))
        else:
            assert torch.equal(la, local_slice(a, specs[t], mesh))
            assert torch.equal(lb, b)
        assert table["layers"][0][t]["a"].shape[1:] == la.shape
        assert table["layers"][0][t]["b"].shape[1:] == lb.shape


def test_tp_lora_delta_sums_to_the_whole_delta():
    """The row-parallel partial deltas of the two ranks sum to the
    unsharded delta; the column-parallel ones concatenate to it."""
    cfg, lcfg = torch_config(), tlora.LoraConfig(rank=2)
    adapter = tlora.init_adapter(torch.Generator().manual_seed(1), cfg,
                                 lcfg, b_scale=0.5, device="cpu")
    x = torch.randn(3, cfg.d_model, generator=torch.Generator().manual_seed(2))
    pair = adapter["layers"][0]
    whole_col = (x @ pair["wqkv"]["a"]) @ pair["wqkv"]["b"]
    h = torch.randn(3, cfg.d_model, generator=torch.Generator().manual_seed(3))
    whole_row = (h @ pair["wo"]["a"]) @ pair["wo"]["b"]
    cols, rows = [], torch.zeros_like(whole_row)
    for r in range(2):
        loc = tlora.local_adapter(adapter, lcfg, _rank_mesh(r))["layers"][0]
        cols.append((x @ loc["wqkv"]["a"]) @ loc["wqkv"]["b"])
        h_loc = h[:, r * 16:(r + 1) * 16]
        rows = rows + (h_loc @ loc["wo"]["a"]) @ loc["wo"]["b"]
    torch.testing.assert_close(torch.cat(cols, -1), whole_col)
    torch.testing.assert_close(rows, whole_row)


# -- F4: init_adapter draws on the card unless asked for the CPU --------------

def test_init_adapter_defaults_to_the_card(monkeypatch):
    params = inspect.signature(tlora.init_adapter).parameters
    assert params["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tlora.init_adapter(None, torch_config(), tlora.LoraConfig())

"""Port parity: the integrity-checked checkpoints (``parallel.checkpoint``
and ``trainer.save_checkpoint``/``restore_checkpoint``/``apply_retention``/
``latest_checkpoint_step``) against the JAX package, on the CPU.

* Manifests: for a JAX ``TrainState`` and its port counterpart (weights
  carried with ``convert``), the port's manifest records of ``.params``,
  ``.batch_stats`` and ``.step`` equal JAX's ``write_manifest`` records
  exactly (path strings, shapes, dtypes, CRC32, order); JAX's
  ``_verify_leaves`` accepts the port's manifest against the JAX tree and
  the port's accepts JAX's; a flipped byte names the same leaf on both
  sides; JAX's ``latest_checkpoint_step`` and ``apply_retention`` give the
  port's answers on a directory the port wrote.
* ZeRO across worlds: one seeded canonical AdamW state, loaded and
  written with ``save_sharded`` from gloo worlds of 1, 2 and 4, has the
  same ``opt_state`` CRCs; the world-2 checkpoint restores onto world 4
  with the shards ``zero_from_canonical`` gives, and its bytes equal
  JAX's ``_canonicalize_zero`` of the same state.
* ``restore_for_inference``: the saved flax-form params and batch_stats
  bitwise, no optimizer-state file opened, the ``fp32``/``bf16`` casts of
  JAX's ``_inference_cast`` (bitwise), the contract of JAX's
  ``test_restore_for_inference_*`` tests (garbage directory, truncated
  and flipped files raise ``CheckpointCorruptError`` naming the path —
  JAX's own function fails here, see ``ROADMAP.md`` Queue 3), the
  sharded flavour into the engine (greedy tokens equal the live model's),
  and the refusals naming their ``ROADMAP.md`` items.
* The hybrid ZeRO state of a one-rank dp×tp mesh in its 2-D canonical
  form, round trip bitwise (the multi-rank cases are
  ``tests/test_torch_mesh_zero_ckpt.py``).

Every comparison here is exact (bytes, CRCs, strings): a checkpoint
moves bits, it computes nothing.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import torch_dist_worker
from horovod_tpu import optimizer as jopt
from horovod_tpu import trainer as jtrainer
from horovod_tpu import training as jtraining
from horovod_tpu.exceptions import CheckpointCorruptError as JCorrupt
from horovod_tpu.models import resnet as jres
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel import checkpoint as jckpt
from horovod_tpu_torch import convert, runtime
from horovod_tpu_torch import trainer as ttrainer
from horovod_tpu_torch.exceptions import CheckpointCorruptError
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.optimizer import zero_to_canonical
from horovod_tpu_torch.parallel import checkpoint as tckpt
from horovod_tpu_torch.parallel import transformer as ttr
from horovod_tpu_torch.training import create_train_state

SMALL = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10)
SGD = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
STEP = 3
KEEP = (".step", ".params", ".batch_stats")
LM = dict(vocab=128, d_model=256, n_heads=2, n_layers=2, d_ff=256)


@pytest.fixture
def world1(monkeypatch):
    for var in ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK", "HVD_ZERO",
                "HVD_OVERLAP", "HVD_GUARD_NONFINITE", "HVD_WIRE_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    yield
    runtime.shutdown()


@pytest.fixture(scope="module")
def variables():
    model = jres.ResNet(block_cls=jres.BottleneckBlock, dtype=jnp.float32,
                        **SMALL)
    v = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32)))
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.1 * rng.randn(*np.shape(a))).astype(np.float32), v)


def _port_state(variables):
    cfg = tres.ResNetConfig(dtype=torch.float32, **SMALL)
    model = convert.resnet_from_jax(variables, cfg, device="cpu")
    state = create_train_state(model, SGD, device="cpu")
    state.step = STEP
    return state


def _jax_state(variables):
    params = variables["params"]
    return jtraining.TrainState(
        step=np.asarray(STEP, np.int32), params=params,
        opt_state=optax.sgd(0.1, momentum=0.9).init(params),
        batch_stats=variables["batch_stats"])


def _kept(records):
    return [r for r in records if r["path"].startswith(KEEP)]


@pytest.fixture
def saved(tmp_path, variables, world1):
    state = _port_state(variables)
    path = ttrainer.save_checkpoint(str(tmp_path / "port"), state)
    return state, path


def test_manifest_records_equal_jax(saved, variables, tmp_path):
    _, path = saved
    jpath = tmp_path / "jax" / f"ckpt_{STEP}"
    jpath.mkdir(parents=True)
    jckpt.write_manifest(str(jpath), _jax_state(variables), step=STEP)
    port, jax_m = tckpt.read_manifest(path), jckpt.read_manifest(str(jpath))
    assert _kept(port["leaves"]) == _kept(jax_m["leaves"])
    assert len(_kept(port["leaves"])) == 1 + len(
        jax.tree_util.tree_leaves(variables["params"])) + len(
        jax.tree_util.tree_leaves(variables["batch_stats"]))
    assert port["format"] == jax_m["format"] == 1
    assert port["step"] == jax_m["step"] == STEP
    assert {"world_size", "mesh_shape"} <= set(port)


def _subset_state(tree_state):
    return jtraining.TrainState(
        step=tree_state.step, params=tree_state.params, opt_state=None,
        batch_stats=tree_state.batch_stats)


def test_verify_leaves_accepts_the_other_side(saved, variables, tmp_path):
    _, path = saved
    n = len(_kept(tckpt.read_manifest(path)["leaves"]))
    assert jckpt._verify_leaves(path, tckpt.read_manifest(path),
                                _subset_state(_jax_state(variables)),
                                subset=True) == n
    jpath = tmp_path / "jax" / f"ckpt_{STEP}"
    jpath.mkdir(parents=True)
    jckpt.write_manifest(str(jpath), _jax_state(variables), step=STEP)
    tree = tckpt.read_checkpoint(path)
    tree["opt_state"] = None
    assert tckpt._verify_leaves(str(jpath), jckpt.read_manifest(str(jpath)),
                                tree, subset=True) == n
    assert tckpt.verify_checkpoint(path) is True


def _leaf_of(path, key):
    for kp, stub in tckpt._flatten(tckpt.read_index(path)):
        if tckpt.keystr(kp) == key:
            return os.path.join(path, stub.file)
    raise KeyError(key)


def _leaf_named(msg: str) -> str:
    return msg.split("leaf ", 1)[1].split(" (", 1)[0]


def test_flipped_byte_names_the_same_leaf_on_both_sides(saved, variables):
    _, path = saved
    key = ".params['stem']['kernel']"
    victim = _leaf_of(path, key)
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        f.seek(size - 7)
        b = f.read(1)
        f.seek(size - 7)
        f.write(bytes([(b[0] + 1) & 0xFF]))
    with pytest.raises(CheckpointCorruptError) as port_err:
        tckpt.verify_checkpoint(path)
    assert path in str(port_err.value)
    corrupt = np.load(victim)
    jstate = _subset_state(_jax_state(variables))
    jstate.params = jax.tree_util.tree_map(lambda a: a, jstate.params)
    jstate.params["stem"]["kernel"] = corrupt
    with pytest.raises(JCorrupt) as jax_err:
        jckpt._verify_leaves(path, tckpt.read_manifest(path), jstate,
                             subset=True)
    assert _leaf_named(str(port_err.value)) == \
        _leaf_named(str(jax_err.value)) == key


def test_retention_and_latest_step_match_jax(tmp_path, variables, world1):
    state = _port_state(variables)
    base = tmp_path / "ckpts"
    order = (3, 1, 4, 2, 5)     # write recency differs from step order
    for i, s in enumerate(order):
        p = ttrainer.save_checkpoint(str(base), state, step=s)
        os.utime(p, (1000 + i, 1000 + i))
    assert ttrainer.latest_checkpoint_step(str(base)) == \
        jtrainer.latest_checkpoint_step(str(base)) == 5
    left = {}
    for side, fn in (("port", ttrainer.apply_retention),
                     ("jax", jtrainer.apply_retention)):
        d = tmp_path / side
        shutil.copytree(base, d)
        for i, s in enumerate(order):
            os.utime(d / f"ckpt_{s}", (1000 + i, 1000 + i))
        fn(str(d), str(d / "ckpt_1"), 2)
        left[side] = sorted(os.listdir(d))
    assert left["port"] == left["jax"] == ["ckpt_1", "ckpt_2", "ckpt_5"]


def test_round_trip_is_bitwise_and_broadcast_free_at_world_one(
        saved, variables):
    state, path = saved
    fresh = _port_state(jax.tree_util.tree_map(np.zeros_like, variables))
    fresh.step = 0
    ttrainer.restore_checkpoint(os.path.dirname(path), fresh)
    assert fresh.step == STEP
    want = convert.resnet_to_numpy(state.model)
    got = convert.resnet_to_numpy(fresh.model)
    for (_, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(want)[0],
            jax.tree_util.tree_flatten_with_path(got)[0]):
        assert a.tobytes() == b.tobytes()
    # The canonical tree is the JAX flax form: the params equal
    # convert.resnet_to_numpy's, conv kernels [kh, kw, Cin, Cout].
    tree = tckpt.read_checkpoint(path)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(tree["params"])[0],
            jax.tree_util.tree_flatten_with_path(want["params"])[0]):
        assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
        assert a.tobytes() == b.tobytes()


# -- ZeRO across worlds -------------------------------------------------------

def _zero_world1(workdir):
    """run_ckpt's ZeRO part in this process (a world of one)."""
    from horovod_tpu_torch.optimizer import (ZeroShardedState,
                                             zero_from_canonical)
    state = create_train_state(torch_dist_worker._MLP(),
                               torch_dist_worker.OPTS["adamw"], zero=True,
                               fusion_threshold=300, device="cpu")
    opt = state.optimizer
    canon = ZeroShardedState(
        inner=[{k: torch.from_numpy(v) for k, v in st.items()} for st in
               torch_dist_worker.zero_canonical_for(opt.plan)],
        plan=opt.plan)
    opt.load_zero_state(zero_from_canonical(canon, opt.zero_state()))
    path = tckpt.save_sharded(os.path.join(workdir, "zero_w1"), 5,
                              state.model, opt)
    return tckpt.read_manifest(path), opt.plan


@pytest.fixture(scope="module")
def zero_worlds(tmp_path_factory):
    w2 = tmp_path_factory.mktemp("ckpt_zero2")
    w4 = tmp_path_factory.mktemp("ckpt_zero4")
    out = {2: torch_dist_worker.spawn_ckpt(2, str(w2), {})}
    out[4] = torch_dist_worker.spawn_ckpt(
        4, str(w4), {"restore_from": str(w2 / "zero_w2")})
    runtime.init(device="cpu")
    try:
        manifest, plan = _zero_world1(str(w4))
    finally:
        runtime.shutdown()
    return {"manifests": {1: manifest, 2: out[2][0]["zero_manifest"],
                          4: out[4][0]["zero_manifest"]},
            "restored": [r["zero_restored"] for r in out[4]],
            "plan": plan, "w2": str(w2 / "zero_w2" / "ckpt_5")}


def test_zero_opt_state_crcs_equal_across_worlds(zero_worlds):
    ms = zero_worlds["manifests"]
    recs = {w: m["leaves"] for w, m in ms.items()}
    opt = {w: [r for r in v if r["path"].startswith("['opt_state']['zero']")]
           for w, v in recs.items()}
    assert opt[1] and opt[1] == opt[2] == opt[4]
    assert recs[1] == recs[2] == recs[4]
    assert {w: m["world_size"] for w, m in ms.items()} == {1: 1, 2: 2, 4: 4}
    assert {w: m["zero_mesh"]["nshards"] for w, m in ms.items()} == \
        {1: 1, 2: 2, 4: 4}


def test_world2_checkpoint_restores_onto_world4(zero_worlds):
    plan = zero_worlds["plan"]
    canon = torch_dist_worker.zero_canonical_for(plan)
    want_params = {n: p.detach().numpy() for n, p in
                   torch_dist_worker._MLP().named_parameters()}
    for r, got in enumerate(zero_worlds["restored"]):
        assert got["step"] == 5
        for n, a in want_params.items():
            assert got["params"][n].tobytes() == a.tobytes()
        for i, st in enumerate(canon):
            padded = got["padded"][i]
            s = padded // 4
            for k in ("exp_avg", "exp_avg_sq"):
                flat = np.concatenate([st[k], np.zeros(padded - st[k].size,
                                                       np.float32)])
                assert got["shards"][i][k].tobytes() == \
                    flat[r * s:(r + 1) * s].tobytes()
            assert float(got["shards"][i]["step"]) == 3.0


def test_zero_bytes_equal_jax_canonicalize(zero_worlds):
    tree = tckpt.read_checkpoint(zero_worlds["w2"])
    saved = tree["opt_state"]["zero"]
    jplan = jfusion.plan_zero(
        [jax.ShapeDtypeStruct(s, jnp.float32)
         for s in ((16,), (8, 16), (10,), (16, 10))], 2, 300)
    stacked = []
    for i, c in enumerate(saved):
        stacked.append({k: np.concatenate(
            [c[k], np.zeros(jplan.padded[i] - c[k].size, np.float32)]
        ).reshape(jplan.shard_shapes()[i]) for k in ("exp_avg",
                                                     "exp_avg_sq")})
    state = jopt.ZeroShardedState(
        inner=(optax.ScaleByAdamState(
            count=jnp.zeros((), jnp.int32),
            mu=tuple(jnp.asarray(s["exp_avg"]) for s in stacked),
            nu=tuple(jnp.asarray(s["exp_avg_sq"]) for s in stacked)),),
        plan=jplan)
    jcanon = jckpt._canonicalize_zero({"opt_state": state})["opt_state"]
    for i, c in enumerate(saved):
        assert np.asarray(jcanon.inner[0].mu[i]).tobytes() == \
            c["exp_avg"].tobytes()
        assert np.asarray(jcanon.inner[0].nu[i]).tobytes() == \
            c["exp_avg_sq"].tobytes()


def test_hybrid_zero_plan_refused(world1):
    """A ZeRO plan with a non-scatter axis is no longer refused: on a
    one-rank dp×tp mesh its state goes to the 2-D canonical form (the
    global leaves of each bucket), the manifest metadata names the
    layout, and ``zero_from_canonical`` gives the shards back bit for
    bit."""
    from horovod_tpu_torch.optimizer import (DistributedOptimizer,
                                             zero_from_canonical)
    from horovod_tpu_torch.parallel.mesh import make_mesh
    model = torch_dist_worker._MLP()
    named = list(model.named_parameters())
    specs = [(None, "tp") if p.dim() == 2 else () for _, p in named]
    opt = DistributedOptimizer(
        torch_dist_worker.OPTS["adamw"]([p for _, p in named]),
        named_parameters=named, zero=True, fusion_threshold=300,
        mesh=make_mesh({"dp": 1, "tp": 1}), param_specs=specs)
    model(torch.ones(4, 8)).sum().backward()
    opt.step()
    assert opt.plan.nonscatter == (("tp", 1),)
    tree = tckpt.opt_tree(opt)
    sizes = opt.plan.canonical_sizes()
    for st, n in zip(tree["zero"], sizes):
        for leaf in st.values():
            if leaf.tensor.dim():
                assert leaf.tensor.numel() == n
    assert tckpt._zero_mesh_meta(opt) == {
        "nshards": 1, "scatter_axis": "dp", "nonscatter": {"tp": 1}}
    live = opt.zero_state()
    canon = type(live)(inner=[{k: v.tensor for k, v in st.items()}
                              for st in tree["zero"]], plan=live.plan)
    back = zero_from_canonical(canon, live)
    for a, b in zip(live.inner, back.inner):
        for k in a:
            if torch.is_tensor(a[k]) and a[k].dim():
                assert torch.equal(a[k], b[k]), k


# -- restore_for_inference ------------------------------------------------------

def test_restore_for_inference_reads_only_the_serving_leaves(
        saved, monkeypatch):
    state, path = saved
    opened = []
    real = np.load
    monkeypatch.setattr(np, "load", lambda f, *a, **k: (
        opened.append(os.path.basename(str(f))), real(f, *a, **k))[1])
    got = tckpt.restore_for_inference(os.path.dirname(path))
    monkeypatch.setattr(np, "load", real)
    want = convert.resnet_to_numpy(state.model)
    assert sorted(got) == ["batch_stats", "params"]
    for coll in ("params", "batch_stats"):
        a = jax.tree_util.tree_flatten_with_path(got[coll])[0]
        b = jax.tree_util.tree_flatten_with_path(want[coll])[0]
        assert [jax.tree_util.keystr(p) for p, _ in a] == \
            [jax.tree_util.keystr(p) for p, _ in b]
        assert all(x.tobytes() == y.tobytes() for (_, x), (_, y) in
                   zip(a, b))
    index = {os.path.basename(s.file): tckpt.keystr(kp) for kp, s in
             tckpt._flatten(tckpt.read_index(path))}
    assert sorted(index[f].split("[")[0] for f in set(opened)) == sorted(
        [".params"] * len(jax.tree_util.tree_leaves(want["params"]))
        + [".batch_stats"] * len(jax.tree_util.tree_leaves(
            want["batch_stats"])))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_restore_for_inference_cast_matches_jax(saved, dtype):
    _, path = saved
    got = tckpt.restore_for_inference(os.path.dirname(path), dtype=dtype)
    want = jckpt._inference_cast(
        tckpt.restore_for_inference(os.path.dirname(path)), dtype)
    gl = jax.tree_util.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        if dtype == "bf16":
            assert w.dtype == ml_dtypes.bfloat16 and g.dtype == torch.bfloat16
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  w.view(np.int16))
        else:
            assert g.dtype == w.dtype == np.float32
            assert g.tobytes() == w.tobytes()


def test_restore_for_inference_garbage_directory(tmp_path):
    path = tmp_path / "ckpt_5"
    path.mkdir()
    (path / "checkpoint").write_bytes(b"\x00garbage\xff" * 7)
    with pytest.raises(CheckpointCorruptError) as ei:
        tckpt.restore_for_inference(str(tmp_path))
    assert str(path) in str(ei.value)


def test_restore_for_inference_truncated_checkpoint(saved):
    _, path = saved
    victim = _leaf_of(path, ".params['stem']['kernel']")
    with open(victim, "r+b") as f:
        f.truncate(max(1, os.path.getsize(victim) // 2))
    with pytest.raises(CheckpointCorruptError) as ei:
        tckpt.restore_for_inference(os.path.dirname(path))
    assert path in str(ei.value)
    assert ".params['stem']['kernel']" in str(ei.value)


@pytest.mark.parametrize("offset", ["header", "data"])
def test_restore_for_inference_flipped_params_byte(saved, offset):
    """The subset restore still CRC-verifies what it reads: a flipped
    byte in a params leaf is caught although opt_state stays unread."""
    _, path = saved
    victim = _leaf_of(path, ".params['stem']['kernel']")
    at = 0 if offset == "header" else os.path.getsize(victim) - 5
    with open(victim, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorruptError) as ei:
        tckpt.restore_for_inference(os.path.dirname(path))
    assert path in str(ei.value)


def test_restore_for_inference_refusals(tmp_path):
    with pytest.raises(NotImplementedError, match="item 12"):
        tckpt.restore_for_inference(str(tmp_path), dtype="int8")
    with pytest.raises(ValueError, match="not supported"):
        tckpt.restore_for_inference(str(tmp_path), dtype="fp16")
    with pytest.raises(FileNotFoundError):      # mesh= is served now
        tckpt.restore_for_inference(str(tmp_path), mesh=object())
    with pytest.raises(FileNotFoundError):
        tckpt.restore_for_inference(str(tmp_path))
    for fn in (tckpt.save_adapter, tckpt.restore_adapter):
        with pytest.raises(NotImplementedError, match="item 12"):
            fn(str(tmp_path), "a")
    from horovod_tpu_torch import serve
    assert serve.restore_for_inference is tckpt.restore_for_inference


def test_sharded_lm_round_trip_and_serving(tmp_path, world1):
    """The LM's ZeRO state through save_sharded / restore_sharded
    (bitwise), and restore_for_inference into the engine: greedy tokens
    equal those of an engine built from the live weights."""
    from horovod_tpu_torch.serve import GenerationConfig, GenerationEngine
    cfg = ttr.TransformerConfig(**LM, dtype=torch.float32)
    adamw = functools.partial(torch.optim.AdamW, lr=1e-3, foreach=False)
    init_state, step = ttr.make_parallel_train_step(cfg, adamw, zero=True,
                                                    device="cpu")
    state = init_state(0)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, LM["vocab"], (2, 128)))
    state, _ = step(state, toks, toks)
    path = tckpt.save_sharded(str(tmp_path), state.step, state.model,
                              state.optimizer)
    assert tckpt.verify_checkpoint(path) is True
    fresh = init_state(1)
    _, _, got_step = tckpt.restore_sharded(str(tmp_path), fresh.model,
                                           fresh.optimizer)
    assert got_step == state.step == 1
    assert all(torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                                 fresh.model.parameters()))
    live = zero_to_canonical(state.optimizer.zero_state())
    back = zero_to_canonical(fresh.optimizer.zero_state())
    assert all(torch.equal(a[k], b[k]) for a, b in zip(live.inner,
                                                       back.inner)
               for k in a)
    variables = tckpt.restore_for_inference(str(tmp_path))
    assert sorted(variables) == ["params"]
    want = convert.params_to_numpy(state.model)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(
        jax.tree_util.tree_leaves(variables["params"]),
        jax.tree_util.tree_leaves(want)))
    prompts = [rng.randint(0, LM["vocab"], n) for n in (5, 40)]
    tokens = []
    for tree in (variables["params"], want):
        model = convert.params_from_jax(tree, cfg, device="cpu")
        eng = GenerationEngine(model, GenerationConfig(
            max_slots=2, max_len=128, block_size=16,
            default_max_new_tokens=6), device="cpu")
        try:
            tokens.append([eng.submit(p).result(120)["tokens"]
                           for p in prompts])
        finally:
            eng.shutdown()
    assert tokens[0] == tokens[1] and all(len(t) == 6 for t in tokens[0])

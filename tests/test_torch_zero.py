"""Port parity: ZeRO-1 (``ops.fusion`` ``ZeroPlan``/``plan_zero``,
``fused_reduce_scatter``, ``fused_allgather_params``; ``optimizer``
``DistributedOptimizer(zero=True)``, ``ZeroShardedState``,
``zero_to_canonical``/``zero_from_canonical``; ``training`` with
``zero=``) against the JAX package, on the CPU.

* ``plan_zero``'s fields equal JAX's for ResNet-50's and the 12-layer
  tiny LM's leaves, in the 1-D and the dp-only spec-grouped form, at
  several thresholds and shard counts, and after a
  ``HOROVOD_FUSION_THRESHOLD`` flip; a non-scatter mesh axis (of any
  size) plans the hybrid form (``tests/test_torch_zero_plan.py`` holds
  it to JAX's); sparse leaves are refused. (ResNet-50's
  leaf shapes are each framework's own layout and agree in size.)
* ``fused_reduce_scatter`` (its shards and rank-local finite flag) and
  ``fused_allgather_params`` (the leaves and the world verdict that
  rides the gather) on gloo worlds of 2 and 4 (``torch_dist_worker.
  run_zero``) against JAX's inside ``shard_map`` over as many CPU
  devices, under the f32, bf16 and fp8 wires: f32 to 1e-6 of each
  leaf's largest value, bf16 to 2^-7, fp8 to 2^-3 of it (one wire ulp:
  the sums round in other orders, and gloo has no fp8 sum, so the port
  sums the e4m3 bytes in f32, as ``test_torch_wire.py`` states).
* The canonical form byte for byte against JAX's ``zero_to_canonical``
  of the same plan and values; round-tripped; saved at world 2 and
  restored at world 4.
* The ZeRO step of the MLP (SGD momentum, Adam, AdamW): bitwise equal
  to the replicated step at world 1; at worlds 2 and 4 within rtol
  2e-5 / atol 1e-6 (``tests/test_zero.py``'s tolerance: the average is
  taken before the sum instead of after) with replicas bit-identical and
  ``Σ shard_len`` state elements per state tensor on each rank; with
  accumulation; the guard's skip bit-unchanged with the same collectives
  as without it; the tiny LM's ZeRO step on the dp mesh's spec-grouped
  plan.
* The LM's ZeRO step at world 1 against the JAX ZeRO step on a 1-device
  mesh from the same weights: the LM tests' tolerance (losses rtol
  1e-5, each leaf's update within 1e-3 relative L2).
* Every eager refusal.
"""

import functools
import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_dist_worker
from horovod_tpu import optimizer as jopt
from horovod_tpu.models import resnet as jres
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.parallel.mesh import create_hybrid_mesh as jmesh
from horovod_tpu_torch import convert, runtime
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.ops.sparse import IndexedSlices
from horovod_tpu_torch.optimizer import (DistributedOptimizer,
                                         ZeroShardedState,
                                         zero_to_canonical)
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import transformer as ttr
from horovod_tpu_torch.training import create_train_state, make_train_step

WIRES = (None, "bf16", "fp8")
LIMIT = {None: 1e-6, "bf16": 2.0 ** -7, "fp8": 2.0 ** -3}
ZERO_TOL = dict(rtol=2e-5, atol=1e-6)
PLAN_FIELDS = ("buckets", "sizes", "padded", "shapes", "dtypes", "nshards")
SPEC_FIELDS = ("scatter_axis", "denoms", "extra_axes", "shard_axes",
               "nonscatter", "global_shapes")
LM_DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)


@pytest.fixture
def one_rank_world(monkeypatch):
    for var in ("HVD_RANK", "PMI_RANK", "OMPI_COMM_WORLD_RANK", "HVD_SIZE",
                "PMI_SIZE", "OMPI_COMM_WORLD_SIZE", "HVD_LOCAL_RANK",
                "OMPI_COMM_WORLD_LOCAL_RANK", "HVD_ZERO", "HVD_OVERLAP",
                "HVD_GUARD_NONFINITE", "HVD_WIRE_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    yield
    runtime.shutdown()


# -- the plan -----------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet50_pair():
    shapes = jax.eval_shape(
        functools.partial(jres.resnet50().init, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    model = tres.resnet50(device="cpu")
    return (jax.tree_util.tree_leaves(shapes["params"]),
            [p for _, p in convert.jax_leaf_order(model)])


def _lm12():
    jcfg = jtr.TransformerConfig(vocab=128, d_model=128, n_heads=1,
                                 n_layers=12, d_ff=256, dtype=jnp.float32)
    tcfg = ttr.TransformerConfig(vocab=128, d_model=128, n_heads=1,
                                 n_layers=12, d_ff=256, dtype=torch.float32)
    shapes = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    shapes = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), shapes)
    named = convert.jax_leaf_order(ttr.Transformer(tcfg, device="cpu"))
    return jcfg, shapes, [p for _, p in named]


def _fields(plan, names):
    return {f: getattr(plan, f) for f in names}


@pytest.mark.parametrize("nshards", [2, 4, 8])
@pytest.mark.parametrize("threshold", [None, 1 << 20, 0])
def test_plan_zero_matches_jax_for_resnet50(resnet50_pair, threshold,
                                            nshards):
    jleaves, tleaves = resnet50_pair
    jplan = jfusion.plan_zero(jleaves, nshards, threshold)
    tplan = tfusion.plan_zero(tleaves, nshards, threshold)
    # Each framework keeps its own parameter layouts (a conv kernel is
    # OIHW here, HWIO in flax): the shapes agree in element count.
    fields = tuple(f for f in PLAN_FIELDS if f != "shapes")
    assert _fields(tplan, fields) == _fields(jplan, fields)
    assert [int(np.prod(s)) for s in tplan.shapes] == \
        [int(np.prod(s)) for s in jplan.shapes]
    assert tplan.shard_shapes() == jplan.shard_shapes()
    assert tplan.canonical_sizes() == jplan.canonical_sizes()


@pytest.mark.parametrize("nshards", [2, 4])
@pytest.mark.parametrize("threshold", [None, 300_000, 0])
def test_plan_zero_matches_jax_for_the_12_layer_lm(threshold, nshards):
    jcfg, shapes, tleaves = _lm12()
    jplan = jfusion.plan_zero(shapes, nshards, threshold)
    tplan = tfusion.plan_zero(tleaves, nshards, threshold)
    assert _fields(tplan, PLAN_FIELDS) == _fields(jplan, PLAN_FIELDS)
    # The spec-grouped plan of the dp-only mesh, as the LM step builds it.
    jm = jmesh(dp=nshards, devices=jax.devices()[:nshards])
    jspec = jfusion.plan_zero(shapes, nshards, threshold,
                              specs=jtr.param_specs(jcfg, jm), mesh=jm)
    tm = tmesh.Mesh(axis_names=("dp",), shape={"dp": nshards},
                    coords={"dp": 0}, ranks={}, groups={})
    tspec = tfusion.plan_zero(tleaves, nshards, threshold,
                              specs=[None] * len(tleaves), mesh=tm)
    assert _fields(tspec, PLAN_FIELDS + SPEC_FIELDS) == \
        _fields(jspec, PLAN_FIELDS + SPEC_FIELDS)
    assert tspec.hybrid and jspec.hybrid


def test_threshold_env_flip_changes_both_plans(monkeypatch):
    _, shapes, tleaves = _lm12()
    for raw in ("0", "200000", "67108864"):
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", raw)
        jplan = jfusion.plan_zero(shapes, 4)
        tplan = tfusion.plan_zero(tleaves, 4)
        assert _fields(tplan, PLAN_FIELDS) == _fields(jplan, PLAN_FIELDS)
    assert len(tplan.buckets) == 1


def test_init_shard_math():
    plan = tfusion.plan_zero([torch.zeros(9), torch.zeros(3, 4)], 8)
    assert plan.sizes == (21,) and plan.padded == (24,)
    assert plan.shard_shapes() == ((8, 3),)
    assert tfusion.shard_params(
        [torch.arange(9.), torch.arange(12.).reshape(3, 4) + 9], plan,
        7)[0].tolist() == [0.0, 0.0, 0.0]
    assert tfusion.shard_params(
        [torch.arange(9.), torch.arange(12.).reshape(3, 4) + 9], plan,
        6)[0].tolist() == [18.0, 19.0, 20.0]


def test_plan_zero_refusals():
    """A non-scatter axis plans (the hybrid plan), whatever its size;
    what stays refused is a leaf sharded over the scatter axis and specs
    without a mesh."""
    tm = tmesh.Mesh(axis_names=("dp", "pp"), shape={"dp": 2, "pp": 1},
                    coords={}, ranks={}, groups={})
    ts = [torch.zeros(4), torch.zeros(2, 3)]
    size1 = tfusion.plan_zero(ts, 2, specs=[None, None], mesh=tm)
    assert size1.nonscatter == (("pp", 1),) and size1.denoms == (2,)
    assert size1.extra_axes == (("pp",),) and size1.shard_axes == ((),)
    ok = tfusion.plan_zero(ts, 2, specs=[None, None], mesh=tm,
                           skip_axes=("pp",))
    assert ok.denoms == (2,) and ok.nonscatter == ()
    assert ok.buckets == size1.buckets
    tp = tmesh.Mesh(axis_names=("dp", "tp"), shape={"dp": 2, "tp": 2},
                    coords={}, ranks={}, groups={})
    hyb = tfusion.plan_zero(ts, 2, specs=[(None,), (None, "tp")], mesh=tp)
    assert hyb.buckets == ((0,), (1,)) and hyb.nonscatter == (("tp", 2),)
    assert hyb.global_shapes == ((4,), (2, 6)) and hyb.shapes == ((4,),
                                                                  (2, 3))
    assert hyb.denoms == (4, 4) and hyb.extra_axes == (("tp",), ())
    assert hyb.shard_shapes() == ((2, 2), (2, 6))
    assert hyb.canonical_sizes() == (4, 12)
    with pytest.raises(ValueError, match="scatter axis"):
        tfusion.plan_zero(ts, 2, specs=[("dp",), None], mesh=tm,
                          skip_axes=("pp",))
    with pytest.raises(ValueError, match="requires mesh"):
        tfusion.plan_zero(ts, 2, specs=[None, None])
    with pytest.raises(ValueError, match="does not match"):
        tfusion.plan_zero(ts, 4, specs=[None, None], mesh=tm,
                          skip_axes=("pp",))
    with pytest.raises(ValueError, match="dense gradients"):
        tfusion.plan_zero([torch.zeros(4), IndexedSlices(
            torch.zeros(2, 4), torch.zeros(2, dtype=torch.int64), (8, 4))],
            2)
    with pytest.raises(ValueError, match="dense gradients"):
        tfusion.plan_zero([torch.zeros(4, 2).to_sparse()], 2)
    with pytest.raises(ValueError, match="nshards"):
        tfusion.plan_zero(ts, 0)


# -- the collectives and the steps in gloo worlds of 2 and 4 -------------------

def _cases(world):
    rng = np.random.RandomState(10 + world)
    base = [rng.randn(world, 37).astype(np.float32) * 3,
            rng.randn(world, 5, 7).astype(np.float32) * 1e-3,
            rng.randn(world, 301).astype(np.float32)]
    out = {}
    for wire in WIRES:
        for name, kw in (("fused", dict(threshold=1 << 20)),
                         ("per_leaf", dict(threshold=0)),
                         ("prescale_sum", dict(threshold=1 << 20,
                                               prescale=0.25,
                                               average=False))):
            out[f"{wire}-{name}"] = dict(
                arrays=base, wire=wire, prescale=kw.get("prescale"),
                average=kw.get("average", True), threshold=kw["threshold"])
        nan = [a.copy() for a in base]
        nan[2][0, 11] = np.nan
        out[f"{wire}-nan"] = dict(arrays=nan, wire=wire, prescale=None,
                                  average=True, threshold=1 << 20)
    return out


def _spawn(world, workdir, restore=None):
    rng = np.random.RandomState(world)
    inp = {"cases": _cases(world),
           "x": rng.randn(3, 16, 8).astype(np.float32),
           "y": rng.randint(0, 10, (3, 16)).astype(np.int64),
           "lm_dims": LM_DIMS,
           "tokens": rng.randint(0, 64, (2, 4, 16)).astype(np.int64),
           "restore": restore}
    with open(workdir / "zero_inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(torch_dist_worker.run_zero, args=(world, port, str(workdir)),
             nprocs=world, join=True)
    ranks = []
    for r in range(world):
        with open(workdir / f"zero_rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return world, inp, ranks


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("torch_zero2", numbered=False))


@pytest.fixture(scope="module")
def world4(world2, tmp_path_factory):
    saved = tmp_path_factory.getbasetemp() / "torch_zero2" / "canonical.pkl"
    return _spawn(4, tmp_path_factory.mktemp("torch_zero4"),
                  restore=str(saved))


@pytest.fixture(params=[2, 4])
def world(request):
    return request.getfixturevalue(f"world{request.param}")


def _jax_scatter_gather(case, world):
    mesh = Mesh(np.array(jax.devices()[:world]), ("hvd",))
    n = len(case["arrays"])
    leaves = [jax.ShapeDtypeStruct(a.shape[1:], jnp.float32)
              for a in case["arrays"]]
    plan = jfusion.plan_zero(leaves, world, case["threshold"])

    def body(*xs):
        shards, local = jfusion.fused_reduce_scatter(
            [x[0] for x in xs], plan, average=case["average"],
            axis_name="hvd", prescale=case["prescale"], return_finite=True,
            wire_dtype=case["wire"])
        tree, everywhere = jfusion.fused_allgather_params(
            shards, plan, axis_name="hvd", and_finite=local)
        return ([s[None] for s in shards], local[None]), (tree, everywhere)
    f = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("hvd"),) * n,
        out_specs=((P("hvd"), P("hvd")), (P(), P())), check_vma=False))
    (shards, local), (tree, everywhere) = f(
        *[jnp.asarray(a) for a in case["arrays"]])
    return ([np.asarray(s, np.float32) for s in shards],
            np.asarray(local), [np.asarray(t, np.float32) for t in tree],
            bool(everywhere))


CASES = [f"{w}-{n}" for w in WIRES
         for n in ("fused", "per_leaf", "prescale_sum", "nan")]


@pytest.mark.parametrize("name", CASES)
def test_reduce_scatter_and_allgather_match_jax(world, name):
    n, inp, ranks = world
    case = inp["cases"][name]
    shards, local, tree, everywhere = _jax_scatter_gather(case, n)
    limit = LIMIT[case["wire"]]
    for r, got in enumerate(ranks):
        g = got["cases"][name]
        assert g["local"] == bool(local[r]), (r, name)
        assert g["all_finite"] == everywhere
        if not everywhere:
            continue
        for gs, js in zip(g["shards"], shards):
            np.testing.assert_allclose(gs, js[r], rtol=0,
                                       atol=limit * np.abs(js).max())
        for gt, jt in zip(g["gathered"], tree):
            np.testing.assert_allclose(gt, jt, rtol=0,
                                       atol=limit * np.abs(jt).max())
        for gt, g0 in zip(g["gathered"], ranks[0]["cases"][name]["gathered"]):
            np.testing.assert_array_equal(gt, g0)


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw", "accum"])
def test_zero_step_matches_replicated_and_replicas_agree(world, opt):
    n, _, ranks = world
    for got in ranks:
        z, rep = got["runs"][(opt, True)], got["runs"][(opt, False)]
        np.testing.assert_allclose(z["losses"], rep["losses"], rtol=1e-5)
        for k, v in rep["params"].items():
            np.testing.assert_allclose(z["params"][k], v, **ZERO_TOL,
                                       err_msg=k)
        for k, v in ranks[0]["runs"][(opt, True)]["params"].items():
            np.testing.assert_array_equal(z["params"][k], v)


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
def test_state_elements_per_rank_are_the_shard_lengths(world, opt):
    n, _, ranks = world
    for got in ranks:
        z = got["runs"][(opt, True)]
        keys = {"sgd": {"momentum_buffer"},
                "adam": {"exp_avg", "exp_avg_sq"},
                "adamw": {"exp_avg", "exp_avg_sq"}}[opt]
        assert set(z["state_elems"]) == keys
        assert all(v == sum(z["shard_len"])
                   for v in z["state_elems"].values())
        total = sum(v.size for v in z["params"].values())
        assert sum(z["shard_len"]) * n >= total > sum(z["shard_len"]) * (
            n - 1)


def test_guard_skip_is_bit_unchanged_with_no_extra_collective(world):
    n, _, ranks = world
    for got in ranks:
        g = got["guard"]
        steps = g["steps"]
        assert [s["bad_step"] for s in steps] == [0.0, 1.0, 0.0]
        assert [s["unchanged"] for s in steps] == [False, True, False]
        assert steps[1]["loss"] == 0.0
        nb = g["n_buckets"]
        want = dict(g["plain_counts"])
        assert want["reduce_scatter_tensor"] == nb
        assert want["all_gather_into_tensor"] == nb
        assert want["all_reduce"] == 1          # the loss's world mean
        for s in steps:
            assert s["counts"] == want


def test_lm_zero_step_on_the_dp_mesh(world):
    n, _, ranks = world
    for got in ranks:
        lm = got["lm"]
        assert lm["plan"][0] == "dp" and set(lm["plan"][1]) == {n}
        np.testing.assert_allclose(lm[True]["loss"], lm[False]["loss"],
                                   rtol=1e-5)
        for k, v in lm[False]["params"].items():
            np.testing.assert_allclose(lm[True]["params"][k], v,
                                       **ZERO_TOL, err_msg=k)
            np.testing.assert_array_equal(lm[True]["params"][k],
                                          ranks[0]["lm"][True]["params"][k])


def test_canonical_roundtrip_and_restore_across_world_resize(world2,
                                                             world4):
    for _, _, ranks in (world2, world4):
        for got in ranks:
            assert got["roundtrip"]
    saved = world2[2][0]["canonical"]
    for r, got in enumerate(world4[2]):
        res = got["restored"]
        padded, lens = res["plan"]
        for i, (want, back) in enumerate(zip(saved, res["canonical"])):
            assert want.keys() == back.keys()
            for k, v in want.items():
                np.testing.assert_array_equal(back[k], v)
                if v.ndim:
                    s = lens[i]
                    full = np.concatenate([v, np.zeros(padded[i] - v.size,
                                                       v.dtype)])
                    np.testing.assert_array_equal(
                        res["shards"][i][k], full[r * s:(r + 1) * s])


def test_canonical_form_is_jax_byte_for_byte(world2):
    """The same plan and the same moment values: JAX's stacked
    ``[nshards, shard_len]`` adam state and the port's per-rank shards
    canonicalize to the same bytes."""
    _, _, ranks = world2
    canon = ranks[0]["canonical"]
    jplan = jfusion.plan_zero(
        [jax.ShapeDtypeStruct(s, jnp.float32)
         for s in ((16,), (8, 16), (10,), (16, 10))], 2, 300)
    # The MLP's leaves in flax order are l0.bias, l0.weight, l1.bias,
    # l1.weight; only the sizes matter to the layout.
    assert [sum(int(np.prod(jplan.shapes[j])) for j in b)
            for b in jplan.buckets] == [c["exp_avg"].size for c in canon]
    stacked = []
    for i, c in enumerate(canon):
        flats = {}
        for k in ("exp_avg", "exp_avg_sq"):
            v = c[k]
            flats[k] = np.concatenate(
                [v, np.zeros(jplan.padded[i] - v.size, v.dtype)]).reshape(
                    jplan.shard_shapes()[i])
        stacked.append(flats)
    state = jopt.ZeroShardedState(
        inner=(optax.ScaleByAdamState(
            count=jnp.zeros((), jnp.int32),
            mu=tuple(jnp.asarray(s["exp_avg"]) for s in stacked),
            nu=tuple(jnp.asarray(s["exp_avg_sq"]) for s in stacked)),),
        plan=jplan)
    jcanon = jopt.zero_to_canonical(state).inner[0]
    for i, c in enumerate(canon):
        assert np.asarray(jcanon.mu[i]).tobytes() == c["exp_avg"].tobytes()
        assert np.asarray(jcanon.nu[i]).tobytes() == \
            c["exp_avg_sq"].tobytes()


# -- a world of one -------------------------------------------------------------

def _mlp_state(opt, **kw):
    return create_train_state(torch_dist_worker._MLP(),
                              torch_dist_worker.OPTS[opt],
                              fusion_threshold=300, device="cpu", **kw)


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("accum", [1, 2])
def test_world_one_zero_is_bitwise_the_replicated_step(opt, accum,
                                                       one_rank_world):
    rng = np.random.RandomState(0)
    batches = [(torch.from_numpy(rng.randn(8, 8).astype(np.float32)),
                torch.from_numpy(rng.randint(0, 10, 8))) for _ in range(3)]
    out = {}
    for zero in (False, True):
        state = _mlp_state(opt, zero=zero)
        step = make_train_step(accum_steps=accum)
        for b in batches:
            state, m = step(state, b)
        out[zero] = [p.detach().clone() for p in state.model.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))


def test_lm_zero_step_matches_the_jax_zero_step(one_rank_world):
    jcfg = jtr.TransformerConfig(**LM_DIMS, dtype=jnp.float32)
    tcfg = ttr.TransformerConfig(**LM_DIMS, dtype=torch.float32,
                                 attn_backend="xla")
    mesh = jmesh(dp=1, devices=jax.devices()[:1])
    init_state, step = jtr.make_parallel_train_step(
        jcfg, mesh, optax.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=0.1),
        zero=True)
    params, opt_state = init_state(jax.random.PRNGKey(0))
    p0 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                jax.device_get(params))
    rng = np.random.RandomState(3)
    batches = [(rng.randint(0, 64, (2, 32)), rng.randint(0, 64, (2, 32)))
               for _ in range(3)]
    jlosses = []
    for toks, labels in batches:
        params, opt_state, loss = step(params, opt_state, jnp.asarray(toks),
                                       jnp.asarray(labels))
        jlosses.append(float(loss))
    assert isinstance(opt_state, jopt.ZeroShardedState)
    p3 = jax.device_get(params)
    t_init, t_step = ttr.make_parallel_train_step(
        tcfg, functools.partial(torch.optim.AdamW, lr=1e-3,
                                betas=(0.9, 0.95), weight_decay=0.1),
        zero=True, device="cpu")
    state = t_init(model=convert.params_from_jax(p0, tcfg, device="cpu"))
    assert state.optimizer.zero
    losses = []
    for toks, labels in batches:
        state, loss = t_step(state, torch.from_numpy(toks),
                             torch.from_numpy(labels))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = convert.params_to_numpy(state.model)
    for (path, a), b, b0 in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree_util.tree_leaves(p3),
                                jax.tree_util.tree_leaves(p0)):
        upd, jupd = a - b0, np.asarray(b, np.float32) - b0
        rel = np.linalg.norm(upd - jupd) / np.linalg.norm(jupd)
        assert rel <= 1e-3, (jax.tree_util.keystr(path), rel)


def test_zero_refusals(one_rank_world):
    model = torch_dist_worker._MLP()
    params = list(model.parameters())
    with pytest.raises(ValueError, match="elementwise"):
        DistributedOptimizer(torch.optim.LBFGS(params), zero=True)
    two = torch.optim.SGD([{"params": params[:2]},
                           {"params": params[2:], "lr": 0.5}], lr=0.1)
    with pytest.raises(ValueError, match="one parameter group"):
        DistributedOptimizer(two, zero=True)
    used = torch.optim.SGD(params, lr=0.1, momentum=0.9)
    model(torch.ones(2, 8)).sum().backward()
    used.step()
    with pytest.raises(ValueError, match="before its first step"):
        DistributedOptimizer(used, zero=True)
    fresh = functools.partial(torch.optim.SGD, params, lr=0.1)
    with pytest.raises(ValueError, match="no process-group argument.*mesh="):
        DistributedOptimizer(fresh(), zero=True,
                             process_group=torch.distributed.group.WORLD)
    with pytest.raises(ValueError, match="param_specs"):
        DistributedOptimizer(fresh(), zero=True, mesh=tmesh.dp_mesh())
    with pytest.raises(ValueError, match="average=False"):
        DistributedOptimizer(fresh(), zero=True, mesh=tmesh.dp_mesh(),
                             param_specs=[None] * 4, average=False)
    with pytest.raises(ValueError, match="dense gradients"):
        DistributedOptimizer(fresh(), zero=True, mesh=tmesh.dp_mesh(),
                             param_specs=[None] * 4, sparse_as_dense=True)
    # mesh= without zero is the spec-grouped all-reduce plane: on the dp
    # mesh every leaf sums over dp, one group.
    grouped = DistributedOptimizer(fresh(), mesh=tmesh.dp_mesh(),
                                   param_specs=[None] * 4)
    assert {s.psum for s in grouped._grouped.syncs} == {("dp",)}
    x, y = torch.ones(4, 8), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="requires a ZeRO-sharded"):
        make_train_step(zero=True)(_mlp_state("sgd"), (x, y))
    with pytest.raises(ValueError, match="built with zero=True"):
        make_train_step(zero=False)(_mlp_state("sgd", zero=True), (x, y))
    zst = _mlp_state("sgd", zero=True)
    with pytest.raises(ValueError, match="no closure"):
        zst.optimizer.step(lambda: 0.0)
    with pytest.raises(ValueError, match="rank-sharded"):
        torch_dist_worker_broadcast(zst.optimizer)
    emb = torch.nn.Embedding(10, 4, sparse=True)
    opt = DistributedOptimizer(torch.optim.SGD(emb.parameters(), lr=0.1),
                               zero=True)
    emb(torch.tensor([1, 2])).sum().backward()
    with pytest.raises(ValueError, match="sparse_as_dense"):
        opt.step()
    opt = DistributedOptimizer(torch.optim.SGD(emb.parameters(), lr=0.1),
                               zero=True, sparse_as_dense=True)
    before = emb.weight.detach().clone()
    opt.step()
    assert not torch.equal(before, emb.weight)
    assert torch.equal(before[0], emb.weight[0])


def torch_dist_worker_broadcast(opt):
    from horovod_tpu_torch import broadcast_optimizer_state
    broadcast_optimizer_state(opt)


def test_env_default_arms_zero(monkeypatch, one_rank_world):
    monkeypatch.setenv("HVD_ZERO", "1")
    state = _mlp_state("sgd")
    assert state.optimizer.zero
    state, m = make_train_step()(state, (torch.ones(4, 8),
                                         torch.zeros(4, dtype=torch.int64)))
    assert np.isfinite(float(m["loss"]))
    monkeypatch.setenv("HVD_ZERO", "0")
    assert not _mlp_state("sgd").optimizer.zero


def test_partition_optimizer_is_the_zero_optimizer(one_rank_world):
    from horovod_tpu_torch import partition_optimizer
    model = torch_dist_worker._MLP()
    opt = partition_optimizer(torch.optim.Adam(model.parameters(), lr=0.1),
                              fusion_threshold=0)
    assert opt.zero and len(opt.plan.buckets) == 4
    assert opt.plan.sizes == tuple(p.numel() for p in model.parameters())


def test_zero_state_is_its_plan_and_canonical_at_world_one(one_rank_world):
    state = _mlp_state("adamw", zero=True)
    make_train_step()(state, (torch.ones(4, 8),
                              torch.zeros(4, dtype=torch.int64)))
    zs = state.optimizer.zero_state()
    assert isinstance(zs, ZeroShardedState)
    canon = zero_to_canonical(zs)
    for i, st in enumerate(canon.inner):
        assert st["exp_avg"].shape == (zs.plan.sizes[i],)
        assert st["step"].dim() == 0

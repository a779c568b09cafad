"""Port parity: the low-precision wire formats of the gradient exchange
(``ops.fusion``: ``resolve_wire_dtype``, ``wire_dtype_name``,
``_wire_applies``, ``fused_allreduce(wire_dtype=, return_finite=)``)
against the JAX package, on the CPU.

* The resolver's aliases, its eager error on an unknown spelling, and
  which bucket dtypes ride the wire, against the JAX functions.
* ``fused_allreduce`` on gloo worlds of 2 and 4 (``torch_dist_worker.
  run_wire``, one spawn each) against JAX's ``fused_allreduce`` inside
  ``shard_map`` over a CPU mesh of as many devices, on the same per-rank
  numpy inputs: fp32 exactly (world 2) or to f32 rounding; bf16 within
  2 bf16 ulps of each bucket's largest value (gloo and XLA each round
  the bf16 sum, in other orders at world 4); fp8 within one e4m3 ulp of
  the largest value (2^-3 of it: XLA rounds the fp8 sum, the port's
  gather path sums the fp8 values exactly in f32) and, more tightly,
  against a numpy run of the port's algorithm (f32 scale, one e4m3
  cast, f32 sum in rank order). The looser tolerances of the JAX tests
  of the same name (``tests/test_overlap_wire.py``: bf16 rtol 5e-2 /
  atol 4e-2, fp8 rtol 5e-1 / atol 5e-2) hold a fortiori.
* The all-finite flag: a NaN on one rank makes it False on every rank,
  as in JAX.
* Which path each wire dtype takes on gloo: bf16 native, fp8 by
  all-gather (gloo's all_reduce has no fp8).
* The LM step with ``wire_dtype`` on a world of 1 against the JAX step
  with the same wire on a 1-device mesh.
"""

import functools
import pickle
import socket

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_dist_worker
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.parallel.mesh import create_hybrid_mesh
from horovod_tpu_torch import convert, runtime
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.parallel import transformer as ttr

WIRES = (None, "bf16", "fp8")
# Per wire: the port-vs-JAX limit as a fraction of each bucket's largest
# |value| (see the module docstring); fp32 sums differ by f32 rounding.
LIMIT = {None: 1e-6, "bf16": 2.0 ** -7, "fp8": 2.0 ** -3}


def _cases(world: int):
    """name -> per-rank inputs and the fused_allreduce arguments: leaves
    of mixed magnitude (one bucket, then one per leaf), a bf16 leaf under
    the bf16 wire (already at wire width), a prescale, a sum, and a NaN
    on rank 0."""
    rng = np.random.RandomState(world)
    base = [rng.randn(world, 37).astype(np.float32) * 3,
            rng.randn(world, 5, 7).astype(np.float32) * 1e-3,
            rng.randn(world, 300).astype(np.float32)]
    out = {}
    for wire in WIRES:
        for name, extra in (("fused", dict(threshold=1 << 20)),
                            ("per_leaf", dict(threshold=0)),
                            ("prescale_sum", dict(threshold=1 << 20,
                                                  prescale=0.25,
                                                  average=False))):
            out[f"{wire}-{name}"] = dict(
                arrays=base, wire=wire, prescale=extra.get("prescale"),
                average=extra.get("average", True),
                threshold=extra["threshold"])
        nan = [a.copy() for a in base]
        nan[2][0, 11] = np.nan
        out[f"{wire}-nan"] = dict(arrays=nan, wire=wire, prescale=None,
                                  average=True, threshold=1 << 20)
    return out


def _spawn(world, tmp_path_factory):
    workdir = tmp_path_factory.mktemp(f"torch_wire{world}")
    cases = _cases(world)
    with open(workdir / "wire_inputs.pkl", "wb") as f:
        pickle.dump(cases, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(torch_dist_worker.run_wire, args=(world, port, str(workdir)),
             nprocs=world, join=True)
    ranks = []
    for r in range(world):
        with open(workdir / f"wire_rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return cases, ranks


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


def _jax_reduce(case, world):
    mesh = Mesh(np.array(jax.devices()[:world]), ("hvd",))
    n = len(case["arrays"])

    def body(*xs):
        out, finite = jfusion.fused_allreduce(
            [x[0] for x in xs], average=case["average"], axis_name="hvd",
            prescale=case["prescale"], wire_dtype=case["wire"],
            fusion_threshold=case["threshold"], return_finite=True)
        return out, finite
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("hvd"),) * n,
                              out_specs=P(), check_vma=False))
    out, finite = f(*[jnp.asarray(a) for a in case["arrays"]])
    return [np.asarray(o, np.float32) for o in out], bool(finite)


def _numpy_fp8(case, world):
    """The port's fp8 algorithm in numpy, bucket by bucket."""
    arrays = case["arrays"]
    plan = jfusion.plan_buckets(
        [jax.ShapeDtypeStruct(a.shape[1:], jnp.float32) for a in arrays],
        case["threshold"])
    out = [None] * len(arrays)
    pre = np.float32(case["prescale"] if case["prescale"] is not None
                     else 1.0)
    if case["average"]:
        pre = np.float32((case["prescale"] or 1.0) * (1.0 / world))
    for bucket in plan:
        flat = np.stack([np.concatenate([arrays[j][r].ravel()
                                         for j in bucket])
                         for r in range(world)]) * pre
        amax = np.abs(flat).max()
        scale = np.float32(224.0) / (np.float32(world) * amax)
        q = (flat * scale).astype(ml_dtypes.float8_e4m3fn)
        total = q[0].astype(np.float32)
        for r in range(1, world):
            total = total + q[r].astype(np.float32)
        total = total / scale
        off = 0
        for j in bucket:
            size = arrays[j][0].size
            out[j] = total[off:off + size].reshape(arrays[j].shape[1:])
            off += size
    return out


def _check_world(cases, ranks, world, name):
    case = cases[name]
    want, want_finite = _jax_reduce(case, world)
    for r, got in enumerate(ranks):
        got_r = got[name]
        assert got_r["inputs_untouched"]
        assert got_r["finite"] == want_finite, (r, name)
        if not want_finite:
            continue
        for g, w in zip(got_r["reduced"], want):
            np.testing.assert_allclose(
                g, w, rtol=0,
                atol=LIMIT[case["wire"]] * np.abs(w).max(),
                err_msg=f"rank {r} {name}")
        # Every rank holds the same result, bit for bit.
        for g, g0 in zip(got_r["reduced"], ranks[0][name]["reduced"]):
            np.testing.assert_array_equal(g, g0)
    if case["wire"] == "fp8" and want_finite:
        for g, e in zip(ranks[0][name]["reduced"], _numpy_fp8(case, world)):
            np.testing.assert_allclose(g, e, rtol=1e-6,
                                       atol=1e-6 * np.abs(e).max())


CASE_NAMES = [f"{w}-{n}" for w in WIRES
              for n in ("fused", "per_leaf", "prescale_sum", "nan")]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_fused_allreduce_matches_jax_world2(world2, name):
    _check_world(*world2, 2, name)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_fused_allreduce_matches_jax_world4(world4, name):
    _check_world(*world4, 4, name)


def test_gloo_paths(world2):
    for got in world2[1]:
        assert got["paths"] == {"fp32": "fp32", "bf16": "native",
                                "fp8": "gather"}


@pytest.mark.parametrize("spec", [None, "", "none", "fp32", "f32",
                                  "float32", "bf16", "bfloat16", " BF16 ",
                                  "fp8", "fp8_e4m3", "f8e4m3",
                                  "float8_e4m3fn"])
def test_resolver_aliases_match_jax(spec):
    assert tfusion.wire_dtype_name(spec) == jfusion.wire_dtype_name(spec)
    want = jfusion.resolve_wire_dtype(spec)
    got = tfusion.resolve_wire_dtype(spec)
    assert (got is None) == (want is None)
    if got is not None:
        assert str(got).replace("torch.", "") == jnp.dtype(want).name
        assert tfusion.resolve_wire_dtype(got) == got


@pytest.mark.parametrize("spec", ["fp16", "int8", "bf8", "float16"])
def test_resolver_rejects_unknown_spellings_like_jax(spec):
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        jfusion.resolve_wire_dtype(spec)
    with pytest.raises(ValueError, match="unknown wire_dtype") as e:
        tfusion.resolve_wire_dtype(spec)
    assert "'bf16', 'fp8'" in str(e.value)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16",
                                   "float16", "int32"])
@pytest.mark.parametrize("wire", ["bf16", "fp8", None])
def test_wire_applies_matches_jax(dtype, wire):
    assert tfusion._wire_applies(
        getattr(torch, dtype), tfusion.resolve_wire_dtype(wire)) == \
        jfusion._wire_applies(jnp.dtype(dtype),
                              jfusion.resolve_wire_dtype(wire))


def test_native_reduce_table():
    assert tfusion.native_wire_reduce("gloo", torch.bfloat16)
    assert tfusion.native_wire_reduce("nccl", torch.bfloat16)
    assert not tfusion.native_wire_reduce("gloo", torch.float8_e4m3fn)
    assert not tfusion.native_wire_reduce("nccl", torch.float8_e4m3fn,
                                          torch.device("cpu"))


@pytest.fixture
def one_rank_world(monkeypatch):
    for var in ("HVD_RANK", "PMI_RANK", "OMPI_COMM_WORLD_RANK", "HVD_SIZE",
                "PMI_SIZE", "OMPI_COMM_WORLD_SIZE", "HVD_LOCAL_RANK",
                "OMPI_COMM_WORLD_LOCAL_RANK", "HVD_WIRE_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    yield
    runtime.shutdown()


LM_DIMS = dict(vocab=128, d_model=256, n_heads=2, n_layers=2, d_ff=256)


@pytest.mark.parametrize("wire", ["bf16", "fp8"])
def test_lm_step_with_wire_matches_jax(wire, one_rank_world):
    """One SGD step of the f32 LM with the gradient on the wire, on a
    world of 1 (the wire still quantizes, as inside the JAX step's
    shard_map) against JAX on a 1-device mesh: the same quantization of
    the same gradient, so the loss to f32 rounding (rtol 1e-5) and the
    updates within the wire's own resolution of the largest update
    entry (2^-8 bf16, 2^-4 fp8)."""
    jcfg = jtr.TransformerConfig(**LM_DIMS, dtype=jnp.float32)
    tcfg = ttr.TransformerConfig(**LM_DIMS, dtype=torch.float32)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, LM_DIMS["vocab"], (2, 128)).astype(np.int32)
    labels = rng.randint(0, LM_DIMS["vocab"], (2, 128)).astype(np.int32)
    mesh = create_hybrid_mesh(dp=1, devices=jax.devices()[:1])
    init_state, jstep = jtr.make_parallel_train_step(
        jcfg, mesh, optax.sgd(1.0), wire_dtype=wire)
    params, opt_state = init_state(jax.random.PRNGKey(0))
    p0 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                jax.device_get(params))
    params, _, jloss = jstep(params, opt_state, jnp.asarray(toks),
                             jnp.asarray(labels))
    model = convert.params_from_jax(p0, tcfg, device="cpu")
    t_init, tstep = ttr.make_parallel_train_step(
        tcfg, functools.partial(torch.optim.SGD, lr=1.0), wire_dtype=wire,
        device="cpu")
    state = t_init(model=model)
    assert state.optimizer.wire_dtype == tfusion.resolve_wire_dtype(wire)
    state, loss = tstep(state, torch.from_numpy(toks),
                        torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = convert.params_to_numpy(model)
    res = {"bf16": 2.0 ** -8, "fp8": 2.0 ** -4}[wire]
    for (path, g), w, w0 in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_leaves(jax.device_get(params)),
            jax.tree_util.tree_leaves(p0)):
        upd, jupd = g - w0, np.asarray(w, np.float32) - w0
        np.testing.assert_allclose(
            upd, jupd, rtol=0, atol=res * np.abs(jupd).max() + 1e-7,
            err_msg=jax.tree_util.keystr(path))


def test_env_sets_the_wire(one_rank_world, monkeypatch):
    monkeypatch.setenv("HVD_WIRE_DTYPE", "fp8")
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(3))], lr=0.1)
    from horovod_tpu_torch import DistributedOptimizer
    assert DistributedOptimizer(opt).wire_dtype == torch.float8_e4m3fn
    assert DistributedOptimizer(opt, wire_dtype="fp32").wire_dtype is None
    monkeypatch.setenv("HVD_WIRE_DTYPE", "fp4")
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        DistributedOptimizer(opt)

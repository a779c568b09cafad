"""Port parity: the bad-step guard (``make_train_step(guard_nonfinite=)``
and the LM and pipelined steps' ``guard_nonfinite``) against the JAX
package, on the CPU.

* A 2-rank gloo world (``torch_dist_worker.run_guard``), one spawn for
  the file: the small fused ResNet takes a finite step, a step where only
  rank 0's batch holds a NaN image, and a finite step. On the skipped
  step both ranks keep params, SGD momentum AND BatchNorm running
  statistics bit-unchanged, ``bad_step`` reads 1.0 and the loss 0; the
  recovery step trains. The JAX step with the guard on a 2-device mesh,
  fed the same batches, skips the same step and ends at the same
  parameters (the training tests' f32 tolerance: rtol 1e-3, atol 1e-4 of
  each leaf's largest entry). The LM step skips on both ranks when only
  rank 1's gradients are NaN (AdamW's state and step count unchanged).
  The pipelined step on dp=1 × pp=2 skips on both stages when stage 1's
  weights hold a NaN, and when only stage 1's flag is False (the one
  scalar MIN over pp folds it).
* In this process: the guard adds no collective; ``HVD_GUARD_NONFINITE``
  arms it; it needs nothing but a ``DistributedOptimizer``.
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
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import Mesh

import torch_dist_worker
from horovod_tpu import optimizer as jopt
from horovod_tpu import training as jtraining
from horovod_tpu.models import resnet as jres
from horovod_tpu.runtime import AXIS
from horovod_tpu_torch import convert, runtime
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.training import create_train_state, make_train_step

SMALL = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10)
TOL = dict(rtol=1e-3, atol=1e-4)
LM_DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)
NAN_STEP = 1


def _jax_model():
    return jres.ResNet(block_cls=jres.BottleneckBlock, conv_backend="fused",
                       dtype=jnp.float32, **SMALL)


@pytest.fixture(scope="module")
def variables():
    v = jax.device_get(jax.jit(_jax_model().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)


@pytest.fixture(scope="module")
def batches():
    """Three global batches of 8; the second has a NaN image in row 0
    (rank 0's shard)."""
    rng = np.random.RandomState(5)
    x = rng.standard_normal((3, 8, 64, 64, 3)).astype(np.float32)
    x[NAN_STEP, 0, 3, 4, 1] = np.nan
    y = rng.randint(0, 10, (3, 8)).astype(np.int64)
    return x, y


@pytest.fixture(scope="module")
def world(variables, batches, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("torch_guard")
    rng = np.random.RandomState(7)
    with open(workdir / "guard_inputs.pkl", "wb") as f:
        pickle.dump({"variables": variables, "x": batches[0],
                     "y": batches[1], "lm_dims": LM_DIMS,
                     "cfg": dict(dtype=torch.float32, conv_backend="fused",
                                 **SMALL),
                     "tokens": rng.randint(0, LM_DIMS["vocab"],
                                           (2, 4, 16)).astype(np.int64)},
                    f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(torch_dist_worker.run_guard, args=(2, port, str(workdir)),
             nprocs=2, join=True)
    out = []
    for r in range(2):
        with open(workdir / f"guard_rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _jax_guarded_steps(variables, batches):
    dist_opt = jopt.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=dist_opt.init(params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    mesh = Mesh(np.array(jax.devices()[:2]), (AXIS,))
    step = jtraining.make_train_step(_jax_model(), dist_opt, mesh=mesh,
                                     guard_nonfinite=True)
    metrics = []
    for x, y in zip(*batches):
        state, m = step(state, (jnp.asarray(x), jnp.asarray(y)))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(state)


def _assert_trees_close(got, want, rtol, atol):
    gl = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    wl = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert sorted(map(jax.tree_util.keystr, gl)) == \
        sorted(map(jax.tree_util.keystr, wl))
    for path, w in wl.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(gl[path]), w, rtol=rtol,
            atol=atol * max(np.abs(w).max(), 1e-30),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("rank", [0, 1])
def test_nan_on_one_rank_skips_on_every_rank(world, rank):
    steps = world[rank]["resnet"]["steps"]
    assert [s["bad_step"] for s in steps] == [0.0, 1.0, 0.0]
    assert [s["unchanged"] for s in steps] == [False, True, False]
    assert steps[NAN_STEP]["loss"] == 0.0
    assert all(np.isfinite(s["loss"]) and s["loss"] > 0
               for i, s in enumerate(steps) if i != NAN_STEP)
    assert world[rank]["resnet"]["step"] == 3       # the counter advances


def test_guarded_steps_match_jax_and_replicas_agree(variables, batches,
                                                    world):
    jmetrics, jstate = _jax_guarded_steps(variables, batches)
    assert [m["bad_step"] for m in jmetrics] == [0.0, 1.0, 0.0]
    assert jmetrics[NAN_STEP]["loss"] == 0.0
    got = [w["resnet"] for w in world]
    np.testing.assert_allclose([s["loss"] for s in got[0]["steps"]],
                               [m["loss"] for m in jmetrics], rtol=1e-4)
    _assert_trees_close(got[0]["variables"]["params"], jstate.params, **TOL)
    # BatchNorm is local: rank 0's statistics are JAX's replica 0's.
    _assert_trees_close(got[0]["variables"]["batch_stats"],
                        jstate.batch_stats, **TOL)
    _assert_trees_close(got[0]["variables"]["params"],
                        got[1]["variables"]["params"], rtol=0, atol=0)


@pytest.mark.parametrize("rank", [0, 1])
def test_lm_step_skips_when_one_rank_is_not_finite(world, rank):
    lm = world[rank]["lm"]
    assert lm["loss"] == 0.0
    assert lm["unchanged"]
    assert lm["adam_steps"] == [1.0]


@pytest.mark.parametrize("case,skipped", [("nan_stage1", True),
                                          ("flag_stage1", True),
                                          ("finite", False)])
def test_pp_guard_folds_the_verdict_over_pp(world, case, skipped):
    for rank in range(2):
        got = world[rank]["pp"][case]
        assert got["unchanged"] == skipped, (rank, got)
        assert (got["loss"] == 0.0) == skipped, (rank, got)


@pytest.fixture
def one_rank_world(monkeypatch):
    for var in ("HVD_RANK", "PMI_RANK", "OMPI_COMM_WORLD_RANK", "HVD_SIZE",
                "PMI_SIZE", "OMPI_COMM_WORLD_SIZE", "HVD_LOCAL_RANK",
                "OMPI_COMM_WORLD_LOCAL_RANK", "HVD_GUARD_NONFINITE"):
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    yield
    runtime.shutdown()


def _small_state(variables):
    model = convert.resnet_from_jax(
        variables, tres.ResNetConfig(dtype=torch.float32,
                                     conv_backend="fused", **SMALL),
        device="cpu")
    return create_train_state(model, functools.partial(
        torch.optim.SGD, lr=0.1, momentum=0.9), device="cpu")


def test_guard_adds_no_collective(variables, batches, one_rank_world,
                                  monkeypatch):
    """The flag is read from the buckets the exchange already reduced:
    the guarded step issues exactly the collectives of the plain one."""
    calls = []
    real = dist.all_reduce

    def counting(tensor, *args, **kwargs):
        calls.append(tuple(tensor.shape))
        return real(tensor, *args, **kwargs)
    monkeypatch.setattr(dist, "all_reduce", counting)
    x, y = torch.from_numpy(batches[0][0][:4]), torch.from_numpy(
        batches[1][0][:4])
    counts = {}
    for guard in (False, True):
        calls.clear()
        step = make_train_step(guard_nonfinite=guard)
        _, metrics = step(_small_state(variables), (x, y))
        counts[guard] = list(calls)
        assert ("bad_step" in metrics) == guard
    assert counts[True] == counts[False]


def test_env_arms_the_guard(variables, batches, one_rank_world,
                            monkeypatch):
    monkeypatch.setenv("HVD_GUARD_NONFINITE", "1")
    x = torch.from_numpy(batches[0][NAN_STEP][:4])
    y = torch.from_numpy(batches[1][NAN_STEP][:4])
    state = _small_state(variables)
    before = {n: p.detach().clone() for n, p in
              state.model.state_dict().items()}
    state, metrics = make_train_step()(state, (x, y))
    assert float(metrics["bad_step"]) == 1.0
    assert float(metrics["loss"]) == 0.0
    for n, t in state.model.state_dict().items():
        assert torch.equal(t, before[n]), n
    assert not state.optimizer.state            # SGD never stepped

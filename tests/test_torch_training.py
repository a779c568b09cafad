"""Port parity: the bucket plan, the data-parallel train step and the
Horovod collectives against the JAX package, on the CPU.

* ``plan_buckets`` membership equals the JAX plan over ResNet-50's leaf
  list (flax flatten order, which ``convert.jax_leaf_order`` gives the
  port).
* Two ``make_train_step`` steps of SGD(0.1, momentum 0.9) on the small
  fused ResNet, from the same randomized variables and batches: a 1-rank
  world (gloo, in this process) against the JAX step on a 1-device mesh,
  and a 2-rank gloo world (spawned once for the file, see
  ``torch_dist_worker.py``) against the JAX step on a 2-device mesh with
  the same global batch of 8.
* ``broadcast_parameters``, ``broadcast_optimizer_state`` and the eager
  ``allreduce``/``allgather``/``broadcast`` in the 2-rank world.

Tolerances (f32): loss rtol 1e-4; params, momentum and batch_stats rtol
1e-3 / atol 1e-4 of each leaf's largest entry (two steps of sums taken in
other orders; a gradient that cancels to ~0 keeps ~1e-7 of noise).
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

import torch_dist_worker
from horovod_tpu import optimizer as jopt
from horovod_tpu import training as jtraining
from horovod_tpu.models import resnet as jres
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.runtime import AXIS
from horovod_tpu_torch import convert, runtime
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.training import (create_train_state, make_eval_step,
                                        make_train_step)

SMALL = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10)
SGD = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
TOL = dict(rtol=1e-3, atol=1e-4)


def _jax_model():
    return jres.ResNet(block_cls=jres.BottleneckBlock, conv_backend="fused",
                       dtype=jnp.float32, **SMALL)


def _port_cfg():
    return tres.ResNetConfig(dtype=torch.float32, conv_backend="fused",
                             **SMALL)


@pytest.fixture(scope="module")
def variables():
    v = jax.device_get(jax.jit(_jax_model().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    rng = np.random.RandomState(0)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        a = np.asarray(leaf, np.float32)
        if "scale" in name:
            return (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        if "bias" in name or "mean" in name:
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        if "var" in name:
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(perturb, v)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(1)
    return (rng.standard_normal((8, 64, 64, 3)).astype(np.float32),
            rng.randint(0, 10, 8).astype(np.int64))


def _jax_steps(variables, x, y, n_devices):
    """Two JAX train steps on an ``n_devices`` mesh; returns (losses,
    params, batch_stats, momentum) as numpy trees."""
    model = _jax_model()
    # create_train_state's non-ZeRO path, from the given variables (its
    # eager model.init would only be overwritten).
    dist_opt = jopt.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=dist_opt.init(params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    mesh = Mesh(np.array(jax.devices()[:n_devices]), (AXIS,))
    step = jtraining.make_train_step(model, dist_opt, mesh=mesh)
    losses = []
    for _ in range(2):
        state, metrics = step(state, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(metrics["loss"]))
    traces = [leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(state.opt_state)[0]
              if "trace" in jax.tree_util.keystr(path)]
    momentum = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(state.params), traces)
    return (losses, jax.device_get(state.params),
            jax.device_get(state.batch_stats), jax.device_get(momentum))


def _flax_tree(named: dict) -> dict:
    """``{dotted name: array in port layout}`` -> flax-layout tree."""
    tree: dict = {}
    for name, a in named.items():
        path = name.split(".")
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return tree


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


# -- bucket plan --------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet50_pair():
    """(flax ResNet-50 param shapes, the port's ResNet-50 on the CPU)."""
    shapes = jax.eval_shape(
        functools.partial(jres.resnet50().init, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    return shapes["params"], tres.resnet50(device="cpu")


@pytest.mark.parametrize("threshold", [None, 1 << 20, 0])
def test_plan_buckets_membership_matches_jax_for_resnet50(threshold,
                                                          resnet50_pair):
    shapes, model = resnet50_pair
    jplan = jfusion.plan_buckets(jax.tree_util.tree_leaves(shapes),
                                 threshold)
    tplan = tfusion.plan_buckets(
        [p for _, p in convert.jax_leaf_order(model)], threshold)
    assert tplan == jplan
    n = sum(p.numel() for p in model.parameters())
    assert 25_000_000 < n < 26_000_000
    if threshold is None:
        assert len(tplan) == 2          # ~102 MB of f32 at 64 MiB
    if threshold == 0:
        assert len(tplan) == len(list(model.parameters()))


def test_plan_keeps_dtypes_apart_and_never_looks_ahead():
    ts = [torch.zeros(4), torch.zeros(4, dtype=torch.bfloat16),
          torch.zeros(2), torch.zeros(100), torch.zeros(1)]
    assert tfusion.plan_buckets(ts, 64) == [[0], [1], [2], [3], [4]]
    assert tfusion.plan_buckets(ts, 1 << 20) == [[0], [1], [2, 3, 4]]
    x = torch.ones(3, dtype=torch.bfloat16) / 3
    got = tfusion._prescale_array(x, 1.0 / 3)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (x.float() * (1.0 / 3)).to(torch.bfloat16))


# -- one rank, in this process ------------------------------------------------

@pytest.fixture
def one_rank_world(monkeypatch):
    """A world of one (no launcher environment: rank 0 of 1)."""
    for var in ("HVD_RANK", "PMI_RANK", "OMPI_COMM_WORLD_RANK", "HVD_SIZE",
                "PMI_SIZE", "OMPI_COMM_WORLD_SIZE", "HVD_LOCAL_RANK",
                "OMPI_COMM_WORLD_LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    yield
    runtime.shutdown()


def test_one_rank_train_steps_match_jax(variables, batch, one_rank_world):
    x, y = batch[0][:4], batch[1][:4]
    jlosses, jparams, jstats, jmom = _jax_steps(variables, x, y, 1)
    model = convert.resnet_from_jax(variables, _port_cfg(), device="cpu")
    state = create_train_state(model, SGD, device="cpu")
    step = make_train_step()
    losses = []
    for _ in range(2):
        state, metrics = step(state, (torch.tensor(x), torch.tensor(y)))
        losses.append(float(metrics["loss"]))
    assert state.step == 2
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    out = convert.resnet_to_numpy(model)
    _assert_trees_close(out["params"], jparams, **TOL)
    _assert_trees_close(out["batch_stats"], jstats, **TOL)
    mom = {n: state.optimizer.state[p]["momentum_buffer"].numpy()
           for n, p in model.named_parameters()}
    _assert_trees_close(_flax_tree(mom), jmom, **TOL)


def test_one_rank_eval_step_matches_jax(variables, batch, one_rank_world):
    """Eval runs every block's stock branch on the running statistics."""
    x, y = batch[0][4:], batch[1][4:]
    mesh = Mesh(np.array(jax.devices()[:1]), (AXIS,))
    jstate = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        opt_state=None,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    want = jtraining.make_eval_step(_jax_model(), mesh=mesh)(
        jstate, (jnp.asarray(x), jnp.asarray(y)))
    model = convert.resnet_from_jax(variables, _port_cfg(), device="cpu")
    got = make_eval_step()(create_train_state(model, SGD, device="cpu"),
                           (torch.tensor(x), torch.tensor(y)))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4)
    assert float(got["accuracy"]) == float(want["accuracy"])


def test_distributed_optimizer_wraps_and_delegates(one_rank_world):
    model = torch.nn.Linear(3, 2)
    inner = torch.optim.SGD(model.parameters(), lr=0.1)
    from horovod_tpu_torch import DistributedOptimizer
    opt = DistributedOptimizer(inner,
                               named_parameters=model.named_parameters())
    assert opt.param_groups is inner.param_groups
    model.weight.grad = torch.ones(2, 3)          # bias grad stays None
    before = model.bias.detach().clone()
    opt.step()
    assert torch.equal(model.bias.detach(), before)
    with pytest.raises(ValueError, match="exactly the parameters"):
        DistributedOptimizer(inner, named_parameters=[("w", model.weight)])


# -- two ranks, one spawned gloo world for the file ---------------------------

@pytest.fixture(scope="module")
def two_ranks(variables, batch, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("torch_world")
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump({"variables": variables, "x": batch[0], "y": batch[1],
                     "cfg": dict(dtype=torch.float32, conv_backend="fused",
                                 **SMALL)}, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(torch_dist_worker.run, args=(2, port, str(workdir)), nprocs=2,
             join=True)
    out = []
    for r in range(2):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def test_two_rank_train_steps_match_jax_on_a_two_device_mesh(
        variables, batch, two_ranks):
    jlosses, jparams, jstats, jmom = _jax_steps(variables, *batch, 2)
    for r in range(2):
        np.testing.assert_allclose(two_ranks[r]["losses"], jlosses,
                                   rtol=1e-4)
        _assert_trees_close(two_ranks[r]["variables"]["params"], jparams,
                            **TOL)
        _assert_trees_close(_flax_tree(two_ranks[r]["momentum"]), jmom,
                            **TOL)
    # The averaged gradients leave the replicas' parameters bit-identical.
    _assert_trees_close(two_ranks[0]["variables"]["params"],
                        two_ranks[1]["variables"]["params"], rtol=0, atol=0)
    # BatchNorm is local: each rank's running statistics are its own. Under
    # out_specs=P() the JAX step returns replica 0's, which rank 0 matches.
    _assert_trees_close(two_ranks[0]["variables"]["batch_stats"], jstats,
                        **TOL)
    with pytest.raises(AssertionError):
        _assert_trees_close(two_ranks[1]["variables"]["batch_stats"],
                            jstats, **TOL)


def test_broadcast_parameters_and_optimizer_state(two_ranks):
    want = tres.ResNet(_port_cfg(), device="cpu",
                       generator=torch.Generator().manual_seed(10))
    for r in range(2):
        got = two_ranks[r]["bcast_params"]
        assert set(got) == set(want.state_dict())
        for k, v in want.state_dict().items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
        assert two_ranks[r]["bcast_opt_lr"] == 0.1
        for k, v in two_ranks[0]["momentum"].items():
            np.testing.assert_array_equal(two_ranks[r]["bcast_momentum"][k],
                                          v, err_msg=k)


def test_eager_collectives(two_ranks):
    base = np.arange(12, dtype=np.float32).reshape(3, 4)
    for r in range(2):
        out = two_ranks[r]
        np.testing.assert_array_equal(out["sum"], base * 2)
        np.testing.assert_array_equal(out["avg"], base)
        np.testing.assert_array_equal(out["op_sum_ranked"], base * 3)
        np.testing.assert_array_equal(out["max_ranked"], base * 2)
        assert out["int_sum"] == [1, 3, 5, 7, 9]
        np.testing.assert_array_equal(
            out["gather"], np.concatenate([np.zeros((2, 3)),
                                           np.ones((2, 3))]))
        for root in range(2):
            np.testing.assert_array_equal(out["bcast"][root],
                                          np.full(4, root + 1.0))
        assert out["input_untouched"]

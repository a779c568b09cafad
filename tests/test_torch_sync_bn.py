"""Port parity: cross-replica BatchNorm (``axis_name=hvd.AXIS``) in a gloo
world of 2 against the JAX package's world of 2 on the virtual CPU mesh,
on the CPU.

Two models, each one SGD(0.1, momentum 0.9) train step from the same
randomized variables and global batch of 8 (each rank its half; the
second half shifted and scaled so the halves' statistics differ):

* stock: ``cifar_resnet_v1(20, axis_name=AXIS)`` (flax's
  ``_compute_stats``: one mean of ``[mean, mean2]`` over the axis);
* fused: a bottleneck ``ResNet`` with ``conv_backend="fused"`` at 64²
  (per-rank rows 1024 and 256: both stages pass the ``M % 128`` gate),
  whose statistics come from the fused op's sums through ``fold``'s
  group mean.

The JAX step is the world step (``make_train_step`` under
``shard_map(check_vma=False)`` on a mesh of two CPU devices), so its
gradients go through ``pmean``'s transpose as JAX differentiates it.
Each rank's loss, updated params and running statistics must match
JAX's; both ranks' running statistics must be bitwise equal; a process
group of the world as ``axis_name`` gives the AXIS run bitwise; and the
local-BN control must fail the comparison.

Tolerances (f32, two steps' sums in other orders: test_torch_training's):
loss rtol 1e-4; params and batch_stats rtol 1e-3 / atol 1e-4 of each
leaf's largest entry. The stock model's JAX reference runs in f64 (its
f32 gradients on the CPU are off by up to 7%, ``test_torch_bench.py``).
"""

import functools
import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch.multiprocessing as mp
from jax.sharding import Mesh

import torch_conv_common as cc
from torch_conv_common import one_intra_op_thread  # noqa: F401
import torch_dist_worker
from horovod_tpu import optimizer as jopt
from horovod_tpu import training as jtraining
from horovod_tpu.models import resnet as jres
from horovod_tpu.runtime import AXIS

TOL = dict(rtol=1e-3, atol=1e-4, rel=True)
STEPS = 1
SMALL = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10)


def _global_batch(hw, seed):
    x, y = cc.batch(8, hw, seed=seed)
    x[4:] = 1.5 * x[4:] + 0.5        # rank 1's half: other statistics
    return x, y


def _cases():
    """name -> (JAX model builder(axis, dtype), port cfg fields, hw,
    variables' init model, f64 reference)."""
    return {
        "stock": (lambda axis, dt: jres.cifar_resnet_v1(
            20, dtype=dt, axis_name=axis),
            dict(stage_sizes=(3, 3, 3), num_classes=10, num_filters=16,
                 block="basic", cifar_stem=True), 32, True),
        "fused": (lambda axis, dt: jres.ResNet(
            block_cls=jres.BottleneckBlock, conv_backend="fused", dtype=dt,
            axis_name=axis, **SMALL),
            dict(conv_backend="fused", **SMALL), 64, False),
    }


CASES = _cases()


def _jax_steps(model, variables, x, y, f64):
    dt = np.float64 if f64 else np.float32
    dist_opt = jopt.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt),
                                    variables["params"])
    state = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=dist_opt.init(params),
        batch_stats=jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt),
                                           variables["batch_stats"]))
    mesh = Mesh(np.array(jax.devices()[:2]), (AXIS,))
    step = jtraining.make_train_step(model, dist_opt, mesh=mesh)
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, (jnp.asarray(x.astype(dt)),
                                      jnp.asarray(y)))
        losses.append(float(metrics["loss"]))
    return losses, {"params": jax.device_get(state.params),
                    "batch_stats": jax.device_get(state.batch_stats)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX world of 2 (sync and local BN) and the port's gloo world of
    2 (sync, group, local), from the same inputs."""
    inputs, jax_out = [], {}
    for name, (build, cfg, hw, f64) in CASES.items():
        variables = cc.init_variables(build(None, jnp.float32),
                                      (1, hw, hw, 3))
        x, y = _global_batch(hw, seed=5)
        inputs.append(dict(name=name, cfg=dict(cfg, dtype=None),
                           variables=variables, x=x, y=y, steps=STEPS,
                           group_too=name == "stock"))
        dt = jnp.float64 if f64 else jnp.float32
        jax_out[name] = _jax_steps(build(AXIS, dt), variables, x, y, f64)
    workdir = tmp_path_factory.mktemp("sync_bn")
    import torch
    for case in inputs:
        case["cfg"]["dtype"] = torch.float32
    with open(workdir / "sync_bn_inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(torch_dist_worker.run_sync_bn, args=(2, port, str(workdir)),
             nprocs=2, join=True)
    ranks = []
    for r in range(2):
        with open(workdir / f"sync_bn_rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return jax_out, ranks


def _close(got, want) -> bool:
    try:
        cc.assert_trees_close(got, want, **TOL)
        return True
    except AssertionError:
        return False


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("rank", [0, 1])
def test_each_rank_matches_the_jax_world(name, rank, results):
    jax_out, ranks = results
    jlosses, jvars = jax_out[name]
    got = ranks[rank][(name, "sync")]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
    cc.assert_trees_close(got["variables"]["params"], jvars["params"],
                          **TOL)
    cc.assert_trees_close(got["variables"]["batch_stats"],
                          jvars["batch_stats"], **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_running_stats_are_bitwise_equal_across_ranks(name, results):
    _, ranks = results
    a = ranks[0][(name, "sync")]["variables"]["batch_stats"]
    b = ranks[1][(name, "sync")]["variables"]["batch_stats"]
    la = jax.tree_util.tree_leaves(a)
    assert la and all(np.array_equal(u, v) for u, v in
                      zip(la, jax.tree_util.tree_leaves(b)))


def test_a_process_group_axis_is_the_world_axis(results):
    _, ranks = results
    for r in (0, 1):
        a, b = ranks[r][("stock", "sync")], ranks[r][("stock", "group")]
        assert a["losses"] == b["losses"]
        assert all(np.array_equal(u, v) for u, v in zip(
            jax.tree_util.tree_leaves(a["variables"]),
            jax.tree_util.tree_leaves(b["variables"])))


@pytest.mark.parametrize("name", sorted(CASES))
def test_local_bn_control_fails_the_comparison(name, results):
    """Local BatchNorm on the same halves: each rank's running statistics
    are its own half's (they differ between ranks and from JAX's), and
    the params after the step miss JAX's."""
    jax_out, ranks = results
    _, jvars = jax_out[name]
    for r in (0, 1):
        got = ranks[r][(name, "local")]["variables"]
        assert not _close(got["batch_stats"], jvars["batch_stats"])
        assert not _close(got["params"], jvars["params"])
    a = jax.tree_util.tree_leaves(
        ranks[0][(name, "local")]["variables"]["batch_stats"])
    b = jax.tree_util.tree_leaves(
        ranks[1][(name, "local")]["variables"]["batch_stats"])
    assert not all(np.array_equal(u, v) for u, v in zip(a, b))


def test_axis_name_is_validated():
    from horovod_tpu_torch.models import resnet as tres
    with pytest.raises(ValueError, match="axis_name must be None"):
        tres.ResNetConfig(axis_name="batch")
    with pytest.raises(ValueError, match="axis_name must be None"):
        tres.cifar_resnet_v1(20, axis_name=3, device="cpu")


def test_world_axis_before_init_raises(monkeypatch):
    """``AXIS`` is resolved from the world when the forward runs: a
    training forward with no world raises naming ``init``; eval (local
    statistics) runs."""
    import torch
    from horovod_tpu_torch import runtime
    from horovod_tpu_torch.models import resnet as tres
    assert not runtime.is_initialized()
    m = tres.cifar_resnet_v1(8, dtype=torch.float32, axis_name="hvd",
                             device="cpu")
    x = torch.zeros(2, 8, 8, 3)
    with pytest.raises(ValueError, match="init"):
        m(x, train=True)
    m(x, train=False)


def test_group_of_one_moves_nothing(monkeypatch):
    """A world of one: the cross-replica model computes the local model's
    numbers bitwise."""
    import torch
    from horovod_tpu_torch import runtime
    from horovod_tpu_torch.models import resnet as tres
    for var in ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    try:
        g = functools.partial(torch.Generator().manual_seed, 0)
        a = tres.cifar_resnet_v1(8, dtype=torch.float32, axis_name="hvd",
                                 device="cpu", generator=g())
        b = tres.cifar_resnet_v1(8, dtype=torch.float32, device="cpu",
                                 generator=g())
        x = torch.randn(4, 8, 8, 3, generator=g())
        ya, yb = a(x, True), b(x, True)
        ya.sum().backward()
        yb.sum().backward()
        assert torch.equal(ya, yb)
        assert all(torch.equal(p.grad, q.grad) for p, q in
                   zip(a.parameters(), b.parameters()))
    finally:
        runtime.shutdown()

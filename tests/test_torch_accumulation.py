"""Port parity: in-step gradient accumulation (``make_train_step(
accum_steps=)``, ``DistributedOptimizer(accum_steps=)``) and the step's
``remat`` against the JAX package, on the CPU.

* The small fused ResNet (BatchNorm statistics threaded through the
  microbatches: N momentum updates) at N = 2, 4 against the JAX step with
  the same ``accum_steps`` on a 1-device mesh, from the same variables
  and batch: loss, metric extras (a float mean and an integer count that
  keeps its sum), params and batch_stats at the training tests' f32
  tolerance (rtol 1e-3, atol 1e-4 of each leaf's largest entry:
  BatchNorm's sums in other orders).
* The f32 LM (no BatchNorm) at N = 2, 4: against the JAX step with the
  same ``accum_steps``, and against the port's own full-batch step — the
  JAX accumulation test's property and tolerance (rtol 1e-5, atol 1e-6).
* The eager divisibility error with its arithmetic, the refusal of
  ``accum_steps`` on both the step and the optimizer, the optimizer's
  ``1/N`` prescale, f32 accumulation of bf16 gradients, and ``remat``
  (the same step, BatchNorm statistics updated once).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from horovod_tpu import optimizer as jopt
from horovod_tpu import training as jtraining
from horovod_tpu.models import resnet as jres
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.parallel.mesh import create_hybrid_mesh
from horovod_tpu.runtime import AXIS
from horovod_tpu_torch import DistributedOptimizer, convert, runtime
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.parallel import transformer as ttr
from horovod_tpu_torch.training import (_acc_dtype, accuracy,
                                        create_train_state, make_train_step)

SMALL = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10)
TOL = dict(rtol=1e-3, atol=1e-4)
LM_DIMS = dict(vocab=128, d_model=256, n_heads=2, n_layers=2, d_ff=256)
SGD = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)


@pytest.fixture
def one_rank_world(monkeypatch):
    for var in ("HVD_RANK", "PMI_RANK", "OMPI_COMM_WORLD_RANK", "HVD_SIZE",
                "PMI_SIZE", "OMPI_COMM_WORLD_SIZE", "HVD_LOCAL_RANK",
                "OMPI_COMM_WORLD_LOCAL_RANK", "HVD_GUARD_NONFINITE",
                "HVD_WIRE_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    yield
    runtime.shutdown()


def _jax_model():
    return jres.ResNet(block_cls=jres.BottleneckBlock, conv_backend="fused",
                       dtype=jnp.float32, **SMALL)


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
    rng = np.random.RandomState(2)
    return (rng.standard_normal((8, 64, 64, 3)).astype(np.float32),
            rng.randint(0, 10, 8).astype(np.int64))


def _jax_metrics(logits, labels):
    return {"acc": jtraining.accuracy(logits, labels),
            "label_sum": jnp.sum(labels).astype(jnp.int32)}


def _port_metrics(logits, labels):
    return {"acc": accuracy(logits, labels),
            "label_sum": labels.sum().to(torch.int32)}


def _jax_step(variables, batch, n):
    dist_opt = jopt.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jtraining.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=dist_opt.init(params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    mesh = Mesh(np.array(jax.devices()[:1]), (AXIS,))
    step = jtraining.make_train_step(_jax_model(), dist_opt, mesh=mesh,
                                     accum_steps=n,
                                     metrics_fn=_jax_metrics)
    state, m = step(state, (jnp.asarray(batch[0]), jnp.asarray(batch[1])))
    return ({k: float(v) for k, v in m.items()},
            jax.device_get(state.params), jax.device_get(state.batch_stats))


def _assert_trees_close(got, want, rtol, atol):
    gl = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    wl = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert sorted(map(jax.tree_util.keystr, gl)) == \
        sorted(map(jax.tree_util.keystr, wl))
    for path, w in wl.items():
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            np.asarray(gl[path], np.float32), w, rtol=rtol,
            atol=atol * max(np.abs(w).max(), 1e-30),
            err_msg=jax.tree_util.keystr(path))


def _port_resnet(variables):
    return convert.resnet_from_jax(
        variables, tres.ResNetConfig(dtype=torch.float32,
                                     conv_backend="fused", **SMALL),
        device="cpu")


@pytest.mark.parametrize("n", [2, 4])
def test_resnet_accumulation_matches_jax(n, variables, batch,
                                         one_rank_world):
    jm, jparams, jstats = _jax_step(variables, batch, n)
    model = _port_resnet(variables)
    state = create_train_state(model, SGD, device="cpu")
    step = make_train_step(accum_steps=n, metrics_fn=_port_metrics)
    state, m = step(state, (torch.from_numpy(batch[0]),
                            torch.from_numpy(batch[1])))
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=1e-4)
    np.testing.assert_allclose(float(m["acc"]), jm["acc"], rtol=1e-6)
    assert float(m["label_sum"]) == jm["label_sum"] == batch[1].sum()
    out = convert.resnet_to_numpy(model)
    _assert_trees_close(out["params"], jparams, **TOL)
    # N momentum updates of the running statistics, one per microbatch.
    _assert_trees_close(out["batch_stats"], jstats, **TOL)


def _lm_batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, LM_DIMS["vocab"], (4, 128)).astype(np.int32),
            rng.randint(0, LM_DIMS["vocab"], (4, 128)).astype(np.int32))


@pytest.mark.parametrize("n", [2, 4])
def test_lm_accumulation_matches_jax_and_the_full_batch(n, one_rank_world):
    jcfg = jtr.TransformerConfig(**LM_DIMS, dtype=jnp.float32)
    tcfg = ttr.TransformerConfig(**LM_DIMS, dtype=torch.float32)
    toks, labels = _lm_batch(3)
    mesh = create_hybrid_mesh(dp=1, devices=jax.devices()[:1])
    init_state, jstep = jtr.make_parallel_train_step(
        jcfg, mesh, optax.sgd(0.5), accum_steps=n)
    params, opt_state = init_state(jax.random.PRNGKey(0))
    p0 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                jax.device_get(params))
    params, _, jloss = jstep(params, opt_state, jnp.asarray(toks),
                             jnp.asarray(labels))
    got = {}
    for k in (n, 1):
        model = convert.params_from_jax(p0, tcfg, device="cpu")
        t_init, tstep = ttr.make_parallel_train_step(
            tcfg, functools.partial(torch.optim.SGD, lr=0.5),
            accum_steps=k, device="cpu")
        state, loss = tstep(t_init(model=model), torch.from_numpy(toks),
                            torch.from_numpy(labels))
        got[k] = (float(loss), convert.params_to_numpy(model))
    np.testing.assert_allclose(got[n][0], float(jloss), rtol=1e-5)
    _assert_trees_close(got[n][1], jax.device_get(params), rtol=1e-5,
                        atol=1e-6)
    np.testing.assert_allclose(got[n][0], got[1][0], rtol=1e-5)
    _assert_trees_close(got[n][1], got[1][1], rtol=1e-5, atol=1e-6)


def test_divisibility_error_is_eager_and_names_the_arithmetic(
        variables, one_rank_world):
    state = create_train_state(_port_resnet(variables), SGD, device="cpu")
    x = torch.zeros((10, 64, 64, 3))
    y = torch.zeros((10,), dtype=torch.int64)
    with pytest.raises(ValueError, match=r"10 rows .* 4 microbatches.*"
                                         r"10 % 4 = 2"):
        make_train_step(accum_steps=4)(state, (x, y))
    assert state.step == 0 and not state.optimizer.state
    with pytest.raises(ValueError, match=">= 1"):
        make_train_step(accum_steps=0)
    with pytest.raises(ValueError, match=">= 1"):
        DistributedOptimizer(torch.optim.SGD(
            [torch.nn.Parameter(torch.zeros(2))], lr=0.1), accum_steps=0)


def test_accum_on_both_the_step_and_the_optimizer_is_refused(
        variables, batch, one_rank_world):
    model = _port_resnet(variables)
    opt = DistributedOptimizer(
        SGD([p for _, p in convert.jax_leaf_order(model)]),
        named_parameters=convert.jax_leaf_order(model), accum_steps=2)
    from horovod_tpu_torch.training import TrainState
    with pytest.raises(ValueError, match="BOTH"):
        make_train_step(accum_steps=2)(
            TrainState(model=model, optimizer=opt),
            (torch.from_numpy(batch[0]), torch.from_numpy(batch[1])))


@pytest.mark.parametrize("n", [1, 3])
def test_optimizer_accum_steps_divides_the_gradient_sum(n, one_rank_world):
    """``DistributedOptimizer(accum_steps=N)``: the caller's ``.grad`` is
    a sum of N microbatch gradients; the exchange divides it by N (and
    the world's 1/size), as JAX's ``allreduce_gradients(accum_steps=)``."""
    g = np.random.RandomState(n).randn(5).astype(np.float32)
    p = torch.nn.Parameter(torch.zeros(5))
    opt = DistributedOptimizer(torch.optim.SGD([p], lr=1.0), accum_steps=n)
    p.grad = torch.from_numpy(g * n)
    opt.step()
    mesh = Mesh(np.array(jax.devices()[:1]), (AXIS,))
    want = jax.shard_map(
        lambda t: jopt.allreduce_gradients(t, accum_steps=n), mesh=mesh,
        in_specs=jax.sharding.PartitionSpec(),
        out_specs=jax.sharding.PartitionSpec(),
        check_vma=False)({"w": jnp.asarray(g * n)})["w"]
    np.testing.assert_allclose(-p.detach().numpy(), np.asarray(want),
                               rtol=1e-6)


def test_sub_f32_gradients_accumulate_in_f32(one_rank_world):
    """bf16 parameters: each microbatch's bf16 gradient is summed in f32
    and the mean cast back once, as JAX's ``_acc_dtype`` accumulators."""
    assert _acc_dtype(torch.bfloat16) == torch.float32
    assert _acc_dtype(torch.float32) == torch.float32
    assert _acc_dtype(torch.int32) == torch.int32
    rng = np.random.RandomState(1)
    w0 = torch.from_numpy(rng.randn(6, 3).astype(np.float32))
    x = torch.from_numpy(rng.randn(8, 6).astype(np.float32))

    class Lin(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(w0.to(torch.bfloat16))

        def forward(self, x, train=True):
            return x.to(torch.bfloat16) @ self.w

    def loss_fn(out, y):
        return (out.float() ** 2).sum()
    seen = []
    model = Lin()
    state = create_train_state(model, functools.partial(
        torch.optim.SGD, lr=0.0), device="cpu")
    real = state.optimizer.synchronize

    def spy(return_finite=False):
        seen.append(model.w.grad.clone())
        return real(return_finite)
    state.optimizer.synchronize = spy
    make_train_step(loss_fn, accum_steps=4)(state, (x, torch.zeros(8)))
    acc = torch.zeros(6, 3)
    for xm in x.reshape(4, 2, 6):
        m = Lin()
        loss_fn(m(xm), None).backward()
        acc += m.w.grad.float()
    assert seen[0].dtype == torch.bfloat16
    assert torch.equal(seen[0], (acc * 0.25).to(torch.bfloat16))


def test_remat_step_equals_the_plain_step(variables, batch,
                                          one_rank_world):
    """``remat`` recomputes the forward in the backward: the same
    gradients, and BatchNorm's running statistics updated once."""
    x, y = torch.from_numpy(batch[0][:4]), torch.from_numpy(batch[1][:4])
    out = {}
    for remat in (False, True):
        model = _port_resnet(variables)
        state = create_train_state(model, SGD, device="cpu")
        state, m = make_train_step(remat=remat)(state, (x, y))
        out[remat] = (float(m["loss"]), model.state_dict())
    assert out[True][0] == out[False][0]
    for k, v in out[False][1].items():
        assert torch.equal(out[True][1][k], v), k
    with pytest.raises(ValueError, match="remat"):
        make_train_step(remat=True, _value_and_grad=lambda m, b: None)

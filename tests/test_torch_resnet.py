"""Port parity: the ResNet model against the JAX package's flax ResNet,
from the same converted variables, at f32 on the CPU.

The small model is the JAX ``ResNet(stage_sizes=(1, 1), block_cls=
BottleneckBlock, num_filters=8, num_classes=10, dtype=float32)``: at batch
4 and 64² both stages take the fused branch (stage-0 M = 1024, stage-1
M = 256 after the stride), so the port's plain fused-kernel versions run
against the Pallas kernels in interpret mode. Every parameter and running
statistic is randomized first (flax zero-initializes each block's last
BatchNorm scale, which would make most gradients zero).

Tolerances (f32, sums in other orders through ~10 BatchNorms): logits
and loss rtol 1e-4 / atol 1e-5; batch_stats rtol 1e-4 / atol 1e-6;
gradients rtol 2e-3 / atol 1e-4 of each leaf's largest entry (a sum
that cancels to ~0 keeps ~1e-7 of noise).
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import resnet as jres
from horovod_tpu.ops import pallas_conv
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import resnet as tres

SMALL = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10)


def _jax_model(backend):
    return jres.ResNet(block_cls=jres.BottleneckBlock, conv_backend=backend,
                       dtype=jnp.float32, **SMALL)


def _port_cfg(backend):
    return tres.ResNetConfig(dtype=torch.float32, conv_backend=backend,
                             **SMALL)


@pytest.fixture(scope="module")
def variables():
    """Randomized flax variables of the small model (numpy, f32)."""
    v = jax.jit(_jax_model("xla").init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
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
    return jax.tree_util.tree_map_with_path(perturb, jax.device_get(v))


def _batch(n, hw, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
            rng.randint(0, 10, n))


def _jax_train(backend, variables, x, y):
    model = _jax_model(backend)

    def loss_fn(params, stats, x, y):
        logits, new = model.apply({"params": params, "batch_stats": stats},
                                  x, train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        loss = -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1))
        return loss, (logits, new["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"], jnp.asarray(x),
                                jnp.asarray(y))
    return (float(loss), np.asarray(logits), jax.device_get(stats),
            jax.device_get(grads))


def _port_train(backend, variables, x, y):
    model = convert.resnet_from_jax(variables, _port_cfg(backend),
                                    device="cpu")
    logits = model(torch.tensor(x), train=True)
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(y))
    loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        path = tuple(name.split("."))
        g = p.grad.numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    return (loss.item(), logits.detach().numpy(),
            convert.resnet_to_numpy(model)["batch_stats"], grads, model)


def _assert_trees_close(got, want, rtol, atol, rel=False):
    gl = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    wl = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert sorted(map(jax.tree_util.keystr, gl)) == \
        sorted(map(jax.tree_util.keystr, wl))
    for path, w in wl.items():
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-30) if rel else 1.0
        np.testing.assert_allclose(np.asarray(gl[path]), w, rtol=rtol,
                                   atol=atol * scale,
                                   err_msg=jax.tree_util.keystr(path))


class _Count:
    """Counts calls of the fused op on either side: one per conv site (the
    JAX side counts while its jitted step is traced)."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_train_forward_grads_and_batch_stats_match_flax(backend, variables,
                                                        monkeypatch):
    x, y = _batch(4, 64)
    jc = _Count(pallas_conv.fused_linear_bn_act)
    tc = _Count(tres.fused_linear_bn_act)
    monkeypatch.setattr(pallas_conv, "fused_linear_bn_act", jc)
    monkeypatch.setattr(tres, "fused_linear_bn_act", tc)
    jloss, jlogits, jstats, jgrads = _jax_train(backend, variables, x, y)
    tloss, tlogits, tstats, tgrads, _ = _port_train(backend, variables, x, y)
    # Both stages fuse: reduce, expand and shortcut in each block.
    assert jc.n == tc.n == (6 if backend == "fused" else 0)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    _assert_trees_close(tstats, jstats, rtol=1e-4, atol=1e-6)
    _assert_trees_close(tgrads, jgrads, rtol=2e-3, atol=1e-4, rel=True)


def test_stage_whose_rows_fail_the_gate_falls_back_where_jax_does(
        variables, monkeypatch):
    """Batch 4 at 32²: stage 0 has M = 256 (fuses), stage 1 M/4 = 64 (the
    JAX rule sends it to the stock branch, and so does the port)."""
    x, y = _batch(4, 32, seed=2)
    jc = _Count(pallas_conv.fused_linear_bn_act)
    tc = _Count(tres.fused_linear_bn_act)
    monkeypatch.setattr(pallas_conv, "fused_linear_bn_act", jc)
    monkeypatch.setattr(tres, "fused_linear_bn_act", tc)
    jloss, jlogits, jstats, jgrads = _jax_train("fused", variables, x, y)
    tloss, tlogits, tstats, tgrads, model = _port_train("fused", variables,
                                                        x, y)
    assert jc.n == tc.n == 3
    blk0, blk1 = (getattr(model, n) for n in model.block_names)
    assert blk0.takes_fused_branch(torch.zeros(4, 8, 8, 8), True)
    assert not blk1.takes_fused_branch(torch.zeros(4, 8, 8, 32), True)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    _assert_trees_close(tstats, jstats, rtol=1e-4, atol=1e-6)
    _assert_trees_close(tgrads, jgrads, rtol=2e-3, atol=1e-4, rel=True)


def test_eval_uses_running_stats_and_the_stock_branch(variables,
                                                      monkeypatch):
    x, y = _batch(4, 64, seed=3)
    jlogits = jax.jit(functools.partial(_jax_model("fused").apply,
                                        train=False))(variables,
                                                      jnp.asarray(x))
    tc = _Count(tres.fused_linear_bn_act)
    monkeypatch.setattr(tres, "fused_linear_bn_act", tc)
    model = convert.resnet_from_jax(variables, _port_cfg("fused"),
                                    device="cpu")
    before = convert.resnet_to_numpy(model)["batch_stats"]
    with torch.no_grad():
        tlogits = model(torch.tensor(x), train=False)
    assert tc.n == 0
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    # eval leaves the running statistics as they were
    _assert_trees_close(convert.resnet_to_numpy(model)["batch_stats"],
                        before, rtol=0, atol=0)


@pytest.mark.parametrize("size", [8, 9])
def test_same_padding_of_the_strided_conv_and_pool(size):
    """flax SAME pads a stride-2 3x3 window (0, 1) on an even input and
    (1, 1) on an odd one; torch's ``padding=1`` is (1, 1) always — same
    output shape, other windows. The max-pool pads with -inf."""
    for s in (1, 2):
        assert tres.same_pads(size, 3, s) == tuple(
            jax.lax.padtype_to_pads((size,), (3,), (s,), "SAME")[0])
    rng = np.random.RandomState(size)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    conv = nn.Conv(6, (3, 3), (2, 2), padding="SAME", use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(v, jnp.asarray(x)))
    port = tres.Conv(4, 6, 3, "cpu")
    with torch.no_grad():
        port.kernel.copy_(torch.tensor(np.asarray(
            v["params"]["kernel"]).transpose(3, 2, 0, 1)))
        pads = (tres.same_pads(size, 3, 2),) * 2
        got = port(torch.tensor(x), 2, pads).numpy()
        naive = port(torch.tensor(x), 2, ((1, 1), (1, 1))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert naive.shape == got.shape
    if size % 2 == 0:
        assert not np.allclose(naive, want, atol=1e-3)
    pool = np.asarray(nn.max_pool(jnp.asarray(-np.abs(x)), (3, 3),
                                  strides=(2, 2), padding="SAME"))
    (pt, pb), (pl, pr) = tres.same_pads(size, 3, 2), tres.same_pads(size,
                                                                      3, 2)
    xt = torch.nn.functional.pad(torch.tensor(-np.abs(x)).permute(0, 3, 1, 2),
                                 (pl, pr, pt, pb), value=float("-inf"))
    got_pool = torch.nn.functional.max_pool2d(xt, 3, 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got_pool.numpy(), pool)


def test_resnet50_variable_tree_and_leaf_order_match_flax():
    shapes = jax.eval_shape(
        functools.partial(jres.resnet50(num_classes=1000).init,
                          train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    model = tres.resnet50(device="cpu", conv_backend="fused")
    ours = convert.resnet_to_numpy(model)
    for coll in ("params", "batch_stats"):
        want = dict(jax.tree_util.tree_flatten_with_path(shapes[coll])[0])
        got = dict(jax.tree_util.tree_flatten_with_path(ours[coll])[0])
        assert list(map(jax.tree_util.keystr, got)) == \
            list(map(jax.tree_util.keystr, want))
        for path, leaf in want.items():
            assert got[path].shape == leaf.shape, jax.tree_util.keystr(path)
    flax_order = [".".join(k.key for k in path) for path, _ in
                  jax.tree_util.tree_flatten_with_path(shapes["params"])[0]]
    assert [n for n, _ in convert.jax_leaf_order(model)] == flax_order
    assert flax_order.index("BottleneckBlock_10.BatchNorm_0.bias") < \
        flax_order.index("BottleneckBlock_2.BatchNorm_0.bias")
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(int(np.prod(x.shape)) for x in
                           jax.tree_util.tree_leaves(shapes["params"]))


def test_converter_round_trip_and_refusals(variables):
    model = convert.resnet_from_jax(variables, _port_cfg("fused"),
                                    device="cpu")
    back = convert.resnet_to_numpy(model)
    _assert_trees_close(back, {k: variables[k] for k in ("params",
                                                         "batch_stats")},
                        rtol=0, atol=0)
    bad = jax.tree_util.tree_map(lambda a: a, variables)
    bad["params"]["head"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="head.kernel"):
        convert.resnet_from_jax(bad, _port_cfg("fused"), device="cpu")

"""Shared helpers of the conv-family parity tests (test_torch_resnet_family,
test_torch_vgg, test_torch_inception, test_torch_sync_bn): randomized flax
variables, one flax train step and one port train step from the same
variables, and tree comparisons in flax's layout.

Tolerances (f32, ``test_torch_resnet.py``'s): logits and loss rtol 1e-4 /
atol 1e-5; batch_stats rtol 1e-4 / atol 1e-6; gradients rtol 2e-3 /
atol 1e-4 of each leaf's largest entry.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch import convert

LOGITS_TOL = dict(rtol=1e-4, atol=1e-5)
STATS_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=2e-3, atol=1e-4, rel=True)


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread, the count given back after: the
    suite runs files side by side, and on an oversubscribed CPU torch's
    many small parallel regions run ten to thirty times slower than on
    one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """:func:`one_thread` over a test module that imports this fixture."""
    with one_thread():
        yield


def perturb(variables, seed: int = 0, keep=None):
    """Every BatchNorm scale, bias and running statistic, and every conv
    or dense bias, randomized (flax zero-initializes biases and some BN
    scales, which would hide their paths); kernels kept, and the leaves
    whose keystr ``keep`` accepts. numpy, f32."""
    rng = np.random.RandomState(seed)

    def one(path, leaf):
        name = jax.tree_util.keystr(path)
        a = np.asarray(leaf, np.float32)
        r = rng.randn(*a.shape)     # one draw per leaf, kept or not
        if keep is not None and keep(name):
            return a
        if "scale" in name:
            return (1.0 + 0.2 * r).astype(np.float32)
        if "bias" in name or "mean" in name:
            return (0.1 * r).astype(np.float32)
        if "var" in name:
            return (0.5 + np.abs(r) % 1.0).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(one, jax.device_get(variables))


def init_variables(model, shape, seed: int = 0, keep=None):
    """flax ``model.init`` at an f32 input of ``shape``, perturbed."""
    v = jax.jit(model.init)(jax.random.PRNGKey(seed),
                            jnp.zeros(shape, jnp.float32))
    return perturb(v, seed, keep)


def batch(n: int, hw: int, classes: int = 10, seed: int = 1):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((n, hw, hw, 3)).astype(np.float32),
            rng.randint(0, classes, n))


def jax_train(model, variables, x, y, grad_model=None):
    """One training forward + backward of mean cross entropy in flax:
    ``(loss, logits, new batch_stats, grads)`` as numpy; the gradients
    from ``grad_model`` (the same network in f64) when given: XLA's f32
    gradients of a deep CIFAR ResNet on the CPU are off their f64 values
    by up to 7%, the port's f32 ones by ~1e-6 (``test_torch_bench.py``)."""
    has_stats = "batch_stats" in variables

    def loss_fn(params, stats, x, y):
        v = {"params": params}
        if has_stats:
            v["batch_stats"] = stats
        logits, new = model.apply(v, x, train=True,
                                  mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        loss = -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1))
        return loss, (logits, new.get("batch_stats", {}))

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables.get("batch_stats", {}),
                                jnp.asarray(x), jnp.asarray(y))
    if grad_model is not None:
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        grads = jax_train(grad_model, v64, x.astype(np.float64), y)[3]
    return (float(loss), np.asarray(logits), jax.device_get(stats),
            jax.device_get(grads))


def jax_eval(model, variables, x):
    return np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))


def grads_tree(model: torch.nn.Module) -> dict:
    """The port's ``.grad`` of every parameter as a flax-layout tree."""
    out: dict = {}
    for name, p in model.named_parameters():
        path = tuple(name.split("."))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = convert._to_flax(path, p.grad.numpy())
    return out


def port_train(model: torch.nn.Module, x, y):
    """One training forward + backward of the port's model:
    ``(loss, logits, batch_stats, grads)`` in flax's layout."""
    logits = model(torch.tensor(x), train=True)
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(y).long())
    loss.backward()
    return (loss.item(), logits.detach().numpy(),
            convert.conv_to_numpy(model)["batch_stats"], grads_tree(model))


def assert_trees_close(got, want, rtol, atol, rel=False):
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


def assert_step_matches(jax_out, port_out):
    jloss, jlogits, jstats, jgrads = jax_out
    tloss, tlogits, tstats, tgrads = port_out
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    np.testing.assert_allclose(tlogits, jlogits, **LOGITS_TOL)
    assert_trees_close(tstats, jstats, **STATS_TOL)
    assert_trees_close(tgrads, jgrads, **GRAD_TOL)


def leaf_order_matches(model: torch.nn.Module, variables) -> bool:
    """``convert.jax_leaf_order`` walks the params in JAX's tree-flatten
    order (the bucket plan's order)."""
    want = [".".join(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(variables["params"])[0]]
    return [n for n, _ in convert.jax_leaf_order(model)] == want


def roundtrip_equal(model: torch.nn.Module, variables) -> bool:
    """``conv_to_numpy`` gives back exactly the variables loaded."""
    back = convert.conv_to_numpy(model)
    got = dict(jax.tree_util.tree_flatten_with_path(
        {k: back[k] for k in variables})[0])
    want = dict(jax.tree_util.tree_flatten_with_path(
        {k: variables[k] for k in variables})[0])
    return (sorted(map(jax.tree_util.keystr, got))
            == sorted(map(jax.tree_util.keystr, want))
            and all(np.array_equal(got[k], np.asarray(want[k], np.float32))
                    for k in want))

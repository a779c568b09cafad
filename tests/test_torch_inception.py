"""Port parity: ``models.inception`` against the JAX package's flax
Inception V3, from the same converted variables, on the CPU: eval (f32)
and a train step (dropout off) at 96², the converter both ways over every
one of its 94 convs (a missing, extra or misshapen leaf raises), flax's
auto-names in the nested scopes, the ε = 1e-3 BatchNorm, the
``count_include_pad`` average pool, and the dropout generator. Tolerances:
``torch_conv_common`` (test_torch_resnet.py's).

The train step runs in f64 on both sides (flax's model at ``dtype=
float64``, the port's cast with ``.double()``; both heads stay f32, as
flax's does). In f32, batch statistics through 94 randomized
BatchNorms put any two summation orders ~1e-4 apart in the logits, the
port and XLA both far from the f64 values at 96² (logits 1.2e-3 and
5.4e-3 off) and still 4.5e-5 apart at 299²: the tolerance then measures
the orders, not the port. In f64 the two agree to 7e-7 (the f32 head's
rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_conv_common as cc
from torch_conv_common import one_intra_op_thread  # noqa: F401
from horovod_tpu.models import inception as jinc
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import inception as tinc

HW = 96


def _jax(rate=0.0):
    return jinc.InceptionV3(num_classes=10, dtype=jnp.float32,
                            dropout_rate=rate)


def _port(rate=0.0, seed=0):
    return tinc.InceptionV3(10, dtype=torch.float32, dropout_rate=rate,
                            dropout_seed=seed, device="cpu")


@pytest.fixture(scope="module")
def variables():
    return cc.init_variables(_jax(), (1, HW, HW, 3))


def test_train_step_matches_flax(variables):
    x, y = cc.batch(4, HW, seed=2)
    v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                 variables)
    jm = jinc.InceptionV3(num_classes=10, dtype=jnp.float64,
                          dropout_rate=0.0)
    port = tinc.InceptionV3(10, dtype=torch.float64, dropout_rate=0.0,
                            device="cpu")
    cc.assert_step_matches(
        cc.jax_train(jm, v64, x.astype(np.float64), y),
        cc.port_train(convert.conv_from_jax(variables, port).double(),
                      x.astype(np.float64), y))


def test_eval_matches_flax(variables):
    x, _ = cc.batch(2, HW, seed=3)
    model = convert.conv_from_jax(variables, _port(rate=0.2))
    with torch.no_grad():
        got = model(torch.tensor(x), train=False).numpy()
    np.testing.assert_allclose(got, cc.jax_eval(_jax(0.2), variables, x),
                               **cc.LOGITS_TOL)


def test_converter_round_trip_names_and_leaf_order(variables):
    model = convert.conv_from_jax(variables, _port())
    assert cc.roundtrip_equal(model, variables)
    assert cc.leaf_order_matches(model, variables)
    p = variables["params"]
    convs = [k for k, _ in jax.tree_util.tree_flatten_with_path(p)[0]
             if k[-2].key == "Conv_0"]
    assert len(convs) == 94
    assert sorted(p) == sorted(
        [f"ConvBN_{i}" for i in range(5)]
        + [f"InceptionA_{i}" for i in range(3)] + ["ReductionA_0"]
        + [f"InceptionB_{i}" for i in range(4)] + ["ReductionB_0"]
        + [f"InceptionC_{i}" for i in range(2)] + ["head"])
    assert sorted(p["InceptionC_0"]) == sorted(f"ConvBN_{i}"
                                               for i in range(9))
    # InceptionC's split convs are ConvBN_2/3 (1x3, 3x1) and 6/7.
    for i, k in ((2, (1, 3)), (3, (3, 1)), (6, (1, 3)), (7, (3, 1))):
        assert p["InceptionC_0"][f"ConvBN_{i}"]["Conv_0"]["kernel"].shape[
            :2] == k
    assert model.InceptionB_0.ConvBN_0.BatchNorm_0.epsilon == 1e-3


@pytest.mark.parametrize("mutate,needle", [
    (lambda v: v["params"]["InceptionB_2"]["ConvBN_7"].pop("Conv_0"),
     "lack"),
    (lambda v: v["batch_stats"]["InceptionC_1"]["ConvBN_8"].update(
        extra={"mean": np.zeros(3, np.float32)}), "no counterpart"),
    (lambda v: v["params"]["InceptionA_1"]["ConvBN_5"]["Conv_0"].update(
        kernel=np.zeros((3, 3, 96, 95), np.float32)), "shape"),
])
def test_converter_refuses_missing_extra_and_misshapen(mutate, needle,
                                                       variables):
    v = jax.tree_util.tree_map(lambda a: a, variables)
    mutate(v)
    with pytest.raises(ValueError, match=needle):
        convert.conv_from_jax(v, _port())


def test_avg_pool_counts_the_padding():
    """flax's SAME 3x3 average pool divides every window by 9, the
    padded zeros included; its gradient is flax's (f64)."""
    x = np.ones((1, 4, 5, 2), np.float32)
    import flax.linen as nn
    want = np.asarray(nn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1),
                                  padding="SAME"))
    got = tinc.avg_pool_3x3_same(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0, 0, 0, 0] == pytest.approx(4 / 9)
    # Its gradient is flax's too.
    rng = np.random.RandomState(0)
    x, w = rng.randn(2, 5, 6, 3), rng.randn(2, 5, 6, 3)
    want = jax.grad(lambda v: jnp.sum(w * nn.avg_pool(
        v, (3, 3), strides=(1, 1), padding="SAME")))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (torch.tensor(w) * tinc.avg_pool_3x3_same(xt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                               rtol=1e-12)


def test_head_dropout_is_seeded_and_off_in_eval(variables):
    x, _ = cc.batch(2, HW, seed=4)

    def run(seed):
        m = convert.conv_from_jax(variables, _port(rate=0.2, seed=seed))
        with torch.no_grad():
            return m(torch.tensor(x), train=True)
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)

"""Port parity: ``models.vgg`` against the JAX package's flax VGG, from the
same converted variables, at f32 on the CPU: eval and train (dropout
off) at 32² with narrow ``dense_features`` for depths 11 and 16, the
converter both ways (a missing, extra or misshapen leaf raises), the
flatten order of ``fc6``'s rows, the depth validation with JAX's text,
and the dropout generator (a seed gives the same mask; the keep rate is
honoured). Tolerances: ``torch_conv_common`` (test_torch_resnet.py's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_conv_common as cc
from torch_conv_common import one_intra_op_thread  # noqa: F401
from horovod_tpu.models import vgg as jvgg
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import vgg as tvgg
from horovod_tpu_torch.models.resnet import Dropout

HW = 32
NARROW = dict(num_classes=10, dense_features=(32, 24))


def _jax(depth, rate=0.0):
    return jvgg.VGG(depth=depth, dtype=jnp.float32, dropout_rate=rate,
                    **NARROW)


def _port(depth, rate=0.0, **kw):
    return tvgg.VGG(depth, dtype=torch.float32, dropout_rate=rate,
                    image_size=HW, device="cpu", **dict(NARROW, **kw))


@pytest.fixture(scope="module")
def variables():
    return {d: cc.init_variables(_jax(d), (1, HW, HW, 3)) for d in (11, 16)}


@pytest.mark.parametrize("depth", [11, 16])
def test_train_step_matches_flax(depth, variables):
    x, y = cc.batch(3, HW, seed=2)
    model = convert.conv_from_jax(variables[depth], _port(depth))
    cc.assert_step_matches(cc.jax_train(_jax(depth), variables[depth], x, y),
                           cc.port_train(model, x, y))


@pytest.mark.parametrize("depth", [11, 16])
def test_eval_matches_flax(depth, variables):
    """Eval at JAX's default dropout rate: dropout is off in eval."""
    x, _ = cc.batch(3, HW, seed=3)
    model = convert.conv_from_jax(variables[depth], _port(depth, rate=0.5))
    with torch.no_grad():
        got = model(torch.tensor(x), train=False).numpy()
    np.testing.assert_allclose(
        got, cc.jax_eval(_jax(depth, 0.5), variables[depth], x),
        **cc.LOGITS_TOL)


@pytest.mark.parametrize("depth", [11, 16])
def test_converter_round_trip_and_leaf_order(depth, variables):
    model = convert.conv_from_jax(variables[depth], _port(depth))
    assert cc.roundtrip_equal(model, variables[depth])
    assert cc.leaf_order_matches(model, variables[depth])
    assert convert.conv_to_numpy(model)["batch_stats"] == {}


def test_fc6_rows_are_flax_nhwc_flatten(variables):
    """At 64² the last map is 2x2x512: ``fc6.kernel``'s rows follow
    (h, w, c). A map whose one (h, w, c) entry is set picks exactly the
    row flax's reshape puts it on."""
    p = convert.conv_from_jax(
        cc.init_variables(_jax(11), (1, 64, 64, 3)), tvgg.VGG(
            11, dtype=torch.float32, dropout_rate=0.0, image_size=64,
            device="cpu", **NARROW))
    assert p.fc6.kernel.shape == (2 * 2 * 512, 32)
    fmap = np.zeros((1, 2, 2, 512), np.float32)
    fmap[0, 1, 0, 7] = 1.0
    row = fmap.reshape(1, -1).argmax()
    assert row == (1 * 2 + 0) * 512 + 7
    got = torch.tensor(fmap).reshape(1, -1) @ p.fc6.kernel
    assert torch.equal(got[0], p.fc6.kernel[row])


@pytest.mark.parametrize("mutate,needle", [
    (lambda v: v["params"].pop("conv1_1"), "lack"),
    (lambda v: v["params"].update(extra={"kernel": np.zeros((3, 3))}),
     "no counterpart"),
    (lambda v: v["params"]["fc7"].update(
        kernel=np.zeros((33, 24), np.float32)), "shape"),
])
def test_converter_refuses_missing_extra_and_misshapen(mutate, needle,
                                                       variables):
    v = {"params": {k: dict(d) for k, d in
                    variables[11]["params"].items()}}
    mutate(v)
    with pytest.raises(ValueError, match=needle):
        convert.conv_from_jax(v, _port(11))


@pytest.mark.parametrize("depth", [10, 17])
def test_depth_validation_uses_jax_text(depth):
    with pytest.raises(ValueError) as jerr:
        jvgg.VGG(depth=depth).init(
            __import__("jax").random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    with pytest.raises(ValueError) as terr:
        tvgg.VGG(depth, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_dropout_generator_is_seeded_and_keeps_its_rate():
    x = torch.ones(200, 500)
    a, b = Dropout(0.5, 7, "cpu"), Dropout(0.5, 7, "cpu")
    ya, yb = a(x, True), b(x, True)
    assert torch.equal(ya, yb)
    assert not torch.equal(ya, a(x, True))       # the stream advances
    assert not torch.equal(ya, Dropout(0.5, 8, "cpu")(x, True))
    kept = (ya != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.01
    assert torch.all((ya == 0) | (ya == 2.0))    # kept entries x / keep
    y2 = Dropout(0.2, 1, "cpu")(x, True)
    assert abs((y2 != 0).float().mean().item() - 0.8) < 0.01
    assert torch.equal(a(x, False), x)           # eval: identity
    # The global RNG is never drawn.
    state = torch.random.get_rng_state()
    Dropout(0.5, 3, "cpu")(x, True)
    assert torch.equal(state, torch.random.get_rng_state())


def test_train_with_dropout_differs_from_eval_and_repeats_by_seed(
        variables):
    x, _ = cc.batch(2, HW, seed=5)

    def run(seed):
        m = convert.conv_from_jax(variables[11],
                                  _port(11, rate=0.5, dropout_seed=seed))
        with torch.no_grad():
            return m(torch.tensor(x), train=True), m(torch.tensor(x),
                                                     train=False)
    (t1, e1), (t2, _), (t3, _) = run(0), run(0), run(1)
    assert torch.equal(t1, t2) and not torch.equal(t1, t3)
    assert not torch.allclose(t1, e1)

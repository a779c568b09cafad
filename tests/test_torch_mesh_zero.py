"""Port parity: ZeRO-1 and overlap on the hybrid mesh (the four-axis LM
step and the core stack with ``DistributedOptimizer(mesh=, zero=,
overlap=)``) against the JAX package, on the CPU, in one gloo world of
4 (``torch_mesh_worker``).

At ``tests/test_hybrid.py``'s size (vocab 64, d_model 32, 4 heads, 2
layers, d_ff 64, f32; the global batch 8 × 16 tokens):

* the four-axis step with ``zero=True`` on dp2×tp2, two momentum-SGD
  steps from JAX's weights, against JAX's ``make_parallel_train_step(
  zero=True)`` (losses rtol 1e-5, params rtol 2e-4 / atol 1e-6: tp
  reassociates the matmul reductions, ``test_hybrid.py``'s
  ``TestDpTpParity``) and against the port's ``zero=False`` step (the
  same); with ``accum_steps=2`` against 1 (rtol 1e-4 / atol 1e-6);
  with ``overlap=True`` bitwise the plain step on either plane (the
  spec-grouped all-reduce keeps its membership, as PR 10 pinned at
  worlds 1 and 2; so does the ZeRO plane);
* the guard on the hybrid ZeRO plane: a NaN in one tp rank's gradient of
  a tp-sharded leaf skips the step on every rank, state bit-unchanged
  (``TestGuardThroughParallelStep``, zero);
* the core stack on ``TpMLP`` (Adam(1e-2), three batches of 16 rows):
  dp2×tp2 with ``zero=True`` against dp4 and against JAX's dp2×tp2
  (loss rtol 1e-5, params rtol 2e-4 / atol 1e-6;
  ``test_flax_core_hybrid_matches_pure_dp``); ``wire_dtype="bf16"``
  with ``overlap=True`` on the hybrid ZeRO plane against the fp32 run
  and against JAX's bf16 wire with overlap (loss rtol 5e-3, params rtol
  5e-2 / atol 4e-2; ``test_wire_overlap_compose_on_hybrid``: JAX's probe
  reads ``jax.core.Var``, pointed at ``jax.extend.core.Var`` here as
  ``tests/test_torch_overlap.py`` does);
* the state a rank holds (``TestZeroSharding``): a tp-sharded bucket
  1/(dp·tp) of its global elements, a replicated one 1/dp.

Every rank reports the same losses and global parameters bit for bit.
"""

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_mesh_worker
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.parallel.mesh import create_hybrid_mesh as jmesh
from test_torch_mesh_step import _assert_tree, _leaves

DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
B, T, LR, STEPS = 8, 16, 0.1, 2
LOSS_RTOL = 1e-5
RTOL, ATOL = 2e-4, 1e-6
WIRE = dict(loss_rtol=5e-3, rtol=5e-2, atol=4e-2)


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  jax.device_get(tree))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, DIMS["vocab"], (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jax_lm_zero():
    cfg = jtr.TransformerConfig(**DIMS, dtype=jnp.float32,
                                unembed_dtype=jnp.float32,
                                attn_backend="xla")
    mesh = jmesh(dp=2, tp=2, devices=jax.devices()[:4])
    init_state, step = jtr.make_parallel_train_step(
        cfg, mesh, optax.sgd(LR, momentum=0.9), zero=True)
    params, opt_state = init_state(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    tree0 = _f32(params)
    tokens, labels = _batch()
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(tokens),
                                       jnp.asarray(labels))
        losses.append(float(loss))
    return tree0, _f32(params), losses


def _mlp_batches():
    from test_hybrid import _mlp_batch
    return [_mlp_batch(seed=i) for i in range(3)]


def _jax_mlp(**kw):
    import horovod_tpu as jhvd
    from horovod_tpu import training as jtraining
    from test_hybrid import TpMLP, _mlp_specs
    jhvd.init()
    mesh = jmesh(dp=2, tp=2, devices=jax.devices()[:4])
    state, dist_opt = jtraining.create_train_state(
        TpMLP(), jax.random.PRNGKey(0), jnp.zeros((2, 8)),
        optax.adam(1e-2), mesh=mesh, param_specs=_mlp_specs(mesh),
        zero=True, **kw)
    step = jtraining.make_train_step(TpMLP(), dist_opt, donate=False)
    tree0 = _f32(state.params)
    losses = []
    for b in _mlp_batches():
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return tree0, _f32(state.params), losses


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.core, "Var", jax.extend.core.Var, raising=False)
    try:
        lm0, lm_want, lm_losses = _jax_lm_zero()
        mlp0, mlp_want, mlp_losses = _jax_mlp()
        _, wire_want, wire_losses = _jax_mlp(wire_dtype="bf16",
                                             overlap=True)
    finally:
        mp.undo()
    tokens, labels = _batch()
    dp2tp2 = dict(dp=2, pp=1, tp=2)
    lm = dict(kind="step", mesh=dp2tp2, dims=DIMS, lr=LR, momentum=0.9,
              steps=STEPS, tree=lm0, tokens=tokens, labels=labels)
    batches = _mlp_batches()
    mlp = dict(kind="mlp", tree=mlp0, batches=batches)
    cases = {
        "zero": dict(lm, zero=True),
        "plain": dict(lm),
        "zero_accum2": dict(lm, zero=True, accum=2),
        "overlap": dict(lm, overlap=True),
        "zero_overlap": dict(lm, zero=True, overlap=True),
        "guard": dict(kind="guard", mesh=dp2tp2, dims=DIMS, tree=lm0,
                      tokens=tokens, labels=labels, zero=True),
        "mlp_dp2tp2": dict(mlp, mesh=dp2tp2, zero=True),
        "mlp_dp4": dict(mlp, mesh=dict(dp=4), zero=True),
        "mlp_wire": dict(mlp, mesh=dp2tp2, zero=True, wire="bf16",
                         overlap=True),
    }
    got = torch_mesh_worker.spawn(4, list(cases.values()),
                                  tmp_path_factory.mktemp("mesh_zero4"))
    out = dict(zip(cases, got))
    out["jax"] = dict(lm=(lm_want, lm_losses), mlp=(mlp_want, mlp_losses),
                      wire=(wire_want, wire_losses))
    return out


def _same_on_every_rank(ranks, key="params"):
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        _assert_tree(r[key], ranks[0][key], rtol=0, atol=0)


def _bitwise(a, b):
    assert a["losses"] == b["losses"]
    _assert_tree(a["params"], b["params"], rtol=0, atol=0)


def test_four_axis_zero_matches_jax_and_plain(world4):
    want, losses = world4["jax"]["lm"]
    zero, plain = world4["zero"], world4["plain"]
    _same_on_every_rank(zero)
    np.testing.assert_allclose(zero[0]["losses"], losses, rtol=LOSS_RTOL)
    _assert_tree(zero[0]["params"], want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(zero[0]["losses"], plain[0]["losses"],
                               rtol=LOSS_RTOL)
    _assert_tree(zero[0]["params"], plain[0]["params"], rtol=RTOL,
                 atol=ATOL)
    rep = zero[0]["zero"]
    assert rep["nonscatter"] == (("pp", 1), ("tp", 2))
    assert sorted(set(rep["shard_axes"])) == [(), ("tp",)]


def test_four_axis_zero_accum2_matches_accum1(world4):
    one, two = world4["zero"], world4["zero_accum2"]
    _same_on_every_rank(two)
    np.testing.assert_allclose(two[0]["losses"], one[0]["losses"],
                               rtol=1e-5)
    _assert_tree(two[0]["params"], one[0]["params"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("plane,base", [("overlap", "plain"),
                                        ("zero_overlap", "zero")])
def test_overlap_is_bitwise_the_plain_step(world4, plane, base):
    """Overlap keeps each plane's bucket membership and only reorders
    emission, in the order rank 0 probed (broadcast over the world)."""
    for r, b in zip(world4[plane], world4[base]):
        _bitwise(r, b)
        assert r["order"] == "probed"


def test_guard_on_hybrid_zero_skips_every_rank(world4):
    for r in world4["guard"]:
        assert r["same"] and r["skipped_loss"] == 0.0
        assert r["changed"] and np.isfinite(r["next_loss"])


def test_core_stack_hybrid_zero_matches_dp4_and_jax(world4):
    want, losses = world4["jax"]["mlp"]
    hyb, dp4 = world4["mlp_dp2tp2"], world4["mlp_dp4"]
    _same_on_every_rank(hyb)
    _same_on_every_rank(dp4)
    np.testing.assert_allclose(hyb[0]["losses"], dp4[0]["losses"],
                               rtol=LOSS_RTOL)
    _assert_tree(hyb[0]["params"], dp4[0]["params"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(hyb[0]["losses"], losses, rtol=LOSS_RTOL)
    _assert_tree(hyb[0]["params"], want, rtol=RTOL, atol=ATOL)


def test_wire_overlap_compose_on_hybrid(world4):
    base = world4["mlp_dp2tp2"][0]
    wire = world4["mlp_wire"]
    _same_on_every_rank(wire)
    for ref_losses, ref_params in (
            (base["losses"], base["params"]),
            (world4["jax"]["wire"][1], world4["jax"]["wire"][0])):
        np.testing.assert_allclose(wire[0]["losses"], ref_losses,
                                   rtol=WIRE["loss_rtol"])
        _assert_tree(wire[0]["params"], ref_params, rtol=WIRE["rtol"],
                     atol=WIRE["atol"])
    assert wire[0]["order"] == "probed"


def test_state_elements_per_rank(world4):
    dp, tp = 2, 2
    for r in world4["mlp_dp2tp2"]:
        rep = r["zero"]
        assert sorted(rep["shard_axes"]) == [(), ("tp",)]
        for axes, n, canon in zip(rep["shard_axes"], rep["state_elems"],
                                  rep["canonical_sizes"]):
            if axes:
                assert n * dp * tp == canon      # 1/(dp·tp) of the global
            else:
                assert n * dp == canon           # 1/dp, replicated over tp
    glob = {k: v.size for k, v in _leaves(world4["mlp_dp2tp2"][0]["params"])}
    assert sum(glob.values()) == sum(world4["mlp_dp2tp2"][0]["zero"][
        "canonical_sizes"])

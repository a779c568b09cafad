"""Port parity: the hybrid ZeRO plan (``ops.fusion.plan_zero`` with a
non-scatter axis, ``ZeroPlan``'s hybrid fields, ``zero_stack_global``/
``zero_unstack_global``) against the JAX package's, on the host (no
collective).

* ``plan_zero`` of the tiny LM's leaves (``tests/test_hybrid.py``'s
  ``CFG``: vocab 64, d_model 32, 4 heads, 2 layers, d_ff 64, f32) on
  dp2×tp2, dp4×tp2 and dp2×tp4, and of the pipelined layout's leaves on
  dp2×pp2×tp2 with ``skip_axes`` ``()`` and ``("pp",)``, at the default
  threshold and at one small enough to split the groups: every field,
  ``shard_shapes()`` and ``canonical_sizes()`` equal JAX's. The port is
  handed each rank's LOCAL blocks (the stage slices without their stage
  dim, with ``pp_global_shapes``) and plans on the global shapes; the
  plan does not depend on which rank's blocks it sees.
* ``zero_stack_global`` and ``zero_unstack_global`` of random global
  leaves equal JAX's bit for bit, on numpy and (stack) on CPU tensors;
  unstacking the stack gives the leaves back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel import create_hybrid_mesh as jmesh
from horovod_tpu.parallel import pp_transformer as jpp
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import pp_transformer as tpp
from horovod_tpu_torch.parallel import transformer as ttr

DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
FIELDS = ("buckets", "sizes", "padded", "shapes", "dtypes", "nshards",
          "scatter_axis", "denoms", "extra_axes", "shard_axes",
          "nonscatter", "global_shapes")
LM_MESHES = {"dp2tp2": dict(dp=2, tp=2), "dp4tp2": dict(dp=4, tp=2),
             "dp2tp4": dict(dp=2, tp=4)}
THRESHOLDS = (None, 2048)


def _spec(s):
    """A JAX PartitionSpec (or None) as the port's tuple spec."""
    return None if s is None else tuple(s)


def _jleaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _jspecs(specs):
    return jax.tree_util.tree_flatten(
        specs, is_leaf=lambda x: isinstance(x, P))[0]


def _hand_mesh(jm, coords):
    names = tuple(jm.axis_names)
    return tmesh.Mesh(axis_names=names,
                      shape={a: int(jm.shape[a]) for a in names},
                      coords=dict(coords), ranks={}, groups={})


def _assert_plan(tp, jp):
    for f in FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.leaf_specs == tuple(_spec(s) for s in jp.leaf_specs)
    assert tp.shard_shapes() == jp.shard_shapes()
    assert tp.canonical_sizes() == jp.canonical_sizes()
    for i in range(len(jp.buckets)):
        assert tp.bucket_ns(i) == jp.bucket_ns(i)
        assert tp.bucket_extra(i) == jp.bucket_extra(i)


def _lm_case(axes):
    n = int(np.prod(list(axes.values())))
    jm = jmesh(**axes, devices=jax.devices()[:n])
    cfg = jtr.TransformerConfig(**DIMS, dtype=jnp.float32,
                                unembed_dtype=jnp.float32,
                                attn_backend="xla")
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jtr.init_params(jax.random.PRNGKey(0), cfg))
    return jm, params, jtr.param_specs(cfg, jm)


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("name", list(LM_MESHES))
def test_lm_plan_equals_jax(name, threshold):
    jm, params, specs = _lm_case(LM_MESHES[name])
    leaves, jspecs = _jleaves(params), _jspecs(specs)
    jp = jfusion.plan_zero(params, int(jm.shape["dp"]), threshold,
                           specs=specs, mesh=jm)
    assert jp.nonscatter and len(jp.buckets) >= 2
    seen = None
    for coords in ({a: 0 for a in jm.axis_names},
                   {a: int(jm.shape[a]) - 1 for a in jm.axis_names}):
        tm = _hand_mesh(jm, coords)
        blocks = [tmesh.local_slice(torch.from_numpy(l), _spec(s), tm)
                  for l, s in zip(leaves, jspecs)]
        tp = tfusion.plan_zero(blocks, int(jm.shape["dp"]), threshold,
                               specs=[_spec(s) for s in jspecs], mesh=tm)
        _assert_plan(tp, jp)
        assert seen is None or tp == seen
        seen = tp


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("skip", [(), ("pp",)])
def test_pp_plan_equals_jax(skip, threshold):
    jm = jmesh(dp=2, pp=2, tp=2)
    cfg = jtr.TransformerConfig(**DIMS, dtype=jnp.float32,
                                unembed_dtype=jnp.float32,
                                attn_backend="xla")
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jpp.init_pp_params(jax.random.PRNGKey(0), cfg, 2))
    specs = jpp.pp_param_specs(jm)
    jp = jfusion.plan_zero(params, 2, threshold, specs=specs, mesh=jm,
                           skip_axes=skip)
    tm = _hand_mesh(jm, dict(dp=1, pp=1, tp=1))
    local = {"embed": torch.from_numpy(params["embed"]),
             "lnf": torch.from_numpy(params["lnf"]),
             "stages": {k: tmesh.local_slice(
                 torch.from_numpy(v[1]),
                 tpp.pp_param_specs(tm)["stages"][k][1:], tm)
                 for k, v in params["stages"].items()}}
    named = tpp.named_leaves(local)
    tspecs = tpp.named_specs(tpp.pp_param_specs(tm))
    assert [_spec(s) for s in _jspecs(specs)] == tspecs
    tp = tfusion.plan_zero([t for _, t in named], 2, threshold,
                           specs=tspecs, mesh=tm, skip_axes=skip,
                           global_shapes=tpp.pp_global_shapes(
                               ttr.TransformerConfig(**DIMS), 2))
    _assert_plan(tp, jp)
    if skip == ():
        # pp rides as a shard axis: the replicated head, the pp-owned
        # norms and the pp×tp matrices (test_plan_unification.py:306).
        assert {tp.bucket_shard_axes(i) for i in range(len(tp.buckets))} \
            == {(), ("pp",), ("pp", "tp")}


def test_plan_refusals_and_global_shapes():
    tm = tmesh.Mesh(axis_names=("dp", "tp"), shape={"dp": 2, "tp": 2},
                    coords={"dp": 0, "tp": 0}, ranks={}, groups={})
    ts = [torch.zeros(4, 3), torch.zeros(5)]
    with pytest.raises(ValueError, match="not on the mesh"):
        tfusion.plan_zero(ts, 2, specs=[(None, "ep"), ()], mesh=tm)
    with pytest.raises(ValueError, match="elements"):
        tfusion.plan_zero(ts, 2, specs=[(None, "tp"), ()], mesh=tm,
                          global_shapes=[(4, 8), (5,)])
    with pytest.raises(ValueError, match="nshards"):
        tfusion.plan_zero(ts, 4, specs=[(None, "tp"), ()], mesh=tm)
    plan = tfusion.plan_zero(ts, 2, specs=[(None, "tp"), ()], mesh=tm)
    assert plan.global_shapes == ((4, 6), (5,))
    assert plan.sizes == (12, 5) and plan.padded == (12, 6)


def _random_globals(jp, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*g).astype(np.float32) for g in jp.global_shapes]


@pytest.mark.parametrize("name", ["dp2tp2", "dp2tp4"])
def test_stack_and_unstack_equal_jax(name):
    jm, params, specs = _lm_case(LM_MESHES[name])
    jp = jfusion.plan_zero(params, int(jm.shape["dp"]), 2048, specs=specs,
                           mesh=jm)
    tm = _hand_mesh(jm, {a: 0 for a in jm.axis_names})
    blocks = [tmesh.local_slice(torch.from_numpy(l), _spec(s), tm)
              for l, s in zip(_jleaves(params), _jspecs(specs))]
    tp = tfusion.plan_zero(blocks, int(jm.shape["dp"]), 2048,
                           specs=[_spec(s) for s in _jspecs(specs)],
                           mesh=tm)
    g = _random_globals(jp, 5)
    for i in range(len(jp.buckets)):
        want = jfusion.zero_stack_global(g, jp, i)
        got = tfusion.zero_stack_global(g, tp, i)
        assert got.shape == tp.shard_shapes()[i]
        np.testing.assert_array_equal(got, want)
        got_t = tfusion.zero_stack_global([torch.from_numpy(x) for x in g],
                                          tp, i)
        np.testing.assert_array_equal(got_t.numpy(), want)
        jback = jfusion.zero_unstack_global(want, jp, i)
        back = tfusion.zero_unstack_global(got, tp, i)
        for a, b, j in zip(back, jback, jp.buckets[i]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, g[j])
        back_t = tfusion.zero_unstack_global(got_t, tp, i)
        for a, j in zip(back_t, jp.buckets[i]):
            np.testing.assert_array_equal(a.numpy(), g[j])

"""Port parity: the checkpoints of the hybrid state against the JAX
package, on the CPU (``torch_mesh_worker``: one gloo world of 4, one of
2).

* The 2-D canonical ZeRO form (``tests/test_hybrid.py``'s
  ``TestMeshReshapeCheckpoint``): one momentum-SGD step of the four-axis
  LM step with ``zero=True`` at dp2×tp2 from JAX's weights; the
  canonical vectors (each bucket's global leaves) are the same on every
  rank and equal JAX's ``zero_to_canonical`` of the ranks' shards laid
  into JAX's stacked layout; ``zero_from_canonical`` gives the shards
  back. ``save_sharded`` (and ``trainer.save_checkpoint``) restored at
  dp1×tp4 into a model from another seed: the parameters and the
  canonical state bit for bit the saved ones, a re-save writes the same
  leaf bytes, and the resumed step matches JAX's second step (loss rtol
  2e-4; params rtol 2e-4 / atol 1e-6) and the uninterrupted one. The
  manifest records the layout (``zero_mesh``). A restore onto a mesh
  with other axis names raises naming them; so does
  ``zero_from_canonical`` onto that plan (``"AXIS NAMES|mismatch"``,
  ``test_hybrid.py:461``).
* The pipelined stages' checkpoint, with and without ZeRO: a step at
  pp2×tp2, saved in JAX's ``init_pp_params`` layout (``[S, lps, ...]``
  stacks), restored at dp2×pp2×tp1 (the same axis names) bit for bit,
  a re-save writing the same leaf bytes; a restore at pp4 raises giving
  both sizes.
* ``restore_for_inference(mesh=, spec_fn=)`` of a tp=2 model's
  checkpoint in a world of 2: each leaf is this rank's block of the
  world-1 restore under the model's spec; without ``spec_fn`` every leaf
  is whole (replicated), as JAX's ``checkpoint.py:580-584`` places them.

Every comparison of bytes is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh as JMesh

import torch_mesh_worker
from horovod_tpu import optimizer as jopt
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel import pp_transformer as jpp
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.parallel.mesh import create_hybrid_mesh as jmesh
from test_torch_mesh_step import _assert_tree, _leaves

DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
PP_DIMS = dict(DIMS, n_layers=4)
B, T, LR = 8, 16, 0.1
RTOL, ATOL = 2e-4, 1e-6


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  jax.device_get(tree))


def _jcfg(dims):
    return jtr.TransformerConfig(**dims, dtype=jnp.float32,
                                 unembed_dtype=jnp.float32,
                                 attn_backend="xla")


def _batch(seed, rows=B, cols=T):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, DIMS["vocab"], (rows, cols)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jax_zero_two_steps():
    mesh = jmesh(dp=2, tp=2, devices=jax.devices()[:4])
    init_state, step = jtr.make_parallel_train_step(
        _jcfg(DIMS), mesh, optax.sgd(LR, momentum=0.9), zero=True)
    params, opt_state = init_state(jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    tree0 = _f32(params)
    tokens, labels = _batch(2)
    trees, losses = [], []
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(tokens),
                                       jnp.asarray(labels))
        trees.append(_f32(params))
        losses.append(float(loss))
    return tree0, trees, losses, tokens, labels


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tree0, trees, losses, tokens, labels = _jax_zero_two_steps()
    pp_tree = _f32(jpp.init_pp_params(jax.random.PRNGKey(2),
                                      _jcfg(PP_DIMS), 2))
    pp_tok, pp_lab = _batch(4, rows=B, cols=8)
    cases = [dict(kind="zckpt", dims=DIMS, lr=LR, tree=tree0,
                  tokens=tokens, labels=labels),
             dict(kind="ppckpt", dims=PP_DIMS, lr=LR, M=2, tree=pp_tree,
                  tokens=pp_tok, labels=pp_lab)]
    got = torch_mesh_worker.spawn(4, cases,
                                  tmp_path_factory.mktemp("zckpt4"))
    return dict(zckpt=(tree0, trees, losses, got[0]), ppckpt=got[1])


def _jax_canonical(tree0, ranks):
    """JAX's ``zero_to_canonical`` of the ranks' momentum shards, laid
    into the stacked ``[dp, ns·shard_len]`` layout of JAX's plan on a
    (dp, pp, tp) mesh of the port's axis names."""
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 1, 2),
                 ("dp", "pp", "tp"))
    plan = jfusion.plan_zero(tree0, 2, None,
                             specs=jtr.param_specs(_jcfg(DIMS), mesh),
                             mesh=mesh)
    stacked = []
    for i in range(len(plan.buckets)):
        s = plan.shard_len(i)
        full = np.zeros(plan.shard_shapes()[i], np.float32)
        for r in ranks:
            d = r["coords"]["dp"]
            c = r["coords"]["tp"] if plan.bucket_shard_axes(i) else 0
            full[d, c * s:(c + 1) * s] = r["shards"][i]["momentum_buffer"]
        stacked.append(full)
    canon = jopt.zero_to_canonical(jopt.ZeroShardedState(
        inner=tuple(stacked), plan=plan))
    return [np.asarray(x) for x in canon.inner]


def _canon_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].tobytes() == y[k].tobytes(), k


def test_2d_canonical_round_trip_equals_jax_form(world4):
    tree0, _, _, ranks = world4["zckpt"]
    for r in ranks:
        assert r["roundtrip"]
        _canon_equal(r["canon1"], ranks[0]["canon1"])
    want = _jax_canonical(tree0, ranks)
    got = [st["momentum_buffer"] for st in ranks[0]["canon1"]]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    assert sum(g.size for g in got) == sum(
        v.size for _, v in _leaves(tree0))


def test_dp2tp2_zero_checkpoint_restores_at_dp1tp4_and_resumes(world4):
    _, trees, losses, ranks = world4["zckpt"]
    for r in ranks:
        assert r["verified"] is True and r["step"] == 1
        assert r["zero_mesh"] == {"nshards": 2, "scatter_axis": "dp",
                                  "nonscatter": {"pp": 1, "tp": 2}}
        _assert_tree(r["saved"], trees[0])
        _assert_tree(r["restored"], r["saved"], rtol=0, atol=0)
        _canon_equal(r["canon2"], r["canon1"])
        _canon_equal(r["canon4"], r["canon1"])
        assert r["records"][0] == r["records"][1]
        np.testing.assert_allclose(r["loss"], losses[1], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(r["loss"], r["loss_a"], rtol=RTOL,
                                   atol=ATOL)
        _assert_tree(r["after"], trees[1])
        _assert_tree(r["after"], r["after_a"])
        _assert_tree(r["trainer_after"], r["after"], rtol=0, atol=0)


def test_axis_name_change_raises_named_error(world4):
    *_, ranks = world4["zckpt"]
    for r in ranks:
        restore_err, canon_err = r["errors"]
        assert "AXIS NAMES" in restore_err and "'tp'" in restore_err
        assert "AXIS NAMES" in canon_err and "mismatch" in canon_err


@pytest.mark.parametrize("zero", [False, True])
def test_pipelined_stages_checkpoint_restores_at_pp2_tp1(world4, zero):
    ranks = [r[zero] for r in world4["ppckpt"]]
    lps = PP_DIMS["n_layers"] // 2
    d, f = PP_DIMS["d_model"], PP_DIMS["d_ff"]
    saved = ranks[0]["saved"]
    assert saved["wqkv"].shape == (2, lps, d, 3 * d)
    assert saved["w2"].shape == (2, lps, f, d)
    by_stage = {}
    for r in ranks:
        for k, v in r["gathered"]["stages"].items():
            np.testing.assert_array_equal(v, saved[k][r["stage"]])
        by_stage[r["stage"]] = r["gathered"]
    for r in ranks:
        want = by_stage[r["stage2"]]
        _assert_tree(r["restored"], want, rtol=0, atol=0)
        assert r["records"][0] == r["records"][1]
        assert "pp=2" in r["error"] and "pp=4" in r["error"], r["error"]
        if zero:
            _canon_equal(r["canon2"], r["canon1"])


def _spec_leaves(tree, prefix=""):
    """The specs of a :func:`param_specs` tree keyed as ``_leaves`` keys
    the parameters (a spec tuple is a leaf)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    got = torch_mesh_worker.spawn(
        2, [dict(kind="infer", dims=DIMS)], tmp_path_factory.mktemp("inf2"))
    return got[0]


def test_restore_for_inference_places_blocks_on_the_mesh(world2):
    from horovod_tpu_torch.parallel import transformer as ttr
    from horovod_tpu_torch.parallel.mesh import Mesh, local_slice
    for r in world2:
        full = dict(_leaves(r["full"]["params"]))
        assert dict(_leaves(r["replicated"]["params"])).keys() == \
            full.keys()
        for k, v in _leaves(r["replicated"]["params"]):
            np.testing.assert_array_equal(v, full[k])
        mesh = Mesh(axis_names=("dp", "pp", "tp"),
                    shape={"dp": 1, "pp": 1, "tp": 2}, coords=r["coords"],
                    ranks={}, groups={})
        specs = ttr.param_specs(ttr.TransformerConfig(**DIMS), mesh)
        spec_at = dict(_spec_leaves(specs))
        sharded = 0
        for k, v in _leaves(r["blocks"]["params"]):
            want = local_slice(full[k], spec_at[k], mesh)
            np.testing.assert_array_equal(v, want)
            sharded += v.shape != full[k].shape
        assert sharded == 4 * DIMS["n_layers"]      # wqkv, wo, w1, w2

"""Port parity: the pipelined step on the full 3-D dp×tp×pp mesh against
the JAX package's data-parallel step, on the CPU, in one gloo world of 8
(``torch_mesh_worker``).

``tests/test_plan_unification.py``'s ``pp3d`` cases (vocab 64, d_model
32, 4 heads, 2 layers, d_ff 64, f32; SGD(0.1); 2 microbatches; the 8 ×
16 token batch of seed 3):

* the port's ``make_pp_transformer_train_step`` at dp2×tp2×pp2 from
  JAX's ``init_pp_params`` weights, two steps, against JAX's
  ``make_parallel_train_step`` at dp=8 from the same global weights
  carried to the per-layer layout (``_flat_from_pp``): losses rtol
  2e-5, every stage's global parameters rtol 2e-4 / atol 1e-6
  (``test_3d_step_matches_dp8_reference``);
* ``overlap=True`` bitwise the plain step, ``zero=True`` within rtol
  1e-5 / atol 1e-7 of it (``test_pp_overlap_bit_identical_and_zero_
  parity``);
* the collectives of one step, counted by wrapping
  ``torch.distributed``: under ``zero`` three reduce-scatters and three
  all-gathers, one per spec group (the replicated head, the pp-owned
  norms, the pp×tp matrices; ``test_pp_hlo_zero_rs_ag_per_plan_
  bucket``); the guard adds one scalar all-reduce under ``zero`` (the
  fold over the plan's non-scatter axes; its verdict rides the
  all-gather) and two without (over (dp, tp), then over pp;
  ``test_pp_hlo_guard_adds_two_scalar_pmins``), and no reduce-scatter
  or all-gather.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_mesh_worker
from horovod_tpu.parallel import create_hybrid_mesh as jmesh
from horovod_tpu.parallel import pp_transformer as jpp
from horovod_tpu.parallel import transformer as jtr

DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
STAGE_KEYS = ("ln1", "ln2", "w1", "w2", "wo", "wqkv")
LR, M, S = 0.1, 2, 2


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  jax.device_get(tree))


def _cfg():
    return jtr.TransformerConfig(**DIMS, dtype=jnp.float32,
                                 unembed_dtype=jnp.float32,
                                 attn_backend="xla")


def _batch():
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, 64, (8, 16)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _flat_from_pp(pp_params, n_stages, lps):
    """The pipeline layout ([S, lps, ...] stacks) as the per-layer list
    of the data-parallel family (``test_plan_unification.py:140``)."""
    st = pp_params["stages"]
    layers = [{k: np.asarray(st[k][s, i]) for k in st}
              for s in range(n_stages) for i in range(lps)]
    return {"embed": np.asarray(pp_params["embed"]),
            "lnf": np.asarray(pp_params["lnf"]), "layers": layers}


def _jax_dp8(pp_tree):
    cfg = _cfg()
    init_state, step = jtr.make_parallel_train_step(cfg, jmesh(dp=8),
                                                    optax.sgd(LR))
    p0, o = init_state(jax.random.PRNGKey(1))
    flat = _flat_from_pp(pp_tree, S, cfg.n_layers // S)
    p = jax.tree_util.tree_map(
        lambda tpl, v: jax.device_put(jnp.asarray(v, jnp.float32),
                                      tpl.sharding), p0, flat)
    tokens, labels = _batch()
    losses = []
    for _ in range(2):
        p, o, loss = step(p, o, jnp.asarray(tokens), jnp.asarray(labels))
        losses.append(float(loss))
    p = _f32(p)
    lps = cfg.n_layers // S
    stages = {k: np.stack([np.stack([p["layers"][s * lps + i][k]
                                     for i in range(lps)])
                           for s in range(S)]) for k in STAGE_KEYS}
    return losses, {"embed": p["embed"], "lnf": p["lnf"], "stages": stages}


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    pp_tree = _f32(jpp.init_pp_params(jax.random.PRNGKey(0), _cfg(), S))
    want = _jax_dp8(pp_tree)
    tokens, labels = _batch()
    case = dict(kind="pp3d", mesh=dict(dp=2, pp=2, tp=2), dims=DIMS,
                lr=LR, M=M, tree=pp_tree, tokens=tokens, labels=labels)
    (ranks,) = torch_mesh_worker.spawn(8, [case],
                                       tmp_path_factory.mktemp("pp3d"),
                                       timeout=900)
    return want, ranks


def _params_close(got, want, stage, **tol):
    np.testing.assert_allclose(got["embed"], want["embed"], **tol)
    np.testing.assert_allclose(got["lnf"], want["lnf"], **tol)
    for k in STAGE_KEYS:
        np.testing.assert_allclose(got["stages"][k], want["stages"][k][stage],
                                   err_msg=k, **tol)


def test_3d_step_matches_dp8_reference(world8):
    (losses, want), ranks = world8
    assert sorted((r["coords"]["dp"], r["coords"]["pp"], r["coords"]["tp"])
                  for r in ranks) == [(d, p, t) for d in range(2)
                                      for p in range(2) for t in range(2)]
    for r in ranks:
        run = r["plain"]
        np.testing.assert_allclose(run["losses"], losses, rtol=2e-5)
        _params_close(run["params"], want, run["stage"], rtol=2e-4,
                      atol=1e-6)


def test_pp_overlap_bit_identical_and_zero_parity(world8):
    _, ranks = world8
    for r in ranks:
        base, over, zero = r["plain"], r["overlap"], r["zero"]
        assert over["losses"] == base["losses"]
        for k in ("embed", "lnf"):
            np.testing.assert_array_equal(over["params"][k],
                                          base["params"][k])
        for k in STAGE_KEYS:
            np.testing.assert_array_equal(over["params"]["stages"][k],
                                          base["params"]["stages"][k])
        np.testing.assert_allclose(zero["losses"], base["losses"],
                                   rtol=1e-5)
        base_stage = {"embed": base["params"]["embed"],
                      "lnf": base["params"]["lnf"],
                      "stages": {k: v[None] for k, v in
                                 base["params"]["stages"].items()}}
        _params_close(zero["params"], base_stage, 0, rtol=1e-5, atol=1e-7)
        assert sorted(set(zero["shard_axes"])) == [(), ("pp",),
                                                   ("pp", "tp")]


def test_pp_zero_rs_ag_per_plan_bucket_and_guard_collectives(world8):
    _, ranks = world8
    for r in ranks:
        c = r["counts"]
        plain, plain_g = c[False, False], c[False, True]
        zero, zero_g = c[True, False], c[True, True]
        assert zero["reduce_scatter_tensor"] == 3
        assert zero["all_gather_into_tensor"] == 3
        assert plain["reduce_scatter_tensor"] == 0
        assert zero_g["reduce_scatter_tensor"] == 3
        assert zero_g["all_gather_into_tensor"] == 3
        assert zero_g["all_reduce"] - zero["all_reduce"] == 1
        assert plain_g["all_reduce"] - plain["all_reduce"] == 2
        assert plain_g["all_gather_into_tensor"] == \
            plain["all_gather_into_tensor"]

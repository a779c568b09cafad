"""Port parity: tp inside the pipelined stages, the checkpoint's mesh
reshape, and the transformer-LM example, on the CPU.

* The pipelined step at pp2×tp2 (a gloo world of 4): one SGD(0.1) step
  from JAX ``init_pp_params`` weights (cast to f32) against JAX
  ``make_pp_transformer_train_step`` on the same mesh: loss rtol 2e-5 /
  atol 1e-6, every stage's global parameters (tp blocks all-gathered)
  rtol 2e-4 / atol 1e-6 (tests/test_parallel.py:406-407, :436). The plan
  has two groups: the replicated head and norm leaves over (dp, tp), the
  tp-sharded matrices over dp.
* The checkpoint of a tp-sharded model in the same world: one
  momentum-SGD step at dp2×tp2, ``save_sharded``, ``restore_sharded``
  at dp1×tp4 into a model drawn from another seed, a second step: the
  saved and restored parameters equal the first step's bit for bit, the
  saved bytes are the world-1 model's form, the resumed step matches
  JAX's two steps (rtol 2e-4 / atol 1e-6), the Trainer's
  ``save_checkpoint``/``restore_checkpoint`` of the same state resumes
  bit for bit the same, and a restore onto a mesh with other axis names
  raises, naming them.
* ``python -m horovod_tpu_torch.examples.transformer_lm`` through the
  launcher in a gloo world of 4: dp2×tp2 for 4 steps with a checkpoint
  every 2, then ``--resume`` at tp4 to step 6.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_mesh_worker
from horovod_tpu.parallel import pp_transformer as jpp
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.parallel.mesh import create_hybrid_mesh as jmesh
from test_torch_mesh_step import _assert_tree, _leaves

DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=4, d_ff=64)
B, T, M, LR = 8, 8, 4, 0.1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  jax.device_get(tree))


def _jcfg():
    return jtr.TransformerConfig(**DIMS, dtype=jnp.float32,
                                 unembed_dtype=jnp.float32,
                                 attn_backend="xla")


def _batch(seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, DIMS["vocab"], (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jax_pp():
    mesh = jmesh(pp=2, tp=2, devices=jax.devices()[:4])
    init_state, step = jpp.make_pp_transformer_train_step(
        _jcfg(), mesh, optax.sgd(LR), n_microbatches=M)
    params, opt_state = init_state(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    tree0 = _f32(params)
    tokens, labels = _batch(1)
    params, _, loss = step(params, opt_state, jnp.asarray(tokens),
                           jnp.asarray(labels))
    return tree0, _f32(params), float(loss), tokens, labels


def _jax_two_steps():
    mesh = jmesh(dp=2, tp=2, devices=jax.devices()[:4])
    init_state, step = jtr.make_parallel_train_step(
        _jcfg(), mesh, optax.sgd(LR, momentum=0.9))
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
    tree0, tree1, loss, tokens, labels = _jax_pp()
    ck0, ck_trees, ck_losses, ck_tok, ck_lab = _jax_two_steps()
    cases = [dict(kind="pp", mesh=dict(dp=1, pp=2, tp=2), dims=DIMS, M=M,
                  lr=LR, tree=tree0, tokens=tokens, labels=labels),
             dict(kind="ckpt", dims=DIMS, lr=LR, tree=ck0, tokens=ck_tok,
                  labels=ck_lab)]
    got = torch_mesh_worker.spawn(4, cases, tmp_path_factory.mktemp("pp4"))
    return dict(pp=(tree1, loss, got[0]),
                ckpt=(ck_trees, ck_losses, got[1]))


def test_pp2_tp2_step_matches_jax(world4):
    tree1, loss, ranks = world4["pp"]
    assert sorted((r["stage"], r["coords"]["tp"]) for r in ranks) == \
        [(s, t) for s in range(2) for t in range(2)]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=2e-5, atol=1e-6)
        assert r["groups"] == [("dp",), ("dp", "tp")]
        for k in ("embed", "lnf"):
            np.testing.assert_allclose(r["params"][k], tree1[k], rtol=2e-4,
                                       atol=1e-6, err_msg=k)
        for k, v in r["params"]["stages"].items():
            np.testing.assert_allclose(
                v, tree1["stages"][k][r["stage"]], rtol=2e-4, atol=1e-6,
                err_msg=f"stage {r['stage']} {k}")
    # The tp ranks of a stage hold the same gathered stage.
    for r in ranks:
        twin = next(x for x in ranks if x["stage"] == r["stage"])
        for k, v in r["params"]["stages"].items():
            np.testing.assert_array_equal(v, twin["params"]["stages"][k])


def test_dp2tp2_checkpoint_restores_at_dp1tp4_and_resumes(world4):
    trees, losses, ranks = world4["ckpt"]
    for r in ranks:
        assert r["verified"] is True and r["step"] == 1
        _assert_tree(r["saved"], trees[0])
        _assert_tree(r["restored"], r["saved"], rtol=0, atol=0)
        np.testing.assert_allclose(r["loss"], losses[1], rtol=2e-4,
                                   atol=1e-6)
        _assert_tree(r["after"], trees[1])
        assert "AXIS NAMES" in r["axis_error"] and "'tp'" in \
            r["axis_error"], r["axis_error"]
        # The Trainer's checkpoint of the same state resumes the same.
        assert r["trainer_step"] == 2
        _assert_tree(r["trainer_after"], r["after"], rtol=0, atol=0)
    # The saved bytes are the world-1 model's form: a plain model loads
    # them as they are.
    world1 = [r["world1"] for r in ranks if r["world1"] is not None]
    assert world1
    _assert_tree(world1[0], ranks[0]["saved"], rtol=0, atol=0)
    shapes = {k: v.shape for k, v in _leaves(world1[0])}
    assert shapes[".layers[0].wqkv"] == (DIMS["d_model"],
                                          3 * DIMS["d_model"])


def _launch(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.launcher", "-np", "4",
         "--cpu", sys.executable, "-m",
         "horovod_tpu_torch.examples.transformer_lm", "--seq", "32",
         *args], capture_output=True, text=True, timeout=timeout, env=env,
        cwd=REPO)


def test_transformer_lm_example_checkpoints_and_resumes(tmp_path):
    d = str(tmp_path / "lm")
    first = _launch(["--dp", "2", "--tp", "2", "--steps", "4",
                     "--checkpoint-dir", d, "--checkpoint-every", "2"])
    assert first.returncode == 0, first.stderr[-3000:]
    assert "mesh: dp=2 sp=1 tp=2 pp=1 (4 ranks)" in first.stdout
    assert "OK: loss" in first.stdout
    assert sorted(os.listdir(d)) == ["ckpt_2", "ckpt_4"]
    second = _launch(["--tp", "4", "--steps", "6", "--checkpoint-dir", d,
                      "--checkpoint-every", "2", "--resume"])
    assert second.returncode == 0, second.stderr[-3000:]
    assert "resumed from step 4" in second.stdout
    assert "OK: loss" in second.stdout and "step    5" in second.stdout
    assert sorted(os.listdir(d)) == ["ckpt_2", "ckpt_4", "ckpt_6"]

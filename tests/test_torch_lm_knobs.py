"""Port parity: the LM's memory knobs — ``TransformerConfig.loss_chunk``
(``chunked_nll``) and ``TransformerConfig.remat`` — against the JAX
package, on the CPU.

* ``chunked_nll`` and its gradients (with respect to the hidden states
  and the tied embedding) against JAX's, with labels below 0 and at or
  past vocab (clamped into range on both sides), at f32 and at a bf16
  unembed: values rtol 1e-5 (online log-sum-exp in another order; bf16
  operands are multiplied exactly and summed in f32 on both sides);
  gradients rtol 1e-5 at f32 and 2^-7 (two bf16 ulps) at bf16, where
  both sides round them to bf16 through the operands' cast after sums in
  other orders. Its ``ValueError`` when the chunk does not divide vocab.
* The chunked loss against the port's dense loss (the same function).
* ``remat`` (each layer checkpointed, matmul outputs kept): the port's
  loss and gradients bitwise equal to no remat on the CPU — but the
  embedding's, whose scatter-add backward sums duplicated tokens in a
  thread-dependent order on the CPU (two plain runs differ there too;
  rtol 1e-6) — and equal to
  JAX's ``remat`` forward to the f32 tolerances of
  ``test_torch_lm_training.py`` (loss rtol 1e-5, gradients rtol 1e-4 /
  atol 1e-5 of each leaf's largest entry).
* One SGD step of ``make_parallel_train_step`` with both knobs against
  the JAX step with both, and the pipelined step with both against the
  plain pipelined step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.parallel.mesh import create_hybrid_mesh
from horovod_tpu_torch import convert, runtime
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import pp_transformer as tpp
from horovod_tpu_torch.parallel import transformer as ttr

DIMS = dict(vocab=128, d_model=256, n_heads=2, n_layers=2, d_ff=256)
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(unembed="f32", **kw):
    jut, tut = DT[unembed]
    return (jtr.TransformerConfig(**DIMS, dtype=jnp.float32,
                                  unembed_dtype=jut, **kw),
            ttr.TransformerConfig(**DIMS, dtype=torch.float32,
                                  unembed_dtype=tut, **kw))


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = _cfgs()
    params = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  params)


def _batch(B, T, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, DIMS["vocab"], (B, T)).astype(np.int32),
            rng.randint(0, DIMS["vocab"], (B, T)).astype(np.int32))


@pytest.mark.parametrize("chunk", [32, 128])
@pytest.mark.parametrize("unembed", ["f32", "bf16"])
def test_chunked_nll_and_grads_match_jax(chunk, unembed):
    jcfg, tcfg = _cfgs(unembed, loss_chunk=chunk)
    rng = np.random.RandomState(chunk)
    x = rng.randn(3, 10, DIMS["d_model"]).astype(np.float32)
    embed = (rng.randn(DIMS["vocab"], DIMS["d_model"]) * 0.05).astype(
        np.float32)
    labels = rng.randint(0, DIMS["vocab"], (3, 10)).astype(np.int32)
    labels[0, :3] = [-5, DIMS["vocab"], DIMS["vocab"] + 40]
    weights = rng.rand(3, 10).astype(np.float32)

    def jloss(xx, ee):
        return jnp.sum(jtr.chunked_nll(xx, ee, jnp.asarray(labels), jcfg)
                       * weights)
    jval = jtr.chunked_nll(jnp.asarray(x), jnp.asarray(embed),
                           jnp.asarray(labels), jcfg)
    jgx, jge = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(embed))
    tx = torch.from_numpy(x).requires_grad_()
    te = torch.from_numpy(embed).requires_grad_()
    val = ttr.chunked_nll(tx, te, torch.from_numpy(labels), tcfg)
    (val * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval),
                               rtol=1e-5)
    rtol = 1e-5 if unembed == "f32" else 2.0 ** -7
    for got, want in ((tx.grad, jgx), (te.grad, jge)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("chunk", [48, 0, 256])
def test_chunk_must_divide_vocab(chunk):
    _, tcfg = _cfgs(loss_chunk=chunk)
    with pytest.raises(ValueError, match="must divide vocab=128"):
        ttr.chunked_nll(torch.zeros(2, DIMS["d_model"]),
                        torch.zeros(DIMS["vocab"], DIMS["d_model"]),
                        torch.zeros(2, dtype=torch.int64), tcfg)


def _loss_and_grads(tree, tcfg, toks, labels):
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    loss = ttr.lm_loss(ttr.gen_weights(model), torch.from_numpy(toks),
                       torch.from_numpy(labels), tcfg)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def test_chunked_loss_equals_the_dense_loss(tree):
    toks, labels = _batch(2, 128, seed=1)
    l0, g0 = _loss_and_grads(tree, _cfgs()[1], toks, labels)
    l1, g1 = _loss_and_grads(tree, _cfgs(loss_chunk=32)[1], toks, labels)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for n, g in g0.items():
        np.testing.assert_allclose(g1[n].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-6 * g.abs().max().item(),
                                   err_msg=n)


@pytest.mark.parametrize("T", [128, 96])
def test_remat_is_bitwise_the_plain_step_and_matches_jax(tree, T):
    """T=128 runs the packed flash path (recomputed in the backward), T=96
    the dense attention."""
    toks, labels = _batch(2, T, seed=2)
    l0, g0 = _loss_and_grads(tree, _cfgs()[1], toks, labels)
    l1, g1 = _loss_and_grads(tree, _cfgs(remat=True)[1], toks, labels)
    assert torch.equal(l0, l1)
    for n, g in g0.items():
        if n == "embed":
            np.testing.assert_allclose(g1[n].numpy(), g.numpy(), rtol=1e-6,
                                       atol=1e-6 * g.abs().max().item())
        else:
            assert torch.equal(g1[n], g), n
    jcfg, _ = _cfgs(remat=True)
    mesh = create_hybrid_mesh(dp=1, devices=jax.devices()[:1])

    def jloss(p, t, y):
        return jnp.mean(jtr.dense_nll(jtr.forward(p, t, jcfg, mesh)[0], y))
    vag = jax.jit(jax.shard_map(
        jax.value_and_grad(jloss), mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=(P(), P()), check_vma=False))
    jl, jg = vag(jax.tree_util.tree_map(jnp.asarray, tree),
                 jnp.asarray(toks), jnp.asarray(labels))
    np.testing.assert_allclose(float(l1), float(jl), rtol=1e-5)
    jflat = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(
                 jax.device_get(jg))[0]}
    for n, g in g1.items():
        w = jflat[n]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)


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


def test_step_with_remat_and_chunked_loss_matches_jax(tree, one_rank_world):
    jcfg, tcfg = _cfgs(remat=True, loss_chunk=32)
    toks, labels = _batch(2, 128, seed=3)
    mesh = create_hybrid_mesh(dp=1, devices=jax.devices()[:1])
    _, jstep = jtr.make_parallel_train_step(jcfg, mesh, optax.sgd(0.5))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    params, _, jloss = jstep(params, optax.sgd(0.5).init(params),
                             jnp.asarray(toks), jnp.asarray(labels))
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    init_state, step = ttr.make_parallel_train_step(
        tcfg, functools.partial(torch.optim.SGD, lr=0.5), device="cpu")
    state, loss = step(init_state(model=model), torch.from_numpy(toks),
                       torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = convert.params_to_numpy(model)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree_util.tree_leaves(
                                jax.device_get(params))):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_pp_step_with_remat_and_chunked_loss(one_rank_world):
    """The pipelined step reads both knobs in its stage and its head: one
    step from the same weights equals the plain pipelined step (loss rtol
    1e-6; params rtol 1e-5 / atol 1e-6 of each leaf's largest entry)."""
    toks, labels = _batch(4, 96, seed=4)
    mesh = tmesh.create_hybrid_mesh(dp=1, pp=1)
    out = {}
    for kw in ({}, {"remat": True, "loss_chunk": 32}):
        cfg = ttr.TransformerConfig(**DIMS, dtype=torch.float32,
                                    attn_backend="xla", **kw)
        init_state, step = tpp.make_pp_transformer_train_step(
            cfg, mesh, functools.partial(torch.optim.SGD, lr=0.5), 2,
            device="cpu")
        state, loss = step(init_state(0), torch.from_numpy(toks),
                           torch.from_numpy(labels))
        out[bool(kw)] = (float(loss), dict(tpp.named_leaves(state.params)))
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-6)
    for n, p in out[False][1].items():
        w = p.detach().numpy()
        np.testing.assert_allclose(out[True][1][n].detach().numpy(), w,
                                   rtol=1e-5, atol=1e-6 * np.abs(w).max(),
                                   err_msg=n)


@pytest.mark.parametrize("op,saved", [
    (torch.ops.aten.mm.default, True), (torch.ops.aten.addmm.default, True),
    (torch.ops.aten.bmm.default, True), (torch.ops.aten.gelu.default, False),
    (torch.ops.aten.mul.Tensor, False), (torch.ops.aten._to_copy.default,
                                         False)])
def test_remat_policy_keeps_only_the_matmul_outputs(op, saved):
    from torch.utils.checkpoint import CheckpointPolicy
    want = CheckpointPolicy.MUST_SAVE if saved \
        else CheckpointPolicy.PREFER_RECOMPUTE
    assert ttr._dots_saveable(None, op) == want

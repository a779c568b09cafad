"""Port parity: transformer-LM training against the JAX package, on the CPU.

A tiny config whose d_head is 128 (vocab 128, d_model 256, 2 heads, 2
layers, d_ff 256), so the JAX side runs its packed Pallas flash kernels
(interpret mode) wherever ``qkv_flash_tilable`` holds and the port runs
their plain versions; T=96 takes the dense attention on both sides.
Weights come from the JAX ``init_params`` and are carried into the port
with ``params_from_jax``; batches are numpy draws.

* logits of ``forward`` at a bf16 unembed (f32 accumulation, f32
  logits, as JAX's ``preferred_element_type=f32``);
* the loss and every leaf's gradient (``jax.value_and_grad``);
* three AdamW steps of ``make_parallel_train_step`` against the JAX step
  on a 1-device mesh — losses and per-leaf updates;
* the JAX tree-flatten leaf order and bucket plan for a 12-layer LM
  (list indices in numeric order);
* a 2-rank gloo world (``torch_dist_worker.run_lm``): one step with each
  rank holding half the batch equals the 1-rank step on the whole batch.
"""

import functools
import inspect
import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

import torch_dist_worker
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.parallel.mesh import create_hybrid_mesh
from horovod_tpu_torch import convert, runtime
from horovod_tpu_torch.ops import LAUNCHES
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.parallel import transformer as ttr
from horovod_tpu_torch.training import create_train_state

DIMS = dict(vocab=128, d_model=256, n_heads=2, n_layers=2, d_ff=256)
ADAMW = dict(lr=1e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _configs(dtype, unembed, **dims):
    dims = {**DIMS, **dims}
    (jdt, tdt), (jut, tut) = DTYPES[dtype], DTYPES[unembed]
    return (jtr.TransformerConfig(**dims, dtype=jdt, unembed_dtype=jut),
            ttr.TransformerConfig(**dims, dtype=tdt, unembed_dtype=tut))


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = _configs("f32", "f32")
    params = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  params)


def _batch(B, T, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, DIMS["vocab"], (B, T)).astype(np.int32),
            rng.randint(0, DIMS["vocab"], (B, T)).astype(np.int32))


def _mesh():
    return create_hybrid_mesh(dp=1, devices=jax.devices()[:1])


def _jax_logits(tree, toks, jcfg):
    mesh = _mesh()
    f = jax.jit(jax.shard_map(
        lambda p, t: jtr.forward(p, t, jcfg, mesh)[0], mesh=mesh,
        in_specs=(P(), P()), out_specs=P(), check_vma=False))
    return np.asarray(f(jax.tree_util.tree_map(jnp.asarray, tree),
                        jnp.asarray(toks)))


def _leaves_close(got, want, rtol, atol, what=""):
    """Per leaf: allclose with atol relative to the leaf's largest entry."""
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(p) for p, _ in gl] == \
        [jax.tree_util.keystr(p) for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            np.asarray(g, np.float32), w, rtol=rtol,
            atol=atol * max(np.abs(w).max(), 1e-30),
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


def test_unembed_at_bf16_is_jax_preferred_element_type_f32():
    """The tied unembed at a bf16 ``unembed_dtype``, on the same hidden
    states: JAX's ``jnp.matmul(bf16, bf16, preferred_element_type=f32)``
    (the line of its ``forward``) multiplies the bf16 operands exactly and
    sums in f32, and so does the port: rtol/atol 1e-6 (summation order).
    A product rounded to bf16 before it is widened is ~2^-9 off."""
    _, tcfg = _configs("f32", "bf16")
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, DIMS["d_model"]).astype(np.float32)
    embed = (rng.randn(DIMS["vocab"], DIMS["d_model"]) * 0.02).astype(
        np.float32)
    want = np.asarray(jnp.matmul(jnp.asarray(x).astype(jnp.bfloat16),
                                 jnp.asarray(embed).T.astype(jnp.bfloat16),
                                 preferred_element_type=jnp.float32))
    w = {"unembed": torch.from_numpy(embed).to(torch.bfloat16)}
    got = ttr.unembed(w, torch.from_numpy(x), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_logits_match_jax_at_bf16_unembed(tree):
    """The whole forward with f32 layers and a bf16 unembed. The hidden
    states agree to f32 summation order, which now and then flips the
    bf16 rounding of one unembed operand (one term off by ~2^-9 of
    itself): max |diff| 2e-3, and a mean |diff| of 2e-5 on logits of mean
    magnitude ~0.25 — a product rounded to bf16 before it is widened is
    off everywhere, by ~4e-4 on average."""
    jcfg, tcfg = _configs("f32", "bf16")
    toks, _ = _batch(2, 128, seed=0)
    want = _jax_logits(tree, toks, jcfg)
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    with torch.no_grad():
        got = ttr.forward(model, torch.from_numpy(toks))
    assert got.dtype == torch.float32
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= 2e-3 and diff.mean() <= 2e-5, \
        (diff.max(), diff.mean())


def test_bf16_logits_match_jax(tree):
    """bf16 layers and unembed, the bench LM's numerics: both sides round
    every projection, residual and P to bf16, but at other internal
    precisions (JAX's bf16 GELU and matmul outputs), so logits drift by a
    few bf16 ulps through two layers (as in test_torch_transformer's
    bf16 test): atol 0.03 on logits of magnitude < 1."""
    jcfg, tcfg = _configs("bf16", "bf16")
    toks, _ = _batch(2, 128, seed=1)
    want = _jax_logits(tree, toks, jcfg)
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    with torch.no_grad():
        got = ttr.forward(model, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.03)


@pytest.mark.parametrize("T", [128, 96])
def test_loss_and_grads_match_jax_f32(tree, T):
    """``mean(dense_nll)`` and every leaf's gradient at f32, through the
    packed flash path (T=128) and the dense route of an untilable length
    (T=96): loss rtol 1e-5; gradients rtol 1e-4 with atol 1e-5 of each
    leaf's largest entry (sums in other orders through two layers)."""
    jcfg, tcfg = _configs("f32", "f32")
    toks, labels = _batch(2, T, seed=2)
    mesh = _mesh()

    def jloss(p, t, y):
        logits, _ = jtr.forward(p, t, jcfg, mesh)
        return jnp.mean(jtr.dense_nll(logits, y))
    vag = jax.jit(jax.shard_map(
        jax.value_and_grad(jloss), mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=(P(), P()), check_vma=False))
    want_loss, want_grads = vag(jax.tree_util.tree_map(jnp.asarray, tree),
                                jnp.asarray(toks), jnp.asarray(labels))
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    before = LAUNCHES.snapshot()
    loss = ttr.dense_nll(ttr.forward(model, torch.from_numpy(toks)),
                         torch.from_numpy(labels)).mean()
    loss.backward()
    assert LAUNCHES.snapshot() == before         # plain versions on CPU
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = _grad_tree(model)
    _leaves_close(grads, jax.device_get(want_grads), rtol=1e-4, atol=1e-5)


def _grad_tree(model):
    """The gradients in the JAX parameter tree's shape."""
    def g(t):
        return t.grad.numpy()
    return {"embed": g(model.embed), "lnf": g(model.lnf),
            "layers": [{k: g(getattr(b, k)) for k in
                        ("ln1", "wqkv", "wo", "ln2", "w1", "w2")}
                       for b in model.layers]}


def _adamw_torch():
    return functools.partial(torch.optim.AdamW, **ADAMW)


@pytest.fixture
def one_rank_world(monkeypatch):
    for var in ("HVD_RANK", "PMI_RANK", "OMPI_COMM_WORLD_RANK", "HVD_SIZE",
                "PMI_SIZE", "OMPI_COMM_WORLD_SIZE", "HVD_LOCAL_RANK",
                "OMPI_COMM_WORLD_LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    yield
    runtime.shutdown()


def _jax_steps(jcfg, batches):
    """JAX make_parallel_train_step + optax.adamw on a 1-device mesh from
    init_params(PRNGKey(0)); returns (initial params, final params,
    losses) as numpy."""
    mesh = _mesh()
    init_state, step = jtr.make_parallel_train_step(
        jcfg, mesh, optax.adamw(1e-4, b1=0.9, b2=0.95, weight_decay=0.1))
    params, opt_state = init_state(jax.random.PRNGKey(0))
    p0 = jax.device_get(params)
    losses = []
    for toks, labels in batches:
        params, opt_state, loss = step(params, opt_state, jnp.asarray(toks),
                                       jnp.asarray(labels))
        losses.append(float(loss))
    return p0, jax.device_get(params), losses


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_three_adamw_steps_match_jax(dtype, one_rank_world):
    """Losses and per-leaf updates (params after three steps minus the
    initial params: an AdamW step moves every entry by about lr whatever
    its gradient, so raw params would hide the update). AdamW divides by
    sqrt(v): where a gradient entry is ~0 its summation-order noise
    decides the sign of that entry's update, so updates are compared by
    relative L2 per leaf, not entry by entry. f32: losses rtol 1e-5,
    each leaf's ||update - jax|| / ||jax|| <= 1e-3. bf16: losses rtol
    5e-3 (tests/test_hybrid.py's bf16-wire loss tolerance); the two
    frameworks round bf16 activations at other internal precisions, so
    the updates are held to a whole-model cosine >= 0.9."""
    jcfg, tcfg = _configs(dtype, dtype)
    batches = [_batch(2, 128, seed=10 + i) for i in range(3)]
    p0, p3, jlosses = _jax_steps(jcfg, batches)
    model = convert.params_from_jax(p0, tcfg, device="cpu")
    init_state, step = ttr.make_parallel_train_step(tcfg, _adamw_torch(),
                                                    device="cpu")
    state = init_state(model=model)
    losses = []
    for toks, labels in batches:
        state, loss = step(state, torch.from_numpy(toks),
                           torch.from_numpy(labels))
        losses.append(float(loss))
    assert state.step == 3
    got = convert.params_to_numpy(model)
    upd = jax.tree_util.tree_map(lambda a, b: a - b, got, p0)
    jupd = jax.tree_util.tree_map(lambda a, b: np.asarray(a, np.float32) - b,
                                  p3, p0)
    if dtype == "f32":
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(upd)[0],
                                jax.tree_util.tree_leaves(jupd)):
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= 1e-3, (jax.tree_util.keystr(path), rel)
        return
    np.testing.assert_allclose(losses, jlosses, rtol=5e-3)
    a = np.concatenate([x.ravel() for x in jax.tree_util.tree_leaves(upd)])
    b = np.concatenate([x.ravel() for x in jax.tree_util.tree_leaves(jupd)])
    cosine = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cosine >= 0.9, cosine


def _dotted(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


@pytest.mark.parametrize("threshold", [None, 300_000, 0])
def test_leaf_order_and_buckets_match_jax_for_12_layers(threshold):
    """JAX flattens the ``layers`` list in index order (2 before 10); the
    port's ``jax_leaf_order`` must too, or from layer 10 on its buckets
    hold other leaves than the JAX plan's."""
    jcfg, tcfg = _configs("f32", "f32", d_model=128, n_heads=1,
                          n_layers=12)
    shapes = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    jnames = [_dotted(path) for path, _ in flat]
    named = convert.jax_leaf_order(ttr.Transformer(tcfg, device="cpu"))
    assert [n for n, _ in named] == jnames
    assert jnames.index("layers.2.ln1") < jnames.index("layers.10.ln1")
    # As f32 leaves (the tests' x64 mode makes init_params' leaves f64).
    jplan = jfusion.plan_buckets(
        [jax.ShapeDtypeStruct(leaf.shape, jnp.float32) for _, leaf in flat],
        threshold)
    tplan = tfusion.plan_buckets([p for _, p in named], threshold)
    assert [[named[i][0] for i in b] for b in tplan] == \
        [[jnames[i] for i in b] for b in jplan]
    if threshold == 300_000:
        assert 12 < len(tplan) < len(jnames)


def test_unported_options_raise(one_rank_world):
    """The JAX function's keywords are all accepted now (``aux_weight``
    weighs the MoE load-balance loss, and a dense model has none: the
    same step at any weight); a MoE config without an ep mesh axis is
    refused, naming the axis, not silently run dense."""
    _, tcfg = _configs("f32", "f32")
    assert "aux_weight" in inspect.signature(
        ttr.make_parallel_train_step).parameters
    toks, labels = _batch(2, 128, seed=3)
    losses = []
    for weight in (0.01, 0.5):
        init_state, step = ttr.make_parallel_train_step(
            tcfg, _adamw_torch(), device="cpu", aux_weight=weight)
        _, loss = step(init_state(0), torch.from_numpy(toks),
                       torch.from_numpy(labels))
        losses.append(float(loss))
    assert losses[0] == losses[1]
    with pytest.raises(ValueError, match="ep mesh axis"):
        ttr.make_parallel_train_step(
            ttr.TransformerConfig(**DIMS, n_experts=2), _adamw_torch(),
            device="cpu")
    for kw in (dict(accum_steps=2), dict(wire_dtype="bf16"),
               dict(guard_nonfinite=True), dict(zero=True),
               dict(overlap=True)):
        ttr.make_parallel_train_step(tcfg, _adamw_torch(), device="cpu",
                                     **kw)
    for field, value in (("loss_chunk", 64), ("remat", True)):
        cfg = ttr.TransformerConfig(**DIMS, **{field: value})
        assert getattr(cfg, field) == value


# -- two ranks ----------------------------------------------------------------

def test_two_rank_step_equals_one_rank_step_on_the_whole_batch(
        tree, tmp_path, one_rank_world):
    """f32: each rank of a 2-rank gloo world steps on half the batch; the
    world-averaged loss and the replicas' parameters equal the 1-rank
    step on the whole batch (rtol 1e-5 / atol 1e-6 of each leaf's
    largest entry: the averaged gradient sums in another order), and the
    two replicas are bit-identical."""
    _, tcfg = _configs("f32", "f32")
    toks, labels = _batch(4, 128, seed=20)
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump({"tree": tree, "tokens": toks, "labels": labels,
                     "dims": DIMS, "adamw": ADAMW}, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(torch_dist_worker.run_lm, args=(2, port, str(tmp_path)),
             nprocs=2, join=True)
    ranks = []
    for r in range(2):
        with open(tmp_path / f"lm_rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    state = create_train_state(model, _adamw_torch(), device="cpu")
    _, step = ttr.make_parallel_train_step(tcfg, _adamw_torch(),
                                           device="cpu")
    state, loss = step(state, torch.from_numpy(toks),
                       torch.from_numpy(labels))
    want = convert.params_to_numpy(model)
    for r in range(2):
        np.testing.assert_allclose(ranks[r]["loss"], float(loss), rtol=1e-5)
        _leaves_close(ranks[r]["params"], want, rtol=1e-5, atol=1e-6,
                      what=f"rank {r} ")
    _leaves_close(ranks[0]["params"], ranks[1]["params"], rtol=0, atol=0)

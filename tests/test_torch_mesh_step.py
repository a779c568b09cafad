"""Port parity: the four-axis LM train step against the JAX package's
``make_parallel_train_step``, on the CPU.

One SGD(0.1) step from the same JAX weights (``init_params(PRNGKey(0))``
cast to f32) and global batch (8 × 16 tokens), on gloo worlds of 4
(dp2×tp2, dp2×ep2 with ``n_experts=2`` and the aux loss, sp2×tp2) and 2
(sp2, and tp2 against the one-rank step), each plain, with
``accum_steps=2`` and with ``wire_dtype="bf16"``: the loss and every
global parameter (the ranks' blocks all-gathered) within rtol 2e-4 /
atol 1e-6 (tests/test_parallel.py:480's tolerance). Under the bf16 wire
the two sides round slightly different f32 gradients to bf16, so an
entry may land one bf16 step apart: there each leaf's update is held
within one bf16 ulp of its largest entry (2^-7 of it; the rule of
tests/test_torch_wire.py at the wire's own resolution, measured up to
0.45% of the largest entry here), and the loss (computed before the
exchange) within rtol 2e-4. Every rank must report the same loss and global
parameters bit for bit.

Also in the world of 4: the gradient-sync reference
(``grad_sync_by_spec``, one collective per leaf) against the fused
spec-grouped plane, and the guard: a NaN in one tp rank's gradient of a
tp-sharded leaf skips the step on every rank, bit-unchanged.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_worker
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.parallel.mesh import create_hybrid_mesh as jmesh
from horovod_tpu_torch import convert, runtime
from horovod_tpu_torch.parallel import transformer as ttr

DIMS = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
B, T, LR = 8, 16, 0.1
RTOL, ATOL = 2e-4, 1e-6
VARIANTS = {"plain": {}, "accum2": dict(accum=2), "wire_bf16":
            dict(wire="bf16")}
WORLD4 = {"dp2tp2": (dict(dp=2, tp=2), 0), "dp2ep2": (dict(dp=2, ep=2), 2),
          "sp2tp2": (dict(sp=2, tp=2), 0)}
WORLD2 = {"sp2": (dict(sp=2), 0)}

LAUNCHER_VARS = ("HVD_RANK", "PMI_RANK", "OMPI_COMM_WORLD_RANK", "HVD_SIZE",
                 "PMI_SIZE", "OMPI_COMM_WORLD_SIZE", "HVD_LOCAL_RANK",
                 "OMPI_COMM_WORLD_LOCAL_RANK")


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, DIMS["vocab"], (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  jax.device_get(tree))


def _jcfg(experts):
    return jtr.TransformerConfig(**DIMS, n_experts=experts,
                                 dtype=jnp.float32,
                                 unembed_dtype=jnp.float32,
                                 attn_backend="xla")


def _jax_step(axes, experts, accum=1, wire=None):
    n = int(np.prod(list(axes.values())))
    mesh = jmesh(**axes, devices=jax.devices()[:n])
    init_state, step = jtr.make_parallel_train_step(
        _jcfg(experts), mesh, optax.sgd(LR), wire_dtype=wire,
        accum_steps=accum)
    params, opt_state = init_state(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    tree0 = _f32(params)
    tokens, labels = _batch()
    params, _, loss = step(params, opt_state, jnp.asarray(tokens),
                           jnp.asarray(labels))
    return tree0, _f32(params), float(loss)


def _case(axes, experts, variant):
    v = VARIANTS[variant]
    tree0, tree1, loss = _jax_step(axes, experts, v.get("accum", 1),
                                   v.get("wire"))
    tokens, labels = _batch()
    mesh = dict(axes)
    mesh.setdefault("dp", 1)
    mesh.setdefault("pp", 1)
    return (dict(kind="step", mesh=mesh, dims=dict(DIMS, n_experts=experts),
                 lr=LR, tree=tree0, tokens=tokens, labels=labels, **v),
            dict(tree1=tree1, loss=loss))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree)


def _assert_tree(got, want, rtol=RTOL, atol=ATOL):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _assert_step(got, w, c):
    if c.get("wire") is None:
        _assert_tree(got, w["tree1"])
        return
    g, want = dict(_leaves(got)), dict(_leaves(w["tree1"]))
    for k, w0 in _leaves(c["tree"]):
        upd, jupd = g[k] - w0, want[k] - w0
        np.testing.assert_allclose(
            upd, jupd, rtol=0, atol=2.0 ** -7 * np.abs(jupd).max() + 1e-7,
            err_msg=k)


def _same_on_every_rank(ranks):
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        _assert_tree(r["params"], ranks[0]["params"], rtol=0, atol=0)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases, want = [], []
    for name, (axes, experts) in WORLD4.items():
        for variant in VARIANTS:
            c, w = _case(axes, experts, variant)
            cases.append(c)
            want.append((name, variant, w))
    tree0 = _jax_step(dict(dp=2, tp=2), 0)[0]
    tokens, labels = _batch(3)
    cases.append(dict(kind="guard", mesh=dict(dp=2, pp=1, tp=2),
                      dims=DIMS, tree=tree0, tokens=tokens, labels=labels))
    want.append(("guard", None, None))
    shapes = [(8, 4), (4,), (4, 6), (6, 4), (5,)]
    specs = [(None, "tp"), (), ("tp", None), (None, "tp"), ()]
    cases.append(dict(kind="sync", mesh=dict(dp=2, pp=1, tp=2),
                      shapes=shapes, specs=specs, threshold=200))
    want.append(("sync", None, None))
    got = torch_mesh_worker.spawn(4, cases, tmp_path_factory.mktemp("w4"))
    return {(n, v): (c, w, g) for (n, v, w), c, g in zip(want, cases, got)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    cases, want = [], []
    for name, (axes, experts) in WORLD2.items():
        for variant in VARIANTS:
            c, w = _case(axes, experts, variant)
            cases.append(c)
            want.append((name, variant, w))
    c, w = _case(dict(tp=2), 0, "plain")
    cases.append(c)
    want.append(("tp2", "plain", w))
    got = torch_mesh_worker.spawn(2, cases, tmp_path_factory.mktemp("w2"))
    return {(n, v): (c, w, g) for (n, v, w), c, g in zip(want, cases, got)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh_name", list(WORLD4))
def test_four_axis_step_matches_jax_world4(world4, mesh_name, variant):
    c, w, ranks = world4[(mesh_name, variant)]
    _same_on_every_rank(ranks)
    np.testing.assert_allclose(ranks[0]["loss"], w["loss"], rtol=RTOL,
                               atol=ATOL)
    _assert_step(ranks[0]["params"], w, c)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sp2_step_matches_jax(world2, variant):
    c, w, ranks = world2[("sp2", variant)]
    _same_on_every_rank(ranks)
    np.testing.assert_allclose(ranks[0]["loss"], w["loss"], rtol=RTOL,
                               atol=ATOL)
    _assert_step(ranks[0]["params"], w, c)


def test_tp2_step_matches_tp1_and_jax(world2, monkeypatch):
    """tp=2 in a world of 2 against the one-rank (tp=1) step on the
    whole batch in this process, and against JAX."""
    c, w, ranks = world2[("tp2", "plain")]
    _same_on_every_rank(ranks)
    for var in LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    try:
        cfg = ttr.TransformerConfig(**DIMS, dtype=torch.float32,
                                    unembed_dtype=torch.float32,
                                    attn_backend="xla")
        init_state, step = ttr.make_parallel_train_step(
            cfg, functools.partial(torch.optim.SGD, lr=LR), device="cpu")
        state = init_state(model=convert.params_from_jax(c["tree"], cfg,
                                                         device="cpu"))
        state, loss = step(state, torch.from_numpy(c["tokens"]),
                           torch.from_numpy(c["labels"]))
        tp1 = convert.params_to_numpy(state.model)
    finally:
        runtime.shutdown()
    np.testing.assert_allclose(ranks[0]["loss"], float(loss), rtol=RTOL,
                               atol=ATOL)
    _assert_tree(ranks[0]["params"], tp1)
    np.testing.assert_allclose(ranks[0]["loss"], w["loss"], rtol=RTOL,
                               atol=ATOL)
    _assert_tree(ranks[0]["params"], w["tree1"])


def test_guard_skips_on_every_rank_bit_identically(world4):
    _, _, ranks = world4[("guard", None)]
    for r in ranks:
        assert r["same"] and r["skipped_loss"] == 0.0
        assert r["changed"] and np.isfinite(r["next_loss"])


def test_grad_sync_reference_matches_the_fused_plan(world4):
    """``grad_sync_by_spec`` (per leaf: mean over the replicated axes,
    then ÷tp for tp-sharded leaves) and the plane's fused buckets (one
    sum per bucket, prescaled by 1/denom) agree to f32 rounding, and
    the plan keeps tp-sharded and replicated leaves in separate
    buckets."""
    c, _, ranks = world4[("sync", None)]
    for r in ranks:
        for a, b in zip(r["plan"], r["ref"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        for bucket in r["buckets"]:
            assert len({"tp" in c["specs"][j] for j in bucket}) == 1

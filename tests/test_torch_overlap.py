"""Port parity: backward-overlapped bucket collectives (``ops.fusion``
``BucketSchedule``/``plan_schedule``, ``probe_grad_order``,
``zero_emit_order``, ``OverlapExchange``; ``DistributedOptimizer(
overlap=)``; ``make_train_step(overlap=)``) against the JAX package, on
the CPU.

* ``plan_schedule`` and ``zero_emit_order`` equal JAX's for the same
  leaves and order; a non-permutation is refused; a threshold flip
  re-plans.
* The probe: on a 3-layer MLP the port's landing order is JAX's
  ``probe_grad_order``'s (last layer first); on the tiny LM both put
  every leaf of the last layer before every leaf of the first, through
  the leaf names ``convert.jax_leaf_order`` shares with the JAX tree.
  JAX's probe reads ``jax.core.Var``, which jax 0.9 no longer exports:
  the test points it at ``jax.extend.core.Var`` (the JAX package is not
  changed).
* The overlapped step against the plain one, f32: bitwise at world 1
  (MLP and LM, all-reduce and ZeRO planes); in gloo worlds of 2 and 4
  (``torch_dist_worker.run_overlap``) bitwise whenever bucket membership
  is the plain plan's (ZeRO, one bucket per leaf) and at world 2 (a
  2-term sum does not depend on order); where the all-reduce plane
  regroups its buckets at world 4, gloo's ring sums each element in an
  order set by its offset in the bucket, so within f32 rounding (rtol
  1e-6, atol 1e-7). Replicas bit-identical; the same collectives per
  step; accumulation, remat, and the guard with a bf16 wire compose
  (the skip bit-unchanged, no extra collective); an armed backward with
  no exchange is drained at ``zero_grad``.
* ``HVD_OVERLAP``/``HVD_ZERO`` defaults and the refusals.
"""

import functools
import pickle
import socket

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu_torch import convert, runtime
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.optimizer import DistributedOptimizer
from horovod_tpu_torch.parallel import transformer as ttr
from horovod_tpu_torch.training import create_train_state, make_train_step

THRESH = 8000            # the JAX overlap tests' threshold
LM_DIMS = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)
ROUNDING = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture
def one_rank_world(monkeypatch):
    for var in ("HVD_RANK", "PMI_RANK", "OMPI_COMM_WORLD_RANK", "HVD_SIZE",
                "PMI_SIZE", "OMPI_COMM_WORLD_SIZE", "HVD_LOCAL_RANK",
                "OMPI_COMM_WORLD_LOCAL_RANK", "HVD_ZERO", "HVD_OVERLAP",
                "HVD_GUARD_NONFINITE", "HVD_WIRE_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    yield
    runtime.shutdown()


def _lm_leaves(n_layers=12):
    jcfg = jtr.TransformerConfig(vocab=128, d_model=128, n_heads=1,
                                 n_layers=n_layers, d_ff=256,
                                 dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    return [jax.ShapeDtypeStruct(s.shape, jnp.float32)
            for s in jax.tree_util.tree_leaves(shapes)]


def _torch_like(leaves):
    return [torch.empty(tuple(s.shape)) for s in leaves]


@pytest.mark.parametrize("threshold", [None, 300_000, 0])
@pytest.mark.parametrize("kind", ["reversed", "shuffled", "flatten"])
def test_plan_schedule_and_emit_order_match_jax(threshold, kind):
    leaves = _lm_leaves()
    n = len(leaves)
    order = {"reversed": tuple(range(n))[::-1],
             "shuffled": tuple(np.random.RandomState(0).permutation(n)),
             "flatten": None}[kind]
    js = jfusion.plan_schedule(leaves, order, threshold)
    ts = tfusion.plan_schedule(_torch_like(leaves), order, threshold)
    assert (ts.buckets, ts.order, ts.threshold) == \
        (js.buckets, js.order, js.threshold)
    jplan = jfusion.plan_zero(leaves, 4, threshold)
    tplan = tfusion.plan_zero(_torch_like(leaves), 4, threshold)
    assert tfusion.zero_emit_order(tplan, order) == \
        jfusion.zero_emit_order(jplan, order)


def test_plan_schedule_refuses_a_non_permutation():
    ts = [torch.zeros(3), torch.zeros(4)]
    with pytest.raises(ValueError, match="permutation"):
        tfusion.plan_schedule(ts, (0, 0))


def test_threshold_env_flip_replans_the_schedule(monkeypatch):
    leaves = _lm_leaves()
    order = tuple(range(len(leaves)))[::-1]
    for raw in ("0", "300000"):
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", raw)
        assert tfusion.plan_schedule(_torch_like(leaves), order).buckets \
            == jfusion.plan_schedule(leaves, order).buckets


def _jax_probe(monkeypatch, grad_fn, *args):
    monkeypatch.setattr(jax.core, "Var", jax.extend.core.Var,
                        raising=False)
    return jfusion.probe_grad_order(grad_fn, *args)


def test_probe_ranks_the_last_layer_first_as_jax(monkeypatch):
    rng = np.random.RandomState(0)
    ws = [rng.randn(8, 8).astype(np.float32) * 0.3 for _ in range(3)]
    x = np.ones((4, 8), np.float32)

    def jloss(p, x):
        h = x
        for i in range(3):
            h = jnp.tanh(h @ p[f"w{i}"])
        return jnp.sum(h)
    jorder = _jax_probe(monkeypatch,
                        lambda q: jax.grad(jloss)(q, jnp.asarray(x)),
                        {f"w{i}": jnp.asarray(w) for i, w in enumerate(ws)})
    params = [torch.tensor(w, requires_grad=True) for w in ws]

    def backward():
        h = torch.from_numpy(x)
        for p in params:
            h = torch.tanh(h @ p)
        h.sum().backward()
    assert tfusion.probe_grad_order(params, backward) == jorder == (2, 1, 0)
    assert tfusion.probe_grad_order(params, lambda: None) is None


def test_lm_probe_puts_the_last_layer_first_as_jax(monkeypatch):
    jcfg = jtr.TransformerConfig(**LM_DIMS, dtype=jnp.float32)
    tcfg = ttr.TransformerConfig(**LM_DIMS, dtype=torch.float32,
                                 attn_backend="xla")
    params = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                    params)
    toks = np.random.RandomState(0).randint(0, 64, (2, 16))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))

    def jloss(p):
        logits, _ = jtr.forward(p, jnp.asarray(toks), jcfg, mesh)
        return jnp.mean(jtr.dense_nll(logits, jnp.asarray(toks)))
    jorder = _jax_probe(monkeypatch, jax.grad(jloss), params)
    model = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    named = convert.jax_leaf_order(model)
    torder = tfusion.probe_grad_order(
        [p for _, p in named],
        lambda: ttr.lm_loss(ttr.gen_weights(model), torch.from_numpy(toks),
                            torch.from_numpy(toks), tcfg).backward())
    names = [n for n, _ in named]
    for order in (jorder, torder):
        pos = {names[j]: k for k, j in enumerate(order)}
        last = [pos[n] for n in names if n.startswith("layers.1.")]
        first = [pos[n] for n in names if n.startswith("layers.0.")]
        assert max(last) < min(first), order
        assert pos["embed"] > max(first)     # the tied leaf lands last


def _mlp_state(**kw):
    return create_train_state(
        torch_dist_worker._MLP(widths=(64, 64, 64, 10)),
        torch_dist_worker.OPTS["adamw"], fusion_threshold=THRESH,
        device="cpu", **kw)


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
def test_world_one_overlap_is_bitwise_the_plain_step(zero, accum,
                                                     one_rank_world):
    rng = np.random.RandomState(0)
    batches = [(torch.from_numpy(rng.randn(8, 8).astype(np.float32)),
                torch.from_numpy(rng.randint(0, 10, 8))) for _ in range(3)]
    out = {}
    for overlap in (False, True):
        state = _mlp_state(zero=zero, overlap=overlap)
        step = make_train_step(accum_steps=accum)
        for b in batches:
            state, _ = step(state, b)
        out[overlap] = [p.detach().clone() for p in state.model.parameters()]
        if overlap:
            assert state.optimizer.grad_order_source == "probed"
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))


def test_world_one_lm_overlap_is_bitwise_the_plain_step(one_rank_world):
    cfg = ttr.TransformerConfig(**LM_DIMS, dtype=torch.float32,
                                attn_backend="xla")
    rng = np.random.RandomState(1)
    toks = [torch.from_numpy(rng.randint(0, 64, (2, 16))) for _ in range(3)]
    out = {}
    for kw in (dict(), dict(overlap=True), dict(zero=True, overlap=True)):
        init_state, step = ttr.make_parallel_train_step(
            cfg, torch_dist_worker.OPTS["adamw"], fusion_threshold=20_000,
            device="cpu", **kw)
        state = init_state(0)
        for t in toks:
            state, loss = step(state, t, t)
        out[tuple(kw)] = [p.detach().clone()
                          for p in state.model.parameters()]
    for k, v in out.items():
        assert all(torch.equal(a, b) for a, b in zip(out[()], v)), k


# -- gloo worlds of 2 and 4 -------------------------------------------------------

def _spawn(world, tmp_path_factory):
    workdir = tmp_path_factory.mktemp(f"torch_overlap{world}")
    rng = np.random.RandomState(world)
    inp = {"x": rng.randn(3, 16, 8).astype(np.float32),
           "y": rng.randint(0, 10, (3, 16)).astype(np.int64),
           "threshold": THRESH}
    with open(workdir / "overlap_inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(torch_dist_worker.run_overlap,
             args=(world, port, str(workdir)), nprocs=world, join=True)
    ranks = []
    for r in range(world):
        with open(workdir / f"overlap_rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return world, ranks


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    return _spawn(request.param, tmp_path_factory)


def _params_equal(a, b):
    for k, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][k], v, err_msg=k)


@pytest.mark.parametrize("plain,overlapped,regrouped", [
    ("plain", "overlap", True), ("plain_t0", "overlap_t0", False),
    ("zero", "zero_overlap", False), ("accum", "accum_overlap", True),
    ("accum_t0", "accum_overlap_t0", False),
    ("remat", "remat_overlap", True),
])
def test_overlap_matches_the_plain_step(world, plain, overlapped,
                                        regrouped):
    n, ranks = world
    for got in ranks:
        a, b = got[plain], got[overlapped]
        assert b["source"] == "probed"
        if regrouped and n > 2:
            for k, v in a["params"].items():
                np.testing.assert_allclose(b["params"][k], v, **ROUNDING,
                                           err_msg=k)
        else:
            _params_equal(a, b)
        _params_equal(ranks[0][overlapped], b)
        # After the probe step: the same collectives as the plain step.
        assert b["steps"][-1]["counts"] == a["steps"][-1]["counts"]


def test_the_probed_order_is_rank_zeros_on_every_rank(world):
    n, ranks = world
    order = ranks[0]["overlap"]["order"]
    assert sorted(order) == list(range(8))
    assert order[:2] in ((6, 7), (7, 6))       # the last Dense lands first
    for got in ranks:
        assert got["overlap"]["order"] == order
        assert got["zero_overlap"]["order"] == order


@pytest.mark.parametrize("name", ["guard_bf16_overlap",
                                  "zero_guard_bf16_overlap"])
def test_guard_and_wire_compose_with_overlap(world, name):
    n, ranks = world
    for got in ranks:
        steps = got[name]["steps"]
        assert [s["bad_step"] for s in steps] == [0.0, 1.0, 0.0]
        assert [s["unchanged"] for s in steps] == [False, True, False]
        # The guard adds no collective: the skipped step's count is the
        # finite steps'.
        assert steps[1]["counts"] == steps[2]["counts"]
        plain = got["guard_bf16"]["steps"]
        if name == "guard_bf16_overlap":
            assert steps[2]["counts"] == plain[2]["counts"]
            for k, v in got["guard_bf16"]["params"].items():
                np.testing.assert_allclose(got[name]["params"][k], v,
                                           rtol=2 ** -7, atol=1e-6)
        _params_equal(ranks[0][name], got[name])


def test_an_armed_backward_is_drained_at_zero_grad(world):
    _, ranks = world
    for got in ranks:
        d = got["drain"]
        assert d["in_flight"] > 0 and d["after"] == 0 and not d["armed"]


# -- defaults and refusals -------------------------------------------------------

def test_env_defaults_arm_overlap_and_zero(monkeypatch, one_rank_world):
    monkeypatch.setenv("HVD_OVERLAP", "1")
    state = _mlp_state()
    assert state.optimizer.overlap and not state.optimizer.zero
    step = make_train_step()
    batch = (torch.ones(4, 8), torch.zeros(4, dtype=torch.int64))
    state, _ = step(state, batch)
    assert state.optimizer.grad_order_source == "probed"
    monkeypatch.setenv("HVD_ZERO", "1")
    state = _mlp_state()
    assert state.optimizer.overlap and state.optimizer.zero
    state, _ = make_train_step()(state, batch)
    assert state.optimizer.grad_order_source == "probed"
    monkeypatch.delenv("HVD_OVERLAP")
    monkeypatch.delenv("HVD_ZERO")
    # The step arms overlap on an optimizer built without it.
    state = _mlp_state()
    assert not state.optimizer.overlap
    state, _ = make_train_step(overlap=True)(state, batch)
    assert state.optimizer.overlap
    assert state.optimizer.grad_order_source == "probed"


def test_overlap_refusals(one_rank_world):
    model = torch_dist_worker._MLP()
    with pytest.raises(ValueError, match="no process-group argument.*mesh="):
        DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                             overlap=True,
                             process_group=torch.distributed.group.WORLD)

    class Half(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(8, 10,
                                                   dtype=torch.bfloat16))

        def forward(self, x, train=True):
            return x.to(torch.bfloat16) @ self.w
    state = create_train_state(Half(), functools.partial(
        torch.optim.SGD, lr=0.1), overlap=True, device="cpu")
    with pytest.raises(ValueError, match="f32 gradients"):
        make_train_step(accum_steps=2)(state, (
            torch.ones(4, 8), torch.zeros(4, dtype=torch.int64)))
    emb = torch.nn.Embedding(10, 4, sparse=True)
    opt = DistributedOptimizer(torch.optim.SGD(emb.parameters(), lr=0.1),
                               overlap=True)
    opt.arm()
    with pytest.raises(ValueError, match="sparse_as_dense"):
        emb(torch.tensor([1, 2])).sum().backward()

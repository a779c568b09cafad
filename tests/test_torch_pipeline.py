"""Port parity: the pipelined LM family (1F1B) against the JAX package, on
the CPU.

* ``one_f_one_b`` on the toy tanh stage of tests/test_parallel.py
  ``TestOneFOneB`` (mb 3, width 8, mean-squared loss) on gloo worlds of
  S=2 and S=4 and in one process at S=1, against JAX ``one_f_one_b`` on
  as many CPU devices: M=6, M=2 < S, a loss head and the input-gradient
  accumulator. Loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6 (the JAX
  test's own tolerances against sequential autodiff).
* ``make_pp_transformer_train_step``: one SGD(0.1) step against the JAX
  step from the same weights (JAX ``init_pp_params``, cast to f32) and
  batch, at pp=1 (a hand-built JAX ``Mesh`` with a size-1 pp axis: the
  card's configuration), pp=2 and dp=2 × pp=2, at two widths:
  - f32 with ``attn_backend="xla"`` (tests/test_parallel.py
    ``TestPPTransformer``'s config, 8 × 8 tokens, 4 microbatches): loss
    rtol 2e-5 / atol 1e-6, parameters rtol 2e-4 / atol 1e-6 (that test's
    tolerances);
  - bf16 with ``"pallas"`` (vocab 128, d_model 256, 2 heads of 128, 2
    layers, 4 × 128 tokens, 2 microbatches; the JAX side runs K6 in
    interpret mode, the port the plain versions of its kernels): loss
    rtol 2e-4 and each leaf's update within 0.05 in relative L2. Both
    sides round activations to bf16 at the same points but at other
    internal precisions (as tests/test_torch_lm_training.py's bf16
    tests), which measured at most 3.0e-5 on the loss and 0.0093 on the
    worst leaf's update over the three meshes.
  Every stage of a dp row and every dp replica must agree exactly.
* The gradient-sync plan: ``plan_grad_sync`` decisions and bucket
  membership against JAX's ``plan_grad_sync`` + ``plan_buckets`` on the
  pp tree.

All multi-rank checks of one world size run in one spawn
(``torch_dist_worker.run_pp``).
"""

import functools
import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_dist_worker
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel import pp_transformer as jpp
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.parallel.mesh import create_hybrid_mesh
from horovod_tpu.parallel.pipeline import one_f_one_b as jax_one_f_one_b
from horovod_tpu_torch import convert, runtime
from horovod_tpu_torch.ops import LAUNCHES
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import pipeline as tpipe
from horovod_tpu_torch.parallel import pp_transformer as tpp
from horovod_tpu_torch.parallel import transformer as ttr

MB, W = 3, 8                      # toy microbatch rows and width
# world size -> toy cases (S = the world): (M, head, input grads, seed)
TOY = {1: [(3, True, True, 4)],
       2: [(6, True, True, 1)],
       4: [(6, False, False, 0), (2, True, True, 3)]}
WIDTHS = {
    "f32": dict(dims=dict(vocab=64, d_model=32, n_heads=4, n_layers=4,
                          d_ff=64), dtype="float32", backend="xla",
                B=8, T=8, M=4),
    "bf16": dict(dims=dict(vocab=128, d_model=256, n_heads=2, n_layers=2,
                           d_ff=256), dtype="bfloat16", backend="pallas",
                 B=4, T=128, M=2),
}
# world size -> (dp, pp) of the train-step cases
STEP_MESH = {1: (1, 1), 2: (1, 2), 4: (2, 2)}
LR = 0.1


# -- the JAX side -------------------------------------------------------------

def _toy_inputs(S, M, head, seed):
    rng = np.random.RandomState(seed)
    ws = (rng.randn(S, W, W) * 0.3).astype(np.float32)
    x = rng.randn(M, MB, W).astype(np.float32)
    y = rng.randn(M, MB, W).astype(np.float32)
    h = (rng.randn(W, W) * 0.2).astype(np.float32) if head else None
    return ws, x, y, h


def _jax_mesh(dp, pp):
    devs = jax.devices()[:dp * pp]
    if pp == 1:     # create_hybrid_mesh drops size-1 axes
        return Mesh(np.array(devs).reshape(dp, pp), ("dp", "pp"))
    return create_hybrid_mesh(dp=dp, pp=pp, devices=devs)


def _jax_toy(S, M, head, input_grads, seed):
    """JAX ``one_f_one_b`` on S CPU devices: ``(loss, grads [S, W, W],
    head grads | None, acc | None, x grads | None)``, the per-stage
    outputs summed over pp as the callers do."""
    ws, x, y, h = _toy_inputs(S, M, head, seed)
    mesh = _jax_mesh(1, S)

    def loss_fn(act, yy, hh=None):
        return jnp.mean(((act if hh is None else act @ hh) - yy) ** 2)

    def wrapped(w, xx, yy, hh):
        kw = {}
        if head:
            kw["head_params"] = hh
        if input_grads:
            kw["input_grad_acc"] = (jnp.zeros_like(xx[0]),
                                    lambda acc, i, din: acc + din)
            kw["return_input_grads"] = True
        out = jax_one_f_one_b(lambda p, a: jnp.tanh(a @ p), w[0], xx, yy,
                              loss_fn, axis_name="pp", **kw)
        return (out[0], out[1][None],
                *(jax.lax.psum(t, "pp") for t in out[2:]))

    n_rest = int(head) + 2 * int(input_grads)
    f = jax.jit(jax.shard_map(
        wrapped, mesh=mesh, in_specs=(P("pp", None, None), P(), P(), P()),
        out_specs=(P(), P("pp", None, None)) + (P(),) * n_rest,
        check_vma=False))
    out = [np.asarray(t) for t in f(ws, x, y, h if head else ws[0])]
    rest = iter(out[2:])
    return (float(out[0]), out[1], next(rest) if head else None,
            *((next(rest), next(rest)) if input_grads else (None, None)))


def _jax_step(width, dp, pp):
    """One JAX pipelined SGD step from ``init_pp_params(PRNGKey(0))``
    (cast to f32): ``(initial tree, updated tree, loss, tokens,
    labels)``, numpy."""
    w = WIDTHS[width]
    jdt = getattr(jnp, w["dtype"])
    cfg = jtr.TransformerConfig(**w["dims"], dtype=jdt, unembed_dtype=jdt,
                                attn_backend=w["backend"])
    init_state, step = jpp.make_pp_transformer_train_step(
        cfg, _jax_mesh(dp, pp), optax.sgd(LR), n_microbatches=w["M"])
    params, opt_state = init_state(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    tree0 = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                   jax.device_get(params))
    rng = np.random.RandomState(dp * 10 + pp)
    tokens = rng.randint(0, w["dims"]["vocab"], (w["B"], w["T"])).astype(
        np.int32)
    labels = np.roll(tokens, -1, axis=1)
    params, _, loss = step(params, opt_state, jnp.asarray(tokens),
                           jnp.asarray(labels))
    tree1 = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                   jax.device_get(params))
    return tree0, tree1, float(loss), tokens, labels


# -- the port's side ----------------------------------------------------------

def _cases(world):
    """The worker's cases for a world size, and what to compare each
    with (the JAX results)."""
    cases, want = [], []
    for M, head, input_grads, seed in TOY[world]:
        ws, x, y, h = _toy_inputs(world, M, head, seed)
        cases.append(dict(kind="1f1b", dp=1, pp=world, ws=ws, x=x, y=y,
                          head=h, input_grads=input_grads))
        want.append(_jax_toy(world, M, head, input_grads, seed))
    dp, pp = STEP_MESH[world]
    for width, w in WIDTHS.items():
        tree0, tree1, loss, tokens, labels = _jax_step(width, dp, pp)
        cases.append(dict(kind="step", dp=dp, pp=pp, dims=w["dims"],
                          dtype=w["dtype"], backend=w["backend"], M=w["M"],
                          lr=LR, tree=tree0, tokens=tokens, labels=labels))
        want.append((width, tree0, tree1, loss))
    return cases, want


def _spawn(world, cases, tmp_path):
    with open(tmp_path / "pp_inputs.pkl", "wb") as f:
        pickle.dump(cases, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(torch_dist_worker.run_pp, args=(world, port, str(tmp_path)),
             nprocs=world, join=True)
    ranks = []
    for r in range(world):
        with open(tmp_path / f"pp_rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return [[ranks[r][i] for r in range(world)] for i in range(len(cases))]


LAUNCHER_VARS = ("HVD_RANK", "PMI_RANK", "OMPI_COMM_WORLD_RANK", "HVD_SIZE",
                 "PMI_SIZE", "OMPI_COMM_WORLD_SIZE", "HVD_LOCAL_RANK",
                 "OMPI_COMM_WORLD_LOCAL_RANK")


@pytest.fixture
def one_rank_world(monkeypatch):
    for var in LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    runtime.init(device="cpu")
    yield
    runtime.shutdown()


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda w: f"world{w}")
def world_results(request, tmp_path_factory):
    """Every case of a world size: ``(world, cases' JAX results, per case
    the list of each rank's result)``. World 1 runs in this process."""
    world = request.param
    cases, want = _cases(world)
    if world == 1:
        with pytest.MonkeyPatch.context() as mp_:
            for var in LAUNCHER_VARS:
                mp_.delenv(var, raising=False)
            runtime.init(device="cpu")
            try:
                got = [[torch_dist_worker._pp_case(c, torch_dist_worker._np)]
                       for c in cases]
            finally:
                runtime.shutdown()
    else:
        got = _spawn(world, cases, tmp_path_factory.mktemp(f"pp{world}"))
    return world, want, got


# -- tests --------------------------------------------------------------------

def test_one_f_one_b_matches_jax(world_results):
    world, want, got = world_results
    n_toy = len(TOY[world])
    for (M, head, input_grads, _), w, ranks in zip(TOY[world], want[:n_toy],
                                                   got[:n_toy]):
        loss, grads, head_g, acc, xg = w
        by_stage = sorted(ranks, key=lambda r: r["stage"])
        for r in by_stage:
            np.testing.assert_allclose(r["out"][0], loss, rtol=1e-5)
        np.testing.assert_allclose(
            np.stack([r["out"][1] for r in by_stage]), grads, rtol=1e-4,
            atol=1e-6)
        rest = [np.sum([r["out"][i] for r in by_stage], axis=0)
                for i in range(2, len(by_stage[0]["out"]))]
        for got_t, want_t in zip(rest, [t for t in (head_g, acc, xg)
                                        if t is not None]):
            np.testing.assert_allclose(got_t, want_t, rtol=1e-4, atol=1e-6)
        assert len(rest) == int(head) + 2 * int(input_grads)


def _update_rel_l2(got, want, tree0):
    a, b = got - tree0, want - tree0
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_pp_step_matches_jax(world_results, width):
    world, want, got = world_results
    i = len(TOY[world]) + list(WIDTHS).index(width)
    (_, tree0, tree1, loss), ranks = want[i], got[i]
    dp, pp = STEP_MESH[world]
    assert sorted((r["dp"], r["stage"]) for r in ranks) == \
        [(d, s) for d in range(dp) for s in range(pp)]
    # Every stage and every dp replica agree exactly where they share.
    for r in ranks:
        assert r["loss"] == ranks[0]["loss"]
        for k in ("embed", "lnf"):
            np.testing.assert_array_equal(r["params"][k],
                                          ranks[0]["params"][k])
        twin = next(x for x in ranks if x["stage"] == r["stage"])
        for k, v in r["params"]["stages"].items():
            np.testing.assert_array_equal(v, twin["params"]["stages"][k])
    row = sorted((r for r in ranks if r["dp"] == 0),
                 key=lambda r: r["stage"])
    got_tree = {"embed": row[0]["params"]["embed"],
                "lnf": row[0]["params"]["lnf"],
                "stages": {k: np.stack([r["params"]["stages"][k]
                                        for r in row])
                           for k in tree1["stages"]}}
    leaves = [("embed",), ("lnf",)] + [("stages", k) for k in
                                       tree1["stages"]]

    def at(tree, path):
        for key in path:
            tree = tree[key]
        return tree
    if width == "f32":
        np.testing.assert_allclose(ranks[0]["loss"], loss, rtol=2e-5,
                                   atol=1e-6)
        for path in leaves:
            np.testing.assert_allclose(at(got_tree, path), at(tree1, path),
                                       rtol=2e-4, atol=1e-6,
                                       err_msg=".".join(path))
        return
    np.testing.assert_allclose(ranks[0]["loss"], loss, rtol=2e-4)
    for path in leaves:
        rel = _update_rel_l2(at(got_tree, path), at(tree1, path),
                             at(tree0, path))
        assert rel <= 0.05, (".".join(path), rel)


@pytest.mark.parametrize("threshold", [None, 40_000, 0])
def test_grad_sync_plan_and_buckets_match_jax(threshold):
    """The pp step's plan: every leaf sums over dp only (pp skipped), one
    group, with the JAX decision's denominator; buckets hold the JAX
    plan's leaves (JAX's leaves are a rank's ``[1, lps, ...]`` blocks,
    the port's its ``[lps, ...]`` slices: the same bytes)."""
    w = WIDTHS["f32"]
    jcfg = jtr.TransformerConfig(**w["dims"], dtype=jnp.float32)
    jmesh = _jax_mesh(2, 2)
    jspecs = jax.tree_util.tree_flatten(
        jpp.pp_param_specs(jmesh), is_leaf=lambda x: isinstance(x, P))[0]
    jsyncs = jfusion.plan_grad_sync(jspecs, jmesh, skip_axes=("pp",))
    shapes = jax.eval_shape(lambda: jpp.init_pp_params(
        jax.random.PRNGKey(0), jcfg, 2))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    names = [".".join(str(k.key) for k in path) for path, _ in flat]
    local = [(leaf.shape[0] // 2,) + leaf.shape[1:] if name.startswith(
        "stages") else leaf.shape for name, (_, leaf) in zip(names, flat)]
    jplan = jfusion.plan_buckets(
        [jax.ShapeDtypeStruct(s, jnp.float32) for s in local], threshold,
        groups=jsyncs)

    tcfg = ttr.TransformerConfig(**w["dims"], dtype=torch.float32)
    tmesh_ = tmesh.Mesh(axis_names=("dp", "pp"), shape={"dp": 2, "pp": 2},
                        coords={"dp": 0, "pp": 0}, ranks={},
                        groups={})
    tspecs = tpp.pp_param_specs(tmesh_)
    named = tpp.named_leaves(tpp.init_pp_params(
        torch.Generator().manual_seed(0), tcfg, 2, 0, device="cpu"))
    assert [n for n, _ in named] == names
    tsyncs = tfusion.plan_grad_sync(
        [tspecs["embed"], tspecs["lnf"]] + [tspecs["stages"][n[7:]]
                                            for n, _ in named[2:]],
        tmesh_, skip_axes=("pp",))
    assert tsyncs == [tfusion.GradSync(psum=s.psum, shard=s.shard,
                                       denom=s.denom) for s in jsyncs]
    assert {s.psum for s in tsyncs} == {("dp",)}
    tplan = tfusion.plan_buckets([p for _, p in named], threshold)
    assert [[names[i] for i in b] for b in tplan] == \
        [[names[i] for i in b] for b in jplan]
    if threshold == 40_000:
        assert 1 < len(tplan) < len(names)


def test_mesh_layout_and_validation(one_rank_world):
    """A 1-rank world holds the dp=1 × pp=1 mesh (both axes kept, the
    world group on each); any other shape is refused."""
    mesh = tmesh.create_hybrid_mesh(dp=1, pp=1)
    assert mesh.axis_names == ("dp", "pp")
    assert mesh.shape == {"dp": 1, "pp": 1}
    assert mesh.coords == {"dp": 0, "pp": 0}
    assert mesh.ranks == {"dp": (0,), "pp": (0,)}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.create_hybrid_mesh(dp=1, pp=2)
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.create_hybrid_mesh(dp=0, pp=1)


def test_unported_keywords_raise(one_rank_world):
    """Every keyword of the JAX step is ported now: ZeRO and overlap (at
    world 1 bitwise the plain step), the wire and the guard; what raises
    is a batch that does not split into microbatches."""
    w = WIDTHS["f32"]
    cfg = ttr.TransformerConfig(**w["dims"], dtype=torch.float32,
                                attn_backend="xla")
    mesh = tmesh.create_hybrid_mesh(dp=1, pp=1)
    sgd = functools.partial(torch.optim.SGD, lr=LR, momentum=0.9,
                            foreach=False)
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab, (4, 8)))
    runs = {}
    for name, kw in (("plain", {}), ("zero", dict(zero=True)),
                     ("overlap", dict(overlap=True))):
        init_state, step = tpp.make_pp_transformer_train_step(
            cfg, mesh, sgd, 2, device="cpu", **kw)
        state = init_state(0)
        for _ in range(2):
            state, loss = step(state, toks, torch.roll(toks, -1, 1))
        runs[name] = (float(loss), [p.detach().clone() for _, p in
                                    tpp.named_leaves(state.params)])
        assert state.optimizer.zero == (name == "zero")
    for name in ("zero", "overlap"):
        assert runs[name][0] == runs["plain"][0]
        assert all(torch.equal(a, b) for a, b in
                   zip(runs[name][1], runs["plain"][1])), name
    for kw in (dict(wire_dtype="bf16"), dict(guard_nonfinite=True)):
        tpp.make_pp_transformer_train_step(cfg, mesh, sgd, 2, device="cpu",
                                           **kw)
    init_state, step = tpp.make_pp_transformer_train_step(cfg, mesh, sgd, 3,
                                                          device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        step(init_state(0), torch.zeros((4, 8), dtype=torch.int64),
             torch.zeros((4, 8), dtype=torch.int64))


def test_pp1_step_trains_and_launches_nothing_on_cpu(one_rank_world):
    """Three AdamW steps of the bf16 "pallas" width at pp=1 on a repeated
    batch: the loss falls, the plain versions run (no launch counted),
    and the parameters carry back through ``pp_params_to_numpy``."""
    w = WIDTHS["bf16"]
    cfg = ttr.TransformerConfig(**w["dims"], dtype=torch.bfloat16,
                                unembed_dtype=torch.bfloat16)
    mesh = tmesh.create_hybrid_mesh(dp=1, pp=1)
    init_state, step = tpp.make_pp_transformer_train_step(
        cfg, mesh, functools.partial(torch.optim.AdamW, lr=1e-2), w["M"],
        device="cpu")
    state = init_state(0)
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, w["dims"]["vocab"], (w["B"], w["T"])))
    before = LAUNCHES.snapshot()
    losses = []
    for _ in range(3):
        state, loss = step(state, toks, toks.roll(-1, 1))
        losses.append(float(loss))
    assert LAUNCHES.snapshot() == before
    assert state.step == 3 and losses[-1] < losses[0], losses
    tree, stage = convert.pp_params_to_numpy(state.params, mesh)
    assert stage == 0
    assert tree["stages"]["wqkv"].shape == (2, 256, 768)
    np.testing.assert_array_equal(
        tree["embed"], state.params["embed"].detach().numpy())


def test_pipeline_flatten_round_trips_in_jax_order():
    tree = {"b": torch.ones(2), "a": [torch.zeros(1), (torch.ones(3),)]}
    leaves, rebuild = tpipe._flatten(tree)
    assert [t.shape[0] for t in leaves] == [1, 3, 2]     # a.0, a.1.0, b
    back = rebuild(leaves)
    assert back.keys() == tree.keys() and isinstance(back["a"][1], tuple)

"""Port parity: the mesh and the tp / sp / ep / pp modules against the JAX
package, on the CPU.

* The layers, in gloo worlds of 2 and 4 (one spawn each,
  ``torch_mesh_worker``), against the JAX functions under ``shard_map``
  on as many CPU devices, forwards and gradients (the gradients follow
  JAX's full-manual transposes: ``psum``'s is ``psum``):
  - the tp column/row pair (tests/test_parallel.py ``TestTensorParallel``,
    rtol 1e-4);
  - ring and Ulysses attention, causal and not (rtol 2e-4, atol 2e-5);
  - ``moe_ffn`` (rtol 2e-4, atol 2e-5; routing decisions equal);
  - ``gpipe`` forward and gradients of the JAX test's pmean loss
    (rtol 1e-5, atol 1e-6).
* ``plan_grad_sync`` and the spec-grouped bucket plan against JAX's,
  field for field, on dp×tp, dp×ep, sp×tp and dp×pp×tp meshes (pp
  skipped), and the MoE capacity expression.
* The mesh helpers at one rank, and what the hybrid plane now runs
  there (the hybrid plan of a size-1 non-scatter axis, overlap on the
  spec-grouped plane, ``zero``/``overlap`` on the pipelined and
  four-axis steps).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import torch_mesh_worker
from horovod_tpu import parallel as jparallel
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel import pp_transformer as jpp
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu.parallel.mesh import create_hybrid_mesh as jmesh
from horovod_tpu_torch import runtime
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.optimizer import DistributedOptimizer
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import moe as tmoe
from horovod_tpu_torch.parallel import pp_transformer as tpp
from horovod_tpu_torch.parallel import transformer as ttr

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


def _f32(*shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _smap(fn, axis, n, in_specs, out_specs):
    mesh = jmesh(**{axis: n}, devices=jax.devices()[:n])
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


# -- the JAX side of each layer case --------------------------------------------

def _case_tp(n):
    D, F = 8, 16
    c = dict(kind="tp", mesh={"tp": n}, x=_f32(3, D, seed=0),
             w1=_f32(D, F, seed=1), w2=_f32(F, D, seed=2),
             cot=_f32(3, D, seed=3))

    def f(x, w1, w2, cot):
        def loss(a, b):
            return jnp.sum(jparallel.row_parallel(
                jparallel.column_parallel(x, a), b, axis_name="tp") * cot)
        out = jparallel.row_parallel(jparallel.column_parallel(x, w1), w2,
                                     axis_name="tp")
        return (out,) + jax.grad(loss, argnums=(0, 1))(w1, w2)
    out, g1, g2 = _smap(f, "tp", n, (P(), P(None, "tp"), P("tp", None), P()),
                        (P(), P(None, "tp"), P("tp", None)))(
        c["x"], c["w1"], c["w2"], c["cot"])
    return c, dict(out=np.asarray(out), dense=(c["x"] @ c["w1"]) @ c["w2"],
                   g1=np.asarray(g1), g2=np.asarray(g2))


def _case_attn(kind, causal, n):
    B, T, H, D = 2, 16, 4, 8
    c = dict(kind=kind, mesh={"sp": n}, causal=causal,
             **{k: _f32(B, T, H, D, seed=10 + i) for i, k in
                enumerate(("q", "k", "v", "cot"))})
    fn = jparallel.ring_attention if kind == "ring" \
        else jparallel.ulysses_attention

    def f(q, k, v, cot):
        def loss(a, b, d):
            return jnp.sum(fn(a, b, d, axis_name="sp", causal=causal) * cot)
        return (fn(q, k, v, axis_name="sp", causal=causal),) + jax.grad(
            loss, argnums=(0, 1, 2))(q, k, v)
    sp = P(None, "sp")
    out = _smap(f, "sp", n, (sp,) * 4, (sp,) * 4)(
        c["q"], c["k"], c["v"], c["cot"])
    return c, dict(zip(("out", "dq", "dk", "dv"),
                       (np.asarray(t) for t in out)))


def _case_moe(n):
    T, D, F, E = 16, 8, 16, n
    c = dict(kind="moe", mesh={"ep": n}, cf=1.25,
             x=_f32(E * T, D, seed=20), gate=_f32(D, E, seed=21),
             w1=_f32(E, D, F, seed=22, scale=0.1),
             w2=_f32(E, F, D, seed=23, scale=0.1),
             cot=_f32(E * T, D, seed=24))

    def f(x, gate, w1, w2, cot):
        def loss(a, g, b, d):
            y, aux = jparallel.moe_ffn(a, g, b[0], d[0], axis_name="ep",
                                       capacity_factor=c["cf"])
            return jnp.sum(y * cot) + aux
        y, aux = jparallel.moe_ffn(x, gate, w1[0], w2[0], axis_name="ep",
                                   capacity_factor=c["cf"])
        dx, dg, d1, d2 = jax.grad(loss, argnums=(0, 1, 2, 3))(x, gate, w1,
                                                              w2)
        return y, aux[None], dx, dg[None], d1, d2
    e3 = P("ep", None, None)
    out = _smap(f, "ep", n, (P("ep"), P(), e3, e3, P("ep")),
                (P("ep"), P("ep"), P("ep"), e3, e3, e3))(
        c["x"], c["gate"], c["w1"], c["w2"], c["cot"])
    y, aux, dx, dg, d1, d2 = (np.asarray(t) for t in out)
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(c["x"]) @ jnp.asarray(c["gate"]), axis=-1))
    return c, dict(y=y, aux=aux, dx=dx, dgate=dg, dw1=d1, dw2=d2,
                   probs=probs)


def _case_gpipe(n):
    S, M, mb, D = n, 4, 2, 4
    c = dict(kind="gpipe", mesh={"pp": n}, ws=_f32(S, D, D, seed=30,
                                                   scale=0.3),
             x=_f32(M, mb, D, seed=31))

    def f(w, x):
        def loss(wl, xx):
            out = jparallel.gpipe(lambda p, a: jnp.tanh(a @ p), wl[0], xx,
                                  axis_name="pp")
            return jax.lax.pmean(jnp.mean(out * out), "pp")
        out = jparallel.gpipe(lambda p, a: jnp.tanh(a @ p), w[0], x,
                              axis_name="pp")
        dw, dx = jax.grad(loss, argnums=(0, 1))(w, x)
        return out, loss(w, x)[None], dw, dx[None]
    out, loss, dw, dx = (np.asarray(t) for t in _smap(
        f, "pp", n, (P("pp", None, None), P()),
        (P(), P("pp"), P("pp", None, None), P("pp")))(c["ws"], c["x"]))
    seq = c["x"]
    for s in range(S):
        seq = np.tanh(seq @ c["ws"][s])
    return c, dict(out=out, seq=seq, loss=loss, dw=dw, dx=dx)


def _cases(n):
    built = [_case_tp(n)]
    built += [_case_attn(k, causal, n) for k in ("ring", "ulysses")
              for causal in (False, True)]
    built += [_case_moe(n), _case_gpipe(n)]
    return [c for c, _ in built], [w for _, w in built]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def layer_results(request, tmp_path_factory):
    n = request.param
    cases, want = _cases(n)
    got = torch_mesh_worker.spawn(n, cases,
                                  tmp_path_factory.mktemp(f"axes{n}"))
    return n, cases, want, got


def _pick(results, kind, causal=None):
    n, cases, want, got = results
    for c, w, g in zip(cases, want, got):
        if c["kind"] == kind and (causal is None or c["causal"] == causal):
            return n, c, w, g
    raise KeyError(kind)


def _block(a, axis_dim, n, i):
    step = a.shape[axis_dim] // n
    idx = [slice(None)] * a.ndim
    idx[axis_dim] = slice(i * step, (i + 1) * step)
    return a[tuple(idx)]


# -- layer parity ---------------------------------------------------------------

def test_tp_column_row_pair_matches_jax(layer_results):
    n, c, w, ranks = _pick(layer_results, "tp")
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["out"], w["dense"], rtol=1e-4)
        np.testing.assert_allclose(r["out"], w["out"], rtol=1e-4)
        # The backward's sum all-reduce: sharded grads arrive tp times the
        # dense ones, as under JAX's psum transpose.
        np.testing.assert_allclose(r["g1"], _block(w["g1"], 1, n, i),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(r["g2"], _block(w["g2"], 0, n, i),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_matches_jax(layer_results, kind,
                                                 causal):
    n, c, w, ranks = _pick(layer_results, kind, causal)
    for i, r in enumerate(ranks):
        for key in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(r[key], _block(w[key], 1, n, i),
                                       rtol=2e-4, atol=2e-5, err_msg=key)


def test_moe_ffn_matches_jax(layer_results):
    n, c, w, ranks = _pick(layer_results, "moe")
    for i, r in enumerate(ranks):
        want_e = _block(w["probs"], 0, n, i).argmax(-1)
        flips = np.nonzero(r["expert"] != want_e)[0]
        # A flip is a fault unless that token's top two gate
        # probabilities are closer than the tolerance.
        for t in flips:
            top2 = np.sort(_block(w["probs"], 0, n, i)[t])[-2:]
            assert top2[1] - top2[0] < 2e-5, (i, t, top2)
        assert len(flips) == 0, f"routing flips at rank {i}: {flips}"
        np.testing.assert_allclose(r["y"], _block(w["y"], 0, n, i),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["aux"], w["aux"][i], rtol=2e-4,
                                   atol=2e-5)
        for key, dim in (("dx", 0), ("dw1", None), ("dw2", None)):
            want = w[key][i] if dim is None else _block(w[key], dim, n, i)
            np.testing.assert_allclose(r[key], want, rtol=2e-4, atol=2e-5,
                                       err_msg=key)
        np.testing.assert_allclose(r["dgate"], w["dgate"][i], rtol=2e-4,
                                   atol=2e-5)


def test_gpipe_forward_and_gradients_match_jax(layer_results):
    n, c, w, ranks = _pick(layer_results, "gpipe")
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["out"], w["seq"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["out"], w["out"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["loss"], w["loss"][i], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["dw"], w["dw"][i], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["dx"], w["dx"][i], rtol=1e-5,
                                   atol=1e-6)
        assert np.abs(r["dw"]).sum() > 0


# -- the plan -------------------------------------------------------------------

def _hand_mesh(names, sizes):
    return tmesh.Mesh(axis_names=tuple(names), shape=dict(zip(names, sizes)),
                      coords={a: 0 for a in names}, ranks={}, groups={})


PLAN_MESHES = [
    (dict(dp=2, tp=2), 0, False),
    (dict(dp=2, ep=2), 2, False),
    (dict(sp=2, tp=2), 0, False),
    (dict(dp=2, tp=4), 0, False),
    (dict(dp=2, pp=2, tp=2), 0, True),
]


@pytest.mark.parametrize("axes,experts,pp", PLAN_MESHES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("threshold", [None, 2_000, 0])
def test_plan_grad_sync_and_buckets_match_jax(axes, experts, pp, threshold):
    n = int(np.prod(list(axes.values())))
    jm = jmesh(**axes, devices=jax.devices()[:n])
    tm = _hand_mesh(jm.axis_names, [jm.shape[a] for a in jm.axis_names])
    dims = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
    if pp:
        jspecs_tree = jpp.pp_param_specs(jm)
        shapes = jax.eval_shape(lambda: jpp.init_pp_params(
            jax.random.PRNGKey(0), jtr.TransformerConfig(**dims), 2))
        tspecs = tpp.named_specs(tpp.pp_param_specs(tm))
        skip = ("pp",)
    else:
        jcfg = jtr.TransformerConfig(**dims, n_experts=experts)
        jspecs_tree = jtr.param_specs(jcfg, jm)
        shapes = jax.eval_shape(lambda: jtr.init_params(
            jax.random.PRNGKey(0), jcfg))
        tcfg = ttr.TransformerConfig(**dims, n_experts=experts)
        tspecs_tree = ttr.param_specs(tcfg, tm)
        skip = ()
    jspecs = jax.tree_util.tree_flatten(
        jspecs_tree, is_leaf=lambda x: isinstance(x, P))[0]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    names = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in flat]
    if not pp:
        tspecs = [ttr.spec_of(tspecs_tree, nm) for nm in names]
    jsyncs = jfusion.plan_grad_sync(jspecs, jm, skip_axes=skip)
    tsyncs = tfusion.plan_grad_sync(tspecs, tm, skip_axes=skip)
    assert [(s.psum, s.shard, s.denom) for s in tsyncs] == \
        [(s.psum, s.shard, s.denom) for s in jsyncs]

    def local(leaf, spec):
        return tuple(d // (jm.shape[a] if a else 1)
                     for d, a in zip(leaf.shape, tuple(spec) + (None,) * 8))
    loc = [local(leaf, spec) for (_, leaf), spec in zip(flat, jspecs)]
    jplan = jfusion.plan_buckets(
        [jax.ShapeDtypeStruct(s, jnp.float32) for s in loc], threshold,
        groups=jsyncs)
    tplan = tfusion.plan_buckets([torch.zeros(s) for s in loc], threshold,
                                 groups=tsyncs)
    assert [list(b) for b in tplan] == [list(b) for b in jplan]


@pytest.mark.parametrize("T,E,cf", [(16, 4, 1.25), (16384, 1, 1.25),
                                    (10, 3, 1.0), (7, 2, 0.5), (1, 4, 1.0)])
def test_moe_capacity_is_the_jax_expression(T, E, cf):
    assert tmoe.capacity(T, E, cf) == max(1, int((T / E) * cf + 0.999))
    if (T, E) == (16384, 1):
        assert tmoe.capacity(T, E, cf) == 20480


# -- one rank ---------------------------------------------------------------------

def test_mesh_layout_keeps_axes_as_documented(one_rank_world):
    mesh = tmesh.create_hybrid_mesh()
    assert mesh.axis_names == ("dp", "pp")
    full = tmesh.make_mesh({"tp": 1, "dp": 1, "sp": 1, "ep": 1, "pp": 1})
    assert full.axis_names == tmesh.AXES
    assert full.subset_size(("dp", "tp")) == 1
    assert full.group(("dp", "tp")) is torch.distributed.group.WORLD
    assert tmesh.axis_size(full, "tp") == 1
    with pytest.raises(ValueError, match="unknown mesh axis"):
        tmesh.axis_size(full, "dpp")
    with pytest.raises(ValueError) as e:
        tmesh.create_hybrid_mesh(dp=1, tp=3)
    assert "tp=3" in str(e.value) and "--tp" in str(e.value)
    assert "needs 3 ranks" in str(e.value)


def test_batch_block_follows_the_batch_spec():
    m = _hand_mesh(("dp", "ep", "sp"), (2, 2, 2))
    x = torch.arange(8 * 4).reshape(8, 4)
    m.coords.update(dp=1, ep=0, sp=1)
    got = tmesh.batch_block(x, m)
    assert torch.equal(got, x[4:6, 2:4])


def test_refusals_that_stay_name_item_11(one_rank_world):
    """What these refusals pinned runs now, at one rank: the hybrid plan
    of a non-scatter axis of any size, overlap on the spec-grouped
    plane, and ``zero``/``overlap`` on the pipelined and four-axis steps
    (bitwise the plain steps at world 1). No refusal of the port names
    the item any more."""
    m = _hand_mesh(("dp", "tp"), (2, 2))
    params = [torch.zeros(4, 4), torch.zeros(4)]
    plan = tfusion.plan_zero(params, 2, specs=[(None, "tp"), ()], mesh=m)
    assert plan.nonscatter == (("tp", 2),)
    assert plan.global_shapes == ((4, 8), (4,))
    assert plan.extra_axes == ((), ("tp",)) and plan.denoms == (4, 4)
    one = tmesh.make_mesh({"dp": 1, "tp": 1})
    ps = [torch.nn.Parameter(torch.zeros(4, 4))]
    opt = DistributedOptimizer(torch.optim.SGD(ps, lr=0.1), mesh=one,
                               param_specs=[(None, "tp")], overlap=True)
    assert opt.overlap and opt._grouped is not None
    assert tfusion.plan_zero(params, 1, specs=[(None, "tp"), ()],
                             mesh=one).nonscatter == (("tp", 1),)
    cfg = ttr.TransformerConfig(vocab=64, d_model=32, n_heads=4,
                                n_layers=2, d_ff=64, dtype=torch.float32,
                                attn_backend="xla")
    sgd = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9,
                            foreach=False)
    tok = torch.arange(64).reshape(4, 16) % 64
    lab = torch.roll(tok, -1, 1)

    def pp_run(**kw):
        init, step = tpp.make_pp_transformer_train_step(
            cfg, tmesh.create_hybrid_mesh(), sgd, 2, device="cpu", **kw)
        st = init(0)
        for _ in range(2):
            st, loss = step(st, tok, lab)
        return float(loss), [p.detach().clone()
                             for _, p in tpp.named_leaves(st.params)], st
    base = pp_run()
    for kw in (dict(zero=True), dict(overlap=True)):
        loss, got, st = pp_run(**kw)
        assert loss == base[0] and all(torch.equal(a, b) for a, b in
                                       zip(got, base[1])), kw
        assert st.optimizer.zero == kw.get("zero", False)
    init, step = ttr.make_parallel_train_step(cfg, sgd, mesh=one,
                                              overlap=True, device="cpu")
    st = init(0)
    st, loss = step(st, tok, lab)
    assert st.optimizer.grad_order_source == "probed"
    assert np.isfinite(float(loss))


def test_tp_init_folds_the_tp_rank_into_the_seed():
    """``init_column``/``init_row`` draw this rank's shard from the seed
    and its tp index: shards differ across tp, and dp replicas (same tp
    index) agree; N(0, 1/d_in) in the shard's shape."""
    from horovod_tpu_torch.parallel import tp as ttp
    m = _hand_mesh(("dp", "tp"), (2, 4))
    shards = {}
    for dp in range(2):
        for t in range(4):
            m.coords.update(dp=dp, tp=t)
            shards[dp, t] = (ttp.init_column(7, 64, 32, m, device="cpu"),
                             ttp.init_row(7, 32, 64, m, device="cpu"))
    assert shards[0, 0][0].shape == (64, 8) and shards[0, 0][1].shape == \
        (8, 64)
    for t in range(4):
        for a, b in zip(shards[0, t], shards[1, t]):
            assert torch.equal(a, b)
    assert not torch.equal(shards[0, 0][0], shards[0, 1][0])
    col = torch.cat([shards[0, t][0] for t in range(4)], 1)
    assert abs(float(col.std()) - 64 ** -0.5) < 0.02


def test_moe_refuses_a_non_positive_capacity_factor(one_rank_world):
    m = tmesh.make_mesh({"dp": 1, "ep": 1})
    x, g = torch.zeros(4, 8), torch.zeros(8, 1)
    w1, w2 = torch.zeros(8, 16), torch.zeros(16, 8)
    for cf in (0.0, -1.0):
        with pytest.raises(ValueError, match="capacity_factor must be > 0"):
            tmoe.moe_ffn(x, g, w1, w2, mesh=m, capacity_factor=cf)
    y, aux = tmoe.moe_ffn(torch.randn(4, 8), g, w1, w2, mesh=m)
    assert y.shape == (4, 8) and float(aux) == 1.0

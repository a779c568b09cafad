"""Port parity: the LoRA adapters of the generation forwards
(``parallel/lora.py``) against the JAX package's.

The same numpy-seeded weights (the JAX KV tests' tiny f32 model) and the
same JAX ``init_adapter`` trees (carried across with
``convert.adapter_from_jax``) go through both packages. Prefill, decode
and verify logits with an adapter table agree with JAX's at rtol 2e-5 /
atol 1e-5 on both layouts; the configuration and tree checks raise
JAX's messages; an adapter row matches the base forward over merged
weights ``W + (alpha/r)·A@B`` at the same tolerance; base rows
(``adapter_idx = -1``) are bitwise a table-free run, and a ``-0.0``
survives the delta hook (``torch.where``, never ``y + 0.0``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_serve_common as common
from horovod_tpu.parallel import kv_blocks as jkv
from horovod_tpu.parallel import lora as jlora
from horovod_tpu.parallel import transformer as jtr
from horovod_tpu_torch import convert
from horovod_tpu_torch.parallel import kv_blocks as tkv
from horovod_tpu_torch.parallel import lora as tlora
from horovod_tpu_torch.parallel import transformer as ttr

TOL = dict(rtol=2e-5, atol=1e-5)
PROMPT = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
S, L, W, MAX_LEN, BS = 2, 6, 3, 16, 4
RANK = 2


@pytest.fixture(scope="module")
def tree():
    return common.make_tree()


@pytest.fixture(scope="module")
def model(tree):
    return common.torch_model(tree)


@pytest.fixture(scope="module")
def adapters():
    """Two distinct JAX adapters (``b_scale > 0``) as f32 numpy trees."""
    jcfg = common.jax_config()
    lora = jlora.LoraConfig(rank=RANK)
    return [jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jlora.init_adapter(jax.random.PRNGKey(1 + i), jcfg, lora,
                           b_scale=0.5)) for i in range(2)]


def _tlora():
    return tlora.LoraConfig(rank=RANK)


def _ttable(adapters):
    return tlora.stack_adapters([convert.adapter_from_jax(
        a, common.torch_config(), _tlora(), device="cpu")
        for a in adapters])


def _jtable(adapters):
    return jlora.stack_adapters(adapters)


def _raises_same(jfn, tfn):
    with pytest.raises(ValueError) as je:
        jfn()
    with pytest.raises(ValueError) as te:
        tfn()
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [dict(rank=0), dict(alpha=0),
                                dict(targets=()),
                                dict(targets=("wq_typo",))])
def test_lora_config_validation_matches_jax(kw):
    _raises_same(lambda: jlora.LoraConfig(**kw),
                 lambda: tlora.LoraConfig(**kw))
    assert tlora.LoraConfig(rank=4, alpha=8).scaling == 2.0


@pytest.mark.parametrize("name", ["base", "retired", "", "a b", "-x",
                                  "x" * 129, "a\x00b"])
def test_adapter_name_rules_match_jax(name):
    _raises_same(lambda: jlora.check_adapter_name(name),
                 lambda: tlora.check_adapter_name(name))


def test_adapter_name_accepted_like_jax():
    for name in ("a0", "tenant.v2", "x" * 128):
        assert tlora.check_adapter_name(name) == \
            jlora.check_adapter_name(name)


def _bad_trees(good):
    short = {"layers": good["layers"][:1]}
    wrong_shape = {"layers": [dict(x) for x in good["layers"]]}
    wrong_shape["layers"][1] = dict(wrong_shape["layers"][1])
    wrong_shape["layers"][1]["wo"] = {
        "a": np.zeros((3, RANK), np.float32),
        "b": good["layers"][1]["wo"]["b"]}
    wrong_keys = {"layers": [dict(x) for x in good["layers"]]}
    wrong_keys["layers"][1] = dict(wrong_keys["layers"][1])
    wrong_keys["layers"][1]["wo"] = {"A": np.zeros((2, 2)),
                                     "B": np.zeros((2, 2))}
    missing = {"layers": [dict(x) for x in good["layers"]]}
    missing["layers"][0] = {k: v for k, v in missing["layers"][0].items()
                            if k != "w2"}
    return [short, wrong_shape, wrong_keys, missing, {"nope": 1}]


@pytest.mark.parametrize("which", range(5))
def test_check_adapter_messages_match_jax(adapters, which):
    bad = _bad_trees(adapters[0])[which]
    _raises_same(
        lambda: jlora.check_adapter(bad, common.jax_config(),
                                    jlora.LoraConfig(rank=RANK)),
        lambda: tlora.check_adapter(bad, common.torch_config(), _tlora()))


def test_tree_helpers_match_jax(adapters):
    jcfg, tcfg = common.jax_config(), common.torch_config()
    tlora.check_adapter(adapters[0], tcfg, _tlora())
    assert tlora.target_shapes(tcfg) == jlora.target_shapes(jcfg)
    for lora_kw in (dict(rank=RANK), dict(rank=8, targets=("wo", "w2"))):
        assert tlora.adapter_bytes(tcfg, tlora.LoraConfig(**lora_kw)) == \
            jlora.adapter_bytes(jcfg, jlora.LoraConfig(**lora_kw))
    table = _ttable(adapters)
    jt = _jtable(adapters)
    for li in range(2):
        for t in tlora.LORA_TARGETS:
            for k in ("a", "b"):
                np.testing.assert_array_equal(
                    table["layers"][li][t][k].numpy(),
                    np.asarray(jt["layers"][li][t][k]))
    empty = tlora.empty_adapter_table(tcfg, _tlora(), 3, device="cpu")
    jempty = jlora.empty_adapter_table(jcfg, jlora.LoraConfig(rank=RANK), 3)
    for li in range(2):
        for t in tlora.LORA_TARGETS:
            for k in ("a", "b"):
                assert tuple(empty["layers"][li][t][k].shape) == \
                    jempty["layers"][li][t][k].shape
                assert not empty["layers"][li][t][k].any()
    with pytest.raises(ValueError, match="capacity"):
        tlora.empty_adapter_table(tcfg, _tlora(), 0, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        tlora.stack_adapters([])
    # the carry is exact both ways
    back = convert.adapter_to_numpy(convert.adapter_from_jax(
        adapters[1], tcfg, _tlora(), device="cpu"))
    for li in range(2):
        for t in tlora.LORA_TARGETS:
            for k in ("a", "b"):
                np.testing.assert_array_equal(
                    back["layers"][li][t][k], adapters[1]["layers"][li][t][k])


def test_init_adapter_shapes_and_zero_b():
    tcfg = common.torch_config()
    gen = torch.Generator().manual_seed(0)
    a = tlora.init_adapter(gen, tcfg, _tlora(), device="cpu")
    tlora.check_adapter(a, tcfg, _tlora())
    assert not any(p["b"].any() for layer in a["layers"]
                   for p in layer.values())
    b = tlora.init_adapter(torch.Generator().manual_seed(0), tcfg, _tlora(),
                           b_scale=0.5, device="cpu")
    assert torch.equal(a["layers"][1]["w1"]["a"], b["layers"][1]["w1"]["a"])
    assert all(p["b"].any() for layer in b["layers"]
               for p in layer.values())


def test_adapters_require_lora_config(model, adapters):
    w = common.torch_weights(model)
    cache = ttr.init_kv_cache(common.torch_config(), 1, MAX_LEN,
                              device="cpu")
    with pytest.raises(ValueError, match="lora="):
        ttr.prefill(w, common.t(PROMPT), cache, 0, common.torch_config(),
                    adapters=_ttable(adapters), adapter_idx=0)


def _jax_runs(tree, adapters, layout):
    """JAX: slot 0 prefilled with adapter 0, slot 1 with adapter 1 (true
    length L), W decode steps with per-slot rows [0, -1] then a verify
    of the same tokens with rows [1, 0]."""
    jcfg = common.jax_config()
    params = common.jax_params(tree)
    lora = jlora.LoraConfig(rank=RANK)
    table = _jtable(adapters)
    nb = MAX_LEN // BS
    tables = (1 + np.arange(S * nb, dtype=np.int32)).reshape(S, nb)
    if layout == "paged":
        cache = jkv.init_paged_kv_cache(jcfg, S * nb + 1, BS, S)
    else:
        cache = jtr.init_kv_cache(jcfg, S, MAX_LEN)
    out = {"pre": [], "dec": []}
    for s in range(S):
        kw = dict(length=L, adapters=table, adapter_idx=s, lora=lora)
        if layout == "paged":
            cache, lg = jkv.paged_prefill(params, PROMPT, cache, s,
                                          tables[s], jcfg, **kw)
        else:
            cache, lg = jtr.prefill(params, PROMPT, cache, s, jcfg, **kw)
        out["pre"].append(np.asarray(lg))
    post = cache
    last = np.stack([p[L - 1] for p in out["pre"]]).argmax(-1).astype(
        np.int32)
    pos = np.full((S,), L, np.int32)
    idx = np.array([0, -1], np.int32)
    drafts = []
    for _ in range(W):
        drafts.append(last.copy())
        kw = dict(adapters=table, adapter_idx=idx, lora=lora)
        if layout == "paged":
            cache, lg = jkv.paged_decode_step(params, last, cache, pos,
                                              tables, jcfg, **kw)
        else:
            cache, lg = jtr.decode_step(params, last, cache, pos, jcfg, **kw)
        out["dec"].append(np.asarray(lg))
        last = np.asarray(lg).argmax(-1).astype(np.int32)
        pos = pos + 1
    drafts = np.stack(drafts, 1)
    kw = dict(adapters=table, adapter_idx=np.array([1, 0], np.int32),
              lora=lora)
    if layout == "paged":
        _, vl = jkv.paged_verify_step(params, drafts, post, np.full(
            (S,), L, np.int32), tables, jcfg, **kw)
    else:
        _, vl = jtr.verify_step(params, drafts, post, np.full(
            (S,), L, np.int32), jcfg, **kw)
    out["ver"] = np.asarray(vl)
    out["drafts"] = drafts
    return out


def _torch_runs(model, adapters, layout, drafts, kernel=False):
    tcfg = common.torch_config()
    w = common.torch_weights(model)
    lora = _tlora()
    table = _ttable(adapters)
    nb = MAX_LEN // BS
    tables = common.t((1 + np.arange(S * nb, dtype=np.int32)).reshape(S, nb))
    if layout == "paged":
        cache = tkv.init_paged_kv_cache(tcfg, S * nb + 1, BS, S,
                                        device="cpu")
    else:
        cache = ttr.init_kv_cache(tcfg, S, MAX_LEN, device="cpu")
    out = {"pre": [], "dec": []}
    with torch.no_grad():
        for s in range(S):
            kw = dict(length=L, adapters=table, adapter_idx=s, lora=lora)
            if layout == "paged":
                _, lg = tkv.paged_prefill(w, common.t(PROMPT), cache, s,
                                          tables[s], tcfg, **kw)
            else:
                _, lg = ttr.prefill(w, common.t(PROMPT), cache, s, tcfg,
                                    **kw)
            out["pre"].append(lg.numpy())
        post = {n: x.clone() for n, x in cache.items()}
        pos = torch.full((S,), L, dtype=torch.int32)
        idx = torch.tensor([0, -1], dtype=torch.int32)
        for j in range(W):
            kw = dict(adapters=table, adapter_idx=idx, lora=lora)
            if layout == "paged":
                _, lg = tkv.paged_decode_step(
                    w, common.t(drafts[:, j]), cache, pos, tables, tcfg,
                    kernel=kernel, **kw)
            else:
                _, lg = ttr.decode_step(w, common.t(drafts[:, j]), cache,
                                        pos, tcfg, **kw)
            out["dec"].append(lg.numpy())
            pos = pos + 1
        kw = dict(adapters=table, adapter_idx=torch.tensor(
            [1, 0], dtype=torch.int32), lora=lora)
        p0 = torch.full((S,), L, dtype=torch.int32)
        if layout == "paged":
            _, vl = tkv.paged_verify_step(w, common.t(drafts), post, p0,
                                          tables, tcfg, kernel=kernel, **kw)
        else:
            _, vl = ttr.verify_step(w, common.t(drafts), post, p0, tcfg,
                                    **kw)
        out["ver"] = vl.numpy()
    return out


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_adapter_logits_match_jax(tree, model, adapters, layout):
    """Prefill (each slot its own adapter), decode (rows [adapter 0,
    base]) and verify (rows [adapter 1, adapter 0], each repeated over
    its W columns) against JAX at rtol 2e-5 / atol 1e-5."""
    j = _jax_runs(tree, adapters, layout)
    t = _torch_runs(model, adapters, layout, j["drafts"])
    for a, b in zip(t["pre"], j["pre"]):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(t["dec"], j["dec"]):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(t["ver"], j["ver"], **TOL)
    # the two adapters and the base really differ
    assert not np.allclose(t["pre"][0][L - 1], t["pre"][1][L - 1])


def test_paged_kernel_flag_matches_gather_on_cpu(tree, model, adapters):
    """``kernel=True`` (K8's plain version here) and ``kernel=False``
    (the gather) agree with adapters on: the CPU runs the same dense
    math either way."""
    j = _jax_runs(tree, adapters, "paged")
    a = _torch_runs(model, adapters, "paged", j["drafts"], kernel=False)
    b = _torch_runs(model, adapters, "paged", j["drafts"], kernel=True)
    for x, y in zip(a["dec"], b["dec"]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["ver"], b["ver"])


def _merged(model, adapter, lora):
    m = common.torch_model(convert.params_to_numpy(model))
    with torch.no_grad():
        for li, block in enumerate(m.layers):
            for t, pair in adapter["layers"][li].items():
                getattr(block, t).add_(lora.scaling * torch.from_numpy(
                    pair["a"] @ pair["b"]))
    return m


def test_merged_weight_parity(model, adapters):
    """An adapter row's logits match the base forward over merged weights
    W + (alpha/r)·A@B (allclose: the association order differs), in the
    prefill and in a decode step."""
    tcfg, lora = common.torch_config(), _tlora()
    table = _ttable(adapters)
    wm = common.torch_weights(_merged(model, adapters[0], lora))
    w = common.torch_weights(model)
    toks = common.t(PROMPT[:L])
    with torch.no_grad():
        cm = ttr.init_kv_cache(tcfg, 1, MAX_LEN, device="cpu")
        ct = ttr.init_kv_cache(tcfg, 1, MAX_LEN, device="cpu")
        _, lm = ttr.prefill(wm, toks, cm, 0, tcfg)
        _, lt = ttr.prefill(w, toks, ct, 0, tcfg, adapters=table,
                            adapter_idx=0, lora=lora)
        np.testing.assert_allclose(lt.numpy(), lm.numpy(), **TOL)
        last = torch.tensor([7], dtype=torch.int32)
        pos = torch.tensor([L], dtype=torch.int32)
        _, dm = ttr.decode_step(wm, last, cm, pos, tcfg)
        _, dt = ttr.decode_step(w, last, ct, pos, tcfg, adapters=table,
                                adapter_idx=torch.tensor([0]), lora=lora)
        np.testing.assert_allclose(dt.numpy(), dm.numpy(), **TOL)


def test_base_rows_bitwise_a_table_free_run(model, adapters):
    """``adapter_idx = -1`` rows are bitwise a run without any table: a
    base prompt, and the base row of a mixed decode step."""
    tcfg, lora = common.torch_config(), _tlora()
    table = _ttable(adapters)
    w = common.torch_weights(model)
    toks = common.t(PROMPT[:L])
    with torch.no_grad():
        cb = ttr.init_kv_cache(tcfg, 2, MAX_LEN, device="cpu")
        ca = ttr.init_kv_cache(tcfg, 2, MAX_LEN, device="cpu")
        for s in range(2):
            _, lb = ttr.prefill(w, toks, cb, s, tcfg)
            _, la = ttr.prefill(w, toks, ca, s, tcfg, adapters=table,
                                adapter_idx=-1, lora=lora)
            assert torch.equal(la, lb)
        last = torch.tensor([7, 3], dtype=torch.int32)
        pos = torch.tensor([L, L], dtype=torch.int32)
        _, db = ttr.decode_step(w, last, cb, pos, tcfg)
        _, da = ttr.decode_step(w, last, ca, pos, tcfg, adapters=table,
                                adapter_idx=torch.tensor([1, -1]),
                                lora=lora)
        assert torch.equal(da[1], db[1])
        assert not torch.equal(da[0], db[0])


def test_negative_zero_survives_the_base_select(adapters):
    """The -0.0 contract: a base row's matmul output passes through
    ``torch.where(active, y + d, y)`` with its sign bit, where ``y +
    0.0`` would flip it; the adapter row gets ``y + d``."""
    tcfg, lora = common.torch_config(), _tlora()
    table = _ttable(adapters)
    d = tcfg.d_model
    x = torch.ones((2, d))
    y = torch.full((2, 3 * d), -0.0)
    out = tlora.step_delta(table, torch.tensor([-1, 0]), lora,
                           tcfg)(0, "wqkv", x, y)
    assert torch.equal(torch.signbit(out[0]), torch.ones(3 * d,
                                                         dtype=torch.bool))
    assert not torch.signbit(y[0] + 0.0).any()
    a = table["layers"][0]["wqkv"]["a"][0]
    b = table["layers"][0]["wqkv"]["b"][0]
    np.testing.assert_allclose(out[1].numpy(),
                               (y[1] + (x[1] @ a @ b) * lora.scaling).numpy(),
                               rtol=1e-6, atol=1e-6)
    pout = tlora.prompt_delta(table, -1, lora, tcfg)(0, "wqkv", x[None],
                                                    y[None])
    assert torch.equal(torch.signbit(pout), torch.signbit(y[None]))
    # JAX's select keeps the sign the same way
    jt = _jtable(adapters)
    jout = jlora.step_delta(jt, jnp.asarray([-1, 0], jnp.int32),
                            jlora.LoraConfig(rank=RANK),
                            common.jax_config())(0, "wqkv",
                                                 jnp.asarray(x.numpy()),
                                                 jnp.asarray(y.numpy()))
    assert np.array_equal(np.signbit(np.asarray(jout)[0]),
                          torch.signbit(out[0]).numpy())


def test_gather_index_is_clipped_like_jax(adapters):
    """An index past the table's rows gathers the last row, as JAX's
    ``safe`` clip does."""
    tcfg, lora = common.torch_config(), _tlora()
    table = _ttable(adapters)
    x = torch.randn((1, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    y = torch.zeros((1, tcfg.d_model))
    far = tlora.step_delta(table, torch.tensor([7]), lora, tcfg)(1, "wo", x, y)
    last = tlora.step_delta(table, torch.tensor([1]), lora, tcfg)(1, "wo", x,
                                                                  y)
    assert torch.equal(far, last)
    jt = _jtable(adapters)
    jfar = jlora.step_delta(jt, jnp.asarray([7], jnp.int32),
                            jlora.LoraConfig(rank=RANK), common.jax_config())(
        1, "wo", jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    np.testing.assert_allclose(far.numpy(), np.asarray(jfar), **TOL)

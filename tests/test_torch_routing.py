"""The engine's configuration and the kernels' routing against the JAX
package's.

``GenerationConfig`` has JAX's fields in JAX's order with JAX's defaults
(``kv_layout="contiguous"``, ``paged_kernel=False``, ``preempt=True``)
and raises JAX's messages. The default paged engine (the gather, no
kernel) is bitwise the contiguous engine, greedy and seeded, as JAX's
is. Each kernel family has one routing predicate (``flash_supported``,
``paged_attention_supported``, ``conv_bn_supported``): on a CUDA device
the kernels take bf16 with d_head 128 (channels multiples of 64 for the
conv pair), and for f32, fp16, d_head 64 or unaligned channels the model
routes to the plain version; on the CPU the wrappers take every input.
The CUDA side of each predicate is decided from the device, dtype and
shape alone, so it is checked here without a card, and so is the
model's route: the transformer and the engine pick the plain versions
from the config, and a wrapper given a CUDA input its kernel does not
take raises before any launch.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_serve_common as common
from horovod_tpu import serve as jserve
from horovod_tpu_torch.ops import (conv_bn_supported, flash_supported,
                                   paged_attention_supported)
from horovod_tpu_torch.ops.attention import (flash_attention_prefill,
                                             flash_attention_reference)
from horovod_tpu_torch.ops.fused_conv_bn import (
    fused_linear_bn_act_fwd, fused_linear_bn_act_reference)
from horovod_tpu_torch.ops.paged_attention import (
    paged_attention_reference, paged_decode_attention)
from horovod_tpu_torch.serve import GenerationConfig, SamplingParams

CUDA = torch.device("cuda")
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5], [2, 7, 1, 8], [5] * 13]
TIMEOUT = 120


def test_config_fields_and_defaults_equal_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(GenerationConfig)]
    ref = [(f.name, f.default)
           for f in dataclasses.fields(jserve.GenerationConfig)]
    assert ours == ref
    c = GenerationConfig()
    assert (c.kv_layout, c.paged_kernel, c.preempt, c.preempt_retries) == \
        ("contiguous", False, True, 3)
    assert c.resolved_n_blocks == jserve.GenerationConfig().resolved_n_blocks


BAD = [dict(max_slots=0), dict(max_len=0), dict(default_max_new_tokens=0),
       dict(kv_layout="ring"), dict(block_size=12), dict(chunk_blocks=3),
       dict(host_blocks=-1), dict(host_admission="later"),
       dict(paged_kernel=True), dict(prefix_reuse=True),
       dict(chunked_prefill=True), dict(n_blocks=8),
       dict(kv_layout="paged", n_blocks=1),
       dict(kv_layout="paged", chunked_prefill=True),
       dict(kv_layout="paged", prefix_reuse=True, chunked_prefill=True,
            block_size=4, max_len=6),
       dict(kv_layout="paged", host_blocks=4),
       dict(tenant_weights={"a": -1.0}), dict(tenant_slo_ttft_ms={"a": 0}),
       dict(tenant_block_budgets={"a": 2}),
       dict(kv_layout="paged", tenant_block_budgets={"a": 0}),
       dict(preempt_retries=-1)]


@pytest.mark.parametrize("kw", BAD)
def test_config_validation_equals_jax(kw):
    with pytest.raises(ValueError) as ours:
        GenerationConfig(**kw)
    with pytest.raises(ValueError) as ref:
        jserve.GenerationConfig(**kw)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("kw", [
    dict(kv_layout="paged", paged_kernel=True),
    dict(tenant_weights={"a": 2.0}, tenant_priorities={"a": 1},
         tenant_slo_ttft_ms={"a": 50.0}, preempt=False),
    dict(kv_layout="paged", tenant_block_budgets={"a": 4})])
def test_config_accepts_what_jax_accepts(kw):
    ours = GenerationConfig(**kw)
    ref = jserve.GenerationConfig(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.fixture(scope="module")
def model():
    return common.torch_model(common.make_tree())


def _streams(model, sampling, **kw):
    eng = common.engine(model, max_slots=3, max_len=32,
                        default_max_new_tokens=12, **kw)
    try:
        hs = [eng.submit(p, sampling=sampling) for p in PROMPTS]
        return [h.result(TIMEOUT)["tokens"] for h in hs]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("sampling", [None, SamplingParams(
    temperature=0.8, top_k=6, seed=5)], ids=["greedy", "seeded"])
def test_default_paged_engine_bitwise_contiguous(model, sampling):
    """F2: ``kv_layout="paged"`` without ``paged_kernel`` gathers each
    slot's blocks into the contiguous view and runs the contiguous
    cache's attention, so its streams are the contiguous engine's; with
    ``paged_kernel=True`` (K8's plain version on the CPU) too."""
    contiguous = _streams(model, sampling)
    assert _streams(model, sampling, kv_layout="paged",
                    block_size=4) == contiguous
    assert _streams(model, sampling, kv_layout="paged", block_size=4,
                    paged_kernel=True) == contiguous


def test_default_paged_step_logits_bitwise_contiguous(model):
    """The paged decode step's logits with ``kernel=False`` are bitwise
    the contiguous step's over the same prompt."""
    from horovod_tpu_torch.parallel import kv_blocks as tkv
    from horovod_tpu_torch.parallel import transformer as ttr
    cfg = common.torch_config()
    w = common.torch_weights(model)
    toks = torch.tensor(PROMPTS[0], dtype=torch.int32)
    nb, bs = 4, 4
    row = torch.arange(1, nb + 1, dtype=torch.int32)
    with torch.no_grad():
        pc = tkv.init_paged_kv_cache(cfg, nb + 1, bs, 1, device="cpu")
        cc = ttr.init_kv_cache(cfg, 1, nb * bs, device="cpu")
        _, lp = tkv.paged_prefill(w, toks, pc, 0, row, cfg)
        _, lc = ttr.prefill(w, toks, cc, 0, cfg)
        assert torch.equal(lp, lc)
        pos = torch.tensor([len(PROMPTS[0])], dtype=torch.int32)
        last = lp[-1].argmax()[None].to(torch.int32)
        _, dp = tkv.paged_decode_step(w, last, pc, pos, row[None], cfg)
        _, dc = ttr.decode_step(w, last, cc, pos, cfg)
        assert torch.equal(dp, dc)


@pytest.mark.parametrize("dtype,d_head,kernel", [
    (torch.bfloat16, 128, True), (torch.float32, 128, False),
    (torch.float16, 128, False), (torch.bfloat16, 64, False),
    (torch.float32, 64, False)])
def test_attention_routes_by_input(dtype, d_head, kernel):
    assert flash_supported(CUDA, dtype, d_head) is kernel
    assert paged_attention_supported(d_head, 16, dtype) is kernel
    assert paged_attention_supported(d_head, 16, dtype, CUDA) is kernel
    # on the CPU the wrappers take every input (their plain versions)
    assert flash_supported("cpu", dtype, d_head) is True
    assert paged_attention_supported(d_head, 16, dtype, "cpu") is True


@pytest.mark.parametrize("dtype,m,cin,cout,kernel", [
    (torch.bfloat16, 256, 64, 256, True), (torch.bfloat16, 1, 512, 128, True),
    (torch.float32, 256, 64, 256, False), (torch.float16, 256, 64, 64, False),
    (torch.bfloat16, 256, 96, 64, False), (torch.bfloat16, 256, 64, 100,
                                           False),
    (torch.bfloat16, 0, 64, 64, False)])
def test_conv_routes_by_input(dtype, m, cin, cout, kernel):
    assert conv_bn_supported(CUDA, dtype, m, cin, cout) is kernel
    assert conv_bn_supported("cpu", dtype, m, cin, cout) is True


def test_routes_refuse_other_devices():
    meta = torch.device("meta")
    for fn, args in ((flash_supported, (meta, torch.bfloat16, 128)),
                     (paged_attention_supported,
                      (128, 16, torch.bfloat16, meta)),
                     (conv_bn_supported, (meta, torch.bfloat16, 128, 64,
                                          64))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*args)


def test_plain_routes_compute_the_plain_versions():
    """On the CPU each wrapper runs its plain version, the function a
    model the card's kernels do not take routes to there."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 5, 2, 64), generator=g) for _ in range(3))
    assert torch.equal(flash_attention_prefill(q, k, v, causal=True),
                       flash_attention_reference(q, k, v, causal=True))
    pool = torch.randn((5, 4, 2, 64), generator=g)
    qd = torch.randn((2, 2, 64), generator=g)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([5, -1], dtype=torch.int32)
    assert torch.equal(paged_decode_attention(qd, pool, pool, tables, pos),
                       paged_attention_reference(qd, pool, pool, tables, pos))
    x = torch.randn((8, 96), generator=g)
    w = torch.randn((64, 96), generator=g)
    got = fused_linear_bn_act_fwd(x, w)
    want = fused_linear_bn_act_reference(x, w)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())


def _meta_cuda(monkeypatch):
    """Make a CPU tensor read as a CUDA one to the routing (no card here):
    what the model routes, and what a wrapper does with it, are decided
    before any launch."""
    from horovod_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "on_card", lambda device, what: True)


@pytest.mark.parametrize("dtype,d_head", [(torch.float32, 128),
                                          (torch.bfloat16, 64)])
def test_transformer_routes_plain_from_the_config(monkeypatch, dtype,
                                                  d_head):
    """A model the card's kernels do not take routes its prefill to the
    plain version before the wrapper (which would raise) is reached; a
    bf16 d_head-128 model reaches the wrapper."""
    from horovod_tpu_torch.ops import attention as tattn
    from horovod_tpu_torch.parallel import transformer as ttr
    calls = []
    monkeypatch.setattr(ttr, "flash_attention_prefill",
                        lambda *a, **k: calls.append("kernel")
                        or tattn.flash_attention_reference(*a, **k))
    _meta_cuda(monkeypatch)
    for dt, dh, want in ((dtype, d_head, []),
                         (torch.bfloat16, 128, ["kernel"])):
        cfg = ttr.TransformerConfig(vocab=32, d_model=2 * dh, n_heads=2,
                                    n_layers=1, d_ff=32, dtype=dt)
        model = ttr.Transformer(cfg, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
        calls.clear()
        with torch.no_grad():
            w = ttr.gen_weights(model)
            cache = ttr.init_kv_cache(cfg, 1, 8, device="cpu")
            _, logits = ttr.prefill(w, torch.arange(5, dtype=torch.int32),
                                    cache, 0, cfg)
        assert calls == want and bool(torch.isfinite(logits).all())


def test_wrappers_raise_on_cuda_inputs_they_do_not_take():
    """The wrappers stay strict: the guards a CUDA input meets before any
    launch raise for an input the kernel does not take; nothing inside a
    wrapper gives way to the plain version."""
    from horovod_tpu_torch.ops import attention as tattn
    from horovod_tpu_torch.ops import fused_conv_bn as tconv
    from horovod_tpu_torch.ops import paged_attention as tpaged
    q = torch.zeros((1, 8, 2, 128), dtype=torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        tattn._check_cuda_inputs(q, q, q)
    qh = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="d_head"):
        tattn._check_cuda_inputs(qh, qh, qh)
    qd = torch.zeros((2, 2, 64), dtype=torch.bfloat16)
    pool = torch.zeros((3, 4, 2, 64), dtype=torch.bfloat16)
    tables = torch.ones((2, 1), dtype=torch.int32)
    pos = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="d_head"):
        tpaged._check_cuda_inputs(qd, pool, pool, tables, pos)
    x = torch.zeros((8, 96), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 64"):
        tconv._check_cuda(x, torch.zeros((64, 96)), None, None)
    with pytest.raises(TypeError):
        tconv._check_cuda(torch.zeros((8, 64)), torch.zeros((64, 64)),
                          None, None)

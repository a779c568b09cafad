"""The port's step profiler (``python -m horovod_tpu_torch.profile_step``)
against the JAX package's ``bin/profile_step.py``: the host-plane report
of a timeline the port wrote equals JAX's, and the per-step tables of a
CPU ``torch.profiler`` trace of the bench's smoke LM step add up, divide
by the steps the trace holds and carry JAX's columns."""

import contextlib
import importlib.util
import io
import json
import os
import time

import pytest
import torch

from torch_conv_common import one_thread
from horovod_tpu_torch import profile_step as tps
from horovod_tpu_torch import runtime
from horovod_tpu_torch.utils.timeline import Timeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_step", os.path.join(REPO, "bin", "profile_step.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jps = _load_jax_tool()


def _printed(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


@pytest.mark.parametrize("closed", [True, False], ids=["closed", "open"])
def test_timeline_host_report_equals_jax(tmp_path, closed):
    path = str(tmp_path / "timeline.json")
    tl = Timeline(path)
    for i in range(3):
        with tl.op(f"batch{i}", "H2D"):
            time.sleep(0.002)
    with tl.op("ckpt", "CKPT_SNAPSHOT"):
        time.sleep(0.001)
    with tl.op("ckpt", "CKPT_WRITE"):
        time.sleep(0.003)
    with tl.op("grad", "ALLREDUCE"):
        pass
    if closed:
        tl.close()
    else:
        tl.flush()
    want = _printed(jps.timeline_host_report, path)
    assert "H2D" in want and "CKPT_WRITE" in want
    assert _printed(tps.timeline_host_report, path) == want
    if not closed:
        tl.close()


def test_timeline_without_host_phases_exits_like_jax(tmp_path):
    path = str(tmp_path / "timeline.json")
    tl = Timeline(path)
    with tl.op("grad", "ALLREDUCE"):
        pass
    tl.close()
    for tool in (jps, tps):
        with pytest.raises(SystemExit, match="no host-plane phases"):
            tool.timeline_host_report(path)


@pytest.fixture(scope="module")
def lm_trace():
    """A CPU trace of the bench's smoke LM step, 2 profiled steps."""
    runtime.init(device="cpu")
    try:
        return tps.profile_model("transformer_lm", "xla", 2,
                                 torch.device("cpu"))
    finally:
        runtime.shutdown()


def test_categories_sum_to_the_busy_total(lm_trace):
    agg = tps.aggregate(lm_trace, "cpu")
    cats = agg["categories"]
    assert sum(c["ms_per_step"] for c in cats.values()) == pytest.approx(
        agg["busy_ms_per_step"], rel=1e-9)
    assert sum(c["pct_busy"] for c in cats.values()) == pytest.approx(100)
    assert {"GEMM", "elementwise", "copy"} <= set(cats)
    assert 0 < agg["busy_ms_per_step"] <= agg["step_wall_ms_mean"]
    assert agg["top_ops"][0]["ms_per_step"] == max(
        o["ms_per_step"] for o in agg["top_ops"])


def test_divisor_is_the_trace_step_count(lm_trace):
    agg = tps.aggregate(lm_trace, "cpu")
    assert agg["steps"] == tps.step_count(lm_trace) == 2
    # A trace that lost a step marker divides by what it holds.
    marks = [i for i, e in enumerate(lm_trace)
             if e.get("name") == tps.STEP_MARK
             and e.get("cat") == "user_annotation"]
    one = [e for i, e in enumerate(lm_trace) if i != marks[0]]
    agg1 = tps.aggregate(one, "cpu")
    assert agg1["steps"] == 1
    assert agg1["busy_ms_per_step"] == pytest.approx(
        2 * agg["busy_ms_per_step"])
    with pytest.raises(SystemExit, match="step marker"):
        tps.aggregate([e for i, e in enumerate(lm_trace)
                       if i not in marks], "cpu")


def _jax_headers() -> list:
    """The two table headers JAX's ``report`` prints, from a minimal
    XLA-shaped trace."""
    meta = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": t,
             "args": {"name": n}} for t, n in ((1, "XLA Ops"),
                                                (2, "XLA Modules"))]
    events = meta + [
        {"ph": "X", "pid": 1, "tid": 2, "name": "jit_step", "dur": 10.0},
        {"ph": "X", "pid": 1, "tid": 1, "name": "fusion.1",
         "args": {"device_duration_ps": 10 ** 6, "device_offset_ps": 0,
                  "hlo_category": "convolution"}}]
    lines = _printed(jps.report, events, 1, 1).splitlines()
    return [ln for ln in lines if ln.startswith(("category", "top ops"))]


def test_tables_have_jax_columns(lm_trace):
    out = _printed(tps.report, tps.aggregate(lm_trace, "cpu")).splitlines()
    assert [ln for ln in out if ln.startswith(("category", "top ops"))] \
        == _jax_headers() == [tps.CATEGORY_HEADER, tps.TOP_HEADER]
    assert out[1].startswith("device busy:")


def test_kernel_names_map_to_the_card_categories():
    assert tps.category("void flash_fwd_wgmma_kernel<true>(Params)") \
        == "flash_fwd_wgmma"
    assert tps.category("flash_bwd_dkv_kernel") == "flash_bwd_dkv"
    assert tps.category("flash_bwd_dq_kernel") == "flash_bwd_dq"
    assert tps.category("conv_bn_bwd_dx_kernel<4, true>") == "conv_bn_bwd"
    assert tps.category("conv_bn_fwd_kernel<2, false, true>") \
        == "conv_bn_fwd"
    assert tps.category("conv_bn_col_sum_kernel") == "conv_bn_aux"
    assert tps.category("paged_decode_split_kernel") == "paged_decode"
    assert tps.category("nvjet_hsh_256x128_64x4_1x2_h_bz_coopA_TNT") \
        == "GEMM"
    assert tps.category("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "NCCL"
    assert tps.category(
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::direct_copy_kernel_cuda>") == "copy"
    assert tps.category("void at::native::reduce_kernel<512, 1>") \
        == "reduction"
    assert tps.category("Memcpy DtoH (Device -> Pinned)") == "copy"


def test_a_card_trace_without_kernels_is_refused(lm_trace):
    """A ``cuda`` run whose trace recorded no CUDA activity exits naming
    it, instead of reporting the host's ops as the card's time."""
    with pytest.raises(SystemExit, match="no CUDA activity"):
        tps.aggregate(lm_trace, "cuda")


def test_cpu_ops_map_by_name():
    assert tps.category("aten::mm", "cpu") == "GEMM"
    assert tps.category("aten::copy_", "cpu") == "copy"
    assert tps.category("aten::gelu_backward", "cpu") == "elementwise"
    assert tps.category("aten::_softmax", "cpu") == "reduction"
    assert tps.category("aten::view", "cpu") == "other"
    assert tps.category("MmBackward0", "cpu") == "other"
    # A kernel-shaped name on the CPU is not a kernel.
    assert tps.category("flash_fwd_wgmma_kernel", "cpu") == "other"


def test_main_on_the_cpu_prints_the_tables_and_json(capsys):
    assert tps.main(["--device", "cpu", "--model", "transformer_lm",
                     "--steps", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    last = json.loads(out[-1])
    assert last["steps"] == 1 and last["model"] == "transformer_lm"
    assert tps.CATEGORY_HEADER in out
    assert not runtime.is_initialized()


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tps.main(["--model", "transformer_lm"])
    assert not runtime.is_initialized()


@pytest.mark.parametrize("model", ["resnet101", "vgg16", "inception3"])
def test_every_bench_model_profiles_on_the_cpu(model, capsys):
    """``--model`` takes every bench model, as JAX's ``bin/profile_step.
    py`` does; on the CPU the conv rows take the smoke swap to
    cifar20."""
    with one_thread():
        assert tps.main(["--device", "cpu", "--model", model, "--steps",
                         "1"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["steps"] == 1 and last["model"] == model
    assert last["busy_ms_per_step"] > 0
    assert not runtime.is_initialized()


@pytest.mark.parametrize("model", ["vgg16", "inception3", "resnet101"])
def test_fused_guard_refuses_as_jax_does(model):
    """JAX's mislabel guard (``bin/profile_step.py:243-250``): the fused
    backend only for resnet50/resnet101, and never on the smoke swap
    (the CPU's config), so every CPU run with it is refused."""
    with pytest.raises(SystemExit, match="resnet50/resnet101"):
        tps.main(["--device", "cpu", "--model", model, "--conv-backend",
                  "fused", "--steps", "1"])
    assert not runtime.is_initialized()

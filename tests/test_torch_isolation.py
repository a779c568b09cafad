"""The port stands alone: importing it never loads JAX or the JAX
package, no file of it names them, and its entry points default to the
GPU — raising on a host without CUDA instead of running on the CPU."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch
from horovod_tpu_torch import runtime
from horovod_tpu_torch.models import ResNetConfig, resnet50
from horovod_tpu_torch.models.resnet import ResNet
from horovod_tpu_torch.parallel.kv_blocks import init_paged_kv_cache
from horovod_tpu_torch.parallel.mesh import create_hybrid_mesh
from horovod_tpu_torch.parallel.pp_transformer import (
    init_pp_params, make_pp_transformer_train_step)
from horovod_tpu_torch.parallel.transformer import (
    Transformer, TransformerConfig, make_parallel_train_step)
from horovod_tpu_torch.serve import GenerationConfig, GenerationEngine
from horovod_tpu_torch.training import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "horovod_tpu_torch")
TINY = TransformerConfig(vocab=16, d_model=64, n_heads=1, n_layers=1,
                         d_ff=64, dtype=torch.float32)

_PROBE = """
import importlib, pkgutil, sys
import horovod_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for needed in ("horovod_tpu_torch.ops.sparse", "horovod_tpu_torch.elastic",
               "horovod_tpu_torch.launcher", "horovod_tpu_torch.obs.summary",
               "horovod_tpu_torch.ops.quant",
               "horovod_tpu_torch.serve.engine",
               "horovod_tpu_torch.serve.router",
               "horovod_tpu_torch.serve.fleet",
               "horovod_tpu_torch.serve.proc_replica",
               "horovod_tpu_torch.serve.tp_plane",
               "horovod_tpu_torch.serve_bench",
               "horovod_tpu_torch.profile_step"):
    assert needed in names, names
for name in names:
    if not name.endswith(".__main__"):   # running it would launch
        importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "horovod_tpu" or m.startswith("horovod_tpu."))
print(len(names), "modules;", "leaked:", bad)
sys.exit(1 if bad else 0)
"""


def test_import_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout


def test_every_submodule_is_importable_here():
    names = [m.name for m in pkgutil.walk_packages(
        horovod_tpu_torch.__path__, "horovod_tpu_torch.")]
    assert {"horovod_tpu_torch.ops.attention",
            "horovod_tpu_torch.ops.paged_attention",
            "horovod_tpu_torch.serve.generate",
            "horovod_tpu_torch.serve.tp_plane",
            "horovod_tpu_torch.ops.fused_conv_bn",
            "horovod_tpu_torch.ops.collectives",
            "horovod_tpu_torch.ops.fusion",
            "horovod_tpu_torch.ops.sparse",
            "horovod_tpu_torch.models.resnet",
            "horovod_tpu_torch.runtime",
            "horovod_tpu_torch.optimizer",
            "horovod_tpu_torch.training",
            "horovod_tpu_torch.utils.config",
            "horovod_tpu_torch.utils.flops",
            "horovod_tpu_torch.parallel.mesh",
            "horovod_tpu_torch.parallel.pipeline",
            "horovod_tpu_torch.parallel.pp_transformer",
            "horovod_tpu_torch.bench",
            "horovod_tpu_torch.elastic",
            "horovod_tpu_torch.launcher",
            "horovod_tpu_torch.launcher.__main__",
            "horovod_tpu_torch.obs.summary",
            "horovod_tpu_torch.serve.router",
            "horovod_tpu_torch.serve.fleet",
            "horovod_tpu_torch.serve.proc_replica",
            "horovod_tpu_torch.serve_bench",
            "horovod_tpu_torch.profile_step"} <= set(names)


# What a subprocess replica's worker runs before it serves: its module,
# the engine built from a spec, the HTTP server, one stream.
_WORKER_PROBE = """
import json, sys
from horovod_tpu_torch.serve import proc_replica
from horovod_tpu_torch.serve.server import HttpServer
spec = {"model": dict(vocab=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                      dtype="float32", unembed_dtype="float32"),
        "seed": 0, "device": "cpu",
        "generation": dict(max_slots=1, max_len=8, default_max_new_tokens=2)}
eng = proc_replica.build_engine(spec)
eng.warmup()
srv = HttpServer(generate=eng).start()
out = eng.generate([1, 2, 3], timeout=60)
srv.stop()
eng.shutdown()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "horovod_tpu" or m.startswith("horovod_tpu."))
print(len(out["tokens"]), "tokens;", "leaked:", bad)
sys.exit(1 if bad else 0)
"""


def test_replica_worker_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _WORKER_PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 tokens; leaked: []" in proc.stdout


def test_replica_worker_defaults_to_cuda(monkeypatch):
    """A spec without ``device`` builds on the card: without CUDA the
    worker raises rather than serving from the CPU."""
    from horovod_tpu_torch.serve.proc_replica import build_engine
    _without_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine({"model": dict(vocab=16, d_model=64, n_heads=1,
                                    n_layers=1, d_ff=64, dtype="float32")})


def test_no_file_names_jax_or_the_jax_package():
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(root, f)
            with open(path, encoding="utf-8") as fh:
                text = fh.read()
            for needle in ("import jax", "from jax", "horovod_tpu."):
                if needle in text:
                    offenders.append(f"{path}: {needle}")
    assert not offenders, offenders


def _without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(monkeypatch):
    _without_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_paged_kv_cache(TINY, 4, 16, 1)


def test_engine_default_device_raises_without_cuda(monkeypatch):
    model = Transformer(TINY, device="cpu")
    _without_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(model, GenerationConfig(max_slots=1, max_len=16))


def test_training_entry_points_raise_without_cuda(monkeypatch):
    tiny = ResNetConfig(stage_sizes=(1,), num_classes=2, num_filters=8,
                        dtype=torch.float32)
    cpu_model = ResNet(tiny, device="cpu")
    _without_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.init()
    assert not runtime.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet50()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(cpu_model, torch.optim.SGD)
    # ... and run when asked for the CPU.
    state = create_train_state(cpu_model, lambda p: torch.optim.SGD(
        p, lr=0.1), device="cpu")
    assert state.step == 0 and len(state.params) == 17


def test_lm_train_step_defaults_to_cuda(monkeypatch):
    _without_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_parallel_train_step(TINY, torch.optim.AdamW)
    init_state, _ = make_parallel_train_step(TINY, torch.optim.AdamW,
                                             device="cpu")
    assert init_state(0).model.device.type == "cpu"


def test_unsupported_device_type_is_rejected():
    with pytest.raises(ValueError, match="unsupported device"):
        Transformer(TINY, device="meta")


def test_pp_train_step_defaults_to_cuda(monkeypatch):
    """The pipelined step and its parameters default to the GPU; the mesh
    is built over the world, which itself defaults to the GPU."""
    monkeypatch.setenv("HVD_SIZE", "1")
    monkeypatch.setenv("HVD_RANK", "0")
    _without_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.init()
    with pytest.raises(ValueError, match="not been initialized"):
        create_hybrid_mesh(dp=1, pp=1)
    runtime.init(device="cpu")
    try:
        mesh = create_hybrid_mesh(dp=1, pp=1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_pp_transformer_train_step(TINY, mesh, torch.optim.AdamW, 1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_pp_params(torch.Generator(), TINY, 1, 0)
        init_state, _ = make_pp_transformer_train_step(
            TINY, mesh, torch.optim.AdamW, 1, device="cpu")
        assert init_state(0).params["embed"].device.type == "cpu"
    finally:
        runtime.shutdown()


def test_bench_entry_defaults_to_cuda(monkeypatch):
    """The bench entry runs on the card unless ``--device cpu`` is given:
    without CUDA it exits before building a world, and never falls back
    to the CPU."""
    from horovod_tpu_torch import bench
    _without_cuda(monkeypatch)
    with pytest.raises(SystemExit, match="--device cpu"):
        bench.main([])
    assert not runtime.is_initialized()


def test_serve_bench_and_profile_step_default_to_cuda(monkeypatch):
    """The two tool entries run on the card unless ``--device cpu`` is
    given: without CUDA they exit naming the flag, before any engine or
    world is built."""
    from horovod_tpu_torch import profile_step, serve_bench
    _without_cuda(monkeypatch)
    for argv in ([], ["--mode", "generate"]):
        with pytest.raises(SystemExit, match="--device cpu"):
            serve_bench.main(argv)
    with pytest.raises(SystemExit, match="--device cpu"):
        profile_step.main([])
    assert not runtime.is_initialized()


_ENTRY_PROBE = """
import sys
from horovod_tpu_torch import profile_step, serve_bench
assert serve_bench.main(["--device", "cpu", "--mode", "generate", "--qps",
                         "50", "--duration", "0.1", "--gen-tokens", "2"]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "horovod_tpu" or m.startswith("horovod_tpu."))
print("leaked:", bad)
sys.exit(1 if bad else 0)
"""


def test_tool_entries_run_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _ENTRY_PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout

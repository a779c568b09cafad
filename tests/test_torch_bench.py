"""The port's bench entry (``python -m horovod_tpu_torch.bench``) and the
model pieces its model builder reaches, on the CPU.

* ``cifar_resnet_v1`` (``BasicBlock`` behind the CIFAR stem; the smoke
  model) and the bottleneck block's ``fused_parts`` against the JAX
  package's flax models from the same variables, at f32: the tolerances
  of ``test_torch_resnet.py`` (logits and loss rtol 1e-4 / atol 1e-5,
  batch_stats rtol 1e-4 / atol 1e-6, gradients rtol 2e-3 / atol 1e-4 of
  each leaf's largest entry); only the named 1x1 convs take the fused
  op. The 20-layer model's gradients are held against the flax model
  run in f64: XLA's f32 gradients of it on the CPU are up to 7% off
  their f64 values (the port's f32 ones 3e-6).
* The bench's formulas and configs against the root ``bench.py``'s.
* The bench at smoke size in a subprocess (``--device cpu``): the two
  default lines, their names and knob fields, null device fields; the
  knobs it runs (accumulation, the wire formats, ``HVD_LM_LOSS_CHUNK``,
  ZeRO and overlap with the order overlap used) recorded in the line;
  and the knobs not ported yet refused with a non-zero exit naming
  their ``ROADMAP.md`` item.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import resnet as jres
from horovod_tpu_torch import bench as tbench
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.utils import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _randomized(variables, seed=0):
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        a = np.asarray(leaf, np.float32)
        if "scale" in name:
            return (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        if "bias" in name or "mean" in name:
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        if "var" in name:
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(perturb,
                                            jax.device_get(variables))


def _assert_trees_close(got, want, rtol, atol, rel=True):
    """Per leaf; ``atol`` is relative to the leaf's largest entry when
    ``rel``, absolute otherwise."""
    gl = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    wl = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert sorted(map(jax.tree_util.keystr, gl)) == \
        sorted(map(jax.tree_util.keystr, wl))
    for path, w in wl.items():
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-30) if rel else 1.0
        np.testing.assert_allclose(
            np.asarray(gl[path]), w, rtol=rtol, atol=atol * scale,
            err_msg=jax.tree_util.keystr(path))


def _flax_grads(model):
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        node = out
        path = name.split(".")
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    return out


def _flax_train(jmodel, variables, x, y):
    def loss_fn(params, stats):
        logits, new = jmodel.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        return (-jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                              axis=-1)),
                (logits, new["batch_stats"]))
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])


def _compare_train_forward(jmodel, variables, port_model, x, y,
                           grad_model=None):
    """Train-mode logits, loss, updated batch_stats and gradients of the
    port's model against the flax model's (the gradients against
    ``grad_model``'s, an f64 flax model, when given)."""
    (jloss, (jlogits, jstats)), jgrads = _flax_train(jmodel, variables, x, y)
    if grad_model is not None:
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        _, jgrads = _flax_train(grad_model, v64, x.astype(np.float64), y)
    logits = port_model(torch.from_numpy(x), train=True)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    _assert_trees_close(convert.resnet_to_numpy(port_model)["batch_stats"],
                        jax.device_get(jstats), rtol=1e-4, atol=1e-6,
                        rel=False)
    _assert_trees_close(_flax_grads(port_model), jax.device_get(jgrads),
                        rtol=2e-3, atol=1e-4)


def test_cifar_resnet_v1_matches_flax():
    jmodel = jres.cifar_resnet_v1(20, dtype=jnp.float32)
    variables = _randomized(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32)))
    port = tres.cifar_resnet_v1(20, dtype=torch.float32, device="cpu")
    assert [n for n, _ in convert.jax_leaf_order(port)] == [
        ".".join(str(k.key) for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(variables["params"])[0]]
    model = convert.resnet_from_jax(variables, port.cfg, device="cpu")
    rng = np.random.RandomState(3)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.randint(0, 10, 4)
    _compare_train_forward(
        jmodel, variables, model, x, y,
        grad_model=jres.cifar_resnet_v1(20, dtype=jnp.float64))
    # Eval: BatchNorm on the (updated) running statistics, as flax.
    want = jmodel.apply(
        {"params": variables["params"],
         "batch_stats": convert.resnet_to_numpy(model)["batch_stats"]},
        jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="6n\\+2"):
        tres.cifar_resnet_v1(21, device="cpu")


SMALL = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10)


@pytest.fixture(scope="module")
def small_variables():
    jmodel = jres.ResNet(block_cls=jres.BottleneckBlock, dtype=jnp.float32,
                         **SMALL)
    return _randomized(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))


@pytest.mark.parametrize("parts", [("reduce",), ("expand",), ("shortcut",),
                                   ("reduce", "shortcut"), ()])
def test_fused_parts_match_flax(parts, small_variables, monkeypatch):
    """Stage 0's and stage 1's blocks take the fused branch (M = 1024 and
    256 at batch 4, 64²); only the 1x1 convs named in ``fused_parts``
    call the fused op — one site per block for each part (both blocks
    have a projection shortcut)."""
    jmodel = jres.ResNet(block_cls=jres.BottleneckBlock, dtype=jnp.float32,
                         conv_backend="fused", fused_parts=parts, **SMALL)
    model = convert.resnet_from_jax(
        small_variables, tres.ResNetConfig(
            dtype=torch.float32, conv_backend="fused", fused_parts=parts,
            **SMALL), device="cpu")
    calls = []
    real = tres.fused_linear_bn_act

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(tres, "fused_linear_bn_act", counting)
    rng = np.random.RandomState(4)
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    y = rng.randint(0, 10, 4)
    _compare_train_forward(jmodel, small_variables, model, x, y)
    assert len(calls) == sum({"reduce": 2, "expand": 2, "shortcut": 2}[p]
                             for p in parts)


def test_fused_parts_are_validated():
    with pytest.raises(ValueError, match="fused_parts"):
        tres.ResNetConfig(fused_parts=("reduce", "squeeze"))


def _root_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_formulas_and_configs_match_the_root_bench():
    ref = _root_bench()
    assert tbench.BASELINE_IMG_PER_SEC_PER_DEVICE == \
        ref.BASELINE_IMG_PER_SEC_PER_DEVICE
    assert flops.FWD_GMACS == ref._FWD_GMACS
    assert flops.TRAIN_GFLOP_PER_IMAGE == ref.TRAIN_GFLOP_PER_IMAGE
    for model in ("resnet50", "cifar20"):
        assert tbench._baseline_for(model) == ref._baseline_for(model)
    for port, jax_cfg in ((tbench._LM_GPU, ref._LM_TPU),
                          (tbench._LM_SMOKE, ref._LM_SMOKE)):
        renamed = {("batch_per_gpu" if k == "batch_per_chip" else k): v
                   for k, v in jax_cfg.items()}
        assert port == renamed
        assert flops.lm_train_gflop_per_token(port) == \
            ref.lm_train_gflop_per_token(jax_cfg)
    rn = {("batch_per_gpu" if k == "batch_per_chip" else k): v
          for k, v in ref._TPU_CONFIGS["resnet50"].items()}
    assert tbench._GPU_CONFIGS["resnet50"] == rn
    for n, tp, pp in ((1, 1, 1), (4, 2, 1), (8, 2, 2)):
        assert tbench._mesh_desc(n, tp, pp) == ref._mesh_desc(n, tp, pp)
    assert flops.peaks_for("NVIDIA H100 80GB HBM3")[0] == 989e12


def _bench(*args, env=None):
    # Two intra-op threads: the suite runs files side by side, and an
    # oversubscribed CPU slows the smoke steps tenfold.
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                 **(env or {})))


def _lines(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]


KNOBS = ("accum_steps", "zero", "overlap", "wire_dtype", "tp", "pp", "mesh")
DEVICE_ONLY = ("tflops_per_gpu", "mfu", "peak_bytes_per_gpu", "gpu")


def test_default_run_prints_both_lines():
    rn, lm = _lines(_bench("--device", "cpu"))
    assert rn["metric"] == "cifar20_synthetic_images_per_sec_per_cpu"
    assert rn["unit"] == "images/sec/cpu"
    assert lm["metric"] == "transformer_lm_tokens_per_sec_per_cpu"
    assert lm["unit"] == "tokens/sec/cpu"
    for line in (rn, lm):
        assert line["value"] > 0 and line["vs_baseline"] >= 0
        assert {k: line[k] for k in KNOBS} == {
            "accum_steps": 1, "zero": False, "overlap": False,
            "wire_dtype": "fp32", "tp": 1, "pp": 1, "mesh": "dp1"}
        assert line["world"] == 1
        # No device number from a CPU run.
        assert all(line[k] is None for k in DEVICE_ONLY)
    assert lm["ep"] == 1 and lm["loss_chunk"] == 0
    assert rn["conv_backend"] == "xla"
    ph = rn["phases"]
    assert set(ph) == {"backward_s", "collective_exposed_s", "update_s",
                       "backward_share", "collective_share",
                       "update_share"}
    assert 0 < ph["backward_share"] <= 1


@pytest.mark.parametrize("args,env,want", [
    (("--model", "transformer_lm", "--accum-steps", "2", "--wire-dtype",
      "fp8"), {"HVD_LM_LOSS_CHUNK": "64"},
     {"accum_steps": 2, "wire_dtype": "fp8", "loss_chunk": 64}),
    (("--model", "resnet50", "--accum-steps", "2", "--wire-dtype", "bf16"),
     {}, {"accum_steps": 2, "wire_dtype": "bf16",
          "metric": "cifar20_synthetic_images_per_sec_per_cpu"}),
    (("--model", "transformer_lm", "--zero", "--overlap"), {},
     {"zero": True, "overlap": True, "overlap_order": "probed"}),
    (("--model", "resnet50", "--zero", "--accum-steps", "2"), {},
     {"zero": True, "overlap": False, "overlap_order": None,
      "accum_steps": 2}),
])
def test_knobs_are_run_and_recorded(args, env, want):
    (line,) = _lines(_bench(*args, "--device", "cpu", env=env))
    assert {k: line[k] for k in want} == want
    assert line["value"] > 0


def test_scaling_runs_gloo_worlds_through_the_launcher():
    """``--scaling --device cpu``: the launcher runs the bench in gloo
    worlds of 1 and 2; one scaling line each (bench.py's, per CPU here),
    then the world of 2's per-CPU line."""
    lines = _lines(_bench("--scaling", "--device", "cpu"))
    assert [ln["metric"] for ln in lines] == [
        "cifar20_scaling_efficiency_1cpus",
        "cifar20_scaling_efficiency_2cpus",
        "cifar20_synthetic_images_per_sec_per_cpu"]
    one, two, per = lines
    assert one["value"] == 1.0 and one["vs_baseline"] == round(1 / 0.9, 3)
    assert (one["world"], one["mesh"], two["world"], two["mesh"]) == \
        (1, "dp1", 2, "dp2")
    assert two["value"] == pytest.approx(
        two["images_per_sec_total"] / (2 * one["images_per_sec_total"]),
        abs=1e-3)
    for ln in (one, two):
        assert ln["unit"] == "fraction" and ln["images_per_sec_total"] > 0
        assert {k: ln[k] for k in KNOBS} == {
            "accum_steps": 1, "zero": False, "overlap": False,
            "wire_dtype": "fp32", "tp": 1, "pp": 1, "mesh": ln["mesh"]}
    assert per["world"] == 2 and per["value"] * 2 == pytest.approx(
        two["images_per_sec_total"], rel=1e-3)


@pytest.mark.parametrize("args,needle", [
    (("--pp", "2", "--zero"), "item 11"),
    (("--pp", "2", "--overlap"), "item 11"),
    (("--tp", "2"), "item 11"),
])
def test_refusals_exit_nonzero_naming_the_roadmap_item(args, needle):
    proc = _bench(*args, "--device", "cpu")
    assert proc.returncode != 0
    assert needle in proc.stderr and "ROADMAP.md" in proc.stderr, \
        proc.stderr[-2000:]
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("args,needle", [
    (("--mesh", "dp=1,tp=2"), "item 11"),
    (("--model", "vgg16"), "item 14"),
    (("--conv-backend", "fused"), "smoke"),
    (("--accum-steps", "3"), "does not divide"),
    (("--accum-steps", "0"), ">= 1"),
    (("--mesh", "dp=1,ep=2"), "--mesh expects"),
    (("--model", "transformer_lm", "--pp", "2"), "must divide the world"),
    (("--pp", "2"), "conv models are not staged"),
    (("--scaling", "--model", "transformer_lm"),
     "--scaling is not supported for transformer_lm"),
    (("--scaling", "--pp", "2"), "pure dp worlds"),
])
def test_other_refusals_name_why(args, needle, monkeypatch):
    for var in ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match=needle):
        tbench.main([*args, "--device", "cpu"])
    from horovod_tpu_torch import runtime
    assert not runtime.is_initialized()


def test_no_gpu_and_no_cpu_flag_exits_nonzero():
    proc = _bench()
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not proc.stdout.strip()

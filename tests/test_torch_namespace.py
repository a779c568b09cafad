"""The port's package namespaces hold the reference's public names: a JAX
user's ``hvd.models.resnet50()`` or ``hvd.callbacks.LearningRateWarmup
Callback(...)`` resolves once the import says ``horovod_tpu_torch``.

Each side is listed in a fresh interpreter (the port's without JAX), so
what a name resolves to never depends on what an earlier test imported.
The names with no torch meaning are absent on purpose, each for the
reason beside it (``ROADMAP.md`` Queue 3)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("", ".obs", ".parallel", ".ops", ".models", ".data")

# Public names of the reference that the port leaves out, by module.
ABSENT = {
    "": {
        "mesh": "returns the world's jax Mesh; the port's meshes are "
                "parallel.mesh.create_hybrid_mesh objects over process "
                "groups",
    },
    ".obs": {},
    ".parallel": {
        "init_params": "draws a JAX PRNG parameter tree; the port builds "
                       "Transformer(cfg, generator=) or takes JAX's tree "
                       "through convert.params_from_jax",
    },
    ".models": {
        "MnistCNN": "the MNIST examples' model: ROADMAP item 15",
        "mnist": "the MNIST examples' model module: ROADMAP item 15",
        "SkipGram": "word2vec: ROADMAP item 15",
        "embedding_grads_as_slices": "word2vec: ROADMAP item 15",
        "word2vec": "word2vec's module: ROADMAP item 15",
    },
    ".data": {},
    ".ops": {
        "pallas_attention": "a Pallas module; the port's kernels are "
                            "ops.attention and ops/csrc",
        "pallas_conv": "a Pallas module; the port's kernel is "
                       "ops.fused_conv_bn and ops/csrc",
    },
}

_LIST = """
import importlib, json, sys
out = {}
for suffix in %r:
    mod = importlib.import_module(sys.argv[1] + suffix)
    out[suffix] = sorted(n for n in dir(mod) if not n.startswith("_"))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
out["jax_loaded"] = bool(bad)
print(json.dumps(out))
""" % (MODULES,)


def _public(package: str) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _LIST, package], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def listings():
    return _public("horovod_tpu"), _public("horovod_tpu_torch")


@pytest.mark.parametrize("suffix", MODULES)
def test_port_holds_every_reference_name(listings, suffix):
    ref, port = listings
    missing = set(ref[suffix]) - set(port[suffix])
    absent = set(ABSENT[suffix])
    assert missing == absent, (
        f"horovod_tpu_torch{suffix} lacks {sorted(missing - absent)}; "
        f"listed as absent but present: {sorted(absent - missing)}")


def test_port_listing_loads_no_jax(listings):
    assert listings[1]["jax_loaded"] is False


def test_user_code_of_the_reference_resolves():
    import horovod_tpu_torch as hvd
    assert callable(hvd.models.resnet50)
    assert callable(hvd.models.resnet101) and callable(hvd.models.vgg16)
    assert callable(hvd.models.inception_v3)
    assert callable(hvd.data.load_dataset)
    assert hvd.AXIS == "hvd" and hvd.AXIS is hvd.runtime.AXIS
    assert isinstance(hvd.callbacks.LearningRateWarmupCallback, type)
    assert isinstance(hvd.BroadcastGlobalVariablesHook, type)
    assert issubclass(hvd.FailoverExhaustedError, hvd.HorovodError)
    assert hvd.world is hvd.runtime.world
    assert hvd.serve.GenerationEngine is not None
    assert hvd.obs.FleetPoller is hvd.obs.summary.FleetPoller
    assert hvd.ops.allreduce is hvd.allreduce
    assert hvd.ops.plan_buckets is hvd.ops.fusion.plan_buckets
    assert hvd.parallel.prefill is hvd.parallel.transformer.prefill

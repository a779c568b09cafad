"""The port's conv examples (``horovod_tpu_torch/examples/``), on the CPU:
``imagenet_resnet50`` (rank-0 asynchronous checkpoints, then a relaunch
that resumes from the saved step broadcast from rank 0, the allreduced
final eval), ``cifar10_resnet`` (v1 and v2) and ``cifar10_cnn``, each in
a gloo world of 2 through the port's launcher ``--cpu`` at tiny sizes
(imagenet on its synthetic set; the CIFAR examples on a small
``cifar10.npz`` in the Keras layout under ``HVD_DATA_DIR``); and
``Cifar10CNN`` against the JAX example's flax module from the same
variables (eval forward and its gradients, f32; the tolerances of
``torch_conv_common``).
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_conv_common as cc
from torch_conv_common import one_intra_op_thread  # noqa: F401
from horovod_tpu_torch import convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(module, *args, data_dir="", timeout=240):
    # One intra-op thread a rank (the launcher would give each of the two
    # half the host's cores): the suite runs files side by side.
    env = dict(os.environ, PYTHONPATH=ROOT, HVD_RESTART_BACKOFF_MAX="0",
               HVD_DATA_DIR=data_dir, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.launcher", "-np", "2",
         "--cpu", sys.executable, "-m",
         f"horovod_tpu_torch.examples.{module}", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def _ok(proc):
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    return proc.stdout


IMAGENET = ("--image", "32", "--classes", "10", "--batch-per-chip", "32",
            "--warmup-epochs", "1")


def test_imagenet_example_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    out = _ok(_launch("imagenet_resnet50", *IMAGENET, "--epochs", "1",
                      "--ckpt-dir", ck))
    # 256 synthetic images at a global batch of 64: 4 steps an epoch.
    assert sorted(os.listdir(ck)) == ["ckpt_4"]
    assert "epoch 1/1" in out and "resumed" not in out
    assert "final eval accuracy (allreduced):" in out
    out = _ok(_launch("imagenet_resnet50", *IMAGENET, "--epochs", "2",
                      "--ckpt-dir", ck))
    assert "resumed from step 4 (epoch 1)" in out
    assert "epoch 2/2" in out and "epoch 1/2" not in out
    assert sorted(os.listdir(ck)) == ["ckpt_4", "ckpt_8"]
    acc = float(out.split("final eval accuracy (allreduced):")[1].split()[0])
    assert 0.0 <= acc <= 1.0


@pytest.fixture(scope="module")
def small_cifar(tmp_path_factory):
    """A 128 + 32-image ``cifar10.npz`` in the Keras archive layout."""
    d = tmp_path_factory.mktemp("cifar")
    rng = np.random.RandomState(0)
    np.savez(d / "cifar10.npz",
             x_train=rng.randint(0, 256, (128, 32, 32, 3)).astype(np.uint8),
             y_train=rng.randint(0, 10, (128, 1)).astype(np.uint8),
             x_test=rng.randint(0, 256, (32, 32, 32, 3)).astype(np.uint8),
             y_test=rng.randint(0, 10, (32, 1)).astype(np.uint8))
    return str(d)


@pytest.mark.parametrize("version,depth", [(1, 8), (2, 11)])
def test_cifar10_resnet_example_runs(version, depth, small_cifar):
    out = _ok(_launch("cifar10_resnet", "--version", str(version),
                      "--depth", str(depth), "--epochs", "1",
                      "--batch-per-chip", "16", data_dir=small_cifar))
    # 128 images at a global batch of 32: 4 steps.
    assert "epoch 1/1" in out and "4 steps" in out and "val_loss" in out


def test_cifar10_cnn_example_runs(small_cifar):
    out = _ok(_launch("cifar10_cnn", "--epochs", "1", "--batch-per-chip",
                      "16", data_dir=small_cifar))
    assert "epoch 1/1" in out and "4 steps" in out and "val_loss" in out


def _jax_cnn():
    """The JAX example's ``Cifar10CNN`` (its ``common`` import wants the
    examples directory on the path)."""
    path = os.path.join(ROOT, "examples", "cifar10_cnn.py")
    sys.path.insert(0, os.path.dirname(path))
    try:
        spec = importlib.util.spec_from_file_location("jax_cifar10_cnn",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.dirname(path))
    return mod.Cifar10CNN()


def test_cifar10_cnn_matches_the_jax_example():
    from horovod_tpu_torch.examples.cifar10_cnn import Cifar10CNN
    jm = _jax_cnn()
    variables = cc.init_variables(jm, (1, 32, 32, 3))
    x, y = cc.batch(4, 32, seed=6)

    def loss_fn(params):
        logits = jm.apply({"params": params}, jnp.asarray(x), train=False)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(y)[:, None], axis=-1)), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    port = convert.conv_from_jax(variables, Cifar10CNN(device="cpu"))
    assert cc.roundtrip_equal(port, variables)
    assert cc.leaf_order_matches(port, variables)
    logits = port(torch.tensor(x), train=False)
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **cc.LOGITS_TOL)
    cc.assert_trees_close(cc.grads_tree(port), jax.device_get(jgrads),
                          **cc.GRAD_TOL)
    # Training draws the dropout masks from the model's own generator.
    with torch.no_grad():
        a = Cifar10CNN(device="cpu", dropout_seed=3)
        b = Cifar10CNN(device="cpu", dropout_seed=3)
        b.load_state_dict(a.state_dict())
        assert torch.equal(a(torch.tensor(x)), b(torch.tensor(x)))
        assert not torch.equal(a(torch.tensor(x)), a(torch.tensor(x),
                                                    train=False))

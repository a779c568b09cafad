"""Shared example utilities: dataset loading with a synthetic fallback
and the host batch factory (port of the JAX package's
``examples/common.py``).

The reference examples download CIFAR via Keras; without network access
they load ``$HVD_DATA_DIR/cifar10.npz`` when present and otherwise a
deterministic synthetic stand-in with the same shapes
(:func:`horovod_tpu_torch.data.load_dataset`).
"""

from __future__ import annotations

import numpy as np

from horovod_tpu_torch.data import load_dataset


def load_cifar10(n_train=4096, n_test=512):
    train, test, _ = load_dataset("cifar10", n_train=n_train,
                                  n_test=n_test)
    return train, test


def batches(x, y, global_batch, *, seed=0, shuffle=True):
    """Zero-arg-callable factory over (x, y) host batches of
    ``global_batch``."""
    def gen():
        idx = np.arange(len(x))
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        for i in range(0, len(idx) - global_batch + 1, global_batch):
            sel = idx[i:i + global_batch]
            yield x[sel], y[sel]
    return gen

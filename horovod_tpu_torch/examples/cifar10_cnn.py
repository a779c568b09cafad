"""CIFAR-10 simple CNN (port of the JAX package's
``examples/cifar10_cnn.py``). Parity with the reference's
``keras-cifar10-cnn.py``: two conv blocks and a dense head, the LR
scaled by the world size. One process per GPU::

    python -m horovod_tpu_torch.launcher -np 2 python -m \\
        horovod_tpu_torch.examples.cifar10_cnn --epochs 2
"""

import argparse
import functools
import sys
from typing import Optional

import torch
from torch import nn

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks, runtime, training
from horovod_tpu_torch import trainer as T
from horovod_tpu_torch.examples.common import batches, load_cifar10
from horovod_tpu_torch.models.resnet import (Conv, Dense, Dropout,
                                             max_pool_valid)


class Cifar10CNN(nn.Module):
    """The reference's 4-conv Keras CNN (keras-cifar10-cnn.py:36-59), as
    the JAX example's flax module: 3x3 SAME convs with bias (f32), 2x2
    max-pools, dropout 0.25, 0.25 and 0.5, a 512-wide dense layer and the
    f32 head. Modules carry flax's auto-names (``Conv_0..3``,
    ``Dense_0..1``) for ``convert.conv_from_jax``."""

    def __init__(self, num_classes: int = 10, *, image_size: int = 32,
                 dropout_seed: int = 0, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = torch.device(device)
        cin = 3
        for i, f in enumerate((32, 32, 64, 64)):
            self.add_module(f"Conv_{i}", Conv(cin, f, 3, dev, bias=True))
            cin = f
        hw = image_size // 4
        self.Dense_0 = Dense(hw * hw * 64, 512, dev)
        self.Dense_1 = Dense(512, num_classes, dev)
        self.drop_conv = Dropout(0.25, dropout_seed, dev)
        self.drop_dense = Dropout(0.5, dropout_seed + 1, dev)
        for mod in self.modules():
            if isinstance(mod, (Conv, Dense)):
                mod.init(generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.float()
        for pair in ((self.Conv_0, self.Conv_1), (self.Conv_2, self.Conv_3)):
            for conv in pair:
                x = torch.relu(conv.same(x))
            x = self.drop_conv(max_pool_valid(x, 2, 2), train)
        x = x.reshape(x.shape[0], -1)
        x = self.drop_dense(torch.relu(self.Dense_0(x)), train)
        return self.Dense_1(x)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-per-chip", type=int, default=32)
    args = p.parse_args(argv)

    hvd.init()
    try:
        return _run(args)
    finally:
        hvd.shutdown()


def _run(args) -> int:
    dev = runtime.device()
    (x_train, y_train), (x_test, y_test) = load_cifar10()
    global_batch = args.batch_per_chip * hvd.size()

    model = Cifar10CNN(device=dev, dropout_seed=hvd.rank(),
                       generator=torch.Generator().manual_seed(0))
    opt = functools.partial(torch.optim.SGD, lr=0.01 * hvd.size(),
                            momentum=0.9)
    state = training.create_train_state(model, opt, device=dev)
    step = training.make_train_step()
    eval_step = training.make_eval_step()

    tr = T.Trainer(step, state, eval_step=eval_step)
    tr.fit(batches(x_train, y_train, global_batch), epochs=args.epochs,
           callbacks=[callbacks.BroadcastGlobalVariablesCallback(0),
                      callbacks.MetricAverageCallback()],
           eval_data=batches(x_test, y_test, global_batch, shuffle=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())

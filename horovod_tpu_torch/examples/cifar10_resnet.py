"""CIFAR-10 ResNet v1/v2 (port of the JAX package's
``examples/cifar10_resnet.py``). Parity with the reference's
``keras-cifar10-resnet.py``: selectable depth and version, the staged LR
schedule (×1 → ×1e-1 @80 → ×1e-2 @120 → ×1e-3 @160 → ×0.5e-3 @180)
behind a warmup, the gradients fused into buckets for the allreduce.
BatchNorm is cross-replica (``axis_name=hvd.AXIS``). One process per
GPU::

    python -m horovod_tpu_torch.launcher -np 2 python -m \\
        horovod_tpu_torch.examples.cifar10_resnet --depth 20 --version 1
"""

import argparse
import functools
import sys

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks, models, runtime, training
from horovod_tpu_torch import trainer as T
from horovod_tpu_torch.examples.common import batches, load_cifar10


def lr_multiplier(epoch: int) -> float:
    """The reference's staged schedule (keras-cifar10-resnet.py:75-95),
    as a multiplier of the base LR."""
    if epoch >= 180:
        return 0.5e-3
    if epoch >= 160:
        return 1e-3
    if epoch >= 120:
        return 1e-2
    if epoch >= 80:
        return 1e-1
    return 1.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--depth", type=int, default=20)
    p.add_argument("--version", type=int, default=1, choices=(1, 2))
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
    steps_per_epoch = len(x_train) // global_batch

    make = (models.cifar_resnet_v1 if args.version == 1
            else models.cifar_resnet_v2)
    model = make(args.depth, dtype=torch.bfloat16, axis_name=hvd.AXIS,
                 device=dev, generator=torch.Generator().manual_seed(0))
    # The JAX example's hyper_sgd: the callbacks set the LR and momentum
    # on the optimizer's param_groups.
    opt = functools.partial(torch.optim.SGD, lr=1e-1 * hvd.size(),
                            momentum=0.9)
    state = training.create_train_state(model, opt, device=dev)
    step = training.make_train_step()
    eval_step = training.make_eval_step()

    tr = T.Trainer(step, state, eval_step=eval_step,
                   steps_per_epoch=steps_per_epoch)
    tr.fit(
        batches(x_train, y_train, global_batch),
        epochs=args.epochs,
        callbacks=[
            callbacks.BroadcastGlobalVariablesCallback(0),
            callbacks.MetricAverageCallback(),
            callbacks.LearningRateWarmupCallback(
                warmup_epochs=min(5, args.epochs),
                steps_per_epoch=steps_per_epoch),
            callbacks.LearningRateScheduleCallback(
                lr_multiplier, start_epoch=min(5, args.epochs)),
        ],
        eval_data=batches(x_test, y_test, global_batch, shuffle=False),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""ImageNet ResNet-50 — the north-star workload (port of the JAX
package's ``examples/imagenet_resnet50.py``). Parity with the
reference's ``keras_imagenet_resnet50.py``: the Goyal et al. recipe
(batch 32/worker, base_lr·size, warmup, ×0.1 decay @ 30/60/80, weight
decay), checkpoint-resume with the step broadcast from rank 0, rank-0
asynchronous checkpoints, an allreduced final eval. BatchNorm is
cross-replica (``axis_name=hvd.AXIS``).

Without an ImageNet tree on disk this runs on synthetic data: the
structure and the collectives are the same. One process per GPU::

    python -m horovod_tpu_torch.launcher -np 8 python -m \\
        horovod_tpu_torch.examples.imagenet_resnet50 --epochs 2 --image 64
    python -m horovod_tpu_torch.launcher -np 2 --cpu python -m \\
        horovod_tpu_torch.examples.imagenet_resnet50 --image 32 \\
        --classes 10 --batch-per-chip 4 --epochs 1

A second run with the same ``--ckpt-dir`` and more ``--epochs`` resumes
from the newest checkpoint.
"""

import argparse
import functools
import sys

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks, models, runtime, training
from horovod_tpu_torch import trainer as T
from horovod_tpu_torch.data import _synthetic, shard_batch
from horovod_tpu_torch.examples.common import batches


def _decay(epoch):
    """Staged decay ×0.1 @ 30/60/80 (keras_imagenet_resnet50.py:118-122)."""
    if epoch >= 80:
        return 1e-3
    if epoch >= 60:
        return 1e-2
    if epoch >= 30:
        return 1e-1
    return 1.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--warmup-epochs", type=int, default=1)
    p.add_argument("--batch-per-chip", type=int, default=32)  # ref: 32/worker
    p.add_argument("--base-lr", type=float, default=0.0125)   # ref: 0.0125
    p.add_argument("--wd", type=float, default=5e-5)          # ref: 5e-5
    p.add_argument("--image", type=int, default=64)
    p.add_argument("--classes", type=int, default=100)
    p.add_argument("--ckpt-dir", default="/tmp/hvd_resnet50_ckpt")
    p.add_argument("--compression", choices=["none", "bf16"], default="none",
                   help="gradient compression for the allreduce "
                        "(bf16 halves interconnect bytes at scale)")
    p.add_argument("--accum-steps", type=int, default=1,
                   help="in-step gradient accumulation (microbatches per "
                        "fused allreduce)")
    args = p.parse_args(argv)

    hvd.init()
    try:
        return _run(args)
    finally:
        hvd.shutdown()


def _run(args) -> int:
    dev = runtime.device()
    verbose = hvd.rank() == 0
    global_batch = args.batch_per_chip * hvd.size()
    x_train, y_train = _synthetic(
        max(global_batch * 4, 256), (args.image, args.image, 3),
        args.classes, 0)
    steps_per_epoch = len(x_train) // global_batch

    model = models.resnet50(num_classes=args.classes, dtype=torch.bfloat16,
                            axis_name=hvd.AXIS, device=dev,
                            generator=torch.Generator().manual_seed(0))
    # lr = base_lr * size (keras_imagenet_resnet50.py:113); SGD momentum
    # 0.9 + weight decay 5e-5 (added to the gradient before the momentum,
    # as optax.add_decayed_weights before optax.sgd).
    opt = functools.partial(torch.optim.SGD, lr=args.base_lr * hvd.size(),
                            momentum=0.9, weight_decay=args.wd)
    state = training.create_train_state(
        model, opt, device=dev,
        compression=(hvd.Compression.bf16 if args.compression == "bf16"
                     else hvd.Compression.none))
    step = training.make_train_step(accum_steps=args.accum_steps)
    eval_step = training.make_eval_step()

    # Checkpoint-resume: rank 0 scans for the latest checkpoint and the
    # step is broadcast so every rank resumes in lockstep
    # (keras_imagenet_resnet50.py:47-56).
    resume_step = (T.latest_checkpoint_step(args.ckpt_dir) or 0) \
        if hvd.rank() == 0 else 0
    resume_step = int(hvd.broadcast(torch.tensor([resume_step], device=dev),
                                    root_rank=0, name="resume_epoch")[0])
    initial_epoch = resume_step // max(steps_per_epoch, 1)
    if resume_step:
        state = T.restore_checkpoint(args.ckpt_dir, state, step=resume_step)
        if verbose:
            print(f"resumed from step {resume_step} (epoch "
                  f"{initial_epoch})", flush=True)

    tr = T.Trainer(step, state, eval_step=eval_step,
                   steps_per_epoch=steps_per_epoch, verbose=verbose)

    # Asynchronous checkpoints: the epoch boundary pays only the
    # device->host snapshot; the write overlaps the next epoch's steps.
    # close() below is the durability barrier.
    ckpt_writer = T.AsyncCheckpointer()

    class CheckpointCallback(callbacks.Callback):
        def on_epoch_end(self, epoch, logs=None):
            T.save_checkpoint(args.ckpt_dir, self.trainer.state,
                              writer=ckpt_writer)  # rank-0 only

    try:
        tr.fit(
            batches(x_train, y_train, global_batch),
            epochs=args.epochs,
            initial_epoch=initial_epoch,
            callbacks=[
                callbacks.BroadcastGlobalVariablesCallback(0),
                callbacks.MetricAverageCallback(),
                callbacks.LearningRateWarmupCallback(
                    warmup_epochs=args.warmup_epochs,
                    steps_per_epoch=steps_per_epoch, verbose=int(verbose)),
                callbacks.LearningRateScheduleCallback(
                    _decay, start_epoch=args.warmup_epochs),
                CheckpointCallback(),
            ],
        )
    finally:
        ckpt_writer.close()  # every epoch checkpoint durable before eval

    # Allreduced final eval (keras_imagenet_resnet50.py:150).
    xb, yb = shard_batch((x_train[:global_batch], y_train[:global_batch]))
    ev = eval_step(tr.state, (xb.to(dev), yb.to(dev)))
    score = hvd.allreduce(ev["accuracy"].reshape(1), name="final_eval")
    if verbose:
        print("final eval accuracy (allreduced):", float(score[0]),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

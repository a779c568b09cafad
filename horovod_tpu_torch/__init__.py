"""horovod_tpu_torch — the PyTorch/CUDA port of the horovod_tpu package

The JAX package beside it stays the reference; this package computes the
same functions with PyTorch on an NVIDIA GPU. Every kernel the JAX
package wrote in Pallas becomes a CUDA kernel written for Hopper
(``ops/csrc``), built with ``nvcc`` on first use and kept beside a plain
PyTorch version of the same math, which runs only for CPU tensors.

The ported slices:

* serving — ``serve.GenerationEngine`` over
  ``parallel.transformer.Transformer`` with a paged KV pool, a
  flash-attention prefill kernel and a paged decode-attention kernel;
* data-parallel training — the Horovod surface below (one process per
  GPU over ``torch.distributed``: NCCL on the GPU, gloo on the CPU; the
  eager collectives, sparse gradients, ZeRO-1 and the
  backward-overlapped exchange), ``training.make_train_step`` and
  ``models.resnet50``/``resnet101`` with the fused 1x1-conv + BatchNorm
  kernels, the other conv families (the CIFAR ResNets v1 and v2, VGG,
  Inception V3), cross-replica BatchNorm (``axis_name=hvd.AXIS``),
  ``data.load_dataset`` and the conv examples (``examples/``);
* transformer-LM training —
  ``parallel.transformer.make_parallel_train_step`` on the same surface,
  with the packed flash-attention forward (with lse) and backward
  kernels;
* pipelined transformer-LM training —
  ``parallel.pp_transformer.make_pp_transformer_train_step`` (1F1B over
  a ``parallel.mesh.create_hybrid_mesh`` dp × pp mesh), with the
  ``[B, T, H, D]`` flash-attention forward (with lse) and backward
  kernels;
* the training state a user can save, verify, resume and serve —
  ``trainer.Trainer`` with ``callbacks`` and ``hooks``, the rank-0
  ``save_checkpoint``/``restore_checkpoint`` and the sharded
  ``parallel.checkpoint.save_sharded``/``restore_sharded`` behind per-leaf
  CRC32 manifests, ``restore_for_inference`` into the serving engine, and
  the telemetry plane (``obs``, ``utils.timeline``);
* the per-GPU launcher (``python -m horovod_tpu_torch.launcher``, one
  process per GPU, supervised, ``--restarts``) and elastic recovery
  (``elastic.ElasticState`` two-phase commits with the verified fallback
  walk, ``elastic.run_with_recovery``, the Trainer's rollback).

The package exports the reference's names (``hvd.models``,
``hvd.serve``, ``hvd.callbacks``, ``hvd.BroadcastGlobalVariablesHook``,
``hvd.world``, ``hvd.AXIS`` ...); the few with no torch meaning
(``mesh``, the ``pallas_*`` modules) are listed in ``ROADMAP.md``
Queue 3.
Importing the package never imports JAX or the JAX package.
"""

from . import callbacks  # noqa: F401
from . import data  # noqa: F401
from . import elastic  # noqa: F401
from . import hooks  # noqa: F401
from . import models  # noqa: F401
from . import obs  # noqa: F401
from . import serve  # noqa: F401
from . import training  # noqa: F401
from .exceptions import (CheckpointCorruptError, CheckpointTimeoutError,
                         DeadlineExceededError, FailedPreconditionError,
                         FailoverExhaustedError, HorovodError,
                         NonFiniteGradError,
                         NotInitializedError, ServerClosedError,
                         ServerOverloadedError, StalledError, TransportError,
                         WorkerFailureError)
from .ops.collectives import (Op, allgather, allgather_async_,
                              allgather_object, allgather_ragged, allreduce,
                              allreduce_async_, alltoall, broadcast,
                              broadcast_async_, broadcast_object,
                              grouped_allreduce, reducescatter, synchronize)
from .ops.fusion import (BucketSchedule, GradSync, plan_grad_sync,
                         plan_schedule, probe_grad_order, resolve_wire_dtype)
from .ops.sparse import IndexedSlices
from .optimizer import (Compression, DistributedOptimizer, ZeroShardedState,
                        allreduce_gradients, broadcast_global_variables,
                        broadcast_optimizer_state, broadcast_parameters,
                        partition_optimizer, zero_from_canonical,
                        zero_to_canonical)
from .hooks import BroadcastGlobalVariablesHook
from .runtime import (AXIS, init, is_initialized, local_rank,
                      process_count, process_index, rank, shutdown, size,
                      world)
from .trainer import (AsyncCheckpointer, Trainer, latest_checkpoint_step,
                      restore_checkpoint, save_checkpoint)
from .version import __version__

__all__ = ["__version__", "HorovodError", "ServerOverloadedError",
           "DeadlineExceededError", "ServerClosedError",
           "NotInitializedError", "FailedPreconditionError",
           "TransportError", "WorkerFailureError", "CheckpointCorruptError",
           "CheckpointTimeoutError", "NonFiniteGradError", "StalledError",
           "init", "shutdown", "is_initialized", "size", "rank",
           "local_rank", "process_index", "process_count", "Op",
           "allreduce", "allgather", "allgather_ragged", "broadcast",
           "alltoall", "reducescatter", "grouped_allreduce",
           "allreduce_async_", "allgather_async_", "broadcast_async_",
           "synchronize", "broadcast_object", "allgather_object",
           "IndexedSlices", "BucketSchedule", "GradSync", "plan_grad_sync",
           "plan_schedule", "probe_grad_order", "resolve_wire_dtype",
           "DistributedOptimizer", "ZeroShardedState",
           "partition_optimizer", "zero_to_canonical",
           "zero_from_canonical", "allreduce_gradients",
           "broadcast_parameters", "broadcast_optimizer_state",
           "broadcast_global_variables", "Compression", "Trainer",
           "AsyncCheckpointer", "save_checkpoint", "restore_checkpoint",
           "latest_checkpoint_step", "elastic", "callbacks", "data",
           "hooks", "models", "obs", "serve", "training",
           "BroadcastGlobalVariablesHook", "FailoverExhaustedError",
           "world", "AXIS"]

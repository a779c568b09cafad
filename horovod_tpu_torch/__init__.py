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
  ``models.resnet50`` with the fused 1x1-conv + BatchNorm kernels;
* transformer-LM training —
  ``parallel.transformer.make_parallel_train_step`` on the same surface,
  with the packed flash-attention forward (with lse) and backward
  kernels;
* pipelined transformer-LM training —
  ``parallel.pp_transformer.make_pp_transformer_train_step`` (1F1B over
  a ``parallel.mesh.create_hybrid_mesh`` dp × pp mesh), with the
  ``[B, T, H, D]`` flash-attention forward (with lse) and backward
  kernels.

Importing the package never imports JAX or the JAX package.
"""

from .exceptions import (DeadlineExceededError, HorovodError,
                         ServerClosedError, ServerOverloadedError)
from .ops.collectives import (Op, allgather, allgather_async_,
                              allgather_object, allgather_ragged, allreduce,
                              allreduce_async_, alltoall, broadcast,
                              broadcast_async_, broadcast_object,
                              grouped_allreduce, reducescatter, synchronize)
from .ops.fusion import (BucketSchedule, GradSync, plan_grad_sync,
                         plan_schedule, probe_grad_order, resolve_wire_dtype)
from .ops.sparse import IndexedSlices
from .optimizer import (DistributedOptimizer, ZeroShardedState,
                        allreduce_gradients, broadcast_optimizer_state,
                        broadcast_parameters, partition_optimizer,
                        zero_from_canonical, zero_to_canonical)
from .runtime import (init, is_initialized, local_rank, rank, shutdown,
                      size)
from .version import __version__

__all__ = ["__version__", "HorovodError", "ServerOverloadedError",
           "DeadlineExceededError", "ServerClosedError", "init", "shutdown",
           "is_initialized", "size", "rank", "local_rank", "Op",
           "allreduce", "allgather", "allgather_ragged", "broadcast",
           "alltoall", "reducescatter", "grouped_allreduce",
           "allreduce_async_", "allgather_async_", "broadcast_async_",
           "synchronize", "broadcast_object", "allgather_object",
           "IndexedSlices", "BucketSchedule", "GradSync", "plan_grad_sync",
           "plan_schedule", "probe_grad_order", "resolve_wire_dtype",
           "DistributedOptimizer", "ZeroShardedState",
           "partition_optimizer", "zero_to_canonical",
           "zero_from_canonical", "allreduce_gradients",
           "broadcast_parameters", "broadcast_optimizer_state"]

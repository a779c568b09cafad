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
  GPU over ``torch.distributed``: NCCL on the GPU, gloo on the CPU),
  ``training.make_train_step`` and ``models.resnet50`` with the fused
  1x1-conv + BatchNorm kernels;
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
from .ops.collectives import Op, allgather, allreduce, broadcast
from .optimizer import (DistributedOptimizer, allreduce_gradients,
                        broadcast_optimizer_state, broadcast_parameters)
from .runtime import (init, is_initialized, local_rank, rank, shutdown,
                      size)
from .version import __version__

__all__ = ["__version__", "HorovodError", "ServerOverloadedError",
           "DeadlineExceededError", "ServerClosedError", "init", "shutdown",
           "is_initialized", "size", "rank", "local_rank", "allreduce",
           "allgather", "broadcast", "Op", "DistributedOptimizer",
           "allreduce_gradients", "broadcast_parameters",
           "broadcast_optimizer_state"]

"""horovod_tpu_torch — the PyTorch/CUDA port of the horovod_tpu package

The JAX package beside it stays the reference; this package computes the
same functions with PyTorch on an NVIDIA GPU. Every kernel the JAX
package wrote in Pallas becomes a CUDA kernel written for Hopper
(``ops/csrc``), built with ``nvcc`` on first use and kept beside a plain
PyTorch version of the same math, which runs only for CPU tensors.

This slice carries the paged generation server: ``serve.GenerationEngine``
over ``parallel.transformer.Transformer`` with a paged KV pool, a
flash-attention prefill kernel and a paged decode-attention kernel.
Importing the package never imports JAX or the JAX package.
"""

from .exceptions import (DeadlineExceededError, HorovodError,
                         ServerClosedError, ServerOverloadedError)
from .version import __version__

__all__ = ["__version__", "HorovodError", "ServerOverloadedError",
           "DeadlineExceededError", "ServerClosedError"]

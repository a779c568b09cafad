"""Weight-only quantization for inference: int8 with per-channel scales.

Port of the JAX package's ``ops/quant.py``. A serving LM's memory at rest
is its weight bytes, and a decode step reads every one of them: storing
each matmul weight as int8 with one f32 scale per output channel
quarters those bytes. Activations and accumulation stay in the model's
compute dtype: the generation forwards dequantize a weight where they
use it (``q * scale`` in f32, then the compute dtype), one layer at a
time, so no whole-model float copy is ever resident. The reference
dequantizes inside its jitted forward, where XLA fuses the scale into
the consuming matmul with no Pallas body; here it is ordinary PyTorch.

:class:`QuantizedTensor` is a NamedTuple ``(q, scale)``: an int8 payload
of the weight's shape and f32 scales over its LAST axis (the output
columns of every ``[in, out]`` weight). Symmetric quantization, no zero
point: round to nearest onto [-127, 127], scale = per-channel absmax /
127. :func:`quantize` runs on the host in numpy with the reference's
operations in its order, so ``q`` and ``scale`` are bitwise the JAX
package's. :class:`QuantizedWeight` holds the pair as a model's device
buffers.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

INT8_MAX = 127.0


class QuantizedTensor(NamedTuple):
    """int8 payload + per-channel (last-axis) f32 scales: numpy arrays on
    the host, tensors on the device."""

    q: Any        # int8, the original shape
    scale: Any    # f32 [shape[-1]]

    @property
    def shape(self):
        return tuple(np.shape(self.q))


def is_quantized(x) -> bool:
    return isinstance(x, QuantizedTensor)


def as_quantized(x) -> Optional[QuantizedTensor]:
    """``x`` as a :class:`QuantizedTensor` when it is one, or the JAX
    package's (a NamedTuple with ``q`` and ``scale`` fields, carried as
    numpy); None for any other leaf."""
    if is_quantized(x):
        return x
    if isinstance(x, tuple) and hasattr(x, "q") and hasattr(x, "scale"):
        return QuantizedTensor(q=x.q, scale=x.scale)
    return None


def _host(w) -> np.ndarray:
    if torch.is_tensor(w):
        return w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def quantize(w) -> QuantizedTensor:
    """Symmetric per-channel int8 quantization of a float array or tensor
    (host-side numpy: it runs once at restore time, never in a step). An
    all-zero channel gets scale 1, so its dequant is an exact zero."""
    w = _host(w)
    absmax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1))) \
        if w.ndim > 1 else np.abs(w)
    scale = np.where(absmax > 0, absmax / INT8_MAX, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -INT8_MAX, INT8_MAX).astype(np.int8)
    return QuantizedTensor(q=q, scale=scale)


def dequantize(qt: QuantizedTensor, dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    """``q * scale`` in f32 (the int8 payload converts exactly), then an
    optional cast to ``dtype``: the reference's rounding points. Numpy
    pairs come back as CPU tensors."""
    q, scale = torch.as_tensor(qt.q), torch.as_tensor(qt.scale)
    out = q * scale.to(torch.float32)
    return out if dtype is None else out.to(dtype)


def _tree_map(fn, tree):
    """``tree`` (dicts, lists, tuples) with ``fn`` applied to every leaf;
    a :class:`QuantizedTensor` (or the JAX package's) is a leaf."""
    if as_quantized(tree) is not None:
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _is_float(x) -> bool:
    if torch.is_tensor(x):
        return x.is_floating_point()
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def quantize_tree(tree: Any, min_ndim: int = 2) -> Any:
    """Quantize every float leaf with ``ndim >= min_ndim`` (the matmul
    weights and the embedding); smaller float leaves (norm scales,
    biases) become f32 numpy (byte-trivial, precision-critical). Other
    leaves pass through."""
    def one(x):
        if as_quantized(x) is not None or not _is_float(x):
            return x
        if np.ndim(x) >= min_ndim:
            return quantize(x)
        return _host(x)
    return _tree_map(one, tree)


def dequantize_tree(tree: Any, dtype: Optional[torch.dtype] = None) -> Any:
    """Every :class:`QuantizedTensor` replaced by its dequantized tensor;
    plain leaves pass through untouched."""
    return _tree_map(lambda x: dequantize(as_quantized(x), dtype)
                     if as_quantized(x) is not None else x, tree)


class QuantizedWeight(nn.Module):
    """A model's int8 weight: the payload ``q`` and the per-channel
    ``scale`` as buffers (so ``.to(device)`` and ``state_dict`` carry
    them); no float copy exists."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        if q.dtype != torch.int8 or scale.dtype != torch.float32:
            raise ValueError(f"QuantizedWeight takes an int8 payload and "
                             f"f32 scales, got {q.dtype} and {scale.dtype}")
        if tuple(scale.shape) != tuple(q.shape[-1:]):
            raise ValueError(f"scale shape {tuple(scale.shape)} is not the "
                             f"payload's last axis {tuple(q.shape[-1:])}")
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    def tensor(self) -> QuantizedTensor:
        return QuantizedTensor(q=self.q, scale=self.scale)

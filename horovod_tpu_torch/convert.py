"""Weight carry between the JAX package's transformer parameter tree and
the port's :class:`~.parallel.transformer.Transformer`.

The JAX tree is ``{"embed", "lnf", "layers": [{"ln1", "wqkv", "wo",
"ln2", "w1", "w2"}, ...]}`` with every projection ``[in, out]`` and used
as ``h @ W``; the port keeps exactly that layout, so the map is one to
one with no transposes. Leaves arrive as numpy arrays (convert JAX
arrays with ``np.asarray`` first): this module never imports JAX.

Float leaves (f32, bf16) are carried as f32. The JAX package's int8
inference format (a ``(q, scale)`` pair per quantized weight, from
``restore_for_inference(dtype="int8")``) is not ported yet and raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .parallel.transformer import Transformer, TransformerConfig

_LAYER_KEYS = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")


def _float_leaf(leaf: Any, name: str) -> np.ndarray:
    if isinstance(leaf, tuple) or np.asarray(leaf).dtype.kind in "iub":
        raise NotImplementedError(
            f"{name}: int8-quantized weights come in a later slice of the "
            f"PyTorch port; restore the checkpoint in f32 or bf16")
    return np.asarray(leaf, dtype=np.float32)


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    device: DeviceLike = "cuda") -> Transformer:
    """Build a :class:`Transformer` on ``device`` holding ``tree``'s
    weights (as f32). Raises ``ValueError`` on a missing leaf or a shape
    that does not match ``cfg``."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, cfg "
                         f"{cfg.n_layers}")
    pairs = [(model.embed, tree["embed"], "embed"),
             (model.lnf, tree["lnf"], "lnf")]
    for i, (blk, leaves) in enumerate(zip(model.layers, tree["layers"])):
        pairs += [(getattr(blk, key), leaves[key], f"layers[{i}].{key}")
                  for key in _LAYER_KEYS]
    with torch.no_grad():
        for param, leaf, name in pairs:
            arr = _float_leaf(leaf, name)
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{name}: shape {arr.shape} does not match "
                                 f"{tuple(param.shape)}")
            param.copy_(torch.from_numpy(arr))
    return model

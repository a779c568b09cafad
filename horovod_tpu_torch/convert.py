"""Weight carry between the JAX package's parameter trees and the port's
models: the transformer (:func:`params_from_jax`,
:func:`params_to_numpy`), the pipelined transformer's stage slices
(:func:`pp_params_from_jax`, :func:`pp_params_to_numpy`), the ResNet
(:func:`resnet_from_jax`,
:func:`resnet_to_numpy`), and the JAX leaf order both train steps plan
their gradient buckets in (:func:`jax_leaf_order`).

The JAX tree is ``{"embed", "lnf", "layers": [{"ln1", "wqkv", "wo",
"ln2", "w1", "w2"}, ...]}`` with every projection ``[in, out]`` and used
as ``h @ W``; the port keeps exactly that layout, so the map is one to
one with no transposes. Leaves arrive as numpy arrays (convert JAX
arrays with ``np.asarray`` first) or CPU tensors (the bf16 leaves of
``restore_for_inference``): this module never imports JAX.

Float leaves (f32, bf16) are carried as f32. The JAX package's int8
inference format (a ``(q, scale)`` pair per quantized weight, from
``restore_for_inference(dtype="int8")``) is not ported yet and raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.resnet import ResNet, ResNetConfig
from .parallel.transformer import Transformer, TransformerConfig

_LAYER_KEYS = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")


def _float_leaf(leaf: Any, name: str) -> np.ndarray:
    if torch.is_tensor(leaf):
        # restore_for_inference(dtype="bf16") returns torch.bfloat16
        # leaves: numpy has no bfloat16.
        leaf = leaf.detach().float().cpu().numpy()
    if isinstance(leaf, tuple) or np.asarray(leaf).dtype.kind in "iub":
        raise NotImplementedError(
            f"{name}: int8-quantized weights come in a later slice of the "
            f"PyTorch port; restore the checkpoint in f32 or bf16")
    return np.asarray(leaf, dtype=np.float32)


def params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """The model's weights as the JAX parameter tree ``{"embed", "lnf",
    "layers": [{...}, ...]}`` of f32 numpy arrays (the inverse of
    :func:`params_from_jax`)."""
    def np_(t):
        return t.detach().float().cpu().numpy().copy()
    return {"embed": np_(model.embed), "lnf": np_(model.lnf),
            "layers": [{key: np_(getattr(blk, key)) for key in _LAYER_KEYS}
                       for blk in model.layers]}


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


def pp_params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig, mesh,
                       device: DeviceLike = "cuda") -> Dict[str, Any]:
    """This rank's parameters of the pipelined transformer from a JAX
    ``init_pp_params`` tree ``{"embed", "lnf", "stages": {leaf: [S, lps,
    ...]}}`` of numpy arrays: the head whole and the stacks' slice at this
    rank's pp index, as f32 ``nn.Parameter``s on ``device`` in the layout
    :func:`~.parallel.pp_transformer.init_pp_params` returns. Raises
    ``ValueError`` when a leaf's shape is not that of ``mesh``'s stages of
    ``cfg``'s layers."""
    dev = resolve_device(device)
    S, stage = mesh.shape["pp"], mesh.coords["pp"]
    if cfg.n_layers % S:
        raise ValueError(f"n_layers={cfg.n_layers} must divide into "
                         f"pp={S} stages")
    lps, d, f = cfg.n_layers // S, cfg.d_model, cfg.d_ff
    stacks = {"ln1": (lps, d), "ln2": (lps, d), "w1": (lps, d, f),
              "w2": (lps, f, d), "wo": (lps, d, d), "wqkv": (lps, d, 3 * d)}

    def param(leaf, name, shape, index=None):
        arr = _float_leaf(leaf, name)
        want = shape if index is None else (S, *shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{name}: shape {arr.shape} does not match "
                             f"{want}")
        if index is not None:
            arr = arr[index]
        return torch.nn.Parameter(torch.tensor(arr, device=dev))

    return {"embed": param(tree["embed"], "embed", (cfg.vocab, d)),
            "lnf": param(tree["lnf"], "lnf", (d,)),
            "stages": {k: param(tree["stages"][k], f"stages.{k}", shape,
                                stage) for k, shape in stacks.items()}}


def pp_params_to_numpy(params: Dict[str, Any], mesh
                       ) -> Tuple[Dict[str, Any], int]:
    """This rank's pipelined parameters as f32 numpy arrays in the JAX
    tree's shape, ``{"embed", "lnf", "stages": {leaf: [lps, ...]}}``,
    with its stage index: stacking the stages of every pp rank in index
    order gives the JAX ``[S, lps, ...]`` leaves."""
    def np_(t):
        return t.detach().float().cpu().numpy().copy()
    return ({"embed": np_(params["embed"]), "lnf": np_(params["lnf"]),
             "stages": {k: np_(v) for k, v in params["stages"].items()}},
            mesh.coords["pp"])


# -- ResNet -------------------------------------------------------------------
#
# The flax tree is {"params": {...}, "batch_stats": {...}} with one dict
# level per module scope. The port's modules carry the flax scope names,
# so a leaf's path IS its dotted attribute name; only conv kernels change
# layout ([kh, kw, Cin, Cout] in flax, [Cout, Cin, kh, kw] in the port).


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for key in sorted(tree):
        val = tree[key]
        if hasattr(val, "items"):
            yield from _flatten(dict(val), prefix + (key,))
        else:
            yield prefix + (key,), val


def _is_conv_kernel(path: Tuple[str, ...], ndim: int) -> bool:
    return path[-1] == "kernel" and ndim == 4


def _to_port(path, arr: np.ndarray) -> np.ndarray:
    if _is_conv_kernel(path, arr.ndim):
        arr = arr.transpose(3, 2, 0, 1)
    return np.array(arr, dtype=np.float32, order="C")


def _to_flax(path, arr: np.ndarray) -> np.ndarray:
    if _is_conv_kernel(path, arr.ndim):
        return np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
    return arr


def _leaf_key(name: str):
    # A purely numeric part is a list index (the LM's "layers.10"), which
    # JAX flattens in index order; any other part is a dict key, which it
    # flattens in sorted string order.
    return tuple((0, int(part), "") if part.isdigit() else (1, 0, part)
                 for part in name.split("."))


def jax_leaf_order(model: torch.nn.Module
                   ) -> List[Tuple[str, torch.nn.Parameter]]:
    """``model``'s parameters in the JAX tree-flatten order of the
    matching parameter tree: dict keys sorted at every level (so flax's
    ``BottleneckBlock_10`` comes before ``BottleneckBlock_2`` and
    ``BatchNorm_*`` before ``Conv_*``) and list entries in index order
    (the LM's ``layers.2`` before ``layers.10``). The bucket plan walks
    this order, as the JAX plan walks the tree."""
    return sorted(model.named_parameters(), key=lambda kv: _leaf_key(kv[0]))


def resnet_from_jax(variables: Dict[str, Any], cfg: ResNetConfig,
                    device: DeviceLike = "cuda") -> ResNet:
    """Build a :class:`ResNet` on ``device`` holding the flax
    ``variables``' params and batch_stats (as f32). Raises ``ValueError``
    when a leaf is missing, extra, or of the wrong shape."""
    dev = resolve_device(device)
    model = ResNet(cfg, device=dev)
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    seen = set()
    with torch.no_grad():
        for coll in ("params", "batch_stats"):
            for path, leaf in _flatten(dict(variables[coll])):
                name = ".".join(path)
                if name not in targets:
                    raise ValueError(f"{coll}/{'/'.join(path)} has no "
                                     f"counterpart in the port's model")
                arr = _to_port(path, _float_leaf(leaf, name))
                dst = targets[name]
                if tuple(arr.shape) != tuple(dst.shape):
                    raise ValueError(f"{name}: shape {arr.shape} does not "
                                     f"match {tuple(dst.shape)}")
                dst.copy_(torch.from_numpy(arr))
                seen.add(name)
    missing = sorted(set(targets) - seen)
    if missing:
        raise ValueError(f"variables lack {missing[:5]} "
                         f"({len(missing)} leaves)")
    return model


def resnet_to_numpy(model: ResNet) -> Dict[str, Dict[str, Any]]:
    """The model's variables as a flax-shaped numpy tree ``{"params":
    ..., "batch_stats": ...}`` (conv kernels back in ``[kh, kw, Cin,
    Cout]``)."""
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    named = [("params", n, t) for n, t in model.named_parameters()]
    named += [("batch_stats", n, t) for n, t in model.named_buffers()]
    for coll, name, t in named:
        path = tuple(name.split("."))
        node = out[coll]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_flax(path, t.detach().float().cpu().numpy())
    return out

"""Weight carry between the JAX package's parameter trees and the port's
models: the transformer (:func:`params_from_jax`,
:func:`params_to_numpy`, and across a mesh :func:`params_to_global`),
the pipelined transformer's stage slices (:func:`pp_params_from_jax`,
:func:`pp_params_to_numpy`, :func:`pp_params_to_global`), LoRA adapter
trees (:func:`adapter_from_jax`, :func:`adapter_to_numpy`), the conv
families — ResNet, VGG, Inception — by flax name (:func:`conv_from_jax`,
:func:`conv_to_numpy`; :func:`resnet_from_jax` and
:func:`resnet_to_numpy` for a :class:`~.models.resnet.ResNetConfig`),
and the JAX leaf order both train steps plan their gradient buckets in
(:func:`jax_leaf_order`).

The JAX tree is ``{"embed", "lnf", "layers": [{"ln1", "wqkv", "wo",
"ln2", "w1", "w2"}, ...]}`` with every projection ``[in, out]`` and used
as ``h @ W``; the port keeps exactly that layout, so the map is one to
one with no transposes. On a mesh each rank takes its block of every
global leaf under the parameter specs (:func:`~.parallel.mesh.
local_slice`), and the blocks all-gather back into the global leaves
(:func:`~.parallel.mesh.gather_global`). Leaves arrive as numpy arrays (convert JAX
arrays with ``np.asarray`` first) or CPU tensors (the bf16 leaves of
``restore_for_inference``): this module never imports JAX.

Float leaves (f32, bf16) are carried as f32. An int8 leaf — the
inference format of ``restore_for_inference(dtype="int8")`` and
:func:`~.ops.quant.quantize_tree`: a ``(q, scale)`` pair, the JAX
package's ``QuantizedTensor`` or the port's — becomes a
:class:`~.ops.quant.QuantizedWeight` on the device (the int8 payload and
its f32 scales, no float copy); :func:`quantize_model` gives the same
model from a float one. Only the transformer serves int8; the other
converters refuse it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.resnet import ResNet, ResNetConfig
from .ops.quant import (QuantizedTensor, QuantizedWeight, as_quantized,
                        quantize_tree)
from .parallel.mesh import gather_global, local_slice
from .parallel.transformer import (Transformer, TransformerConfig,
                                   param_specs)

_LAYER_KEYS = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")


def _layer_keys(cfg: TransformerConfig) -> Tuple[str, ...]:
    return _LAYER_KEYS + (("gate",) if cfg.n_experts else ())


def _float_leaf(leaf: Any, name: str) -> np.ndarray:
    if as_quantized(leaf) is not None:
        raise ValueError(
            f"{name}: an int8 (quantized) leaf; int8 weights serve through "
            f"the transformer's params_from_jax only")
    if torch.is_tensor(leaf):
        # restore_for_inference(dtype="bf16") returns torch.bfloat16
        # leaves: numpy has no bfloat16.
        leaf = leaf.detach().float().cpu().numpy()
    if isinstance(leaf, tuple) or np.asarray(leaf).dtype.kind in "iub":
        raise ValueError(
            f"{name}: a {type(leaf).__name__} of "
            f"{np.asarray(leaf).dtype} is no float leaf; int8 weights come "
            f"as (q, scale) pairs (ops.quant.quantize_tree)")
    return np.asarray(leaf, dtype=np.float32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def _scale_spec(spec) -> Tuple:
    """The spec of a quantized weight's scales: its last dimension's."""
    return tuple(spec[-1:]) if spec else ()


def _np_leaf(t) -> Any:
    """A model leaf as host numpy: a :class:`QuantizedTensor` of numpy
    arrays for an int8 weight, f32 otherwise."""
    if isinstance(t, QuantizedWeight):
        return QuantizedTensor(q=t.q.detach().cpu().numpy().copy(),
                               scale=_np(t.scale))
    return _np(t)


def params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """The model's weights as the JAX parameter tree ``{"embed", "lnf",
    "layers": [{...}, ...]}`` of f32 numpy arrays, an int8 weight as a
    :class:`~.ops.quant.QuantizedTensor` of numpy arrays (the inverse of
    :func:`params_from_jax`); on a mesh, this rank's blocks."""
    keys = _layer_keys(model.cfg)
    return {"embed": _np_leaf(model.embed), "lnf": _np(model.lnf),
            "layers": [{key: _np_leaf(getattr(blk, key)) for key in keys}
                       for blk in model.layers]}


def params_to_global(model: Transformer) -> Dict[str, Any]:
    """The global (canonical) JAX tree of a model on a mesh: each
    rank's blocks all-gathered under :func:`~.parallel.transformer.
    param_specs`, as f32 numpy arrays (an int8 weight's payload and
    scales gathered alike). Collective: every rank of the mesh must call
    it. Off a mesh it is :func:`params_to_numpy`."""
    if model.mesh is None:
        return params_to_numpy(model)
    specs = param_specs(model.cfg, model.mesh)
    keys = _layer_keys(model.cfg)

    def g(t, spec):
        if isinstance(t, QuantizedWeight):
            return QuantizedTensor(
                q=gather_global(t.q, spec, model.mesh).cpu().numpy(),
                scale=_np(gather_global(t.scale, _scale_spec(spec),
                                        model.mesh)))
        return _np(gather_global(t, spec, model.mesh))
    return {"embed": _np_leaf(model.embed), "lnf": _np(model.lnf),
            "layers": [{key: g(getattr(blk, key), sp[key]) for key in keys}
                       for blk, sp in zip(model.layers, specs["layers"])]}


def _leaf_of(tree: Dict[str, Any], name: str) -> Any:
    node = tree
    for part in name.split("."):
        node = node[int(part)] if part.isdigit() else node[part]
    return node


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    device: DeviceLike = "cuda", mesh=None) -> Transformer:
    """Build a :class:`Transformer` on ``device`` holding ``tree``'s
    weights: float leaves as f32 parameters, int8 leaves (``(q, scale)``
    pairs: the JAX package's ``QuantizedTensor`` or the port's) as
    :class:`~.ops.quant.QuantizedWeight` buffers — the payload and its
    f32 scales, with no float copy of the weight ever allocated. On a
    ``mesh``, this rank's block of each global leaf
    (:func:`~.parallel.transformer.param_specs`; a scale split as its
    column). Raises ``ValueError`` on a missing leaf, a shape that does
    not match ``cfg``, or an int8 norm scale."""
    dev = resolve_device(device)
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, cfg "
                         f"{cfg.n_layers}")
    specs = param_specs(cfg, mesh)

    def spec_of(name):
        return specs["layers"][0][name.rsplit(".", 1)[1]] \
            if name.startswith("layers.") else ()

    def block(arr, spec):
        if mesh is not None:
            arr = local_slice(arr, spec, mesh)
        return np.ascontiguousarray(arr)

    def weights(name, shape):
        leaf = _leaf_of(tree, name)
        where = name.replace("layers.", "layers[", 1).replace(".", "].", 1) \
            if name.startswith("layers.") else name
        spec = spec_of(name)
        want = tuple(local_slice(np.empty(shape, np.int8), spec, mesh).shape
                     if mesh is not None else shape)
        qt = as_quantized(leaf)
        if qt is None:
            arr = block(_float_leaf(leaf, where), spec)
            if tuple(arr.shape) != want:
                raise ValueError(f"{where}: shape {arr.shape} does not "
                                 f"match {want}")
            return torch.nn.Parameter(torch.tensor(arr, device=dev))
        if len(shape) < 2:
            raise ValueError(f"{where}: an int8 norm scale; quantize only "
                             f"the matmul weights (min_ndim=2)")
        q = np.asarray(qt.q)
        scale = np.asarray(qt.scale)
        if q.dtype != np.int8 or scale.dtype != np.float32 \
                or tuple(q.shape) != tuple(shape) \
                or tuple(scale.shape) != tuple(shape[-1:]):
            raise ValueError(
                f"{where}: (q, scale) of {q.dtype}{tuple(q.shape)}, "
                f"{scale.dtype}{tuple(scale.shape)} does not match int8"
                f"{tuple(shape)}, float32{tuple(shape[-1:])}")
        return QuantizedWeight(
            torch.tensor(block(q, spec), device=dev),
            torch.tensor(block(scale, _scale_spec(spec)), device=dev))

    with torch.no_grad():
        return Transformer(cfg, device=dev, mesh=mesh, weights=weights)


def quantize_model(model: Transformer) -> Transformer:
    """A new int8 :class:`Transformer` on ``model``'s device (and mesh):
    the host :func:`~.ops.quant.quantize_tree` of its global weights
    through :func:`params_from_jax` — the model that
    ``restore_for_inference(dtype="int8")`` of its checkpoint serves.
    On a mesh the weights are gathered first (collective), so each
    scale is its unsharded column's."""
    return params_from_jax(quantize_tree(params_to_global(model)),
                           model.cfg, device=model.device, mesh=model.mesh)


def pp_params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig, mesh,
                       device: DeviceLike = "cuda") -> Dict[str, Any]:
    """This rank's parameters of the pipelined transformer from a JAX
    ``init_pp_params`` tree ``{"embed", "lnf", "stages": {leaf: [S, lps,
    ...]}}`` of numpy arrays: the head whole and the stacks' slice at this
    rank's pp index (its tp blocks when the mesh has tp), as f32
    ``nn.Parameter``s on ``device`` in the layout
    :func:`~.parallel.pp_transformer.init_pp_params` returns. Raises
    ``ValueError`` when a leaf's shape is not that of ``mesh``'s stages of
    ``cfg``'s layers."""
    from .parallel.pp_transformer import pp_param_specs
    dev = resolve_device(device)
    specs = pp_param_specs(mesh)["stages"]
    S, stage = mesh.shape["pp"], mesh.coords["pp"]
    if cfg.n_layers % S:
        raise ValueError(f"n_layers={cfg.n_layers} must divide into "
                         f"pp={S} stages")
    lps, d, f = cfg.n_layers // S, cfg.d_model, cfg.d_ff
    stacks = {"ln1": (lps, d), "ln2": (lps, d), "w1": (lps, d, f),
              "w2": (lps, f, d), "wo": (lps, d, d), "wqkv": (lps, d, 3 * d)}

    def param(leaf, name, shape, key=None):
        arr = _float_leaf(leaf, name)
        want = shape if key is None else (S, *shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{name}: shape {arr.shape} does not match "
                             f"{want}")
        if key is not None:
            arr = np.ascontiguousarray(
                local_slice(arr[stage], specs[key][1:], mesh))
        return torch.nn.Parameter(torch.tensor(arr, device=dev))

    return {"embed": param(tree["embed"], "embed", (cfg.vocab, d)),
            "lnf": param(tree["lnf"], "lnf", (d,)),
            "stages": {k: param(tree["stages"][k], f"stages.{k}", shape, k)
                       for k, shape in stacks.items()}}


def pp_params_to_numpy(params: Dict[str, Any], mesh
                       ) -> Tuple[Dict[str, Any], int]:
    """This rank's pipelined parameters as f32 numpy arrays in the JAX
    tree's shape, ``{"embed", "lnf", "stages": {leaf: [lps, ...]}}``,
    with its stage index: stacking the stages of every pp rank in index
    order gives the JAX ``[S, lps, ...]`` leaves."""
    return ({"embed": _np(params["embed"]), "lnf": _np(params["lnf"]),
             "stages": {k: _np(v) for k, v in params["stages"].items()}},
            mesh.coords["pp"])


def pp_params_to_global(params: Dict[str, Any], mesh
                        ) -> Tuple[Dict[str, Any], int]:
    """As :func:`pp_params_to_numpy`, with each stage leaf's tp blocks
    all-gathered into the stage's global slice. Collective over the
    mesh."""
    from .parallel.pp_transformer import pp_param_specs
    specs = pp_param_specs(mesh)["stages"]
    return ({"embed": _np(params["embed"]), "lnf": _np(params["lnf"]),
             "stages": {k: _np(gather_global(v, specs[k][1:], mesh))
                        for k, v in sorted(params["stages"].items())}},
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


def conv_from_jax(variables: Dict[str, Any],
                  model: torch.nn.Module) -> torch.nn.Module:
    """Load the flax ``variables`` (``{"params": ..., "batch_stats":
    ...}``; a model without BatchNorm has no ``batch_stats``) into a
    conv-family ``model`` (:class:`~.models.resnet.ResNet`,
    :class:`~.models.vgg.VGG`, :class:`~.models.inception.InceptionV3`)
    by name, conv kernels ``[kh, kw, Cin, Cout]`` -> ``[Cout, Cin, kh,
    kw]``, dense kernels as they are, every leaf as f32; returns
    ``model``. Raises ``ValueError`` when a leaf is missing, extra, or
    of the wrong shape — before or after copying, never silently."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    seen = set()
    with torch.no_grad():
        for coll in ("params", "batch_stats"):
            for path, leaf in _flatten(dict(variables.get(coll, {}))):
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


def conv_to_numpy(model: torch.nn.Module) -> Dict[str, Dict[str, Any]]:
    """A conv-family model's variables as a flax-shaped numpy tree
    ``{"params": ..., "batch_stats": ...}`` (conv kernels back in ``[kh,
    kw, Cin, Cout]``; ``batch_stats`` empty for a model without
    BatchNorm): the inverse of :func:`conv_from_jax`."""
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


def resnet_from_jax(variables: Dict[str, Any], cfg: ResNetConfig,
                    device: DeviceLike = "cuda") -> ResNet:
    """Build a :class:`ResNet` of ``cfg`` on ``device`` holding the flax
    ``variables``' params and batch_stats (:func:`conv_from_jax`)."""
    return conv_from_jax(variables, ResNet(cfg,
                                           device=resolve_device(device)))


def resnet_to_numpy(model: ResNet) -> Dict[str, Dict[str, Any]]:
    """The ResNet's variables as a flax-shaped numpy tree
    (:func:`conv_to_numpy`)."""
    return conv_to_numpy(model)


def adapter_from_jax(tree: Dict[str, Any], cfg: TransformerConfig, lora,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    """A JAX adapter tree (``{"layers": [{target: {"a": [d_in, r], "b":
    [r, d_out]}}]}``, numpy leaves; ``parallel.lora.init_adapter`` or
    ``restore_adapter``) as the port's: the same tree of f32 tensors on
    ``device``, checked against ``(cfg, lora)`` first. The layout is one
    to one (``A`` is applied as ``x @ A``, as in JAX). The tree stays
    global on a tp mesh too: an ``AdapterRegistry(mesh=)`` cuts each
    rank's blocks when it loads it (as it does a JAX tree's numpy
    leaves)."""
    from .parallel.lora import check_adapter
    check_adapter(tree, cfg, lora)
    dev = resolve_device(device)
    return {"layers": [
        {t: {k: torch.tensor(_float_leaf(pair[k], f"layers[{li}].{t}.{k}"),
                             device=dev) for k in ("a", "b")}
         for t, pair in layer.items()}
        for li, layer in enumerate(tree["layers"])]}


def adapter_to_numpy(adapter: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`adapter_from_jax`: the port's adapter tree as
    f32 numpy leaves in the JAX tree shape."""
    return {"layers": [{t: {k: _np(pair[k]) if torch.is_tensor(pair[k])
                            else np.asarray(pair[k], np.float32)
                            for k in ("a", "b")}
                        for t, pair in layer.items()}
                       for layer in adapter["layers"]]}

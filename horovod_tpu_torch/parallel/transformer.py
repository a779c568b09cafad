"""The transformer LM of the port: model, the training forward and its
train step (data-parallel, or dp × tp × sp × ep over a mesh), the
prompt/decode-step forwards the generation engine runs, and the
contiguous KV cache (:func:`init_kv_cache`, :func:`prefill`,
:func:`decode_step`, :func:`verify_step`). On a tp mesh the generation
forwards run this rank's ``n_heads / tp`` heads against a cache of those
heads (:func:`kv_cache_specs`), with tp's row-parallel sums.

Port of the JAX package's ``parallel/transformer.py``. On a mesh
(:mod:`.mesh`) the model holds this rank's blocks of the JAX global
parameters (:func:`param_specs`): ``wqkv``/``w1`` column-sharded and
``wo``/``w2`` row-sharded over ``tp`` with one sum all-reduce after each
row product (:mod:`.tp`), the experts of a MoE FFN sharded over ``ep``
(:func:`~.moe.moe_ffn`), the sequence split over ``sp`` with
:func:`~.ring.ring_attention`; the batch splits over ``(dp, ep)``. The
weights keep the JAX layout: every projection is ``[in,
out]`` and applied as ``h @ W``, ``wqkv``'s columns are head-major
(``[D, H, 3, dh]``), and the unembedding is tied to the embedding — so a
JAX parameter tree maps onto :class:`Transformer` one to one
(:mod:`..convert`).

Numerics follow the JAX functions: parameters are f32 and every
projection runs in ``cfg.dtype`` (weights cast once by
:func:`gen_weights`), RMSNorm statistics are f32, the FFN is tanh-GELU,
residuals add in ``cfg.dtype`` and logits are f32 from a
``cfg.unembed_dtype`` product with f32 accumulation (:func:`unembed`).
``cfg.remat`` checkpoints each layer keeping only its matmul outputs
(the counterpart of ``dots_saveable``), and ``cfg.loss_chunk`` computes
the loss in vocab chunks with an online log-sum-exp (:func:`chunked_nll`).
Attention in training (:func:`forward_hidden`) routes as the JAX
function does: the packed flash kernels
(:func:`~..ops.attention.flash_attention_qkv`) where
``cfg.attn_backend`` is ``"pallas"`` and the shape is tilable,
:func:`~..ops.attention.flash_attention` with that backend otherwise
(which takes the dense :func:`~..ops.attention.xla_attention` for
untilable shapes). Prompts run
:func:`~..ops.attention.flash_attention_prefill` at every length (or a
caller's ``attend``, the chunked prefill's pool read), decode steps a
caller-supplied ``mix``: the paged pool read in :mod:`.kv_blocks`, or
the contiguous cache's :func:`cached_attention`, plain PyTorch as the
JAX function is plain XLA. The contiguous functions write the cache in
place, as the paged ones write the pool. On the card the kernels take a
bf16 model with d_head 128; every other model's attention routes to the
plain versions (:func:`~..ops.attention.flash_supported`), as on the
CPU. The route is decided from the config, not from the activations, so
a tensor that reaches a wrapper in another dtype than the model's raises
instead of leaving the kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import DeviceLike, resolve_device
from ..ops.attention import (flash_attention, flash_attention_prefill,
                             flash_attention_qkv, flash_attention_reference,
                             flash_supported, qkv_flash_tilable)
from ..ops.quant import QuantizedWeight, dequantize, is_quantized
from .mesh import local_slice
from .moe import moe_ffn
from .ring import ring_attention
from .tp import tp_reduce


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 1024
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    n_experts: int = 0          # 0 = dense MLP; >0 = MoE over the ep axis
    dtype: torch.dtype = torch.bfloat16
    # Training attention: "pallas" takes the flash kernels where the shape
    # is tilable (the JAX name for the kernel route), "xla" the dense
    # attention, "auto" the kernels only past 4 GiB of scores.
    attn_backend: str = "pallas"
    # Rematerialize each layer in the backward, saving only its matmul
    # outputs (JAX's dots_saveable): the rest, attention included, is
    # recomputed.
    remat: bool = False
    # The tied-head unembed matmul dtype; logits are f32 (and accumulated
    # in f32) either way.
    unembed_dtype: torch.dtype = torch.float32
    # >0: the LM loss in vocab chunks of this width with an online
    # log-sum-exp (chunked_nll), never materializing the [B, T, vocab]
    # f32 logits; each chunk is checkpointed. Must divide vocab. 0 = dense.
    loss_chunk: int = 0

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def check_dense(cfg: TransformerConfig, what: str) -> None:
    """Refuse a MoE config where only dense FFNs run: serving (the MoE
    dispatch has no incremental decode, in JAX either) and the pipelined
    family."""
    if cfg.n_experts:
        raise NotImplementedError(
            f"{what} supports dense FFNs only (cfg.n_experts="
            f"{cfg.n_experts}); MoE layers train through "
            f"make_parallel_train_step on a mesh with an ep axis")


def check_mesh(cfg: TransformerConfig, mesh) -> None:
    """The JAX step's shape rules on ``mesh``: heads and d_ff divide by
    tp; a MoE config needs an ep axis of ``n_experts`` ranks."""
    if mesh is None:
        if cfg.n_experts:
            raise ValueError(
                f"n_experts={cfg.n_experts} needs an ep mesh axis (one "
                f"expert per ep rank): pass mesh=")
        return
    tp = mesh.shape.get("tp", 1)
    if cfg.n_heads % tp or cfg.d_ff % tp:
        raise ValueError(f"n_heads={cfg.n_heads} and d_ff={cfg.d_ff} must "
                         f"divide by tp={tp}")
    if cfg.n_experts:
        if "ep" not in mesh.shape:
            raise ValueError(
                f"n_experts={cfg.n_experts} needs an ep mesh axis (one "
                f"expert per ep rank); the mesh has {mesh.axis_names}")
        if cfg.n_experts != mesh.shape["ep"]:
            raise ValueError(
                f"n_experts={cfg.n_experts} must equal the ep mesh axis "
                f"size {mesh.shape['ep']} (one expert per ep rank)")


def serving_tp(mesh, what: str = "the generation forwards") -> int:
    """The tp size the generation forwards run at on ``mesh`` (1 off a
    mesh). Serving shards over ``tp`` only: a mesh whose dp, pp, ep or sp
    axis is above 1 raises ``ValueError`` naming the axis (a replica per
    dp slice is a fleet of tp groups, not one engine: ``FleetRouter(
    factory=serve.spawn_replica_factory({..., "tp": n}))``)."""
    if mesh is None:
        return 1
    for a in ("dp", "pp", "ep", "sp"):
        n = mesh.shape.get(a, 1)
        if n > 1:
            raise ValueError(
                f"{what}: serving runs on a tp mesh only, and this mesh "
                f"has {a}={n} (serve one tp group per engine: dp replicas "
                f"of a tp group are a fleet of groups, FleetRouter("
                f"factory=serve.spawn_replica_factory({{..., 'tp': n}})); "
                f"pp, ep and sp do not serve)")
    return int(mesh.shape.get("tp", 1))


def local_heads(cfg: TransformerConfig, mesh) -> int:
    """The attention heads this rank computes and caches: ``n_heads /
    tp`` on a tp mesh (the head-major ``wqkv`` columns it holds)."""
    return cfg.n_heads // serving_tp(mesh)


def param_specs(cfg: TransformerConfig, mesh) -> Dict:
    """The spec tree matching the JAX ``init_params`` tree (JAX
    ``param_specs``): per dimension the mesh axis it is split over, or
    None. Megatron column (out-dim) sharding of ``wqkv``/``w1`` and row
    (in-dim) sharding of ``wo``/``w2`` over tp; experts over ep; every
    other leaf replicated (dp and sp replicate the parameters)."""
    axes = set(mesh.axis_names) if mesh is not None else set()
    tp = "tp" if "tp" in axes else None
    ep = "ep" if "ep" in axes else None
    layers = []
    for _ in range(cfg.n_layers):
        layer = {"ln1": (), "wqkv": (None, tp), "wo": (tp, None),
                 "ln2": ()}
        if cfg.n_experts:
            layer.update(gate=(), w1=(ep, None, None), w2=(ep, None, None))
        else:
            layer.update(w1=(None, tp), w2=(tp, None))
        layers.append(layer)
    return {"embed": (), "lnf": (), "layers": layers}


def spec_of(specs: Dict, name: str):
    """The spec of the parameter named ``name`` (``"layers.3.wo"``) in a
    :func:`param_specs` tree."""
    node = specs
    for part in name.split("."):
        node = node[int(part)] if part.isdigit() else node[part]
    return node


def _block_leaves(cfg: TransformerConfig):
    """``(name, shape, init std)`` of one layer's leaves in draw order
    (std None: a norm scale of ones)."""
    d, ff = cfg.d_model, cfg.d_ff
    leaves = [("ln1", (d,), None), ("wqkv", (d, 3 * d), d ** -0.5),
              ("wo", (d, d), d ** -0.5), ("ln2", (d,), None)]
    if cfg.n_experts:
        E = cfg.n_experts
        return leaves + [("gate", (d, E), d ** -0.5),
                         ("w1", (E, d, ff), d ** -0.5),
                         ("w2", (E, ff, d), ff ** -0.5)]
    return leaves + [("w1", (d, ff), d ** -0.5), ("w2", (ff, d), ff ** -0.5)]


class Block(nn.Module):
    """One pre-norm layer's weights (JAX names and layouts), each from
    ``make(name, shape, std)``: an ``nn.Parameter``, or a
    :class:`~..ops.quant.QuantizedWeight` in an int8 model."""

    def __init__(self, cfg: TransformerConfig, make: Callable):
        super().__init__()
        for name, shape, std in _block_leaves(cfg):
            setattr(self, name, make(name, shape, std))


class Transformer(nn.Module):
    """Decoder-only LM with a tied unembedding.

    Weights are drawn from ``generator`` (a ``torch.Generator`` on
    ``device``; a fresh one seeded with 0 when omitted) with the JAX
    ``init_params`` scales: embedding N(0, 0.02²), projections
    N(0, 1/fan_in), norm scales 1. ``device`` defaults to ``"cuda"``.

    On a ``mesh`` every rank draws the same global weights and keeps its
    block of each under :func:`param_specs` (so the model computes the
    function of the unsharded one; seed alike on every rank), and the
    forwards run the mesh's axes.

    ``weights(name, shape)`` supplies each leaf (``"embed"``, ``"lnf"``,
    ``"layers.3.wqkv"``; this rank's block on a mesh) instead of drawing
    it: an ``nn.Parameter``, or a :class:`~..ops.quant.QuantizedWeight`
    for an int8 model (:func:`~..convert.params_from_jax` builds one
    that way, with no float copy of the weight). An int8 model serves
    only: the generation forwards dequantize each weight where they use
    it, the training forwards refuse it."""

    def __init__(self, cfg: TransformerConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = "cuda", mesh=None,
                 weights: Optional[Callable] = None):
        super().__init__()
        check_mesh(cfg, mesh)
        dev = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        if weights is not None:
            def leaf(name, shape, std):
                return weights(name, shape)
        else:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            specs = param_specs(cfg, mesh)["layers"][0] if cfg.n_layers \
                else {}

            def leaf(name, shape, std):
                if std is None:
                    t = torch.ones(shape, device=dev)
                else:
                    t = torch.randn(shape, generator=generator,
                                    device=dev) * std
                key = name.rsplit(".", 1)[-1]
                if mesh is not None and name.startswith("layers."):
                    t = local_slice(t, specs[key], mesh).clone()
                return nn.Parameter(t)

        self.embed = leaf("embed", (cfg.vocab, cfg.d_model), 0.02)
        self.lnf = leaf("lnf", (cfg.d_model,), None)
        self.layers = nn.ModuleList(
            Block(cfg, lambda name, shape, std, i=i: leaf(
                f"layers.{i}.{name}", shape, std))
            for i in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.lnf.device

    @property
    def quantized(self) -> bool:
        """Whether any weight is held as int8 (an inference-only model)."""
        return any(isinstance(m, QuantizedWeight) for m in self.modules())

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def gen_weights(model: Transformer) -> Dict:
    """The weights as the forwards read them, a dict mirroring the JAX
    parameter tree: projections cast to ``cfg.dtype`` once (not at every
    matmul), norm scales and the embedding f32, the unembedding in
    ``cfg.unembed_dtype``. Casts to the parameters' own dtype are free
    (no copy). An int8 weight stays a :class:`~..ops.quant.
    QuantizedTensor` of the model's buffers, which the forwards
    dequantize where they use it (the tied unembedding is then the
    embedding's pair). ``"mesh"`` is the model's mesh: the generation
    forwards read it to run this rank's heads and the row-parallel sums.
    Call under ``torch.no_grad()`` for inference."""
    cfg = model.cfg
    dt = cfg.dtype

    def proj(t):
        return t.tensor() if isinstance(t, QuantizedWeight) else t.to(dt)
    layers = []
    for b in model.layers:
        layer = {"ln1": b.ln1, "wqkv": proj(b.wqkv), "wo": proj(b.wo),
                 "ln2": b.ln2, "w1": proj(b.w1), "w2": proj(b.w2)}
        if cfg.n_experts:
            layer["gate"] = proj(b.gate)
        layers.append(layer)
    if isinstance(model.embed, QuantizedWeight):
        embed = unembed_w = model.embed.tensor()
    else:
        embed, unembed_w = model.embed, model.embed.to(cfg.unembed_dtype)
    return {"embed": embed, "unembed": unembed_w, "lnf": model.lnf,
            "layers": layers, "mesh": model.mesh}


def _check_float(w: Dict, what: str) -> None:
    """Refuse int8 weights where only float ones run: int8 is for
    inference only, as in the JAX package (its training step
    differentiates float leaves)."""
    if any(is_quantized(t) for t in [w["embed"]] + [
            t for layer in w["layers"] for t in layer.values()]):
        raise ValueError(
            f"{what} takes float weights; this model holds int8 "
            f"(quantized) weights, which serve only (the generation "
            f"forwards of GenerationEngine)")


def _w(layer: Dict, name: str, cfg: TransformerConfig) -> torch.Tensor:
    """``layer[name]`` in ``cfg.dtype`` where the forward uses it: an
    int8 weight dequantizes here (``q * scale`` in f32, then
    ``cfg.dtype``: the reference's rounding points), one weight at a
    time."""
    t = layer[name]
    return dequantize(t, cfg.dtype) if is_quantized(t) else t


def _embed(w: Dict, tokens: torch.Tensor, cfg: TransformerConfig
           ) -> torch.Tensor:
    """The embedding rows of ``tokens`` in ``cfg.dtype``. An int8 table
    gathers its int8 rows, then scales them: bitwise the rows of the
    dequantized table, without dequantizing the table."""
    e, idx = w["embed"], tokens.long()
    if is_quantized(e):
        return (e.q[idx] * e.scale).to(cfg.dtype)
    return e[idx].to(cfg.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    rms = torch.sqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + 1e-6)
    return ((x32 / rms) * scale).to(x.dtype)


def _split_heads(qkv: torch.Tensor, cfg: TransformerConfig,
                 n_heads: Optional[int] = None):
    """q, k, v ``[..., H, dh]`` views of the head-major projection (one
    ``unbind``, whose backward stacks the three gradients in one pass);
    ``n_heads`` is the projection's head count (this rank's under tp)."""
    return qkv.unflatten(-1, (n_heads or cfg.n_heads, 3,
                              cfg.d_head)).unbind(-2)


def _no_delta(name: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return y


def _layer(layer: Dict, x: torch.Tensor, cfg: TransformerConfig,
           attend: Callable, reduce: Optional[Callable] = None,
           ffn: Optional[Callable] = None,
           delta: Optional[Callable] = None) -> torch.Tensor:
    """One pre-norm layer over ``x [..., d_model]``. ``attend(qkv)`` maps
    the head-major projection ``[..., H·3·dh]`` to the attention output
    ``[..., H·dh]``; ``reduce`` (tp's row-parallel sum) combines the
    products of ``wo`` and ``w2``; ``ffn(layer, h)`` replaces the dense
    FFN (the MoE's). ``delta(name, x, y)`` adjusts the output ``y = x @
    W`` of each of ``wqkv`` (before the head split), ``wo``, ``w1``
    (before the GELU) and ``w2``: the LoRA hook of the generation
    forwards (JAX ``_prompt_forward``/``_step_forward``'s ``dl``)."""
    dl = _no_delta if delta is None else delta
    h = rms_norm(x, layer["ln1"])
    attn = attend(dl("wqkv", h, h @ _w(layer, "wqkv", cfg)))
    a = attn.to(cfg.dtype)
    proj = dl("wo", a, a @ _w(layer, "wo", cfg))
    if reduce is not None:
        proj = reduce(proj)
    x = x + proj
    h2 = rms_norm(x, layer["ln2"])
    if ffn is not None:
        return x + ffn(layer, h2)
    up = F.gelu(dl("w1", h2, h2 @ _w(layer, "w1", cfg)), approximate="tanh")
    down = dl("w2", up, up @ _w(layer, "w2", cfg))
    if reduce is not None:
        down = reduce(down)
    return x + down


# The matmuls whose outputs a rematerialized layer keeps (JAX's
# ``dots_saveable``): everything else in the layer — norms, GELU, casts,
# residual adds and the flash kernels, which run outside the dispatcher —
# is recomputed in the backward.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_layer(layer: Dict, x: torch.Tensor, cfg: TransformerConfig,
                attend: Callable, reduce: Optional[Callable] = None,
                ffn: Optional[Callable] = None) -> torch.Tensor:
    """:func:`_layer` under a selective checkpoint that saves only the
    matmul outputs (``cfg.remat``; JAX ``jax.checkpoint(_layer_fwd,
    policy=dots_saveable)``). Without autograd it is :func:`_layer`."""
    if not torch.is_grad_enabled():
        return _layer(layer, x, cfg, attend, reduce, ffn)
    return checkpoint(
        lambda h: _layer(layer, h, cfg, attend, reduce, ffn), x,
        use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _dots_saveable))


class _MatmulF32Out(torch.autograd.Function):
    """``x @ w.T`` for low-precision CUDA operands, accumulated and
    returned in f32 (cuBLAS through ``torch.mm(..., out_dtype=float32)``):
    the card's counterpart of ``jnp.matmul(...,
    preferred_element_type=f32)``. The backward runs the two products in
    the operands' dtype with f32 accumulation, the f32 cotangent rounded
    to that dtype first — as the TPU's default-precision matmul rounds
    it; the CPU path differentiates the exact f32 product instead."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = torch.mm(g, w) if ctx.needs_input_grad[0] else None
        dw = torch.mm(g.t(), x) if ctx.needs_input_grad[1] else None
        return dx, dw


def _logits(x: torch.Tensor, u: torch.Tensor, cfg: TransformerConfig
            ) -> torch.Tensor:
    """``x @ u.T`` f32 ``[..., rows of u]``: the product runs in
    ``cfg.unembed_dtype`` and accumulates in f32 with no rounding of its
    output, as JAX's ``preferred_element_type=jnp.float32`` does. On the
    CPU a bf16 product multiplies the bf16-valued operands in f32, which
    is exact per product."""
    xu = x.to(cfg.unembed_dtype)
    u = u.to(cfg.unembed_dtype)
    if cfg.unembed_dtype == torch.float32:
        return xu @ u.t()
    if xu.device.type == "cuda":
        out = _MatmulF32Out.apply(xu.reshape(-1, xu.shape[-1]), u)
        return out.view(*xu.shape[:-1], u.shape[0])
    return xu.float() @ u.float().t()


def unembed(w: Dict, x: torch.Tensor, cfg: TransformerConfig
            ) -> torch.Tensor:
    """Tied-head logits ``[..., vocab]`` f32 from the final hidden states
    (already through the final norm; :func:`_logits` of the tied
    unembedding). An int8 embedding dequantizes into
    ``cfg.unembed_dtype`` here, as the reference casts its dequantized
    f32 table."""
    u = w["unembed"]
    if is_quantized(u):
        u = dequantize(u, cfg.unembed_dtype)
    return _logits(x, u, cfg)


def attend_heads(qkv: torch.Tensor, cfg: TransformerConfig,
                 n_heads: Optional[int] = None) -> torch.Tensor:
    """Causal attention over the head-major projection ``[B, T,
    H·3·dh]`` (``n_heads`` heads, default ``cfg.n_heads``) through
    :func:`~..ops.attention.flash_attention` with ``cfg.attn_backend``
    (``"xla"`` for a model the card's kernels do not take); returns
    ``[B, T, H·dh]``."""
    q, k, v = _split_heads(qkv, cfg, n_heads)
    backend = (cfg.attn_backend
               if flash_supported(qkv.device, cfg.dtype, cfg.d_head)
               else "xla")
    return flash_attention(q, k, v, causal=True,
                           backend=backend).flatten(-2)


def _train_attend(cfg: TransformerConfig, T: int, mesh=None) -> Callable:
    """The training forward's attention for sequences of length ``T``
    (JAX ``forward_hidden`` :165-185) over this rank's ``n_heads / tp``
    heads: :func:`~.ring.ring_attention` when the mesh has ``sp``, the
    packed flash kernels when ``cfg.attn_backend`` is ``"pallas"`` and
    the shape is tilable and the kernels take the model,
    :func:`attend_heads` otherwise."""
    heads = cfg.n_heads // (mesh.shape.get("tp", 1) if mesh else 1)
    if mesh is not None and "sp" in mesh.shape:
        def ring(qkv):
            q, k, v = _split_heads(qkv, cfg, heads)
            return ring_attention(q, k, v, mesh=mesh,
                                  causal=True).flatten(-2)
        return ring
    if cfg.attn_backend == "pallas" and qkv_flash_tilable(T, cfg.d_head):
        def packed(qkv):
            if flash_supported(qkv.device, cfg.dtype, cfg.d_head):
                return flash_attention_qkv(qkv, heads, causal=True)
            return attend_heads(qkv, cfg, heads)
        return packed
    return lambda qkv: attend_heads(qkv, cfg, heads)


def _moe_ffn(mesh, aux: list) -> Callable:
    """The MoE FFN of a layer on ``mesh``'s ep axis (JAX
    ``forward_hidden`` :194-200); each call appends its load-balance
    loss to ``aux``."""
    def ffn(layer, h):
        B, T, D = h.shape
        y, a = moe_ffn(h.reshape(-1, D), layer["gate"], layer["w1"][0],
                       layer["w2"][0], mesh=mesh)
        aux.append(a)
        return y.reshape(B, T, D)
    return ffn


def _hidden(w: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
            mesh=None, aux: Optional[list] = None) -> torch.Tensor:
    """The final hidden states; on a mesh the layers run its axes and a
    MoE layer appends its load-balance loss to ``aux``. Float weights
    only (the training forward)."""
    _check_float(w, "the training forward")
    x = _embed(w, tokens, cfg)                                  # [B, T, D]
    attend = _train_attend(cfg, tokens.shape[-1], mesh)
    run = remat_layer if cfg.remat else _layer
    kw = {}
    if mesh is not None:
        kw["reduce"] = tp_reduce(mesh)
        if cfg.n_experts:
            kw["ffn"] = _moe_ffn(mesh, aux if aux is not None else [])
    for layer in w["layers"]:
        x = run(layer, x, cfg, attend, **kw)
    return rms_norm(x, w["lnf"])


def _hidden_aux(w: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
                mesh):
    """``(hidden states, MoE aux loss)`` on a mesh; the aux is the f32
    sum of the layers' (0 for a dense model), read right after the
    forward (a rematerialized layer appends again in the backward)."""
    aux: list = []
    x = _hidden(w, tokens, cfg, mesh, aux)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in aux:
        total = total + a
    return x, total


def forward_hidden(model: Transformer, tokens: torch.Tensor):
    """The final hidden states ``[B, T, d_model]`` (through the final
    norm, before the unembedding) of ``tokens [B, T]``; differentiable.
    A model on a mesh takes this rank's ``[B_local, T_local]`` block and
    returns ``(states, aux)`` as the JAX function does (aux: the MoE
    load-balance loss, 0 for a dense model); a model off a mesh has no
    aux and returns the states alone."""
    cfg = model.cfg
    if model.mesh is not None:
        return _hidden_aux(gen_weights(model), tokens, cfg, model.mesh)
    return _hidden(gen_weights(model), tokens, cfg)


def forward(model: Transformer, tokens: torch.Tensor):
    """Full causal forward: ``tokens [B, T]`` → logits ``[B, T, vocab]``
    f32 (:func:`forward_hidden` and the tied :func:`unembed`);
    differentiable. On a mesh it returns ``(logits, aux)``, as
    :func:`forward_hidden`."""
    cfg = model.cfg
    w = gen_weights(model)
    if model.mesh is not None:
        x, aux = _hidden_aux(w, tokens, cfg, model.mesh)
        return unembed(w, x, cfg), aux
    return unembed(w, _hidden(w, tokens, cfg), cfg)


def dense_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token ``-log p(label)`` as ``logsumexp − picked logit`` (no
    ``log_softmax`` tensor), f32 like the logits."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return lse - picked


def _nll_chunk(xf, w, lab, off: int, m, s, ll, cfg: TransformerConfig):
    """One vocab chunk of :func:`chunked_nll`: the chunk's logits, the
    running max and sum updated, and the picked logit where the label
    falls in the chunk."""
    logits = _logits(xf, w, cfg)                                # [N, C]
    chunk = w.shape[0]
    m_new = torch.maximum(m, logits.amax(-1))
    s = s * torch.exp(m - m_new) + torch.exp(
        logits - m_new[:, None]).sum(-1)
    in_chunk = (lab >= off) & (lab < off + chunk)
    idx = (lab - off).clamp(0, chunk - 1)
    picked = logits.gather(-1, idx[:, None])[:, 0]
    ll = ll + torch.where(in_chunk, picked, torch.zeros_like(picked))
    return m_new, s, ll


def chunked_nll(x: torch.Tensor, embed: torch.Tensor, labels: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """Per-token −log p(label) over the tied unembedding ``embed [vocab,
    d]``, computed in vocab chunks of ``cfg.loss_chunk`` with an online
    log-sum-exp, so the ``[N, vocab]`` f32 logits never exist at once.
    Each chunk is checkpointed: the backward recomputes its logits (one
    more ``[N, d] × [d, C]`` product a chunk) instead of keeping them.
    Each chunk's product runs in ``cfg.unembed_dtype`` with f32 output
    (:func:`_logits`). Labels are clamped into ``[0, vocab)``, as the
    dense path's gather of a clipped index reads a real logit. Raises
    ``ValueError`` when the chunk does not divide vocab."""
    orig_shape = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    vocab = embed.shape[0]
    chunk = cfg.loss_chunk
    if chunk <= 0 or vocab % chunk:
        raise ValueError(f"loss_chunk={chunk} must divide vocab={vocab}")
    lab = labels.reshape(-1).long().clamp(0, vocab - 1)
    n = xf.shape[0]
    m = torch.full((n,), -1e30, dtype=torch.float32, device=x.device)
    s = torch.zeros((n,), dtype=torch.float32, device=x.device)
    ll = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for i, w in enumerate(embed.split(chunk)):
        m, s, ll = checkpoint(_nll_chunk, xf, w, lab, i * chunk, m, s, ll,
                              cfg, use_reentrant=False)
    return (m + torch.log(s) - ll).reshape(orig_shape)


def lm_loss(w: Dict, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: TransformerConfig, mesh=None,
            aux_weight: float = 0.0) -> torch.Tensor:
    """The LM training loss ``mean(−log p(label))`` from the weights
    ``w`` (:func:`gen_weights`): :func:`chunked_nll` when
    ``cfg.loss_chunk``, else :func:`dense_nll` of the full logits. On a
    ``mesh`` the forward runs its axes, and a MoE model adds
    ``aux_weight`` times its load-balance loss (JAX ``_loss_fn``)."""
    aux = None
    if mesh is not None:
        x, aux = _hidden_aux(w, tokens, cfg, mesh)
    else:
        x = _hidden(w, tokens, cfg)
    if cfg.loss_chunk:
        loss = chunked_nll(x, w["unembed"], labels, cfg).mean()
    else:
        loss = dense_nll(unembed(w, x, cfg), labels).mean()
    if cfg.n_experts and aux is not None:
        loss = loss + aux_weight * aux
    return loss


def _bind(delta: Optional[Callable], li: int) -> Optional[Callable]:
    """``delta(li, name, x, y)`` bound to layer ``li`` (None stays None)."""
    if delta is None:
        return None
    return lambda name, x, y: delta(li, name, x, y)


def _serving(w: Dict, cfg: TransformerConfig):
    """``(heads, reduce)`` of a generation forward: this rank's head
    count and tp's row-parallel sum from the weights' mesh (the model's:
    :func:`gen_weights`). At tp 1 there is nothing to sum, so no
    collective is issued."""
    mesh = w.get("mesh")
    tp = serving_tp(mesh)
    return cfg.n_heads // tp, (tp_reduce(mesh) if tp > 1 else None)


def prompt_forward(w: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
                   store_kv: Callable, attend: Optional[Callable] = None,
                   delta: Optional[Callable] = None) -> torch.Tensor:
    """Prompt-phase forward (``w`` from :func:`gen_weights`): per layer
    the computed K/V (``[T, H, dh]``) is handed to ``store_kv(li, k, v)``
    and the attention is the self-contained causal
    :func:`~..ops.attention.flash_attention_prefill` over the prompt (the
    kernel at every length; its plain version for a model the card's
    kernels do not take). ``attend(li, q)`` replaces that attention
    with a caller-supplied read (q ``[1, T, H, dh]`` → attention of the
    same shape), the chunked prefill's hook: ``store_kv`` runs first, so
    the hook may gather the just-stored rows back out of a paged pool.
    ``delta(li, name, x, y)`` adjusts each target matmul's output (the
    LoRA hook, :mod:`.lora`). Returns logits ``[T, vocab]`` f32.

    On a tp mesh (``w["mesh"]``) the K/V, the queries and the attention
    are this rank's ``n_heads / tp`` heads and the ``wo``/``w2`` products
    are summed over tp, so every rank returns the same logits."""
    heads, reduce = _serving(w, cfg)
    x = _embed(w, tokens, cfg)[None]                            # [1, T, D]
    flash = (flash_attention_prefill
             if flash_supported(x.device, cfg.dtype, cfg.d_head)
             else flash_attention_reference)
    for li, layer in enumerate(w["layers"]):
        def attn(qkv, li=li):
            q, k, v = _split_heads(qkv, cfg, heads)
            store_kv(li, k[0], v[0])
            if attend is not None:
                return attend(li, q).to(cfg.dtype).flatten(-2)
            return flash(q, k, v, causal=True).flatten(-2)
        x = _layer(layer, x, cfg, attn, reduce=reduce,
                   delta=_bind(delta, li))
    return unembed(w, rms_norm(x, w["lnf"]), cfg)[0]


def step_forward(w: Dict, last_tokens: torch.Tensor,
                 cfg: TransformerConfig, mix: Callable,
                 delta: Optional[Callable] = None) -> torch.Tensor:
    """Decode-step forward (``w`` from :func:`gen_weights`):
    ``mix(li, q, k, v)`` does the cache write and attention read (q/k/v
    ``[S, H, dh]`` → attention of the same shape); ``delta(li, name, x,
    y)`` is the per-slot LoRA hook (row-independent, :mod:`.lora`).
    Returns logits ``[S, vocab]`` f32. On a tp mesh q/k/v are this
    rank's heads, as in :func:`prompt_forward`."""
    heads, reduce = _serving(w, cfg)
    x = _embed(w, last_tokens, cfg)                             # [S, D]
    for li, layer in enumerate(w["layers"]):
        x = _layer(layer, x, cfg, lambda qkv, li=li: mix(
            li, *_split_heads(qkv, cfg, heads)).flatten(-2),
            reduce=reduce, delta=_bind(delta, li))
    return unembed(w, rms_norm(x, w["lnf"]), cfg)


# -- the contiguous KV cache --------------------------------------------------

def kv_cache_specs(cfg: TransformerConfig, mesh) -> Dict:
    """The spec tree matching :func:`init_kv_cache` (JAX
    ``kv_cache_specs``), per dimension as :func:`param_specs` writes
    them: the head axis shards over ``tp`` (each tp rank caches the heads
    its ``wqkv`` columns compute); slots and positions are replicated."""
    tp = "tp" if mesh is not None and "tp" in mesh.axis_names else None
    kv = (None, None, None, tp, None)
    return {"k": kv, "v": kv, "lengths": ()}


def init_kv_cache(cfg: TransformerConfig, max_slots: int, max_len: int,
                  dtype: Optional[torch.dtype] = None, *,
                  device: DeviceLike = "cuda", mesh=None) -> Dict:
    """Fresh (zeroed) contiguous K/V cache on ``device``: ``{"k", "v":
    [n_layers, max_slots, max_len, n_heads, d_head], "lengths":
    [max_slots] int32}``. Every slot reserves ``max_len`` rows up front;
    rows past a slot's length are garbage by contract (padded prefill
    writes land there) and are masked out of every attention. On a tp
    ``mesh`` the cache holds this rank's ``n_heads / tp`` heads
    (:func:`kv_cache_specs`)."""
    check_dense(cfg, "init_kv_cache")
    dev = resolve_device(device)
    shape = (cfg.n_layers, max_slots, max_len,
             local_heads(cfg, mesh), cfg.d_head)
    kv_dtype = cfg.dtype if dtype is None else dtype
    return {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
            "v": torch.zeros(shape, dtype=kv_dtype, device=dev),
            "lengths": torch.zeros((max_slots,), dtype=torch.int32,
                                   device=dev)}


def prefill(w: Dict, tokens: torch.Tensor, cache: Dict, slot: int,
            cfg: TransformerConfig, length: Optional[int] = None, *,
            adapters=None, adapter_idx=None, lora=None):
    """Full-prompt forward writing every position's K/V into slot
    ``slot`` of the contiguous cache, in place. ``tokens`` is ``[T]`` at
    a bucket width (padded positions' K/V are written but masked by
    ``length``). Returns ``(cache, logits [T, vocab] f32)``; the logits
    read nothing from the cache (the same self-contained attention as
    the paged prefill). ``adapters``/``adapter_idx``/``lora``: the LoRA
    table, this prompt's row (``-1`` = base) and its
    :class:`~.lora.LoraConfig`."""
    check_dense(cfg, "prefill")
    T = tokens.shape[0]
    if T > cache["k"].shape[2]:
        raise ValueError(f"prompt bucket {T} exceeds the cache max_len "
                         f"{cache['k'].shape[2]}")

    def store(li, k, v):
        cache["k"][li, slot, :T] = k.to(cache["k"].dtype)
        cache["v"][li, slot, :T] = v.to(cache["v"].dtype)

    from .lora import make_delta
    logits = prompt_forward(w, tokens, cfg, store, delta=make_delta(
        "prompt", adapters, adapter_idx, lora, cfg))
    cache["lengths"][slot] = T if length is None else int(length)
    return cache, logits


def cached_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """One query token per row against that row's cache: q ``[S, H, d]``,
    k/v_cache ``[S, M, H, d]``, positions ``[S]`` (attends keys
    ``0..position`` inclusive). f32 scores, ``1/sqrt(d)`` scale, -1e30
    mask, f32 softmax and value product, cast back to q's dtype (JAX
    ``_cached_attention``)."""
    d = q.shape[-1]
    s = torch.einsum("shd,smhd->shm", q.float(),
                     k_cache.float()) * (float(d) ** -0.5)
    m = torch.arange(k_cache.shape[1], device=q.device)
    s = s.masked_fill(m[None, None, :] > positions.long()[:, None, None],
                      -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("shm,smhd->shd", p, v_cache.float())
    return out.to(q.dtype)


def _clamped(positions: torch.Tensor):
    """``(active, pos)``: which slots are live, and their positions with
    inactive slots (``-1``) clamped to 0, as the JAX steps do."""
    active = positions >= 0
    pos = torch.where(active, positions,
                      torch.zeros_like(positions)).to(torch.int32)
    return active, pos


def decode_step(w: Dict, last_tokens: torch.Tensor, cache: Dict,
                positions: torch.Tensor, cfg: TransformerConfig, *,
                adapters=None, adapter_idx=None, lora=None):
    """One autoregressive step for every slot of the contiguous cache:
    each slot's K/V is written at ``positions[s]`` (``-1`` = inactive: its
    scratch write lands at row 0 of its own slot, its output row is
    garbage), then :func:`cached_attention` over the slot's rows. Writes
    in place; returns ``(cache, logits [S, vocab] f32)``. Every slot's
    row depends only on that slot's token, position and cache row.
    ``adapters``/``adapter_idx [S]``/``lora``: the per-slot LoRA hook
    (``-1`` = base)."""
    check_dense(cfg, "decode_step")
    S = last_tokens.shape[0]
    active, pos = _clamped(positions)
    rows = torch.arange(S, device=positions.device)
    at = pos.long()

    def mix(li, q, k, v):
        kc, vc = cache["k"][li], cache["v"][li]
        kc[rows, at] = k.to(kc.dtype)
        vc[rows, at] = v.to(vc.dtype)
        return cached_attention(q, kc, vc, pos)

    from .lora import make_delta
    logits = step_forward(w, last_tokens, cfg, mix, delta=make_delta(
        "step", adapters, adapter_idx, lora, cfg, rows=S,
        device=last_tokens.device))
    cache["lengths"].copy_(torch.where(active, pos + 1, cache["lengths"]))
    return cache, logits


def verify_step(w: Dict, draft_tokens: torch.Tensor, cache: Dict,
                positions: torch.Tensor, cfg: TransformerConfig, *,
                adapters=None, adapter_idx=None, lora=None):
    """Speculative verify: score ``W = k + 1`` positions per slot in one
    forward. ``draft_tokens [S, W]`` holds, per slot, its last sampled
    token then the drafted continuation; column ``j`` writes its K/V at
    ``positions[s] + j`` (writes at or past ``max_len`` are dropped, as
    JAX's scatter drops them) and attends the slot's rows up to there.

    The ``W`` columns are flattened onto the slot axis, so each row runs
    the decode step's per-row math over the slot's cache (repeated ``W``
    times). Returns ``(cache, logits [S, W, vocab] f32)``; row ``j`` is
    the next-token distribution after ``draft_tokens[s, :j + 1]``. Only
    column 0's position is claimed in ``lengths``. The LoRA hook repeats
    each slot's ``adapter_idx`` over its ``W`` rows."""
    check_dense(cfg, "verify_step")
    S, W = draft_tokens.shape
    max_len = cache["k"].shape[2]
    active, pos = _clamped(positions)
    wpos = pos[:, None] + torch.arange(W, dtype=torch.int32,
                                       device=pos.device)[None, :]
    keep = wpos < max_len
    rows = torch.arange(S, device=pos.device)[:, None].expand(S, W)
    r_keep, p_keep = rows[keep], wpos[keep].long()
    flat_pos = wpos.reshape(S * W)

    def mix(li, q, k, v):
        kc, vc = cache["k"][li], cache["v"][li]
        kc[r_keep, p_keep] = k.reshape(S, W, *k.shape[1:])[keep].to(kc.dtype)
        vc[r_keep, p_keep] = v.reshape(S, W, *v.shape[1:])[keep].to(vc.dtype)
        return cached_attention(q, kc.repeat_interleave(W, dim=0),
                                vc.repeat_interleave(W, dim=0), flat_pos)

    from .lora import make_delta
    logits = step_forward(w, draft_tokens.reshape(S * W), cfg, mix,
                          delta=make_delta("step", adapters, adapter_idx,
                                           lora, cfg, rows=S, repeat=W,
                                           device=pos.device))
    cache["lengths"].copy_(torch.where(active, pos + 1, cache["lengths"]))
    return cache, logits.reshape(S, W, -1)


def named_param_specs(model: Transformer) -> list:
    """``model``'s parameter specs in the JAX leaf order of its
    parameters (:func:`~horovod_tpu_torch.convert.jax_leaf_order`): the
    spec list a :class:`~horovod_tpu_torch.DistributedOptimizer` on its
    mesh takes."""
    from .. import convert
    specs = param_specs(model.cfg, model.mesh)
    return [spec_of(specs, n) for n, _ in convert.jax_leaf_order(model)]


def make_parallel_train_step(cfg: TransformerConfig,
                             optimizer: Callable[..., torch.optim.Optimizer],
                             *, mesh=None, aux_weight: float = 0.01,
                             wire_dtype=None, accum_steps: int = 1,
                             guard_nonfinite: Optional[bool] = None,
                             fusion_threshold: Optional[int] = None,
                             zero: bool = False,
                             overlap: Optional[bool] = None,
                             device: DeviceLike = "cuda"):
    """Build ``(init_state, step)``: the LM's train step.

    ``optimizer`` builds the wrapped optimizer from the parameter list,
    e.g. ``functools.partial(torch.optim.AdamW, lr=1e-4, betas=(0.9,
    0.95), eps=1e-8, weight_decay=0.1)`` for ``optax.adamw(1e-4, b1=0.9,
    b2=0.95, weight_decay=0.1)`` (decay on every leaf, as optax's
    ``mask=None``).

    Without ``mesh`` it is the data-parallel step over the world of
    :func:`horovod_tpu_torch.init` (one process per GPU, the mesh of
    :func:`~.mesh.dp_mesh`): ``init_state(seed=0, model=None)`` builds a
    :class:`Transformer` from ``seed`` (or takes ``model``, e.g. from
    :func:`~horovod_tpu_torch.convert.params_from_jax`) and wraps the
    optimizer in a :class:`~horovod_tpu_torch.DistributedOptimizer`
    whose buckets follow the JAX leaf order; call
    :func:`~horovod_tpu_torch.broadcast_parameters` on ``state.model`` to
    start every rank from rank 0's weights. ``step(state, tokens,
    labels) -> (state, loss)`` takes this rank's ``[B_local, T]`` shard
    and updates the state in place; the loss is :func:`lm_loss` averaged
    over the world.

    With ``mesh`` (:func:`~.mesh.create_hybrid_mesh`) it is the JAX
    function's multi-axis step: the model holds this rank's blocks
    (:func:`param_specs`; every rank draws the same global weights from
    ``seed``, so no broadcast is needed — a ``model`` passed in must be
    built on ``mesh``), the optimizer runs the spec-grouped all-reduce
    plane (``DistributedOptimizer(mesh=, param_specs=)``: tp-sharded
    leaves sum over dp only with the tp correction, replicated ones over
    the whole mesh), and ``step`` takes this rank's ``[B/(dp·ep),
    T/sp]`` block (:func:`~.mesh.batch_block`). The loss is
    ``mean(nll) + aux_weight · aux`` with the MoE load-balance loss
    ``aux`` (``cfg.n_experts`` must equal the ep size). ``zero`` on a
    mesh is the hybrid ZeRO plane over the model's
    :func:`named_param_specs` with nothing skipped, as the JAX step
    builds it: the state shards over dp, each bucket is reduce-scattered
    over dp, a replicated bucket is summed over its other axes on the
    shard. ``overlap`` on a mesh starts each bucket of either plane on
    its own group as the backward lands it, in the order rank 0 probed.

    The knobs run on the core step (:func:`~horovod_tpu_torch.training.
    make_train_step`): ``accum_steps`` microbatches with one exchange,
    ``guard_nonfinite`` (default ``HVD_GUARD_NONFINITE``; on a skipped
    step the loss is 0 and the state bit-unchanged on every rank),
    ``wire_dtype`` (``"bf16"``/``"fp8"``; default ``HVD_WIRE_DTYPE``),
    ``zero`` (ZeRO-1 over the spec-grouped plan of the dp mesh, or of
    ``mesh``, as the JAX step builds it; off by default, as there) and
    ``overlap`` (default ``HVD_OVERLAP``; the tied embedding is one
    leaf, so its hook fires once). ``cfg.remat`` and ``cfg.loss_chunk`` act in the forward
    and the loss."""
    check_mesh(cfg, mesh)
    from .. import convert, training
    from ..optimizer import DistributedOptimizer
    from .mesh import dp_mesh
    dev = resolve_device(device)

    def value_and_grad(model: Transformer, batch):
        tokens, labels = batch
        loss = lm_loss(gen_weights(model), tokens, labels, model.cfg,
                       mesh=mesh, aux_weight=aux_weight)
        loss.backward()
        return loss.detach(), None

    core = training.make_train_step(
        _value_and_grad=value_and_grad, accum_steps=accum_steps,
        guard_nonfinite=guard_nonfinite, zero=zero, overlap=overlap)

    def init_state(seed: int = 0, model: Optional[Transformer] = None):
        if model is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            model = Transformer(cfg, generator=gen, device=dev, mesh=mesh)
        elif model.cfg != cfg:
            raise ValueError(f"model.cfg {model.cfg} is not {cfg}")
        elif model.quantized:
            raise ValueError(
                "make_parallel_train_step takes float weights; this model "
                "holds int8 (quantized) weights, which serve only")
        elif model.mesh is not mesh:
            raise ValueError("the model was built on another mesh than "
                             "the step's")
        model.to(dev)
        named = convert.jax_leaf_order(model)
        if mesh is not None:
            spec_kw = dict(mesh=mesh, param_specs=named_param_specs(model))
        else:
            # Every leaf is replicated over dp: one spec group, so the
            # plan's buckets are the 1-D plan's and it adds the
            # per-bucket fields.
            spec_kw = dict(mesh=dp_mesh(),
                           param_specs=[None] * len(named)) if zero else {}
        opt = DistributedOptimizer(
            optimizer([p for _, p in named]), named_parameters=named,
            fusion_threshold=fusion_threshold, wire_dtype=wire_dtype,
            zero=zero, overlap=overlap, **spec_kw)
        return training.TrainState(model=model, optimizer=opt)

    def step(state, tokens: torch.Tensor, labels: torch.Tensor):
        state, metrics = core(state, (tokens, labels))
        return state, metrics["loss"]

    return init_state, step

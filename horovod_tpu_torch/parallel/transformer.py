"""The transformer LM of the port: model, the training forward and its
data-parallel train step, and the prompt/decode-step forwards the paged
generation engine runs.

Port of the JAX package's ``parallel/transformer.py`` for a 1-D
data-parallel world (the tp/sp/ep mesh variants and MoE belong to later
slices). The weights keep the JAX layout: every projection is ``[in,
out]`` and applied as ``h @ W``, ``wqkv``'s columns are head-major
(``[D, H, 3, dh]``), and the unembedding is tied to the embedding — so a
JAX parameter tree maps onto :class:`Transformer` one to one
(:mod:`..convert`).

Numerics follow the JAX functions: parameters are f32 and every
projection runs in ``cfg.dtype`` (weights cast once by
:func:`gen_weights`), RMSNorm statistics are f32, the FFN is tanh-GELU,
residuals add in ``cfg.dtype`` and logits are f32 from a
``cfg.unembed_dtype`` product with f32 accumulation (:func:`unembed`).
Attention in training (:func:`forward_hidden`) routes as the JAX
function does: the packed flash kernels
(:func:`~..ops.attention.flash_attention_qkv`) where
``cfg.attn_backend`` is ``"pallas"`` and the shape is tilable,
:func:`~..ops.attention.flash_attention` with that backend otherwise
(which takes the dense :func:`~..ops.attention.xla_attention` for
untilable shapes). Prompts run
:func:`~..ops.attention.flash_attention_prefill` at every length, decode
steps a caller-supplied ``mix`` (the paged pool read in
:mod:`.kv_blocks`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.attention import (flash_attention, flash_attention_prefill,
                             flash_attention_qkv, qkv_flash_tilable)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 1024
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    n_experts: int = 0          # 0 = dense MLP (the only kind ported yet)
    dtype: torch.dtype = torch.bfloat16
    # Training attention: "pallas" takes the flash kernels where the shape
    # is tilable (the JAX name for the kernel route), "xla" the dense
    # attention, "auto" the kernels only past 4 GiB of scores.
    attn_backend: str = "pallas"
    # The tied-head unembed matmul dtype; logits are f32 (and accumulated
    # in f32) either way.
    unembed_dtype: torch.dtype = torch.float32

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


def check_dense(cfg: TransformerConfig, what: str) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            f"{what} supports dense FFNs only (cfg.n_experts="
            f"{cfg.n_experts}); the MoE layers are not ported yet")


class Block(nn.Module):
    """One pre-norm layer's parameters (JAX names and layouts)."""

    def __init__(self, cfg: TransformerConfig, normal: Callable):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.ln1 = nn.Parameter(normal((d,), None))
        self.wqkv = nn.Parameter(normal((d, 3 * d), d ** -0.5))
        self.wo = nn.Parameter(normal((d, d), d ** -0.5))
        self.ln2 = nn.Parameter(normal((d,), None))
        self.w1 = nn.Parameter(normal((d, ff), d ** -0.5))
        self.w2 = nn.Parameter(normal((ff, d), ff ** -0.5))


class Transformer(nn.Module):
    """Decoder-only LM with a tied unembedding.

    Weights are drawn from ``generator`` (a ``torch.Generator`` on
    ``device``; a fresh one seeded with 0 when omitted) with the JAX
    ``init_params`` scales: embedding N(0, 0.02²), projections
    N(0, 1/fan_in), norm scales 1. ``device`` defaults to ``"cuda"``."""

    def __init__(self, cfg: TransformerConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = "cuda"):
        super().__init__()
        check_dense(cfg, "Transformer")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def normal(shape, std):
            if std is None:
                return torch.ones(shape, device=dev)
            return torch.randn(shape, generator=generator, device=dev) * std

        self.cfg = cfg
        self.embed = nn.Parameter(normal((cfg.vocab, cfg.d_model), 0.02))
        self.lnf = nn.Parameter(normal((cfg.d_model,), None))
        self.layers = nn.ModuleList(Block(cfg, normal)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def gen_weights(model: Transformer) -> Dict:
    """The weights as the forwards read them, a dict mirroring the JAX
    parameter tree: projections cast to ``cfg.dtype`` once (not at every
    matmul), norm scales and the embedding f32, the unembedding in
    ``cfg.unembed_dtype``. Casts to the parameters' own dtype are free
    (no copy). Call under ``torch.no_grad()`` for inference."""
    cfg = model.cfg
    dt = cfg.dtype
    return {
        "embed": model.embed,
        "unembed": model.embed.to(cfg.unembed_dtype),
        "lnf": model.lnf,
        "layers": [{"ln1": b.ln1, "wqkv": b.wqkv.to(dt), "wo": b.wo.to(dt),
                    "ln2": b.ln2, "w1": b.w1.to(dt), "w2": b.w2.to(dt)}
                   for b in model.layers],
    }


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    rms = torch.sqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + 1e-6)
    return ((x32 / rms) * scale).to(x.dtype)


def _split_heads(qkv: torch.Tensor, cfg: TransformerConfig):
    """q, k, v ``[..., H, dh]`` views of the head-major projection (one
    ``unbind``, whose backward stacks the three gradients in one pass)."""
    return qkv.unflatten(-1, (cfg.n_heads, 3, cfg.d_head)).unbind(-2)


def _layer(layer: Dict, x: torch.Tensor, cfg: TransformerConfig,
           attend: Callable) -> torch.Tensor:
    """One pre-norm layer over ``x [..., d_model]``. ``attend(qkv)`` maps
    the head-major projection ``[..., H·3·dh]`` to the attention output
    ``[..., H·dh]``."""
    h = rms_norm(x, layer["ln1"])
    attn = attend(h @ layer["wqkv"])
    x = x + attn.to(cfg.dtype) @ layer["wo"]
    h2 = rms_norm(x, layer["ln2"])
    up = F.gelu(h2 @ layer["w1"], approximate="tanh")
    return x + up @ layer["w2"]


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


def unembed(w: Dict, x: torch.Tensor, cfg: TransformerConfig
            ) -> torch.Tensor:
    """Tied-head logits ``[..., vocab]`` f32 from the final hidden states
    (already through the final norm): the product runs in
    ``cfg.unembed_dtype`` and accumulates in f32 with no rounding of its
    output, as JAX's ``preferred_element_type=jnp.float32`` does. On the
    CPU a bf16 unembed multiplies the bf16-valued operands in f32, which
    is exact per product."""
    xu = x.to(cfg.unembed_dtype)
    u = w["unembed"]
    if cfg.unembed_dtype == torch.float32:
        return xu @ u.t()
    if xu.device.type == "cuda":
        out = _MatmulF32Out.apply(xu.reshape(-1, xu.shape[-1]), u)
        return out.view(*xu.shape[:-1], u.shape[0])
    return xu.float() @ u.float().t()


def attend_heads(qkv: torch.Tensor, cfg: TransformerConfig
                 ) -> torch.Tensor:
    """Causal attention over the head-major projection ``[B, T,
    H·3·dh]`` through :func:`~..ops.attention.flash_attention` with
    ``cfg.attn_backend``; returns ``[B, T, H·dh]``."""
    q, k, v = _split_heads(qkv, cfg)
    return flash_attention(q, k, v, causal=True,
                           backend=cfg.attn_backend).flatten(-2)


def _train_attend(cfg: TransformerConfig, T: int) -> Callable:
    """The training forward's attention for sequences of length ``T``
    (JAX ``forward_hidden`` :165-185 without sp): the packed flash
    kernels when ``cfg.attn_backend`` is ``"pallas"`` and the shape is
    tilable, :func:`attend_heads` otherwise."""
    if cfg.attn_backend == "pallas" and qkv_flash_tilable(T, cfg.d_head):
        return lambda qkv: flash_attention_qkv(qkv, cfg.n_heads,
                                               causal=True)
    return lambda qkv: attend_heads(qkv, cfg)


def _hidden(w: Dict, tokens: torch.Tensor, cfg: TransformerConfig
            ) -> torch.Tensor:
    x = w["embed"][tokens.long()].to(cfg.dtype)                 # [B, T, D]
    attend = _train_attend(cfg, tokens.shape[-1])
    for layer in w["layers"]:
        x = _layer(layer, x, cfg, attend)
    return rms_norm(x, w["lnf"])


def forward_hidden(model: Transformer, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """The final hidden states ``[B, T, d_model]`` (through the final
    norm, before the unembedding) of ``tokens [B, T]``; differentiable.
    The dense model has no MoE auxiliary loss, so unlike the JAX function
    it returns the states alone."""
    cfg = model.cfg
    check_dense(cfg, "forward_hidden")
    return _hidden(gen_weights(model), tokens, cfg)


def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Full causal forward: ``tokens [B, T]`` → logits ``[B, T, vocab]``
    f32 (:func:`forward_hidden` and the tied :func:`unembed`);
    differentiable."""
    cfg = model.cfg
    check_dense(cfg, "forward")
    w = gen_weights(model)
    return unembed(w, _hidden(w, tokens, cfg), cfg)


def dense_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token ``-log p(label)`` as ``logsumexp − picked logit`` (no
    ``log_softmax`` tensor), f32 like the logits."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return lse - picked


def prompt_forward(w: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
                   store_kv: Callable) -> torch.Tensor:
    """Prompt-phase forward (``w`` from :func:`gen_weights`): per layer
    the computed K/V (``[T, H, dh]``) is handed to ``store_kv(li, k, v)``
    and the attention is the self-contained causal
    :func:`~..ops.attention.flash_attention_prefill` over the prompt (the
    kernel at every length). Returns logits
    ``[T, vocab]`` f32."""
    x = w["embed"][tokens.long()][None].to(cfg.dtype)           # [1, T, D]
    for li, layer in enumerate(w["layers"]):
        def attend(qkv, li=li):
            q, k, v = _split_heads(qkv, cfg)
            store_kv(li, k[0], v[0])
            return flash_attention_prefill(q, k, v,
                                           causal=True).flatten(-2)
        x = _layer(layer, x, cfg, attend)
    return unembed(w, rms_norm(x, w["lnf"]), cfg)[0]


def step_forward(w: Dict, last_tokens: torch.Tensor,
                 cfg: TransformerConfig, mix: Callable) -> torch.Tensor:
    """Decode-step forward (``w`` from :func:`gen_weights`):
    ``mix(li, q, k, v)`` does the cache write and attention read (q/k/v
    ``[S, H, dh]`` → attention of the same shape). Returns logits
    ``[S, vocab]`` f32."""
    x = w["embed"][last_tokens.long()].to(cfg.dtype)             # [S, D]
    for li, layer in enumerate(w["layers"]):
        x = _layer(layer, x, cfg, lambda qkv, li=li: mix(
            li, *_split_heads(qkv, cfg)).flatten(-2))
    return unembed(w, rms_norm(x, w["lnf"]), cfg)


def make_parallel_train_step(cfg: TransformerConfig,
                             optimizer: Callable[..., torch.optim.Optimizer],
                             *, fusion_threshold: Optional[int] = None,
                             device: DeviceLike = "cuda"):
    """Build ``(init_state, step)``: the LM's data-parallel train step.

    Port of the JAX function for a 1-D data-parallel world (the world of
    :func:`horovod_tpu_torch.init`; one process per GPU). ``optimizer``
    builds the wrapped optimizer from the parameter list, e.g.
    ``functools.partial(torch.optim.AdamW, lr=1e-4, betas=(0.9, 0.95),
    eps=1e-8, weight_decay=0.1)`` for ``optax.adamw(1e-4, b1=0.9,
    b2=0.95, weight_decay=0.1)`` (decay on every leaf, as optax's
    ``mask=None``).

    ``init_state(seed=0, model=None)`` builds a :class:`Transformer` from
    ``seed`` (or takes ``model``, e.g. from
    :func:`~horovod_tpu_torch.convert.params_from_jax`) and wraps the
    optimizer in a :class:`~horovod_tpu_torch.DistributedOptimizer` whose
    buckets follow the JAX leaf order; call
    :func:`~horovod_tpu_torch.broadcast_parameters` on ``state.model`` to
    start every rank from rank 0's weights. ``step(state, tokens,
    labels) -> (state, loss)`` takes this rank's ``[B_local, T]`` shard
    and updates the state in place; the loss is ``mean(dense_nll)``
    averaged over the world (the dense model has no MoE auxiliary loss,
    so the JAX function's ``aux_weight`` has nothing to weigh).

    The JAX function's ``aux_weight``, ``wire_dtype``, ``zero``,
    ``accum_steps``, ``guard_nonfinite`` and ``overlap`` keywords, the
    chunked loss and the tp/sp/ep axes are not ported yet: passing one of
    those keywords is a ``TypeError``."""
    check_dense(cfg, "make_parallel_train_step")
    from .. import training
    dev = resolve_device(device)

    def value_and_grad(model: Transformer, batch) -> torch.Tensor:
        tokens, labels = batch
        loss = dense_nll(forward(model, tokens), labels).mean()
        loss.backward()
        return loss

    core = training.make_train_step(_value_and_grad=value_and_grad)

    def init_state(seed: int = 0, model: Optional[Transformer] = None):
        if model is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            model = Transformer(cfg, generator=gen, device=dev)
        elif model.cfg != cfg:
            raise ValueError(f"model.cfg {model.cfg} is not {cfg}")
        return training.create_train_state(
            model, optimizer, fusion_threshold=fusion_threshold, device=dev)

    def step(state, tokens: torch.Tensor, labels: torch.Tensor):
        state, metrics = core(state, (tokens, labels))
        return state, metrics["loss"]

    return init_state, step

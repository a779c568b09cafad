"""The transformer LM of the port: model, full forward, and the
prompt/decode-step forwards the paged generation engine runs.

Port of the JAX package's ``parallel/transformer.py`` (single device;
the dp/tp/sp/ep mesh variants belong to later slices). The weights keep
the JAX layout: every projection is ``[in, out]`` and applied as
``h @ W``, ``wqkv``'s columns are head-major (``[D, H, 3, dh]``), and the
unembedding is tied to the embedding — so a JAX parameter tree maps onto
:class:`Transformer` one to one (:mod:`..convert`).

Numerics follow the JAX functions: parameters are f32 and every
projection runs in ``cfg.dtype`` (weights cast once by
:func:`gen_weights`), RMSNorm statistics are f32, the FFN is tanh-GELU,
residuals add in ``cfg.dtype`` and logits are f32 from an
``cfg.unembed_dtype`` product. Attention is
:func:`~..ops.attention.flash_attention` for whole prompts and a
caller-supplied ``mix`` for decode steps (the paged pool read in
:mod:`.kv_blocks`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 1024
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    n_experts: int = 0          # 0 = dense MLP (the only kind ported yet)
    dtype: torch.dtype = torch.bfloat16
    # The tied-head unembed matmul dtype; logits are f32 either way.
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


def _layer(layer: Dict, x: torch.Tensor, cfg: TransformerConfig,
           attend: Callable) -> torch.Tensor:
    """One pre-norm layer over ``x [..., d_model]``. ``attend(q, k, v)``
    maps ``[..., H, dh]`` q/k/v views of the head-major projection to
    the attention output of the same shape."""
    h = rms_norm(x, layer["ln1"])
    qkv = (h @ layer["wqkv"]).unflatten(-1, (cfg.n_heads, 3, cfg.d_head))
    attn = attend(qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :])
    x = x + attn.to(cfg.dtype).flatten(-2) @ layer["wo"]
    h2 = rms_norm(x, layer["ln2"])
    up = F.gelu(h2 @ layer["w1"], approximate="tanh")
    return x + up @ layer["w2"]


def _unembed(w: Dict, x: torch.Tensor, cfg: TransformerConfig
             ) -> torch.Tensor:
    x = rms_norm(x, w["lnf"])
    return (x.to(cfg.unembed_dtype) @ w["unembed"].t()).float()


def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Full causal forward: ``tokens [B, T]`` → logits ``[B, T, vocab]``
    f32 (attention through :func:`flash_attention`)."""
    cfg = model.cfg
    check_dense(cfg, "forward")
    w = gen_weights(model)
    x = w["embed"][tokens.long()].to(cfg.dtype)
    for layer in w["layers"]:
        x = _layer(layer, x, cfg,
                   lambda q, k, v: flash_attention(q, k, v, causal=True))
    return _unembed(w, x, cfg)


def prompt_forward(w: Dict, tokens: torch.Tensor, cfg: TransformerConfig,
                   store_kv: Callable) -> torch.Tensor:
    """Prompt-phase forward (``w`` from :func:`gen_weights`): per layer
    the computed K/V (``[T, H, dh]``) is handed to ``store_kv(li, k, v)``
    and the attention is the self-contained causal
    :func:`flash_attention` over the prompt. Returns logits
    ``[T, vocab]`` f32."""
    x = w["embed"][tokens.long()][None].to(cfg.dtype)           # [1, T, D]
    for li, layer in enumerate(w["layers"]):
        def attend(q, k, v, li=li):
            store_kv(li, k[0], v[0])
            return flash_attention(q, k, v, causal=True)
        x = _layer(layer, x, cfg, attend)
    return _unembed(w, x, cfg)[0]


def step_forward(w: Dict, last_tokens: torch.Tensor,
                 cfg: TransformerConfig, mix: Callable) -> torch.Tensor:
    """Decode-step forward (``w`` from :func:`gen_weights`):
    ``mix(li, q, k, v)`` does the cache write and attention read (q/k/v
    ``[S, H, dh]`` → attention of the same shape). Returns logits
    ``[S, vocab]`` f32."""
    x = w["embed"][last_tokens.long()].to(cfg.dtype)             # [S, D]
    for li, layer in enumerate(w["layers"]):
        x = _layer(layer, x, cfg,
                   lambda q, k, v, li=li: mix(li, q, k, v))
    return _unembed(w, x, cfg)

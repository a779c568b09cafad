"""Expert parallelism: top-1 gated MoE with all-to-all dispatch over ``ep``.

Port of the JAX package's ``parallel/moe.py`` ``moe_ffn`` (:31), the
GShard layout: one expert per ep rank; each rank's tokens are routed by
a learned gate, packed into a static-capacity dispatch buffer ``[E, C,
D]`` (tokens past an expert's capacity drop), exchanged with one
all-to-all so rank e receives every rank's tokens for expert e,
transformed by the local expert FFN and returned by the inverse
all-to-all; the gate probability weighs the combine. Expert weights
carry ``ep`` in their specs, so their gradients ride the same
spec-grouped plan as every other leaf (:func:`~..ops.fusion.
plan_grad_sync`).

The JAX packing adds each token into its slot (``.at[...].add``), and a
dropped token adds zero into the clipped slot ``C - 1``; the port adds
likewise (``index_put_`` with ``accumulate=True``), so a dropped token
never overwrites the kept one there. ``argmax`` returns the first
maximal index in both libraries.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .comm import all_to_all


def capacity(tokens: int, experts: int, capacity_factor: float) -> int:
    """Per-expert slots, the JAX expression exactly (not a ceiling)."""
    return max(1, int((tokens / experts) * capacity_factor + 0.999))


def moe_ffn(x: torch.Tensor, gate_w: torch.Tensor, w1: torch.Tensor,
            w2: torch.Tensor, *, mesh, axis_name: str = "ep",
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 MoE feed-forward over the tokens of this rank.

    x ``[T_local, D]``; gate_w ``[D, E]`` (replicated, E the ep size);
    w1 ``[D, F]`` and w2 ``[F, D]`` this rank's expert. Returns ``(y
    [T_local, D], aux)``: aux is the load-balance loss ``E · Σ_e
    frac_e · mean_prob_e`` over the local tokens (f32). Raises for
    ``capacity_factor <= 0``."""
    if capacity_factor <= 0:
        raise ValueError(
            f"capacity_factor must be > 0, got {capacity_factor} — a "
            f"non-positive capacity would silently drop every token")
    T, D = x.shape
    E = mesh.shape[axis_name]
    group = mesh.groups[axis_name]
    C = capacity(T, E, capacity_factor)

    logits = x @ gate_w                                       # [T, E]
    probs = torch.softmax(logits.float(), dim=-1)
    expert = probs.argmax(-1)                                 # [T]
    gate = probs.gather(1, expert[:, None])[:, 0]

    # Slot of each token in its expert's buffer (1-based cumsum, -1 pad).
    onehot = F.one_hot(expert, E).to(torch.int32)             # [T, E]
    pos = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1      # [T]
    keep = (pos >= 0) & (pos < C)
    slot = pos.clamp(0, C - 1)

    vals = torch.where(keep[:, None], x, torch.zeros_like(x))
    dispatch = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    dispatch = dispatch.index_put((expert, slot), vals, accumulate=True)

    shuffled = all_to_all(dispatch, group)        # block s from rank s
    h = F.gelu(shuffled.reshape(-1, D) @ w1, approximate="tanh")
    out = (h @ w2).reshape(E, C, D)
    returned = all_to_all(out, group)

    combined = returned[expert, slot]
    combined = torch.where(keep[:, None], combined,
                           torch.zeros_like(combined))
    y = combined * gate[:, None].to(x.dtype)

    frac = onehot.float().mean(0)
    mean_prob = probs.mean(0)
    aux = (frac * mean_prob).sum() * E
    return y, aux

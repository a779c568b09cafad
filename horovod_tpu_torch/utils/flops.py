"""Matmul FLOPs of the LM train step, for model FLOP utilisation.

A copy of the JAX package's bench formula (``bench.py``
``lm_train_gflop_per_token``), kept here because that module imports
JAX."""

from __future__ import annotations

from typing import Mapping


def lm_train_gflop_per_token(c: Mapping[str, int]) -> float:
    """Matmul-only GFLOPs per trained token: per layer the forward costs
    8·d² (qkv + output projection) + 4·d·ff (FFN) + 2·T·d (causal QKᵀ and
    AV, halved); the tied unembed 2·d·V; training is 3× the forward.
    ``c`` holds ``d_model``, ``d_ff``, ``seq``, ``vocab``, ``n_layers``."""
    d, ff, T, V, L = (c["d_model"], c["d_ff"], c["seq"], c["vocab"],
                      c["n_layers"])
    fwd = L * (8 * d * d + 4 * d * ff + 2 * T * d) + 2 * d * V
    return 3 * fwd / 1e9

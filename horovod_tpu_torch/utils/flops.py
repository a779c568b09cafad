"""FLOPs of the bench's train steps and the card's peak rates, for
model FLOP utilisation.

The FLOPs models are copies of the JAX package's bench formulas
(``bench.py`` ``_FWD_GMACS``/``TRAIN_GFLOP_PER_IMAGE`` and
``lm_train_gflop_per_token``), kept here because that module imports
JAX. The peaks are NVIDIA's published dense rates.
"""

from __future__ import annotations

from typing import Mapping, Tuple

# Forward GMACs per image; a train step is 3 x 2 x that (multiply-
# accumulate = 2 FLOPs, backward ~ 2x forward).
FWD_GMACS = {"resnet50": 4.09, "resnet101": 7.80, "vgg16": 15.47,
             "inception3": 5.73, "cifar20": 0.041}
TRAIN_GFLOP_PER_IMAGE = {k: 3 * 2 * v for k, v in FWD_GMACS.items()}

# Published dense peaks by card name: (bf16 tensor-core FLOP/s, memory
# bytes/s); the H100 SXM part's where no other name matches.
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H200": (989e12, 4.8e12)}
PEAK_DEFAULT = (989e12, 3.35e12)


def peaks_for(name: str) -> Tuple[float, float]:
    """``(bf16 FLOP/s, bytes/s)`` of the card called ``name``."""
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAK_DEFAULT


def lm_train_gflop_per_token(c: Mapping[str, int]) -> float:
    """Matmul-only GFLOPs per trained token: per layer the forward costs
    8·d² (qkv + output projection) + 4·d·ff (FFN) + 2·T·d (causal QKᵀ and
    AV, halved); the tied unembed 2·d·V; training is 3× the forward.
    ``c`` holds ``d_model``, ``d_ff``, ``seq``, ``vocab``, ``n_layers``."""
    d, ff, T, V, L = (c["d_model"], c["d_ff"], c["seq"], c["vocab"],
                      c["n_layers"])
    fwd = L * (8 * d * d + 4 * d * ff + 2 * T * d) + 2 * d * V
    return 3 * fwd / 1e9

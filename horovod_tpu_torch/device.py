"""Device selection shared by every entry point of the port.

Entry points take ``device=`` and default to ``"cuda"``: the port is
written for the GPU, and a host without one must fail loudly instead of
quietly running the plain PyTorch versions on the CPU. Tests and
reference runs ask for ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Normalize ``device`` to a concrete ``torch.device``.

    ``"cuda"`` (the default) resolves to the current CUDA device and
    raises ``RuntimeError`` when CUDA is not available; ``"cpu"`` is
    returned as is. Other device types are rejected."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch runs on a CUDA device by default, but "
                "torch.cuda.is_available() is False on this host; pass "
                "device='cpu' explicitly to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev} (expected 'cuda' or 'cpu')")

"""LoRA adapters for the generation transformer: many fine-tunes, one base.

Port of the JAX package's ``parallel/lora.py``. A tenant's fine-tune is
``W + (alpha/r) · A @ B`` per target matrix, with ``A [d_in, r]`` and
``B [r, d_out]``: at rank ``r`` it costs ``4·r·(d_in + d_out)`` bytes
against the ``4·d_in·d_out`` of the full matrix, so hundreds of tenants
share one resident base.

The adapters are stacked into ``[M, d_in, r]`` / ``[M, r, d_out]``
tables and every decode slot carries an ``adapter_idx`` (``-1`` = base).
Tenant identity is data: the delta is a gather and two batched low-rank
products inside the same prefill and decode steps, so a mixed-adapter
batch runs the same step as a base-only one, and loading a tenant
changes no shape. The reference computes the delta in XLA, outside any
Pallas body; here it is plain PyTorch (``torch.bmm``).

Per-slot rows stay numerically independent: the gather takes row ``s``'s
own ``A``/``B`` and both products contract within a row, so a tenant's
stream is the same whether it decodes alone, in a mixed batch, or beside
base traffic. A base row goes through ``torch.where(active, y + d, y)``,
never ``y + 0.0`` (which would turn a ``-0.0`` into ``+0.0``), so a base
stream through an adapter engine is bitwise a plain engine's. The
gather index is clipped into ``[0, rows - 1]`` as the JAX ``safe`` index
is: a base row gathers row 0 and discards it.

On a tp mesh a rank holds its block of each adapter leaf
(:func:`adapter_specs`): the column-parallel targets (``wqkv``, ``w1``)
this rank's column block of ``B`` (the same contiguous block
:func:`~.mesh.local_slice` takes of the weight, so ``wqkv``'s block is
this rank's heads), the row-parallel ones (``wo``, ``w2``) its row block
of ``A``. A row-parallel delta is then a partial sum, added before the
layer's tp sum (:func:`~.transformer._layer`), so the summed output
carries the whole delta.

Adapter trees mirror the transformer's layer list:
``{"layers": [{target: {"a": [d_in, r], "b": [r, d_out]}}, ...]}`` with
targets from :data:`LORA_TARGETS`. The device table's lifecycle lives in
:class:`~..serve.adapters.AdapterRegistry`; persistence in
:func:`~.checkpoint.save_adapter` / :func:`~.checkpoint.restore_adapter`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .mesh import local_slice
from .transformer import TransformerConfig

#: The per-layer dense matmuls a LoRA delta can target, in forward order.
LORA_TARGETS = ("wqkv", "wo", "w1", "w2")

# Adapter names are identifiers: they become checkpoint directory
# suffixes, metric keys and parts of the engine's prefix-reuse salt,
# where a name holding "\x00" and digits could forge another (name,
# generation) pair's key. This charset keeps the salt's "name\x00gen\x00"
# framing unambiguous.
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,127}$")

#: Tenant keys the serving plane keeps for itself: ``base`` is the
#: adapter-less traffic class, ``retired`` the metric fold of evicted
#: tenants.
RESERVED_ADAPTER_NAMES = ("base", "retired")


def check_adapter_name(name: str) -> str:
    """Validate (and return) an adapter name; ``ValueError`` otherwise."""
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise ValueError(
            f"adapter name must match {_NAME_RE.pattern} (letters, "
            f"digits, '._-', max 128 chars), got {name!r}")
    if name in RESERVED_ADAPTER_NAMES:
        raise ValueError(
            f"adapter name {name!r} is reserved "
            f"({RESERVED_ADAPTER_NAMES}: the adapter-less traffic class "
            f"and the evicted-tenant metric fold)")
    return name


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """Adapter shape knobs: ``rank`` is the low-rank width ``r``, the
    applied delta is scaled by ``alpha / rank``, ``targets`` names the
    per-layer matmuls carrying a delta (default: all four)."""

    rank: int = 4
    alpha: float = 8.0
    targets: Tuple[str, ...] = LORA_TARGETS

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if not self.alpha > 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")
        targets = tuple(self.targets)
        if not targets:
            raise ValueError("targets must name at least one matmul")
        bad = [t for t in targets if t not in LORA_TARGETS]
        if bad:
            raise ValueError(
                f"unknown LoRA target(s) {bad}; supported: {LORA_TARGETS}")
        object.__setattr__(self, "targets", targets)

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def target_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, int]]:
    """``target -> (d_in, d_out)`` of the base matmuls a delta rides."""
    d = cfg.d_model
    return {"wqkv": (d, 3 * d), "wo": (d, d),
            "w1": (d, cfg.d_ff), "w2": (cfg.d_ff, d)}


#: The column-parallel targets (their B splits over tp); the others are
#: row-parallel (their A splits).
COLUMN_TARGETS = ("wqkv", "w1")


def adapter_specs(lora: LoraConfig) -> Dict[str, Dict[str, Tuple]]:
    """``target -> {"a": spec, "b": spec}`` of one adapter's leaves on a
    tp mesh, per dimension as :func:`~.transformer.param_specs` writes
    them: B's columns of a column-parallel target, A's rows of a
    row-parallel one."""
    col = {"a": (None, None), "b": (None, "tp")}
    row = {"a": ("tp", None), "b": (None, None)}
    return {t: (col if t in COLUMN_TARGETS else row) for t in lora.targets}


def local_adapter(adapter: Any, lora: LoraConfig, mesh) -> Any:
    """This rank's block of every leaf of a global adapter tree
    (:func:`adapter_specs`); the tree itself off a mesh."""
    if mesh is None:
        return adapter
    specs = adapter_specs(lora)
    return {"layers": [
        {t: {n: local_slice(pair[n], specs[t][n], mesh) for n in ("a", "b")}
         for t, pair in layer.items()}
        for layer in adapter["layers"]]}


def adapter_bytes(cfg: TransformerConfig, lora: LoraConfig) -> int:
    """Bytes of ONE adapter (f32 A/B pairs)."""
    shapes = target_shapes(cfg)
    per_layer = sum(4 * lora.rank * (shapes[t][0] + shapes[t][1])
                    for t in lora.targets)
    return cfg.n_layers * per_layer


def init_adapter(generator: Optional[torch.Generator],
                 cfg: TransformerConfig, lora: LoraConfig,
                 b_scale: float = 0.0, *,
                 device: DeviceLike = "cuda") -> Dict:
    """Fresh adapter tree of f32 tensors on ``device`` (``"cuda"`` by
    default, as every entry point of the port; ``"cpu"`` must be asked
    for): ``A ~ N(0, 1/d_in)`` and ``B = 0`` (the standard LoRA init: the
    delta starts at zero). ``b_scale > 0`` draws ``B ~ N(0, b_scale²)`` instead, for tests
    and benches that need distinct tenants without fine-tuning them.
    ``generator`` (on ``device``) seeds the draws, in the order layer by
    layer, target by target, ``A`` then ``B``."""
    dev = resolve_device(device)
    shapes = target_shapes(cfg)
    layers = []
    for _ in range(cfg.n_layers):
        layer = {}
        for t in lora.targets:
            d_in, d_out = shapes[t]
            a = torch.randn((d_in, lora.rank), generator=generator,
                            device=dev) * d_in ** -0.5
            # B's draw is taken either way (as JAX splits its key either
            # way), so A is the same with and without b_scale.
            b = torch.randn((lora.rank, d_out), generator=generator,
                            device=dev)
            b = b * b_scale if b_scale else torch.zeros_like(b)
            layer[t] = {"a": a, "b": b}
        layers.append(layer)
    return {"layers": layers}


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))


def check_adapter(adapter: Any, cfg: TransformerConfig,
                  lora: LoraConfig) -> None:
    """Reject an adapter tree that does not fit ``(cfg, lora)`` at load
    time, naming the culprit (the JAX function's messages)."""
    shapes = target_shapes(cfg)
    layers = adapter.get("layers") if isinstance(adapter, dict) else None
    if layers is None or len(layers) != cfg.n_layers:
        raise ValueError(
            f"adapter tree must be {{'layers': [... x {cfg.n_layers}]}}, "
            f"got layers="
            f"{None if layers is None else len(layers)}")
    for li, layer in enumerate(layers):
        if set(layer) != set(lora.targets):
            raise ValueError(
                f"adapter layer {li} targets {sorted(layer)} != "
                f"configured {sorted(lora.targets)}")
        for t, pair in layer.items():
            d_in, d_out = shapes[t]
            if not isinstance(pair, dict) or set(pair) != {"a", "b"}:
                got = (sorted(pair) if isinstance(pair, dict)
                       else type(pair).__name__)
                raise ValueError(
                    f"adapter layer {li} target {t!r} must be a "
                    f"{{'a', 'b'}} pair, got {got}")
            a_shape = _shape(pair["a"])
            b_shape = _shape(pair["b"])
            if a_shape != (d_in, lora.rank) or b_shape != (lora.rank,
                                                           d_out):
                raise ValueError(
                    f"adapter layer {li} target {t!r}: a{a_shape} / "
                    f"b{b_shape} do not match expected "
                    f"a({d_in}, {lora.rank}) / b({lora.rank}, {d_out})")


def _as_tensor(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.detach().to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _tree_map(fn: Callable, *trees):
    """Map ``fn`` over the leaves of same-shaped adapter trees."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def stack_adapters(adapters: Sequence[Any], *,
                   device: Optional[DeviceLike] = None) -> Any:
    """Stack N same-shaped adapter trees into one ``[N, ...]``-leaved f32
    table (the gather target of the batched application), on ``device``
    (default: the first leaf's, or the CPU for numpy leaves)."""
    if not adapters:
        raise ValueError("stack_adapters needs at least one adapter")

    def stack(*xs):
        dev = (resolve_device(device) if device is not None
               else xs[0].device if torch.is_tensor(xs[0])
               else torch.device("cpu"))
        return torch.stack([_as_tensor(x, dev) for x in xs])
    return _tree_map(stack, *adapters)


def empty_adapter_table(cfg: TransformerConfig, lora: LoraConfig,
                        capacity: int, *,
                        device: DeviceLike = "cuda", mesh=None) -> Any:
    """All-zero f32 stacked table of ``capacity`` rows on ``device``: a
    zero row IS the base model (delta 0), so an unoccupied row is
    harmless even if a stale index gathered it. On a tp ``mesh`` each row
    holds this rank's blocks (:func:`adapter_specs`)."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    dev = resolve_device(device)
    shapes = target_shapes(cfg)
    specs = adapter_specs(lora)

    def zeros(shape, spec):
        if mesh is not None:
            shape = local_slice(np.empty(shape, np.int8), spec, mesh).shape
        return torch.zeros((capacity,) + tuple(shape), device=dev)
    return {"layers": [
        {t: {"a": zeros((shapes[t][0], lora.rank), specs[t]["a"]),
             "b": zeros((lora.rank, shapes[t][1]), specs[t]["b"])}
         for t in lora.targets}
        for _ in range(cfg.n_layers)]}


# -- batched application: the delta callbacks the prompt and step forwards
# thread past every target matmul ---------------------------------------------

def _table_rows(adapters: Any) -> int:
    for layer in adapters["layers"]:
        for pair in layer.values():
            return int(pair["a"].shape[0])
    raise ValueError("adapter table has no target pairs")


def prompt_delta(adapters: Any, adapter_idx, lora: LoraConfig,
                 cfg: TransformerConfig) -> Callable:
    """Delta callback of the single-sequence prompt forward: ONE adapter
    (``adapter_idx`` an int or 0-d tensor; ``-1`` = base, whose matmul
    output passes through bitwise)."""
    n = _table_rows(adapters)
    idx = int(adapter_idx)
    safe = min(max(idx, 0), n - 1)
    scale = lora.scaling

    def delta(li, name, x, y):
        pair = adapters["layers"][li].get(name)
        if pair is None or idx < 0:
            # torch.where(False, y + d, y) is y: skip computing d.
            return y
        a = pair["a"][safe].to(cfg.dtype)           # [d_in, r]
        b = pair["b"][safe].to(cfg.dtype)           # [r, d_out]
        return y + ((x @ a) @ b) * scale

    return delta


def step_delta(adapters: Any, adapter_idx: torch.Tensor, lora: LoraConfig,
               cfg: TransformerConfig) -> Callable:
    """Delta callback of the fixed-shape decode step: per-slot
    ``adapter_idx [S]`` gathers each row's A/B pair (clipped into the
    table) and applies the delta through two batched low-rank products,
    each contracting within its row; base rows (``-1``) keep ``y``
    through ``torch.where``."""
    n = _table_rows(adapters)
    idx = adapter_idx.long()                        # [S]
    active = (idx >= 0)[:, None]
    safe = idx.clamp(0, n - 1)
    scale = lora.scaling

    def delta(li, name, x, y):
        pair = adapters["layers"][li].get(name)
        if pair is None:
            return y
        a = pair["a"][safe].to(cfg.dtype)           # [S, d_in, r]
        b = pair["b"][safe].to(cfg.dtype)           # [S, r, d_out]
        xa = torch.bmm(x[:, None, :], a)            # [S, 1, r]
        d = torch.bmm(xa, b)[:, 0, :] * scale       # [S, d_out]
        return torch.where(active, y + d, y)

    return delta


def make_delta(kind: str, adapters: Any, adapter_idx, lora: LoraConfig,
               cfg: TransformerConfig, *, rows: int = 0, repeat: int = 1,
               device: Optional[DeviceLike] = None) -> Optional[Callable]:
    """The LoRA hook of a generation entry point, ``None`` without a
    table. ``kind`` is ``"prompt"`` (one adapter; ``adapter_idx`` an int,
    ``None`` = base) or ``"step"`` (``adapter_idx [rows]`` on ``device``,
    ``None`` = every slot base, each slot's index repeated ``repeat``
    times: the verify's columns)."""
    if adapters is None:
        return None
    if lora is None:
        raise ValueError(
            "adapters= needs lora=LoraConfig(...) (the rank/alpha/targets "
            "the table was built with)")
    if kind == "prompt":
        return prompt_delta(adapters, -1 if adapter_idx is None
                            else adapter_idx, lora, cfg)
    idx = (torch.full((rows,), -1, dtype=torch.int32, device=device)
           if adapter_idx is None
           else torch.as_tensor(adapter_idx, device=device))
    if repeat > 1:
        idx = idx.repeat_interleave(repeat)
    return step_delta(adapters, idx, lora, cfg)

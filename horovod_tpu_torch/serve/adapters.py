"""Multi-tenant adapter lifecycle: a fixed-capacity stacked device table.

Port of the JAX package's ``serve/adapters.py``. The model layer
(:mod:`..parallel.lora`) makes tenant identity data: a per-slot
``adapter_idx`` gathers rows of stacked ``[capacity, ...]`` LoRA tables
inside the one decode step. This module owns everything around that
table:

* **Fixed capacity.** The table is allocated once at ``[capacity,
  ...]`` f32 on the engine's device; loading tenant #37 into a free row
  changes no shape.
* **Hot-load at a step boundary, never mid-step: the table is swapped,
  not written.** A load stages the adapter's rows on the device, then,
  in one critical section with the row's checks, builds a NEW table
  (each leaf cloned with the row set) and swaps it in, as the JAX
  registry swaps in a new immutable tree under one lock. The engine
  loop reads :meth:`AdapterRegistry.table` afresh at every prefill and
  decode step, so a step already in flight keeps the old tensors and the
  next step sees the whole new row or none of it; a ``retain`` or
  ``evict`` of the name waits for the swap, so no stream prefills on one
  generation of the weights and decodes on the next, and no row is both
  free and named. The alternative, staging rows and writing them into
  the live table at the top of the loop, would need the registry to
  reach into the engine's loop (and every engine sharing the registry)
  and would still write a tensor a queued kernel may read. The swap
  costs one table copy per load (64 MiB at the bench LM with rank 16 and
  capacity 4): on the card an asynchronous device copy, so the lock is
  held for the launches only. Every kernel runs on one device stream, so
  the old table's memory is reused only after the steps queued before
  the swap.
* **Evict refuses while referenced**, the
  :class:`~..parallel.kv_blocks.BlockManager` refcount discipline:
  every admitted request retains its adapter's row from submit until it
  finishes or fails, so a row a live stream gathers from is never freed
  and overwritten under it.
* **Per-tenant admission quotas** (``quota``: in-flight streams; the
  engine rejects over-quota submits with reason ``tenant_quota``) and
  **scheduling policy** (``weight``, ``priority``, ``slo_ttft_ms``: the
  fair scheduler's share, the strict priority class that may preempt,
  the TTFT target of the burn figures). ``"base"`` (no adapter) is a
  tenant too; registry values override the engine config's defaults and
  apply at the next admission.

* **On a tp mesh** (``mesh=``, the model's) the table holds this
  rank's block of every adapter leaf (:func:`~..parallel.lora.
  adapter_specs`); :meth:`AdapterRegistry.load` takes the global tree and
  slices it. A tp engine's followers load nothing themselves: the
  leader's engine sends each row loaded since its last device call with
  that call (:meth:`AdapterRegistry.rows_since`, the table generation),
  and the follower's registry installs it (:meth:`AdapterRegistry.
  install`) before the step that may read it.

Weights come from anything yielding the
:func:`~..parallel.lora.init_adapter` tree shape — typically
:func:`~..parallel.checkpoint.restore_adapter` (manifest-CRC-verified),
so a corrupt fine-tune fails its load and the base model keeps serving.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..parallel.lora import (LoraConfig, _as_tensor, _tree_map,
                             check_adapter, check_adapter_name,
                             empty_adapter_table, local_adapter)
from ..parallel.transformer import TransformerConfig


class AdapterRegistry:
    """Name → table-row bookkeeping over one stacked LoRA device table.

    Args:
      model_cfg: the base :class:`~..parallel.transformer.
        TransformerConfig` the adapters fine-tune.
      lora: the :class:`~..parallel.lora.LoraConfig` every loaded adapter
        must match (rank/alpha/targets are table shape).
      capacity: table rows, the most adapters resident at once.
      device: where the table lives (the engine's device; ``"cuda"`` by
        default, ``"cpu"`` for CPU engines).
      mesh: the tp mesh of the model the adapters ride (None: unsharded);
        the table then holds this rank's blocks.

    Thread-safe: every method holds one lock, a load's checks, copy and
    swap included.
    """

    def __init__(self, model_cfg: TransformerConfig, lora: LoraConfig,
                 capacity: int = 8, *, device: DeviceLike = "cuda",
                 mesh=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._model_cfg = model_cfg
        self._lora = lora
        self._capacity = int(capacity)
        self._device = resolve_device(device)
        self._mesh = mesh
        self._table = empty_adapter_table(model_cfg, lora, capacity,
                                          device=self._device, mesh=mesh)
        # The table generation (bumped by every load and install) and,
        # at tp above 1, each row's last load as (generation, global host
        # tree): what a tp leader sends its followers.
        self._version = 0
        self._row_trees: Dict[int, Tuple[int, Any]] = {}
        self._lock = threading.Lock()
        self._names: Dict[str, int] = {}
        self._ref = np.zeros(self._capacity, np.int64)
        self._free: List[int] = list(range(self._capacity - 1, -1, -1))
        self._quotas: Dict[str, Optional[int]] = {}
        self._weights: Dict[str, float] = {}
        self._priorities: Dict[str, int] = {}
        self._slo_ttft: Dict[str, float] = {}
        # Monotone per-name load generation, bumped on every load and
        # never reset by evict: the engine salts its prefix-reuse keys
        # with (name, generation), so an adapter loaded under a recycled
        # name never hits K/V its predecessor wrote.
        self._gens: Dict[str, int] = {}
        self._loads_total = 0
        self._evictions_total = 0
        # Called (outside the lock) after an evict commits: the engine
        # folds the tenant's metrics so tenant churn stays bounded.
        self._evict_listeners: List[Callable[[str], None]] = []

    # -- properties --------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def lora(self) -> LoraConfig:
        return self._lora

    @property
    def model_cfg(self) -> TransformerConfig:
        return self._model_cfg

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def mesh(self):
        """The tp mesh the table's blocks are cut for (None: whole)."""
        return self._mesh

    def rows_since(self, version: int) -> Tuple[int, list]:
        """``(current generation, [(row, global tree), ...])``: the rows
        loaded after table generation ``version``, each with its last
        load's global tree (at tp above 1; otherwise no tree is kept and
        the list is empty). A tp leader sends these with its next device
        call."""
        with self._lock:
            return self._version, [
                (row, tree) for row, (v, tree) in
                sorted(self._row_trees.items()) if v > version]

    def install(self, row: int, adapter: Any) -> None:
        """Write the global ``adapter`` tree's blocks into ``row`` (a tp
        follower's copy of its leader's load): the table is swapped, as
        by :meth:`load`, with no name or policy bookkeeping."""
        staged = _tree_map(lambda x: _as_tensor(x, self._device),
                           local_adapter(adapter, self._lora, self._mesh))
        with self._lock, torch.no_grad():
            self._table = _tree_map(_with_row(row), self._table, staged)
            self._version += 1

    def table(self) -> Any:
        """The current stacked device table. Never written after it is
        published: a concurrent load swaps in a new one."""
        with self._lock:
            return self._table

    def resident(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._names))

    def index_of(self, name: str) -> Optional[int]:
        with self._lock:
            return self._names.get(name)

    # -- load / evict ------------------------------------------------------

    def load(self, name: str, adapter: Any,
             quota: Optional[int] = None,
             weight: Optional[float] = None,
             priority: Optional[int] = None,
             slo_ttft_ms: Optional[float] = None) -> int:
        """Stage ``adapter`` and swap it into a table row; returns the
        row. Re-loading a resident name hot-reloads its weights in place,
        refused (``RuntimeError``) while a live stream references the row
        (a mid-stream weight change would fork the tenant's stream). A
        full table raises ``ValueError`` naming the capacity.
        ``quota``/``weight``/``priority``/``slo_ttft_ms`` set the tenant's
        policy in the same call (``None`` leaves each unset)."""
        check_adapter_name(name)
        if weight is not None and weight <= 0:
            raise ValueError(
                f"scheduling weight must be > 0 or None, got {weight}")
        if slo_ttft_ms is not None and slo_ttft_ms <= 0:
            raise ValueError(
                f"slo_ttft_ms must be > 0 or None, got {slo_ttft_ms}")
        check_adapter(adapter, self._model_cfg, self._lora)
        host = None
        if self._mesh is not None and self._mesh.shape.get("tp", 1) > 1:
            host = _tree_map(lambda x: np.array(
                x.detach().float().cpu() if torch.is_tensor(x) else x,
                np.float32), adapter)
        staged = _tree_map(lambda x: _as_tensor(x, self._device),
                           local_adapter(adapter, self._lora, self._mesh))
        with self._lock:
            row = self._names.get(name)
            if row is not None:
                if self._ref[row] > 0:
                    raise RuntimeError(
                        f"adapter {name!r} is referenced by "
                        f"{int(self._ref[row])} live stream(s) — a "
                        f"hot-reload would change tokens mid-stream; "
                        f"drain the tenant first")
            elif not self._free:
                raise ValueError(
                    f"adapter table full ({self._capacity} rows, "
                    f"resident: {sorted(self._names)}) — evict an idle "
                    f"adapter or raise capacity")
            else:
                row = self._free[-1]
            with torch.no_grad():
                self._table = _tree_map(_with_row(row), self._table, staged)
            self._version += 1
            if host is not None:
                self._row_trees[row] = (self._version, host)
            if name not in self._names:
                self._free.pop()
            self._names[name] = row
            self._gens[name] = self._gens.get(name, 0) + 1
            if quota is not None:
                self._quotas[name] = int(quota)
            if weight is not None:
                self._weights[name] = float(weight)
            if priority is not None:
                self._priorities[name] = int(priority)
            if slo_ttft_ms is not None:
                self._slo_ttft[name] = float(slo_ttft_ms)
            self._loads_total += 1
            return row

    def evict(self, name: str) -> None:
        """Free ``name``'s row for a future load. Refuses
        (``RuntimeError``) while any live stream references the row. The
        row's bytes stay; nothing gathers from an unnamed row, and the
        next load replaces it."""
        with self._lock:
            row = self._names.get(name)
            if row is None:
                raise ValueError(
                    f"no adapter {name!r} resident "
                    f"(resident: {sorted(self._names)})")
            if self._ref[row] > 0:
                raise RuntimeError(
                    f"adapter {name!r} is referenced by "
                    f"{int(self._ref[row])} live stream(s) — refusing to "
                    f"evict; drain the tenant first")
            del self._names[name]
            self._quotas.pop(name, None)
            self._weights.pop(name, None)
            self._priorities.pop(name, None)
            self._slo_ttft.pop(name, None)
            self._free.append(row)
            self._evictions_total += 1
            listeners = list(self._evict_listeners)
        for fn in listeners:
            try:
                fn(name)
            except Exception:  # noqa: BLE001 — cleanup must not fail evict
                pass

    def add_evict_listener(self, fn: Callable[[str], None]) -> None:
        """Register a post-evict callback (called with the evicted name,
        outside the registry lock): the engine's metric fold."""
        with self._lock:
            self._evict_listeners.append(fn)

    def remove_evict_listener(self, fn: Callable[[str], None]) -> None:
        """Unhook a listener (idempotent): engines unhook at shutdown so a
        shared registry keeps no callbacks of retired engines."""
        with self._lock:
            try:
                self._evict_listeners.remove(fn)
            except ValueError:
                pass

    # -- stream references -------------------------------------------------

    def retain(self, name: str) -> int:
        """One more live-stream reference on ``name``'s row (at submit);
        returns the row the stream's ``adapter_idx`` uses for its whole
        lifetime."""
        with self._lock:
            row = self._names.get(name)
            if row is None:
                raise ValueError(
                    f"adapter {name!r} is not resident (resident: "
                    f"{sorted(self._names)}) — load() it first")
            self._ref[row] += 1
            return row

    def release(self, name: str) -> None:
        """Drop one stream reference (stream finished or failed)."""
        with self._lock:
            row = self._names.get(name)
            if row is None or self._ref[row] <= 0:
                raise RuntimeError(
                    f"release of unretained adapter {name!r}")
            self._ref[row] -= 1

    def refcount(self, name: str) -> int:
        with self._lock:
            row = self._names.get(name)
            return int(self._ref[row]) if row is not None else 0

    def generation(self, name: str) -> int:
        """How many times ``name`` has been loaded; stable for a stream's
        lifetime once its row is retained (a reload is refused while
        referenced), hence a sound prefix-reuse salt component."""
        with self._lock:
            if name not in self._names:
                raise ValueError(
                    f"adapter {name!r} is not resident (resident: "
                    f"{sorted(self._names)})")
            return self._gens[name]

    # -- quotas ------------------------------------------------------------

    def quota(self, tenant: str) -> Optional[int]:
        """Max in-flight streams for ``tenant`` (``None`` = unlimited)."""
        with self._lock:
            return self._quotas.get(tenant)

    def set_quota(self, tenant: str, quota: Optional[int]) -> None:
        if quota is not None and quota < 1:
            raise ValueError(f"quota must be >= 1 or None, got {quota}")
        with self._lock:
            if quota is None:
                self._quotas.pop(tenant, None)
            else:
                self._quotas[tenant] = int(quota)

    # -- scheduling policy ---------------------------------------------------

    def weight(self, tenant: str) -> Optional[float]:
        """Fair-share weight of ``tenant`` (``None`` = the engine
        default, 1.0)."""
        with self._lock:
            return self._weights.get(tenant)

    def set_weight(self, tenant: str, weight: Optional[float]) -> None:
        """Applied at the next admission pick."""
        if weight is not None and weight <= 0:
            raise ValueError(
                f"scheduling weight must be > 0 or None, got {weight}")
        with self._lock:
            if weight is None:
                self._weights.pop(tenant, None)
            else:
                self._weights[tenant] = float(weight)

    def priority(self, tenant: str) -> Optional[int]:
        """Strict priority class of ``tenant`` (``None`` = the engine
        default, 0; higher admits first and may preempt lower)."""
        with self._lock:
            return self._priorities.get(tenant)

    def set_priority(self, tenant: str, priority: Optional[int]) -> None:
        with self._lock:
            if priority is None:
                self._priorities.pop(tenant, None)
            else:
                self._priorities[tenant] = int(priority)

    def slo_ttft_ms(self, tenant: str) -> Optional[float]:
        """TTFT target of ``tenant`` in ms (``None`` = no target)."""
        with self._lock:
            return self._slo_ttft.get(tenant)

    def set_slo_ttft_ms(self, tenant: str,
                        slo_ttft_ms: Optional[float]) -> None:
        if slo_ttft_ms is not None and slo_ttft_ms <= 0:
            raise ValueError(
                f"slo_ttft_ms must be > 0 or None, got {slo_ttft_ms}")
        with self._lock:
            if slo_ttft_ms is None:
                self._slo_ttft.pop(tenant, None)
            else:
                self._slo_ttft[tenant] = float(slo_ttft_ms)

    # -- gauges ------------------------------------------------------------

    def gauges(self) -> Dict:
        """The ``/stats`` adapter-table block: plain json-ready values."""
        with self._lock:
            return {
                "capacity": self._capacity,
                "resident": len(self._names),
                "free_rows": len(self._free),
                "names": sorted(self._names),
                "refcounts": {n: int(self._ref[i])
                              for n, i in sorted(self._names.items())},
                "quotas": dict(sorted(self._quotas.items())),
                "weights": dict(sorted(self._weights.items())),
                "priorities": dict(sorted(self._priorities.items())),
                "slo_ttft_ms": dict(sorted(self._slo_ttft.items())),
                "loads_total": self._loads_total,
                "evictions_total": self._evictions_total,
            }


def _with_row(row: int) -> Callable:
    """Leaf function of a load: a copy of the table leaf with ``row``
    replaced by the staged adapter leaf."""
    def one(leaf: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        out = leaf.clone()
        out[row] = value.to(leaf.dtype)
        return out
    return one

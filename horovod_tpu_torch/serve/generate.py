"""Continuous-batching autoregressive generation over the KV cache.

Port of the JAX package's ``serve/generate.py`` ``GenerationEngine``.
Orca-style iteration-level scheduling over vLLM-style paged KV memory:

* **Slots, not batches.** The decode step always runs at the fixed
  ``[max_slots]`` shape and requests join/leave the batch at every step
  boundary: a new request prefills into a free slot while its neighbours
  are mid-stream. Slot rows are numerically independent, so a request's
  greedy stream is the same whether it runs alone or in a busy batch.
* **Two KV layouts.** ``"contiguous"`` (the default, as in JAX): every
  slot reserves ``max_len`` rows of :func:`~..parallel.transformer.
  init_kv_cache`. ``"paged"``: a fixed pool of ``block_size``-position
  blocks (:mod:`..parallel.kv_blocks`); a stream reserves at admission
  every block it can write and holds only those, admission tracks free
  blocks next to free slots (``blocks_exhausted`` vs ``slots_full``).
* **Prefix reuse, chunked prefill, host tier** (paged): full prompt
  blocks are registered and shared copy-on-write by later prompts with
  the same prefix; ``chunked_prefill`` runs every admission as chunks
  that read the shared prefix out of the pool, so a hit computes only
  its suffix; ``host_blocks`` offloads cold registered prefixes to host
  memory and fetches them back at the loop's top, never inside a step.
* **Speculative decoding** (``spec=SpecConfig(k)``): a host-side drafter
  proposes up to ``k`` tokens a slot and one verify forward scores all
  ``k + 1`` positions (:mod:`.spec`).
* **Multi-tenant LoRA** (``adapters=AdapterRegistry``): ``submit(adapter=
  name)`` serves that tenant's fine-tune; the per-slot adapter row is
  data gathered inside the same prefill and decode steps
  (:mod:`..parallel.lora`), so a mixed batch is the same step. Admission
  is the :class:`~.sched.FairScheduler`'s pick (weighted deficit round
  robin over tenants, strict priority classes above it, FIFO within a
  tenant), with per-tenant quotas and KV block budgets; a higher-priority
  admission that finds no slot or blocks may preempt-by-evict the
  lowest-priority stream, which rejoins the held line and replays its
  emitted tokens suppressed and verified (``PreemptedError`` past
  ``preempt_retries``).
* **Kernels.** Prompts run the flash-attention prefill kernel; paged
  decode and verify steps run the paged decode-attention kernel under
  ``paged_kernel=True``, and otherwise gather each slot's blocks into the
  contiguous cache's own attention, so the default paged engine is
  bitwise the contiguous one. The routes are chosen once, from the model
  config, as the JAX engine chooses them: on the card a model the kernels
  do not take (f32, fp16, d_head other than 128) runs the prefill's plain
  version and the gather even under ``paged_kernel=True``, as on the
  CPU; ``stats()["kernels"]`` says which route each phase took. The LoRA
  delta, the contiguous decode and the chunked prefill's pool read are
  plain PyTorch, as the JAX functions are plain XLA. Prompts pad to
  power-of-two buckets, so :meth:`GenerationEngine.warmup` can run every
  shape the engine will see before traffic.
* **Tensor parallelism.** A model on a tp mesh (every rank holding its
  :func:`~..parallel.transformer.param_specs` blocks, from
  :func:`~..convert.params_from_jax` with ``mesh=``) serves from one
  engine per rank, built on every rank with the same arguments. The
  cache holds each rank's ``n_heads / tp`` heads
  (:func:`~..parallel.transformer.kv_cache_specs`). The tp group's rank
  0 is the leader: it runs this loop and sends every device call first
  to the other ranks, which run it on their shards
  (:mod:`.tp_plane`); :meth:`GenerationEngine.wait` blocks a follower
  until the leader stops. A mesh with dp, pp, ep or sp above 1 is
  refused.
* **Liveness** (for a fleet's router): :meth:`GenerationEngine.
  loop_alive` reads dead on the loop thread's death and on a busy loop
  with no iteration for ``stall_s``; each iteration calls the fault
  injector's ``serve_hook``, and the flight recorder keeps the serving
  events (``serve_admit``, ``serve_crash`` naming the in-flight streams).
* **Sampling is per-request and host-side** (numpy, seeded per request:
  greedy / temperature / top-k), so a stream is reproducible no matter
  what shares its batch.
* **Backpressure**: bounded admission queue
  (:class:`~..exceptions.ServerOverloadedError` at the door), deadlines
  checked while a request waits for a slot
  (:class:`~..exceptions.DeadlineExceededError` through the handle),
  graceful drain on shutdown, ``/healthz`` readiness via
  :class:`~.engine.ReadinessMixin`.

The loop is one background thread: one consumer keeps slot assignment and
the scheduler's state trivially correct (fairness reorders held requests
across tenants only; within a tenant, FIFO holds).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import queue as std_queue
import signal
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..exceptions import (DeadlineExceededError, PreemptedError,
                          ServerClosedError, ServerOverloadedError)
from ..obs import flightrec
from ..ops.attention import flash_supported
from ..ops.paged_attention import paged_attention_supported
from ..parallel.kv_blocks import (TRASH_BLOCK, BlockManager, blocks_for,
                                  init_paged_kv_cache, paged_chunked_prefill,
                                  paged_decode_step, paged_prefill,
                                  paged_verify_step, prefix_route_digest)
from ..parallel.lora import target_shapes
from ..parallel.transformer import (Transformer, check_dense, decode_step,
                                    gen_weights, init_kv_cache, prefill,
                                    verify_step)
from ..testing import faults
from .adapters import AdapterRegistry
from .batcher import RequestQueue, bucket_for
from .engine import ReadinessMixin
from .metrics import ServeMetrics
from .sched import FairScheduler
from .spec import SpecConfig, accept_greedy, accept_sampled
from .tp_plane import TpRole, plane_for

_DEFAULT = object()    # "knob not passed" sentinel (None is a real value)


def prefill_buckets(max_len: int) -> Tuple[int, ...]:
    """Prompt-padding buckets: powers of two below ``max_len``, topped by
    ``max_len`` itself."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    sizes: List[int] = []
    b = 1
    while b < max_len:
        sizes.append(b)
        b *= 2
    sizes.append(max_len)
    return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. ``temperature <= 0`` is greedy (argmax;
    ``top_k``/``seed`` ignored). ``top_k=0`` samples the full vocab.
    ``seed`` makes the stream reproducible: the request owns a private
    ``numpy`` Generator."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Engine knobs (the JAX ``GenerationConfig``: the same fields,
    defaults and validation).

    ``max_slots`` is the decode batch width and ``max_len`` the per-
    request cache depth (prompt + generated tokens). ``kv_layout``:

    * ``"contiguous"`` (the default): every slot reserves ``max_len``
      rows up front.
    * ``"paged"``: a pool of ``n_blocks`` blocks of ``block_size``
      positions, the reserved trash block included; ``None`` sizes it for
      every slot at full depth (``max_slots · ceil(max_len/block_size) +
      1``). ``prefix_reuse`` shares full block-aligned prompt prefixes
      copy-on-write across streams. ``paged_kernel`` reads the pool
      through the paged decode-attention kernel in the decode and verify
      steps; off (the default), each slot's blocks are gathered into the
      contiguous view the contiguous cache's attention reads, which is
      the bitwise reference.

    ``chunked_prefill`` (paged + prefix_reuse) runs every admission
    through :func:`~..parallel.kv_blocks.paged_chunked_prefill`: a
    prefix-hit admission computes only its suffix, reading the hit
    blocks' K/V out of the pool, and a cold admission is the same loop
    from block 0, so hit and cold streams are bitwise equal.
    ``chunk_blocks`` is the chunk's width in blocks; ``max_len`` must
    hold at least two chunks and divide evenly by the chunk.

    ``host_blocks`` (paged + prefix_reuse) adds a host-memory tier of
    that many blocks: cold registered prefixes offload there instead of
    being dropped at reclaim, and an admission whose chain continues in
    the host tier stages a prefetch, applied at the loop's top (never
    inside a decode step). ``host_admission`` picks what that admission
    does meanwhile: ``"wait"`` holds it in the queue until the prefetch
    lands, ``"miss"`` admits it at once on the device-tier hits only (a
    recompute, never a stale read).

    The multi-tenant policy (host-side data, none of it a shape):
    ``tenant_weights`` / ``tenant_priorities`` / ``tenant_slo_ttft_ms``
    map tenant names (``"base"`` included) to their fair-share weight
    (> 0, default 1), strict priority class (higher admits first and may
    preempt lower; default 0) and TTFT target in ms. An attached
    :class:`~.adapters.AdapterRegistry`'s own per-tenant values override
    these. ``tenant_block_budgets`` (paged only) caps the KV pool blocks
    a tenant may hold: over budget, its admissions are rejected
    (``blocks_exhausted`` with a ``retry_after_ms`` hint) or starved
    without holding any other tenant's line, and the tenant offloads or
    reclaims its OWN coldest blocks first. ``preempt`` lets a
    higher-priority admission evict the lowest-priority active stream;
    ``preempt_retries`` is how many evictions one stream survives before
    failing with :class:`~..exceptions.PreemptedError`
    (``preempted_exhausted``).
    """

    max_slots: int = 8
    max_len: int = 512
    max_queue: int = 256
    default_deadline_ms: Optional[float] = None
    default_max_new_tokens: int = 64
    eos_id: Optional[int] = None
    kv_layout: str = "contiguous"
    block_size: int = 16
    n_blocks: Optional[int] = None
    prefix_reuse: bool = False
    paged_kernel: bool = False
    chunked_prefill: bool = False
    chunk_blocks: int = 1
    host_blocks: int = 0
    host_admission: str = "wait"
    tenant_weights: Optional[Dict[str, float]] = None
    tenant_priorities: Optional[Dict[str, int]] = None
    tenant_block_budgets: Optional[Dict[str, int]] = None
    tenant_slo_ttft_ms: Optional[Dict[str, float]] = None
    preempt: bool = True
    preempt_retries: int = 3

    def __post_init__(self):
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.default_max_new_tokens < 1:
            raise ValueError("default_max_new_tokens must be >= 1")
        if self.kv_layout not in ("contiguous", "paged"):
            raise ValueError(
                f"kv_layout must be 'contiguous' or 'paged', got "
                f"{self.kv_layout!r}")
        if self.block_size < 1 or (self.block_size & (self.block_size - 1)):
            raise ValueError(
                f"block_size must be a power of two, got {self.block_size}")
        if self.chunk_blocks < 1 or (self.chunk_blocks
                                     & (self.chunk_blocks - 1)):
            raise ValueError(
                f"chunk_blocks must be a power of two, got "
                f"{self.chunk_blocks}")
        if self.host_blocks < 0:
            raise ValueError(
                f"host_blocks must be >= 0, got {self.host_blocks}")
        if self.host_admission not in ("wait", "miss"):
            raise ValueError(
                f"host_admission must be 'wait' or 'miss', got "
                f"{self.host_admission!r}")
        if self.kv_layout != "paged":
            for knob in ("prefix_reuse", "paged_kernel", "chunked_prefill",
                         "host_blocks"):
                if getattr(self, knob):
                    raise ValueError(
                        f"{knob} requires kv_layout='paged'")
            if self.n_blocks is not None:
                raise ValueError(
                    "n_blocks applies to kv_layout='paged' only")
        elif self.n_blocks is not None and self.n_blocks < 2:
            raise ValueError(
                f"n_blocks must be >= 2 (block 0 is the reserved trash "
                f"block), got {self.n_blocks}")
        if self.chunked_prefill:
            if not self.prefix_reuse:
                raise ValueError(
                    "chunked_prefill=True requires prefix_reuse=True "
                    "(its whole point is skipping prefix-hit compute)")
            c = self.chunk_tokens
            if self.max_len % c or self.max_len < 2 * c:
                raise ValueError(
                    f"chunked_prefill needs max_len divisible by the "
                    f"chunk ({self.chunk_blocks} blocks × "
                    f"{self.block_size} = {c} tokens) and at least two "
                    f"chunks, got max_len={self.max_len}")
        if self.host_blocks and not self.prefix_reuse:
            raise ValueError(
                "host_blocks > 0 requires prefix_reuse=True (only "
                "registered prefixes ever offload)")
        for t, w in (self.tenant_weights or {}).items():
            if w <= 0:
                raise ValueError(
                    f"tenant_weights[{t!r}] must be > 0, got {w} (use "
                    f"tenant_priorities, not zero weights, to de-class "
                    f"a tenant)")
        for t, slo in (self.tenant_slo_ttft_ms or {}).items():
            if slo <= 0:
                raise ValueError(
                    f"tenant_slo_ttft_ms[{t!r}] must be > 0, got {slo}")
        if self.tenant_block_budgets:
            if self.kv_layout != "paged":
                raise ValueError(
                    "tenant_block_budgets requires kv_layout='paged' "
                    "(contiguous slots have no block pool to budget)")
            for t, b in self.tenant_block_budgets.items():
                if b < 1:
                    raise ValueError(
                        f"tenant_block_budgets[{t!r}] must be >= 1, "
                        f"got {b}")
        if self.preempt_retries < 0:
            raise ValueError(
                f"preempt_retries must be >= 0, got {self.preempt_retries}")

    @property
    def chunk_tokens(self) -> int:
        """Tokens per chunked-prefill chunk."""
        return self.chunk_blocks * self.block_size

    @property
    def blocks_per_slot(self) -> int:
        """Blocks a full-depth (``max_len``) sequence occupies."""
        return blocks_for(self.max_len, self.block_size)

    @property
    def resolved_n_blocks(self) -> int:
        """``n_blocks`` with the default applied."""
        if self.n_blocks is not None:
            return self.n_blocks
        return self.max_slots * self.blocks_per_slot + 1


class _HostBlock(dict):
    """A block's K/V staged in the host tier: the payload the
    :class:`~..parallel.kv_blocks.BlockManager` holds (the leader's
    head shard, ``{"k", "v": [n_layers, block_size, heads, d_head]}``).
    Every rank keeps its own shard in its engine's host store under
    ``pid``; once the manager and the prefetch queue let go of the
    payload, ``pid`` is dropped from every rank's store at the next
    device call."""

    def __init__(self, pid: int):
        super().__init__()
        self.pid = pid


class GenerationHandle:
    """Streaming result of one generation request.

    Consume incrementally (``for tok in handle: ...`` yields token ids as
    they are sampled; raises the failure exception if the request dies)
    or wait for completion: ``handle.result(timeout)`` returns
    ``{"tokens", "finish_reason" ("eos"|"length"), "n_tokens",
    "ttft_ms", "tokens_per_sec"}``.
    """

    def __init__(self):
        self._events: std_queue.Queue = std_queue.Queue()
        self._done = threading.Event()
        self._tokens: List[int] = []
        self._error: Optional[BaseException] = None
        self._info: Optional[Dict] = None
        self.request: Any = None    # the engine's _GenRequest (tests)

    # -- engine side -------------------------------------------------------

    def _emit(self, tok: int) -> None:
        self._tokens.append(tok)
        self._events.put(("token", tok))

    def _finish(self, info: Dict) -> None:
        self._info = info
        self._done.set()
        self._events.put(("done", info))

    def _fail(self, exc: BaseException) -> None:
        if self._done.is_set():
            return
        self._error = exc
        self._done.set()
        self._events.put(("error", exc))

    # -- client side -------------------------------------------------------

    def next_event(self, timeout: Optional[float] = None):
        """``("token", id)`` / ``("done", info)`` / ``("error", exc)`` in
        emission order; raises ``queue.Empty`` on timeout."""
        return self._events.get(timeout=timeout)

    def __iter__(self):
        while True:
            kind, val = self._events.get()
            if kind == "token":
                yield val
            elif kind == "done":
                return
            else:
                raise val

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Dict:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"generation not finished within {timeout} s")
        if self._error is not None:
            raise self._error
        return dict(self._info)


@dataclasses.dataclass
class _GenRequest:
    """One queued/in-flight generation request."""

    tokens: np.ndarray               # [L] int32 prompt
    max_new: int
    sampling: SamplingParams
    eos: Optional[int]
    handle: GenerationHandle
    enqueued_at: float               # time.monotonic()
    deadline_at: Optional[float]
    rng: np.random.Generator
    n_out: int = 0
    t_admit: Optional[float] = None     # dequeued into a slot
    t_first: Optional[float] = None     # first token sampled
    # Tenant identity: tenant is the quota/metrics key ("base" for
    # adapter-less traffic), adapter the registry name (None = base),
    # adapter_slot the table row the stream pins for its lifetime
    # (retained at submit, released by _req_done).
    tenant: str = "base"
    adapter: Optional[str] = None
    adapter_slot: int = -1
    stream_id: int = -1
    # Prefix-registry salt: cached K/V is a function of the weights that
    # wrote it, so tenants never hit each other's prefixes (nor a
    # reloaded adapter its predecessor's). Base traffic carries the
    # reserved NUL frame: an adapter salt starts with a name character,
    # so a base key never equals a tenant's.
    prefix_salt: bytes = b"\x00"
    _done_accounted: bool = False
    # Priority class resolved at submit (registry, else config, else 0).
    priority: int = 0
    # Preemption envelope: evictions so far, and while resuming the
    # already-emitted tokens to regenerate suppressed and verified.
    retries: int = 0
    replay_expect: Optional[List[int]] = None
    replay_i: int = 0
    # Whether this request holds a max_queue admission ticket (False for
    # a preempted stream back in the held line: it was admitted once).
    held_ticket: bool = False
    # Host-tier keys this request staged prefetches for (dropped if it
    # leaves the held line unserved).
    prefetch_keys: set = dataclasses.field(default_factory=set)
    # Speculation accounting: drafts proposed for / accepted into it.
    spec_proposed: int = 0
    spec_accepted: int = 0

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_at is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline_at

    def sample(self, logits: np.ndarray) -> int:
        t = self.sampling.temperature
        if t <= 0:
            return int(np.argmax(logits))
        x = logits.astype(np.float64) / float(t)
        k = self.sampling.top_k
        keep = None
        if k and k < x.size:
            keep = np.argpartition(x, -k)[-k:]
            x = x[keep]
        e = np.exp(x - np.max(x))
        p = e / e.sum()
        j = int(self.rng.choice(p.size, p=p))
        return int(keep[j]) if keep is not None else j

    def probs(self, logits: np.ndarray) -> np.ndarray:
        """Full-vocab probabilities under this request's temperature /
        top-k transform — the distribution :meth:`sample` draws from
        (outside top-k exactly 0). Callers guarantee
        ``temperature > 0``."""
        t = self.sampling.temperature
        x = logits.astype(np.float64) / float(t)
        k = self.sampling.top_k
        if k and k < x.size:
            keep = np.argpartition(x, -k)[-k:]
            xk = x[keep]
            e = np.exp(xk - np.max(xk))
            p = np.zeros(x.size, np.float64)
            p[keep] = e / e.sum()
            return p
        e = np.exp(x - np.max(x))
        return e / e.sum()


class GenerationEngine(ReadinessMixin, TpRole):
    """Continuous-batching generation server over one transformer.

    Args:
      model: the :class:`~..parallel.transformer.Transformer` to serve
        (dense FFN only), already on ``device``.
      config: :class:`GenerationConfig`.
      device: where the cache lives and the model runs; ``"cuda"`` (the
        default) raises on a host without CUDA, ``"cpu"`` runs the
        kernels' plain PyTorch versions.
      adapters: an :class:`~.adapters.AdapterRegistry` on ``device``: the
        multi-tenant plane. ``submit(adapter="name")`` then serves that
        tenant's LoRA fine-tune; the per-slot adapter row is gathered
        inside the same prefill and decode steps whether the batch is
        base-only or mixed, quotas gate admission, and ``stats()``
        splits TTFT and tokens by tenant.
      spec: :class:`~.spec.SpecConfig` turns on speculative decoding
        (``None``: off). A step where no slot drafted anything is the
        plain decode step.

    On a tp mesh every rank constructs the engine with the same
    arguments. On the leader (``is_leader``: tp index 0) it serves as
    above; on a follower it runs the leader's device calls on its shards
    and :meth:`submit` raises ``ValueError`` naming the leader; call
    :meth:`wait` there to block until the leader's :meth:`shutdown`.
    """

    def __init__(self, model: Transformer,
                 config: GenerationConfig = GenerationConfig(), *,
                 device: DeviceLike = "cuda",
                 adapters: Optional[AdapterRegistry] = None,
                 spec: Optional[SpecConfig] = None):
        cfg = model.cfg
        check_dense(cfg, "GenerationEngine")
        # The step plane first (it creates a process group: collective,
        # so every rank reaches it before any rank-dependent check).
        self._plane = plane_for(model.mesh, "GenerationEngine")
        self._device = resolve_device(device)
        if model.device != self._device:
            raise ValueError(f"model is on {model.device}, the engine's "
                             f"device is {self._device}; move it first")
        if adapters is not None:
            if not isinstance(adapters, AdapterRegistry):
                raise TypeError(
                    f"adapters must be an AdapterRegistry, got "
                    f"{type(adapters).__name__}")
            a_cfg = adapters.model_cfg
            if (target_shapes(a_cfg) != target_shapes(cfg)
                    or a_cfg.n_layers != cfg.n_layers):
                raise ValueError(
                    "the AdapterRegistry was built for another model "
                    "shape (d_model, d_ff or n_layers differ)")
            if adapters.device != self._device:
                raise ValueError(
                    f"the AdapterRegistry's table is on {adapters.device}, "
                    f"the engine's device is {self._device}")
            if adapters.mesh is not model.mesh and (
                    adapters.mesh is not None or self._plane is not None):
                raise ValueError(
                    "the AdapterRegistry was built for another mesh than "
                    "the model's: pass AdapterRegistry(..., mesh="
                    "model.mesh) on every rank")
        if spec is not None and spec.k + 1 > config.max_len:
            raise ValueError(
                f"spec k={spec.k} needs k+1 <= max_len={config.max_len}")
        self._model_cfg = cfg
        self._cfg = config
        with torch.no_grad():
            self._weights = gen_weights(model)
        self._adapters = adapters
        # The table generation the tp followers hold (the leader sends
        # the rows loaded since with its next device call).
        self._lora_synced = 0
        # Per-slot adapter table row, the decode step's gather index
        # (-1 = base): data, never a shape.
        self._adapter_idx = np.full((config.max_slots,), -1, np.int32)
        self._tenant_lock = threading.Lock()
        self._tenant_inflight: Dict[str, int] = {}
        # Block demand a tenant has in flight (reserved at the door,
        # freed by _req_done): the budget's admission-time half; the
        # pool's owner ledger is the occupancy half. Under _tenant_lock.
        self._tenant_blocks: Dict[str, int] = {}
        self._queue = RequestQueue(config.max_queue)
        self._metrics = ServeMetrics()
        if adapters is not None:
            # Fold an evicted tenant's metrics into "retired".
            adapters.add_evict_listener(self._metrics.forget_tenant)
        # Admission order: weighted DRR over tenants, strict priorities
        # above it; weights and priorities resolve at every pick.
        self._sched = FairScheduler(self._weight_of, self._priority_of)
        s = config.max_slots
        self._paged = config.kv_layout == "paged"
        # paged_kernel: K8 in the paged decode and verify steps where the
        # kernel takes the model (JAX's paged_attention_supported gate);
        # otherwise the gather into the contiguous view.
        self._use_kernel = bool(
            self._paged and config.paged_kernel
            and paged_attention_supported(cfg.d_head, config.block_size,
                                          cfg.dtype, self._device))
        if self._paged:
            self._n_blocks = config.resolved_n_blocks
            self._cache = init_paged_kv_cache(cfg, self._n_blocks,
                                              config.block_size, s,
                                              device=self._device,
                                              mesh=model.mesh)
            # Host bookkeeping, which only the leader's loop reads (its
            # block ids name every rank's blocks).
            self._blocks = BlockManager(self._n_blocks, config.block_size,
                                        host_blocks=config.host_blocks)
            for t, b in (config.tenant_block_budgets or {}).items():
                self._blocks.set_budget(t, int(b))
            self._tables = np.full((s, config.blocks_per_slot),
                                   TRASH_BLOCK, np.int32)
            self._slot_blocks: List[List[int]] = [[] for _ in range(s)]
        else:
            self._cache = init_kv_cache(cfg, s, config.max_len,
                                        device=self._device, mesh=model.mesh)
            self._blocks = None
        self._chunked = self._paged and config.chunked_prefill
        # Host-tier prefetches staged by admissions, applied at the top
        # of the loop: a decode step never waits on a host→device copy.
        self._host_cap = config.host_blocks if self._paged else 0
        self._prefetch_q: deque = deque()
        self._prefetch_inflight: set = set()
        # This rank's host-tier shards by payload id, and the ids whose
        # payload the leader let go of (dropped at the next device call).
        self._host_store: Dict[int, Dict[str, torch.Tensor]] = {}
        self._host_drops: deque = deque()
        self._host_pids = itertools.count()
        self._spec = spec
        self._drafter = spec.make_drafter() if spec is not None else None
        self._buckets = prefill_buckets(config.max_len)
        # Chunked buckets: the same grid restricted to multiples of the
        # chunk holding at least two chunks.
        c = config.chunk_tokens
        self._chunked_buckets = tuple(
            b for b in self._buckets if b % c == 0 and b >= 2 * c)
        self._last_prefill_bucket: Optional[int] = None
        # Requests popped from the admission queue but not yet in a slot
        # (block-starved, waiting on a host-tier prefetch, or preempted);
        # the scheduler picks among them.
        self._held: deque = deque()
        self._peak_active = 0
        self._slots: List[Optional[_GenRequest]] = [None] * s
        self._positions = np.full((s,), -1, np.int32)
        self._last = np.zeros((s,), np.int32)
        self._stream_seq = itertools.count()
        self._closed = False
        self._warmed = False
        self._abort = False
        # Serving-plane identity and liveness: ``serve_name`` is stamped
        # by the fleet router at attach (fault clauses and flight-recorder
        # events name replicas by it); the loop beat and the admitted-
        # stream counter feed loop_alive() and the fault hook.
        self.serve_name = "engine"
        self._beat = time.monotonic()
        self._stall_mark: Optional[Tuple[float, float]] = None
        self._streams_started = 0
        self._loop_error_dumped = False
        if self.is_leader:
            self._thread = threading.Thread(target=self._loop,
                                            name="hvd-torch-generate-loop",
                                            daemon=True)
        else:
            self._thread = threading.Thread(
                target=self._follow, args=(self._run_op, self._device),
                name="hvd-torch-tp-follower", daemon=True)
        self._thread.start()

    def loop_alive(self, stall_s: float = 60.0) -> bool:
        """The in-process liveness probe a :class:`~.router.ReplicaHandle`
        polls for thread replicas: False once the loop thread died
        without a shutdown (abrupt death: the ``replica_kill`` drill), or
        once the loop was seen with work pending (live slots, held or
        queued requests) and no completed iteration for ``stall_s``
        seconds (a wedged loop: the ``replica_hang`` drill). The stall
        clock starts at the first busy observation with no progress
        since, not at the raw beat's age: an idle loop parks in the
        untimed queue wait by design, so its beat is stale, and a
        request landing in that queue must not read as a wedge before
        the loop has had ``stall_s`` to wake. ``stall_s`` must cover the
        engine's worst single iteration (a first prefill, a warmup)."""
        if self._closed:
            return True     # a drained or shut-down loop's exit is no death
        if not self._thread.is_alive():
            return False
        if not stall_s:
            return True
        busy = (any(r is not None for r in self._slots)
                or self._held or len(self._queue))
        now = time.monotonic()
        if not busy:
            self._stall_mark = None
            return True
        mark = self._stall_mark
        if mark is not None and self._beat != mark[1]:
            mark = None     # the loop iterated since the last mark
        if mark is None:
            self._stall_mark = (now, self._beat)
            return True
        return now - mark[0] <= stall_s

    # -- the device programs -----------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        # A copy, never a view: the loop mutates these host arrays.
        return torch.tensor(arr, device=self._device)

    def _lora(self, adapter_idx) -> Dict:
        """The LoRA keywords of one device call: the registry's current
        table (read here, at the step boundary: a load swaps in a new
        table, never writes this one) and ``adapter_idx`` (a prompt's
        int row, or the ``[S]`` per-slot rows). Empty without a registry,
        and for a step whose rows are all base: ``where`` would return
        every row's ``y`` unchanged."""
        if self._adapters is None:
            return {}
        if isinstance(adapter_idx, np.ndarray):
            if not (adapter_idx >= 0).any():
                return {}
            adapter_idx = self._to_device(adapter_idx)
        elif adapter_idx < 0:
            return {}
        return dict(adapters=self._adapters.table(),
                    adapter_idx=adapter_idx, lora=self._adapters.lora)

    def _device_call(self, op: str, **args):
        """One call that touches device state, run on this rank; on a tp
        leader it is sent to the followers first (:mod:`.tp_plane`), under
        the plane's lock, with the LoRA rows loaded since the last call,
        and a failure takes the plane down (the followers' collectives
        are left unmatched). Host-tier payloads let go of since the last
        call are dropped first, on every rank."""
        plane = self._plane
        with plane.lock if plane is not None else contextlib.nullcontext():
            args["drops"] = [self._host_drops.popleft()
                             for _ in range(len(self._host_drops))]
            if plane is None:
                return self._run_op(op, args)
            if self._adapters is not None:
                # A row a step reads was loaded before its stream was
                # submitted, so before this read: the followers install
                # it ahead of the call.
                self._lora_synced, rows = self._adapters.rows_since(
                    self._lora_synced)
                if rows:
                    args["lora_rows"] = rows
            return plane.run(op, args, lambda: self._run_op(op, args))

    @torch.no_grad()
    def _run_op(self, op: str, args: Dict) -> Any:
        """Run device call ``op`` on this rank's shards (the leader's
        loop, or a follower's from the leader's descriptor)."""
        for pid in args.pop("drops", ()):
            self._host_store.pop(pid, None)
        for row, tree in args.pop("lora_rows", ()):
            if not self.is_leader:
                self._adapters.install(row, tree)
        return getattr(self, "_op_" + op)(**args)

    def _op_prefill(self, tokens, slot, length, write_row, adapter_slot):
        toks = self._to_device(tokens)
        lora = self._lora(adapter_slot)
        if self._paged:
            _, logits = paged_prefill(
                self._weights, toks, self._cache, slot,
                self._to_device(write_row), self._model_cfg, length=length,
                **lora)
        else:
            _, logits = prefill(self._weights, toks, self._cache, slot,
                                self._model_cfg, length=length, **lora)
        return logits

    def _op_chunked(self, tokens, slot, length, start, write_rows,
                    read_row, adapter_slot):
        _, logits = paged_chunked_prefill(
            self._weights, self._to_device(tokens), self._cache, slot,
            self._to_device(write_rows), self._to_device(read_row), start,
            self._model_cfg, length=length,
            chunk_blocks=self._cfg.chunk_blocks,
            **self._lora(adapter_slot))
        return logits

    def _op_decode(self, last, positions, tables, adapter_idx):
        toks, pos = self._to_device(last), self._to_device(positions)
        lora = self._lora(adapter_idx)
        if self._paged:
            _, logits = paged_decode_step(
                self._weights, toks, self._cache, pos,
                self._to_device(tables), self._model_cfg,
                kernel=self._use_kernel, **lora)
        else:
            _, logits = decode_step(self._weights, toks, self._cache, pos,
                                    self._model_cfg, **lora)
        return logits

    def _op_verify(self, drafts, positions, tables, adapter_idx):
        toks, pos = self._to_device(drafts), self._to_device(positions)
        lora = self._lora(adapter_idx)
        if self._paged:
            _, logits = paged_verify_step(
                self._weights, toks, self._cache, pos,
                self._to_device(tables), self._model_cfg,
                kernel=self._use_kernel, **lora)
        else:
            _, logits = verify_step(self._weights, toks, self._cache, pos,
                                    self._model_cfg, **lora)
        return logits

    def _op_reset_lengths(self):
        self._cache["lengths"].zero_()

    def _op_offload(self, blk, pid):
        """Stage block ``blk``'s K/V of every layer (this rank's heads) in
        host memory under ``pid``."""
        shard = {n: self._cache[n][:, blk].to("cpu", copy=True)
                 for n in ("k", "v")}
        self._host_store[pid] = shard
        return shard

    def _op_prefetch(self, blk, pid):
        """Write the staged shard ``pid`` back into block ``blk``."""
        shard = self._host_store[pid]
        for n in ("k", "v"):
            self._cache[n][:, blk] = shard[n].to(self._device)

    # The leader's views of the calls: the host rows sampling reads.

    def _prefill(self, tokens: np.ndarray, slot: int, length: int,
                 write_row: Optional[np.ndarray],
                 adapter_slot: int = -1) -> np.ndarray:
        """Prefill one padded prompt; returns the logits row of its last
        real position (the only row sampling reads)."""
        logits = self._device_call(
            "prefill", tokens=tokens, slot=slot, length=length,
            write_row=write_row, adapter_slot=adapter_slot)
        return logits[length - 1].cpu().numpy()

    def _chunked_prefill(self, tokens: np.ndarray, slot: int, length: int,
                         start: int, write_rows: np.ndarray,
                         read_row: np.ndarray,
                         adapter_slot: int = -1) -> np.ndarray:
        """The chunked prefill of a suffix starting at ``start``; returns
        the logits row of the last prompt position."""
        logits = self._device_call(
            "chunked", tokens=tokens, slot=slot, length=length, start=start,
            write_rows=write_rows, read_row=read_row,
            adapter_slot=adapter_slot)
        return logits[length - start - 1].cpu().numpy()

    def _decode(self, last: np.ndarray, positions: np.ndarray,
                tables: Optional[np.ndarray],
                adapter_idx: np.ndarray) -> np.ndarray:
        """One decode step for every slot; returns ``[S, vocab]`` logits."""
        return self._device_call(
            "decode", last=last, positions=positions, tables=tables,
            adapter_idx=adapter_idx).cpu().numpy()

    def _verify(self, drafts: np.ndarray, positions: np.ndarray,
                tables: Optional[np.ndarray],
                adapter_idx: np.ndarray) -> np.ndarray:
        """One verify forward over ``[S, k + 1]`` draft columns; returns
        ``[S, k + 1, vocab]`` logits."""
        return self._device_call(
            "verify", drafts=drafts, positions=positions, tables=tables,
            adapter_idx=adapter_idx).cpu().numpy()

    def warmup(self) -> Tuple[Any, ...]:
        """Run the decode step, the verify step (with ``spec``) and every
        prefill bucket (the chunked ones on a chunked engine) once before
        traffic. Paged writes land in the trash block, contiguous ones in
        rows past every slot's length, so the cache stays usable; every
        row is base. Returns the shapes warmed (on a tp leader every
        rank runs them)."""
        self._leader_only("warmup()")
        s = self._cfg.max_slots
        nb = self._cfg.blocks_per_slot
        tables = np.full((s, nb), TRASH_BLOCK, np.int32)
        idle = np.full((s,), -1, np.int32)
        self._decode(np.zeros((s,), np.int32), idle, tables, idle)
        spec_keys: Tuple[Any, ...] = ()
        if self._spec is not None:
            w = self._spec.k + 1
            self._verify(np.zeros((s, w), np.int32), idle, tables, idle)
            spec_keys = (("verify", w),)
        trash_row = np.full((nb,), TRASH_BLOCK, np.int32)
        if self._chunked:
            ct, cb = self._cfg.chunk_tokens, self._cfg.chunk_blocks
            for t in self._chunked_buckets:
                self._chunked_prefill(
                    np.zeros((t,), np.int32), 0, 1, 0,
                    np.full((t // ct, cb), TRASH_BLOCK, np.int32),
                    trash_row)
            buckets = self._chunked_buckets
        else:
            for t in self._buckets:
                self._prefill(np.zeros((t,), np.int32), 0, 1, trash_row)
            buckets = self._buckets
        self._device_call("reset_lengths")
        self._warmed = True
        return ("decode",) + spec_keys + tuple(buckets)

    # -- client API --------------------------------------------------------

    def submit(self, tokens: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               eos_id: Any = _DEFAULT,
               deadline_ms: Optional[float] = None,
               adapter: Optional[str] = None) -> GenerationHandle:
        """Enqueue one prompt; returns a :class:`GenerationHandle`
        streaming the sampled tokens. Raises
        :class:`ServerOverloadedError` when the admission queue is full
        (or the tenant is over its quota — reason ``tenant_quota`` — or
        over its block budget), :class:`ServerClosedError` after
        shutdown, ``ValueError`` on a malformed prompt, one the pool (or
        the tenant's budget) could never hold, an ``adapter`` that is not
        resident or an ``adapter`` without a registry (all eagerly, in
        the caller's thread).

        ``max_new_tokens`` is clamped to the cache room left after the
        prompt (the stream then finishes with reason ``"length"``);
        ``eos_id=None`` disables EOS for this request even when the
        engine has a default. ``adapter`` names the tenant's resident
        LoRA fine-tune (None = base); the stream pins the adapter's row
        for its whole lifetime, so an evict racing it is refused. On a
        tp follower it raises ``ValueError`` naming the leader."""
        self._leader_only("submit()")
        toks = np.asarray(tokens, np.int32)
        if toks.ndim != 1 or toks.size == 0:
            raise ValueError(
                f"prompt must be a non-empty 1-D int sequence, got shape "
                f"{toks.shape}")
        if toks.min() < 0 or toks.max() >= self._model_cfg.vocab:
            raise ValueError(
                f"prompt token ids must lie in [0, {self._model_cfg.vocab})")
        if toks.size > self._cfg.max_len:
            raise ValueError(
                f"prompt of {toks.size} tokens exceeds max_len="
                f"{self._cfg.max_len} (prompt + generated tokens share "
                f"the KV cache)")
        max_new = (self._cfg.default_max_new_tokens
                   if max_new_tokens is None else int(max_new_tokens))
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        # Token t+1's K/V lands at position L+t; the last sampled token
        # needs no cache write, so room caps new tokens at max_len-L+1.
        max_new = min(max_new, self._cfg.max_len - toks.size + 1)
        need_blocks = 0
        if self._paged:
            need_blocks = self._blocks_needed(toks.size, max_new)
            if need_blocks > self._blocks.usable:
                raise ValueError(
                    f"request needs {need_blocks} KV blocks (prompt "
                    f"{toks.size} + up to {max_new} generated, block_size="
                    f"{self._cfg.block_size}) but the pool holds only "
                    f"{self._blocks.usable} usable blocks — raise "
                    f"n_blocks or lower max_new_tokens")
        sampling = SamplingParams() if sampling is None else sampling
        eos = self._cfg.eos_id if eos_id is _DEFAULT else eos_id
        if deadline_ms is None:
            deadline_ms = self._cfg.default_deadline_ms
        tenant = "base" if adapter is None else adapter
        a_slot = -1
        salt = b"\x00"      # the base frame (_GenRequest.prefix_salt)
        if adapter is not None:
            if self._adapters is None:
                raise ValueError(
                    f"submit(adapter={adapter!r}) on an engine without an "
                    f"AdapterRegistry — pass adapters= to "
                    f"GenerationEngine")
            # Retain before admission: the row must survive the queue
            # wait too (an evict of a queued tenant would free the row
            # its prefill is about to gather from).
            a_slot = self._adapters.retain(adapter)   # ValueError if absent
            # Read after retain: the refcount blocks reloads, so the salt
            # is stable for the stream's lifetime.
            salt = (f"{adapter}\x00"
                    f"{self._adapters.generation(adapter)}\x00".encode())
        try:
            # Raises over quota (tenant_quota) or over the block budget
            # (blocks_exhausted), both with a retry_after_ms hint.
            self._tenant_admit(tenant, need_blocks=need_blocks)
            now = time.monotonic()
            handle = GenerationHandle()
            req = _GenRequest(
                tokens=toks, max_new=max_new, sampling=sampling, eos=eos,
                handle=handle, enqueued_at=now,
                deadline_at=(None if deadline_ms is None
                             else now + deadline_ms / 1e3),
                rng=np.random.default_rng(sampling.seed),
                tenant=tenant, adapter=adapter, adapter_slot=a_slot,
                prefix_salt=salt, stream_id=next(self._stream_seq),
                priority=self._priority_of(tenant))
            handle.request = req
            try:
                depth = self._queue.put(req)   # raises Closed / Overloaded
            except ServerOverloadedError:
                self._tenant_release(tenant, blocks=need_blocks)
                reason, detail = self._overload_reason(toks.size, max_new)
                self._metrics.on_overload(reason)
                err = ServerOverloadedError(
                    f"request queue full ({self._cfg.max_queue}); "
                    f"{reason}: {detail}")
                err.retry_after_ms = self._metrics.retry_after_ms(
                    len(self._queue))
                raise err from None
            except ServerClosedError:
                self._tenant_release(tenant, blocks=need_blocks)
                raise
        except BaseException:
            if adapter is not None:
                self._adapters.release(adapter)
            raise
        self._metrics.on_submit(depth)
        flightrec.record("serve_admit", replica=self.serve_name,
                         stream=req.stream_id, tenant=tenant,
                         prompt_len=int(toks.size))
        return handle

    def generate(self, tokens: Sequence[int],
                 timeout: Optional[float] = None, **kw) -> Dict:
        """Synchronous :meth:`submit` (+ ``handle.result(timeout)``)."""
        return self.submit(tokens, **kw).result(timeout)

    def _tenant_admit(self, tenant: str, need_blocks: int = 0) -> None:
        """Count ``tenant``'s in-flight streams (queued + decoding) and
        reject over quota, atomically (two racing submits cannot both
        squeeze under the cap); the rejection is its own reason,
        ``tenant_quota``. With a block budget, ``need_blocks`` is also
        reserved against it here (released by :meth:`_req_done`): over
        budget, only THIS tenant is rejected, ``blocks_exhausted`` with a
        ``retry_after_ms`` hint."""
        quota = (self._adapters.quota(tenant)
                 if self._adapters is not None else None)
        budget = self._blocks.budget(tenant) if self._paged else None
        if budget is not None and need_blocks > budget:
            raise ValueError(
                f"request needs {need_blocks} KV blocks but tenant "
                f"{tenant!r} has a block budget of {budget} — it can "
                f"NEVER be admitted; raise the tenant's budget or lower "
                f"max_new_tokens")
        with self._tenant_lock:
            inflight = self._tenant_inflight.get(tenant, 0)
            if quota is not None and inflight >= quota:
                self._metrics.on_overload("tenant_quota")
                err = ServerOverloadedError(
                    f"tenant {tenant!r} over quota: {inflight} streams "
                    f"in flight >= quota {quota} — finish streams or "
                    f"raise the tenant's quota")
                err.retry_after_ms = self._metrics.retry_after_ms(inflight)
                raise err
            if budget is not None:
                demand = self._tenant_blocks.get(tenant, 0)
                if demand + need_blocks > budget:
                    self._metrics.on_overload("blocks_exhausted")
                    err = ServerOverloadedError(
                        f"tenant {tenant!r} over KV block budget: "
                        f"{demand} blocks reserved in flight + "
                        f"{need_blocks} needed > budget {budget} — "
                        f"blocks_exhausted for THIS tenant only; finish "
                        f"streams or raise tenant_block_budgets")
                    err.retry_after_ms = self._metrics.retry_after_ms(
                        len(self._queue))
                    raise err
                self._tenant_blocks[tenant] = demand + need_blocks
            self._tenant_inflight[tenant] = inflight + 1

    def _tenant_label(self, req: _GenRequest) -> Optional[str]:
        """The tenant stamped into metrics: only an engine with an
        AdapterRegistry splits by tenant."""
        return req.tenant if self._adapters is not None else None

    def _tenant_release(self, tenant: str, blocks: int = 0) -> None:
        with self._tenant_lock:
            n = self._tenant_inflight.get(tenant, 1) - 1
            if n > 0:
                self._tenant_inflight[tenant] = n
            else:
                self._tenant_inflight.pop(tenant, None)
            if blocks:
                d = self._tenant_blocks.get(tenant, 0) - blocks
                if d > 0:
                    self._tenant_blocks[tenant] = d
                else:
                    self._tenant_blocks.pop(tenant, None)

    def _req_done(self, req: _GenRequest) -> None:
        """One request left the engine (finished, failed, expired or
        cancelled): drop its in-flight count, its block-budget demand and
        its adapter-row reference. Idempotent."""
        if req._done_accounted:
            return
        req._done_accounted = True
        self._tenant_release(req.tenant, blocks=self._demand_of(req))
        if req.adapter is not None and self._adapters is not None:
            self._adapters.release(req.adapter)

    def _demand_of(self, req: _GenRequest) -> int:
        """The block demand :meth:`_tenant_admit` reserved for ``req``
        (0 when its tenant has no budget), recomputed from its prompt
        length and clamped ``max_new``."""
        if not self._paged or self._blocks.budget(req.tenant) is None:
            return 0
        return self._blocks_needed(req.tokens.size, req.max_new)

    # -- scheduling policy: the registry's value, then the config's map,
    # then the neutral default; read at every pick and admission.

    def _weight_of(self, tenant: str) -> float:
        if self._adapters is not None:
            w = self._adapters.weight(tenant)
            if w is not None:
                return w
        w = (self._cfg.tenant_weights or {}).get(tenant)
        return 1.0 if w is None else float(w)

    def _priority_of(self, tenant: str) -> int:
        if self._adapters is not None:
            p = self._adapters.priority(tenant)
            if p is not None:
                return p
        return int((self._cfg.tenant_priorities or {}).get(tenant, 0))

    def _slo_of(self, tenant: str) -> Optional[float]:
        if self._adapters is not None:
            slo = self._adapters.slo_ttft_ms(tenant)
            if slo is not None:
                return slo
        return (self._cfg.tenant_slo_ttft_ms or {}).get(tenant)

    def slo_burn(self, tenant: str) -> float:
        """``tenant``'s SLO burn fraction on this engine (0.0 when
        unknown)."""
        return self._metrics.slo_burn(tenant)

    def _blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """KV blocks a request reserves at admission: every position it
        can write (the last sampled token needs no write)."""
        total = min(prompt_len + max_new - 1, self._cfg.max_len)
        return blocks_for(total, self._cfg.block_size)

    def _overload_reason(self, prompt_len: int,
                         max_new: int) -> Tuple[str, str]:
        """Name the scarce resource behind a full admission queue (racy
        reads: this labels an error and a counter, it gates nothing)."""
        if self._paged:
            free_slots = sum(r is None for r in self._slots)
            need = self._blocks_needed(prompt_len, max_new)
            free_blocks = self._blocks.free_count
            if free_slots > 0 and free_blocks < need:
                return ("blocks_exhausted",
                        f"{free_blocks}/{self._blocks.usable} KV blocks "
                        f"free, next request needs {need} — raise "
                        f"n_blocks or lower max_new_tokens")
        return ("slots_full",
                f"all {self._cfg.max_slots} decode slots busy and the "
                f"queue is full — raise max_slots/max_queue or shed load")

    def _active_rows(self) -> int:
        """Live decode slots plus held requests (block-starved, waiting
        on a prefetch, or preempted): with the queue depth
        (:meth:`~.engine.ReadinessMixin.load`), a dispatcher's
        least-depth signal. Lock-free reads: approximate by design."""
        return sum(r is not None for r in self._slots) + len(self._held)

    def stats(self) -> Dict:
        """The ``/stats`` snapshot: :class:`ServeMetrics` plus the slot,
        bucket, (paged) block-pool and adapter-table view
        (``batch_fill_ratio`` is decode-slot occupancy), and on a tp mesh
        the step plane's counters under ``"tp"`` (a follower reports
        those alone)."""
        if not self.is_leader:
            return self._tp_stats({"device": str(self._device)})
        snap = self._metrics.snapshot()
        snap["max_slots"] = self._cfg.max_slots
        snap["max_len"] = self._cfg.max_len
        snap["active_slots"] = sum(r is not None for r in self._slots)
        snap["peak_active_slots"] = self._peak_active
        snap["prefill_buckets"] = list(self._buckets)
        snap["kv_layout"] = self._cfg.kv_layout
        # The routes chosen from the model config: the flash prefill
        # kernel (or its plain version) and K8 (or the gather).
        on_card = self._device.type == "cuda"
        snap["kernels"] = {
            "prefill": on_card and flash_supported(
                self._device, self._model_cfg.dtype, self._model_cfg.d_head),
            "paged_decode": on_card and self._use_kernel}
        if self._paged:
            snap["block_size"] = self._cfg.block_size
            snap["blocks"] = self._blocks.gauges()
            hits = snap["generation"]["prefix_hits_total"]
            misses = snap["generation"]["prefix_misses_total"]
            snap["prefix_hit_rate"] = (hits / (hits + misses)
                                       if hits + misses else None)
            snap["chunked_prefill"] = self._cfg.chunked_prefill
            snap["prefix_digests"] = list(self.prefix_digests())
            # Per-tenant owned/budget blocks: a key of its own, since the
            # "blocks" gauges must stay scalar.
            snap["blocks_by_tenant"] = self._blocks.tenant_gauges()
        snap["last_prefill_bucket"] = self._last_prefill_bucket
        if self._adapters is not None:
            snap["adapters_resident"] = len(self._adapters.resident())
            snap["adapter_table"] = self._adapters.gauges()
        snap["spec_k"] = self._spec.k if self._spec is not None else 0
        self._tp_stats(snap)
        snap["device"] = str(self._device)
        snap["max_queue"] = self._cfg.max_queue
        return snap

    def prom_collect(self):
        """This engine's ``(meta, samples)`` in Prometheus terms:
        everything :meth:`stats` knows (TTFT, tokens/s per user, block
        gauges, prefix hit rate, rejection splits, tenants) plus the
        histograms, labelled ``engine="generate"``
        (:func:`~.metrics.collect_stats`)."""
        from .metrics import collect_stats
        return collect_stats(self.stats(), self._metrics.registry,
                             engine="generate")

    def prom_metrics(self) -> str:
        """Prometheus text exposition of :meth:`prom_collect` (the
        ``/metrics`` body when this engine serves alone)."""
        from ..obs.registry import render
        return render(*self.prom_collect())

    # -- the multi-tenant adapter surface ----------------------------------

    @property
    def adapters(self) -> Optional[AdapterRegistry]:
        """This engine's registry (None = base-only engine)."""
        return self._adapters

    def adapter_names(self) -> Optional[Tuple[str, ...]]:
        """Resident adapter names, or None without a registry."""
        if self._adapters is None:
            return None
        return self._adapters.resident()

    def adapters_resident(self) -> Optional[int]:
        """Resident-adapter count for ``/healthz`` (None = no registry)."""
        names = self.adapter_names()
        return None if names is None else len(names)

    def load_adapter(self, name: str, adapter: Any,
                     quota: Optional[int] = None) -> int:
        """Hot-load ``adapter`` under ``name``; returns its table row.
        Raises ``ValueError`` without a registry or on a full table."""
        if self._adapters is None:
            raise ValueError(
                "engine has no AdapterRegistry — pass adapters= to "
                "GenerationEngine to serve adapters")
        return self._adapters.load(name, adapter, quota=quota)

    def prefix_digests(self) -> Tuple[str, ...]:
        """Advisory routing digests of the prefix chains this engine
        holds (either tier), the residency signal a prefix-affine
        dispatcher sorts on. Empty without a prefix registry."""
        if not (self._paged and self._cfg.prefix_reuse):
            return ()
        return self._blocks.route_digests()

    @property
    def route_block_size(self) -> int:
        """Block size a dispatcher must use to compute a request's
        routing digest so it matches this engine's advertised ones."""
        return self._cfg.block_size

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the engine. ``drain=True`` finishes every stream already
        admitted (queued AND mid-generation) first; ``drain=False`` fails
        pending handles with :class:`ServerClosedError` and aborts
        in-flight streams. On a tp leader the loop's end releases the
        followers; on a follower it waits up to ``timeout`` for that.
        Idempotent."""
        if self._shutdown_follower(timeout):
            return
        if self._closed:
            return
        self._closed = True
        if self._adapters is not None:
            # A registry shared across engines must not keep this one's
            # metrics alive.
            self._adapters.remove_evict_listener(
                self._metrics.forget_tenant)
        if drain:
            self._queue.close()
        else:
            self._abort = True
            self._fail_pending()
        self._thread.join(timeout)
        # A racing submit can slip past the _closed check into an
        # already-swept queue: whatever is still pending is never served.
        self._fail_pending()

    def _fail_pending(self) -> None:
        cancelled = 0
        for req in self._queue.drain_pending():
            if not req.handle.done():
                req.handle._fail(ServerClosedError(
                    "server shut down before execution"))
                cancelled += 1
            self._req_done(req)
        if cancelled:
            self._metrics.on_shutdown_cancel(cancelled)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)

    # -- the continuous-batching loop --------------------------------------

    def _crash_dump(self, reason: str) -> None:
        """This replica's flight-recorder post-mortem: one event naming
        every in-flight stream, then the ring's dump (what an operator
        reads after a replica's death to know which streams the
        failover plane had to resume)."""
        inflight = [r.stream_id for r in self._slots if r is not None]
        inflight += [r.stream_id for r in self._held]
        flightrec.record("serve_crash", replica=self.serve_name,
                         inflight=inflight, queued=len(self._queue))
        flightrec.dump(reason=f"serving replica {self.serve_name}: "
                              f"{reason}")

    def _loop(self):
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            try:
                self._beat = time.monotonic()
                act = faults.serve_hook(self.serve_name,
                                        self._streams_started)
                if act == "kill":
                    # Abrupt loop death: the thread exits without failing
                    # its handles (a crashed process delivers nothing);
                    # the stranded streams are the failover drill's point.
                    self._crash_dump("fault injection: replica_kill")
                    return
                if act == "proc_kill":
                    # Real process death: the post-mortem first (SIGKILL
                    # runs no atexit), then SIGKILL ourselves, so the
                    # parent sees a dead pid and broken streams.
                    self._crash_dump("fault injection: replica_proc_kill")
                    os.kill(os.getpid(), signal.SIGKILL)
                if act == "hang":
                    # Park forever with the thread alive: only the
                    # stale-beat half of loop_alive() catches this.
                    while True:
                        time.sleep(3600)
                if self._abort:
                    err = ServerClosedError(
                        "server shut down before completion")
                    for req in self._held:
                        req.handle._fail(err)
                        self._req_done(req)
                    self._held.clear()
                    self._fail_active(err)
                    self._stop_followers()
                    return
                if self._prefetch_q:
                    self._apply_prefetches()
                free = [i for i, r in enumerate(self._slots) if r is None]
                idle = len(free) == self._cfg.max_slots and not self._held
                # Pull everything queued into the held line (the scheduler
                # is fair only across tenants it can see); block only when
                # fully idle. Held requests keep their max_queue ticket.
                want = len(self._queue) or (len(free) if idle else 0)
                if want > 0:
                    # A tp leader's idle wait is bounded by the plane's
                    # heartbeat, so its followers' waits stay bounded too.
                    batch = self._queue.take_batch(
                        want, 0.0, hold=True,
                        idle_s=(self._plane.beat_s
                                if self._plane is not None and idle
                                else None))
                    if batch is None:
                        self._plane.beat()
                        continue
                    if not batch and idle:
                        # Closed and drained, nothing in flight.
                        self._stop_followers()
                        return
                    for r in batch:
                        r.held_ticket = True
                    self._held.extend(batch)
                self._expire_held()
                # Admission order is the FairScheduler's pick; a tenant
                # starved on blocks holds only its own line.
                blocked: set = set()
                budget_blocked: set = set()
                while self._held and free:
                    i = self._sched.pick(self._held,
                                         blocked=frozenset(blocked))
                    if i is None:
                        break       # every pending tenant is block-starved
                    req = self._held[i]
                    # The ticket covers the request until its first
                    # admission attempt: from then on it is being served.
                    if req.held_ticket:
                        req.held_ticket = False
                        self._queue.release_held()
                    outcome = self._admit(req, free[0])
                    if outcome in ("starved", "starved_budget"):
                        blocked.add(req.tenant)
                        if outcome == "starved_budget":
                            budget_blocked.add(req.tenant)
                        continue
                    del self._held[i]
                    if outcome == "ok":
                        free.pop(0)
                preempted = False
                if (self._cfg.preempt and self._held
                        and (not free or blocked)
                        and any(r is not None for r in self._slots)):
                    preempted = self._maybe_preempt(budget_blocked)
                if any(r is not None for r in self._slots):
                    if self._spec is None:
                        self._decode_once()
                    else:
                        self._spec_once()
                elif self._held and (self._prefetch_q or preempted):
                    # Progress is in motion: a staged prefetch lands at the
                    # next top, or an eviction freed slots the next
                    # admission pass fills.
                    pass
                elif self._held:
                    # Starved with nothing in flight: the submit-time pool
                    # and budget checks make this unreachable. Fail loudly
                    # rather than spin.
                    req = self._held.popleft()
                    if req.held_ticket:
                        req.held_ticket = False
                        self._queue.release_held()
                    req.handle._fail(ServerOverloadedError(
                        "KV block pool cannot cover an admitted request "
                        "with the engine idle — admission accounting bug"))
                    self._req_done(req)
            except Exception as e:  # noqa: BLE001 — deliver, don't die
                # Every active stream is about to fail: the post-mortem
                # first, once per engine (the loop keeps serving after an
                # error; a fault in every batch must not pay a dump each).
                if not self._loop_error_dumped:
                    self._loop_error_dumped = True
                    self._crash_dump(f"engine loop error: {e!r}")
                self._fail_active(e)
                self._close_if_broken()

    def _close_if_broken(self) -> bool:
        """On a tp leader whose step plane is down (a rank died, or a
        call failed after its descriptor went out), no device call can
        run again: fail the started streams with the group's error (a
        fleet fails them over), close for good, and refuse every request
        not started yet as a closed door (a fleet's dispatch tries the
        next). True when it closed."""
        err = self.plane_error
        if err is None:
            return False
        self._fail_active(err)
        self._closed = self._abort = True
        self._queue.close()
        self._fail_pending()
        return True

    def _fail_active(self, exc: BaseException) -> None:
        for i, req in enumerate(self._slots):
            if req is not None:
                req.handle._fail(exc)
                self._req_done(req)
                self._release_slot(i)

    def _release_slot(self, i: int) -> None:
        """Vacate slot ``i``: a paged slot's blocks return to the pool
        (refcount-aware: a shared prefix block frees only when its last
        reader ends) and its table row points at the trash block
        again."""
        self._slots[i] = None
        self._positions[i] = -1
        self._adapter_idx[i] = -1
        if self._paged:
            self._blocks.release(self._slot_blocks[i])
            self._slot_blocks[i] = []
            self._tables[i] = TRASH_BLOCK

    def _expire_held(self) -> None:
        """Fail deadline-expired requests parked in the held line now,
        not when they next reach a slot."""
        now = time.monotonic()
        if not any(r.expired(now) for r in self._held):
            return
        expired = [r for r in self._held if r.expired(now)]
        self._held = deque(r for r in self._held if not r.expired(now))
        for req in expired:
            self._fail_expired(req, now)
            if req.held_ticket:
                req.held_ticket = False
                self._queue.release_held()
            self._release_prefetches(req)

    def _release_prefetches(self, req: _GenRequest) -> None:
        """Drop staged prefetches only ``req`` wanted (it left the held
        line unserved): each would take a device block on landing for a
        chain nobody waits on. Keys another held request staged stay."""
        if not req.prefetch_keys:
            return
        wanted: set = set()
        for other in self._held:
            wanted |= other.prefetch_keys
        drop = req.prefetch_keys - wanted
        req.prefetch_keys = set()
        if not drop:
            return
        self._prefetch_q = deque(
            e for e in self._prefetch_q if e[0] not in drop)
        self._prefetch_inflight -= drop

    def _fail_expired(self, req: _GenRequest, now: float) -> None:
        wait_ms = (now - req.enqueued_at) * 1e3
        self._metrics.on_deadline_expired(wait_ms,
                                          tenant=self._tenant_label(req))
        req.handle._fail(DeadlineExceededError(
            f"deadline expired after {wait_ms:.1f} ms in queue"))
        self._req_done(req)

    # -- preemption --------------------------------------------------------

    def _maybe_preempt(self, budget_blocked: set) -> bool:
        """Preempt-by-evict: when a higher-priority held request found no
        free slot (or no pool blocks), evict the LOWEST-priority active
        stream so the next iteration admits the higher one. Tenants
        starved on their own block budget do not count (evicting a
        neighbour frees pool blocks, never budget). One victim per
        iteration. Returns whether a stream was evicted."""
        now = time.monotonic()
        waiting = [r for r in self._held
                   if r.tenant not in budget_blocked
                   and not r.expired(now)]
        if not waiting:
            return False
        top = max(self._priority_of(r.tenant) for r in waiting)
        # Victim: the lowest priority class; ties evict the latest
        # admitted stream (the least work lost to replay).
        prio, _, slot = min(
            (self._priority_of(r.tenant), -r.stream_id, i)
            for i, r in enumerate(self._slots) if r is not None)
        if top > prio:
            self._preempt(slot)
            return True
        return False

    def _preempt(self, slot: int) -> None:
        """Evict the stream in ``slot``: everything it emitted becomes an
        expect-prefix to regenerate suppressed and verified, its rng
        restarts from the seed, its original deadline stays, and it
        rejoins the held line without a new admission ticket. Past
        ``preempt_retries`` evictions it fails with
        :class:`PreemptedError` instead."""
        req = self._slots[slot]
        req.retries += 1
        self._metrics.on_preempt("evicted", tenant=self._tenant_label(req))
        flightrec.record("serve_preempt", replica=self.serve_name,
                         stream=req.stream_id, tenant=req.tenant,
                         n_tokens=req.n_out, retries=req.retries)
        self._release_slot(slot)
        if req.retries > self._cfg.preempt_retries:
            self._metrics.on_preempt("exhausted",
                                     tenant=self._tenant_label(req))
            req.handle._fail(PreemptedError(
                f"stream {req.stream_id} (tenant {req.tenant!r}) "
                f"evicted {req.retries} times > preempt_retries="
                f"{self._cfg.preempt_retries}: preempted_exhausted — "
                f"re-submit, or raise the tenant's priority or the "
                f"retry budget"))
            self._req_done(req)
            return
        req.replay_expect = list(req.handle._tokens)
        req.replay_i = 0
        req.n_out = 0
        req.rng = np.random.default_rng(req.sampling.seed)
        req.t_admit = None
        self._held.append(req)

    def _req_emit(self, req: _GenRequest, tok: int) -> None:
        """Every sampled token flows through here. A stream resuming from
        preemption first regenerates its emitted prefix suppressed: each
        token checked against the kept envelope, none delivered or
        counted again. A divergence breaks the slot-row contract, so it
        raises (an engine fault, like the admission accounting guard)."""
        if req.replay_expect is not None:
            if req.replay_i < len(req.replay_expect):
                want = req.replay_expect[req.replay_i]
                if tok != want:
                    raise RuntimeError(
                        f"preemption replay diverged on stream "
                        f"{req.stream_id}: position {req.replay_i} "
                        f"regenerated {tok}, envelope expected {want} — "
                        f"the slot-row bit-identity contract is broken")
                req.replay_i += 1
                return
            req.replay_expect = None
            self._metrics.on_preempt("resumed",
                                     tenant=self._tenant_label(req))
        self._metrics.on_tokens(tenant=self._tenant_label(req))
        req.handle._emit(tok)

    # -- block reservation -------------------------------------------------

    def _paged_reserve(self, req: _GenRequest):
        """Reserve the blocks ``req`` needs: prefix-registry hits are
        retained (shared), the rest freshly allocated to its tenant.
        Returns ``(hits, fresh, n_total)``; None when the pool cannot
        cover it yet; ``"wait"`` when the chain continues in the host tier
        under ``host_admission="wait"``; ``"budget"`` when the tenant is
        over its own block budget and offloading or reclaiming its OWN
        coldest blocks cannot bring it under (a starvation that never
        holds another tenant's line). Hits are looked up again after
        every sweep; cold registered prefixes are offloaded to the host
        tier (when there is one) before any is dropped."""
        n_total = self._blocks_needed(req.tokens.size, req.max_new)
        budget = self._blocks.budget(req.tenant)
        while True:
            hits = (self._blocks.lookup_prefix(req.tokens,
                                               salt=req.prefix_salt)
                    if self._cfg.prefix_reuse else [])
            hits = hits[:n_total]
            if self._host_cap:
                cont = self._blocks.host_lookup(
                    req.tokens, len(hits), salt=req.prefix_salt)
                if cont:
                    self._stage_prefetch(cont, req)
                    if self._cfg.host_admission == "wait":
                        return "wait"
                    # "miss": admit now on the device-tier hits only; the
                    # prefetch still lands for the next admission.
            if self._chunked:
                # A hit depth is whole chunks, and at least one prompt
                # token stays in the suffix to score the sampled row.
                cb = self._cfg.chunk_blocks
                cap = ((int(req.tokens.size) - 1)
                       // self._cfg.chunk_tokens) * cb
                n_hit = min(len(hits), cap)
                hits = hits[:n_hit - n_hit % cb]
            need = n_total - len(hits)
            if budget is not None:
                over = self._blocks.owned_count(req.tenant) + need - budget
                if over > 0:
                    if self._host_cap and self._offload_for(
                            over, owner=req.tenant):
                        continue
                    if not self._blocks.reclaim(
                            self._blocks.free_count + over,
                            owner=req.tenant):
                        return "budget"
                    continue
            free = self._blocks.free_count
            if free >= need:
                self._blocks.retain(hits)
                return (hits, self._blocks.alloc(need, owner=req.tenant),
                        n_total)
            if self._host_cap and self._offload_for(need - free):
                continue
            if not self._blocks.reclaim(need):
                return None

    # -- host tier (offload / prefetch) ------------------------------------

    def _offload_for(self, shortfall: int,
                     owner: Optional[str] = None) -> bool:
        """Move up to ``shortfall`` cold registered-prefix blocks (only
        ``owner``'s when given) to the host tier: the block's K/V of every
        layer copied to host memory, then committed (the manager checks
        again under its lock, so a hit landing meanwhile cancels that
        block's offload). Each rank stages its own head shard. Returns
        whether any device block was freed."""
        moved = 0
        for key, blk in self._blocks.offload_candidates(shortfall,
                                                        owner=owner):
            # Committed first, copied right after: the freed block is
            # written by no device call queued before the copy.
            payload = _HostBlock(next(self._host_pids))
            if self._blocks.offload_commit(key, payload):
                weakref.finalize(payload, self._host_drops.append,
                                 payload.pid)
                payload.update(self._device_call("offload", blk=blk,
                                                  pid=payload.pid))
                moved += 1
        if moved:
            self._metrics.on_kv_offload(moved)
        return moved > 0

    def _stage_prefetch(self, cont, req: _GenRequest) -> None:
        """Queue host→device copies for a chain continuation found in the
        host tier; applied at the loop's next top, never inside a decode
        step. Idempotent per key while a copy is pending; ``req`` records
        the keys it staged, and its tenant owns the landing blocks."""
        now = time.monotonic()
        for key, payload in cont:
            req.prefetch_keys.add(key)
            if key in self._prefetch_inflight:
                continue
            self._prefetch_inflight.add(key)
            self._prefetch_q.append((key, payload, now, req.tenant))

    def _apply_prefetches(self) -> None:
        """Land staged prefetches: allocate a device block (offloading or
        reclaiming a cold one first if the pool is dry), write the staged
        bytes, promote the registry entry (idempotent against an
        admission that registered the chain cold meanwhile). Entries that
        cannot get a block yet stay queued; the loop never blocks
        here."""
        for _ in range(len(self._prefetch_q)):
            key, payload, t0, owner = self._prefetch_q.popleft()
            if (self._blocks.free_count < 1
                    and not self._offload_for(1)
                    and not self._blocks.reclaim(1)):
                self._prefetch_q.append((key, payload, t0, owner))
                continue
            blk = self._blocks.alloc(1, owner=owner)[0]
            self._device_call("prefetch", blk=blk, pid=payload.pid)
            self._blocks.promote(key, blk)
            self._prefetch_inflight.discard(key)
            self._metrics.on_kv_prefetch(time.monotonic() - t0)

    # -- admission and the steps -------------------------------------------

    def _admit(self, req: _GenRequest, slot: int) -> str:
        """Prefill ``req`` into ``slot`` and emit its first token. Returns
        ``"ok"`` (slot occupied), ``"done"`` (expired, failed, or finished
        on its first token — slot stays free), ``"starved"`` (paged: not
        enough free KV blocks yet, or its chain is on its way back from
        the host tier) or ``"starved_budget"`` (its tenant is over its own
        block budget); a starved request stays held."""
        now = time.monotonic()
        if req.expired(now):
            self._fail_expired(req, now)
            return "done"
        reservation = None
        row: List[int] = []
        read_row = None
        if self._paged:
            reservation = self._paged_reserve(req)
            if reservation == "budget":
                return "starved_budget"
            if not isinstance(reservation, tuple):
                return "starved"
        req.t_admit = now
        self._streams_started += 1     # the serve_hook @stream counter
        length = int(req.tokens.size)
        bs = self._cfg.block_size
        n_full = length // bs
        nb = self._cfg.blocks_per_slot
        try:
            if self._paged:
                hits, fresh, n_total = reservation
                row = hits + fresh
                read_row = np.full((nb,), TRASH_BLOCK, np.int32)
                read_row[:n_total] = row
            if self._chunked:
                ct = self._cfg.chunk_tokens
                # The loop starts at the first block not shared: the
                # bucket is drawn on the suffix, so a deep hit runs a
                # smaller program.
                start = len(hits) * bs
                suf_len = length - start
                bucket = bucket_for(suf_len, self._chunked_buckets)
                toks = np.zeros((bucket,), np.int32)
                toks[:suf_len] = req.tokens[start:]
                # Per-chunk write targets: only the fresh blocks the
                # suffix's prompt positions land in; hit blocks are never
                # written, generation blocks and padding go to trash.
                suffix_blocks = row[len(hits):blocks_for(length, bs)]
                wflat = np.full((bucket // bs,), TRASH_BLOCK, np.int32)
                wflat[:len(suffix_blocks)] = suffix_blocks
                if n_full > 0:
                    self._metrics.on_prefix(len(hits), n_full)
                self._metrics.on_chunked_prefill(bucket // ct, start // ct)
                self._last_prefill_bucket = bucket
                logits = self._chunked_prefill(
                    toks, slot, length, start,
                    wflat.reshape(bucket // ct, self._cfg.chunk_blocks),
                    read_row, req.adapter_slot)
            else:
                bucket = bucket_for(length, self._buckets)
                toks = np.zeros((bucket,), np.int32)
                toks[:length] = req.tokens
                write_row = None
                if self._paged:
                    # Writes aimed at shared prefix blocks go to the trash
                    # block: a sharer never touches bytes others read.
                    write_row = read_row.copy()
                    write_row[:len(hits)] = TRASH_BLOCK
                    if self._cfg.prefix_reuse and n_full > 0:
                        self._metrics.on_prefix(len(hits), n_full)
                self._last_prefill_bucket = bucket
                logits = self._prefill(toks, slot, length, write_row,
                                       req.adapter_slot)
        except Exception as e:  # noqa: BLE001
            if self._paged:
                self._blocks.release(row)
            if self._close_if_broken():
                e = ServerClosedError(f"the tp group lost a rank before "
                                      f"this request started: {e!r}")
            req.handle._fail(e)
            self._req_done(req)
            return "done"
        if self._paged and self._cfg.prefix_reuse and n_full > 0:
            # Pin the prompt's full blocks for later admissions: the
            # prefix now lives in the pool whether or not this stream
            # survives its first token.
            self._blocks.register_prefix(
                req.tokens, row, n_full, salt=req.prefix_salt,
                route_digest=prefix_route_digest(req.tokens, bs,
                                                 req.adapter))
        if req.replay_expect is None:
            # A resuming stream's first token was delivered (and its TTFT
            # recorded) before the eviction.
            req.t_first = time.monotonic()
            self._metrics.on_first_token(
                (req.t_first - req.enqueued_at) * 1e3,
                tenant=self._tenant_label(req),
                slo_ms=self._slo_of(req.tenant))
        tok = req.sample(logits)
        req.n_out = 1
        try:
            self._req_emit(req, tok)
            reason = self._finish_reason(req, tok, next_pos=length)
            if reason:
                self._finish(req, reason)
        except RuntimeError as e:
            # A replay that diverged at its first token: this stream
            # fails with the error; it never held a slot.
            reason = "error"
            req.handle._fail(e)
            self._req_done(req)
        if reason:
            if self._paged:
                self._blocks.release(row)
            return "done"
        self._slots[slot] = req
        self._positions[slot] = length
        self._last[slot] = tok
        self._adapter_idx[slot] = req.adapter_slot
        if self._paged:
            self._slot_blocks[slot] = row
            self._tables[slot] = read_row
        return "ok"

    def _spec_once(self) -> None:
        """Draft up to k tokens per slot host-side, verify all k + 1
        positions in one forward, accept per slot: a slot whose drafts all
        miss still emits one token (verify row 0 is the decode step's
        logits), and a step where no slot drafted anything is the plain
        decode step. Greedy acceptance emits exactly the one-token
        stream; sampled acceptance is the seeded rejection rule of
        :mod:`.spec`."""
        k = self._spec.k
        w = k + 1
        t0 = time.monotonic()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        # Pad columns repeat the slot's last token: a valid id whose rows
        # the host never reads (their K/V is overwritten before any mask
        # exposes it).
        toks = np.repeat(self._last.copy()[:, None], w, axis=1)
        drafts: Dict[int, np.ndarray] = {}
        for i in active:
            req = self._slots[i]
            # Most tokens this stream may still emit: drafting past
            # cap - 1 cannot be accepted and keeps every write inside
            # the blocks admission reserved.
            cap = min(req.max_new - req.n_out,
                      self._cfg.max_len - int(self._positions[i]))
            if cap < 2:
                continue
            # [:n_out]: a preemption replay drafts from the regenerated
            # prefix only, never from the envelope's future tokens.
            ctx = np.concatenate(
                [np.asarray(req.tokens, np.int64),
                 np.asarray(req.handle._tokens[:req.n_out], np.int64)])
            d = np.asarray(self._drafter.propose(ctx, min(k, cap - 1)),
                           np.int64).ravel()[:min(k, cap - 1)]
            d = d[(d >= 0) & (d < self._model_cfg.vocab)]
            if d.size:
                drafts[i] = d
                toks[i, 1:1 + d.size] = d
        draft_ms = (time.monotonic() - t0) * 1e3
        if not drafts:
            # The plain step (still counted: tokens a step is the rate
            # over every step speculation supervised).
            self._decode_once()
            self._metrics.on_spec_step(0, 0, len(active), draft_ms, 0.0)
            return
        t1 = time.monotonic()
        logits_np = self._verify(toks, self._positions,
                                 self._tables if self._paged else None,
                                 self._adapter_idx)
        exec_ms = (time.monotonic() - t1) * 1e3
        self._peak_active = max(self._peak_active, len(active))
        self._metrics.on_batch(self._cfg.max_slots, len(active), exec_ms,
                               len(self._queue) + len(self._held))
        proposed = accepted = emitted_total = 0
        for i in active:
            req = self._slots[i]
            rows = logits_np[i]
            d = drafts.get(i)
            if d is None:
                cand, hits = [req.sample(rows[0])], 0
            elif req.sampling.temperature <= 0:
                cand, hits = accept_greedy(rows, d)
            else:
                cand, hits = accept_sampled(rows, d, req.probs, req.rng)
            emitted = 0
            reason = None
            for tok in cand:
                tok = int(tok)
                req.n_out += 1
                self._req_emit(req, tok)
                self._positions[i] += 1
                self._last[i] = tok
                emitted += 1
                reason = self._finish_reason(
                    req, tok, next_pos=int(self._positions[i]))
                if reason:
                    break
            n_prop = int(d.size) if d is not None else 0
            # EOS/length can cut an acceptance short: only tokens that
            # reached the stream count as accepted drafts.
            n_hit = min(hits, emitted)
            req.spec_proposed += n_prop
            req.spec_accepted += n_hit
            proposed += n_prop
            accepted += n_hit
            emitted_total += emitted
            if reason:
                self._finish(req, reason)
                self._release_slot(i)
        self._metrics.on_spec_step(proposed, accepted, emitted_total,
                                   draft_ms, exec_ms)

    def _decode_once(self) -> None:
        t0 = time.monotonic()
        logits_np = self._decode(self._last, self._positions,
                                 self._tables if self._paged else None,
                                 self._adapter_idx)
        exec_ms = (time.monotonic() - t0) * 1e3
        active = [i for i, r in enumerate(self._slots) if r is not None]
        self._peak_active = max(self._peak_active, len(active))
        self._metrics.on_batch(self._cfg.max_slots, len(active), exec_ms,
                               len(self._queue) + len(self._held))
        for i in active:
            req = self._slots[i]
            tok = req.sample(logits_np[i])
            req.n_out += 1
            self._req_emit(req, tok)
            self._positions[i] += 1
            self._last[i] = tok
            reason = self._finish_reason(req, tok,
                                         next_pos=int(self._positions[i]))
            if reason:
                self._finish(req, reason)
                self._release_slot(i)

    def _finish_reason(self, req: _GenRequest, tok: int,
                       next_pos: int) -> Optional[str]:
        if req.eos is not None and tok == req.eos:
            return "eos"
        if req.n_out >= req.max_new or next_pos >= self._cfg.max_len:
            return "length"
        return None

    def _finish(self, req: _GenRequest, reason: str) -> None:
        if (req.replay_expect is not None
                and req.replay_i < len(req.replay_expect)):
            # The regenerated stream ended before its own envelope: the
            # divergence _req_emit guards.
            raise RuntimeError(
                f"preemption replay of stream {req.stream_id} finished "
                f"({reason}) at position {req.replay_i} but its envelope "
                f"holds {len(req.replay_expect)} tokens — the slot-row "
                f"bit-identity contract is broken")
        now = time.monotonic()
        gen_s = now - req.t_first
        self._metrics.on_generation_end(req.n_out, gen_s,
                                        tenant=self._tenant_label(req))
        # queue_ms is the admission wait (enqueue → slot), not TTFT.
        self._metrics.on_response((now - req.enqueued_at) * 1e3,
                                  (req.t_admit - req.enqueued_at) * 1e3)
        self._req_done(req)
        flightrec.record("serve_complete", replica=self.serve_name,
                         stream=req.stream_id, n_tokens=req.n_out,
                         reason=reason)
        req.handle._finish({
            "tokens": list(req.handle._tokens),
            "finish_reason": reason,
            "n_tokens": req.n_out,
            "ttft_ms": (req.t_first - req.enqueued_at) * 1e3,
            "tenant": req.tenant,
            "adapter": req.adapter,
            "tokens_per_sec": ((req.n_out - 1) / gen_s
                               if req.n_out > 1 and gen_s > 0 else None),
            # Per-request speculation accounting (None: spec off).
            "spec_accept_rate": (
                (req.spec_accepted / req.spec_proposed
                 if req.spec_proposed else 0.0)
                if self._spec is not None else None),
        })

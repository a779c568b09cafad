"""Continuous-batching autoregressive generation over the KV cache.

Port of the JAX package's ``serve/generate.py`` ``GenerationEngine``.
Orca-style iteration-level scheduling over vLLM-style paged KV memory:

* **Slots, not batches.** The decode step always runs at the fixed
  ``[max_slots]`` shape and requests join/leave the batch at every step
  boundary: a new request prefills into a free slot while its neighbours
  are mid-stream. Slot rows are numerically independent, so a request's
  greedy stream is the same whether it runs alone or in a busy batch.
* **Two KV layouts.** ``"paged"`` (the default): a fixed pool of
  ``block_size``-position blocks (:mod:`..parallel.kv_blocks`); a stream
  reserves at admission every block it can write and holds only those,
  admission tracks free blocks next to free slots (``blocks_exhausted``
  vs ``slots_full``). ``"contiguous"``: every slot reserves ``max_len``
  rows of :func:`~..parallel.transformer.init_kv_cache`.
* **Prefix reuse, chunked prefill, host tier** (paged): full prompt
  blocks are registered and shared copy-on-write by later prompts with
  the same prefix; ``chunked_prefill`` runs every admission as chunks
  that read the shared prefix out of the pool, so a hit computes only
  its suffix; ``host_blocks`` offloads cold registered prefixes to host
  memory and fetches them back at the loop's top, never inside a step.
* **Speculative decoding** (``spec=SpecConfig(k)``): a host-side drafter
  proposes up to ``k`` tokens a slot and one verify forward scores all
  ``k + 1`` positions (:mod:`.spec`).
* **Kernels.** Prompts run the flash-attention prefill kernel, paged
  decode and verify steps the paged decode-attention kernel on a CUDA
  device (their plain PyTorch versions on the CPU); the contiguous decode
  and the chunked prefill's pool read are plain PyTorch, as the JAX
  functions are plain XLA. Prompts pad to power-of-two buckets, so
  :meth:`GenerationEngine.warmup` can run every shape the engine will
  see before traffic.
* **Sampling is per-request and host-side** (numpy, seeded per request:
  greedy / temperature / top-k), so a stream is reproducible no matter
  what shares its batch.
* **Backpressure**: bounded admission queue
  (:class:`~..exceptions.ServerOverloadedError` at the door), deadlines
  checked while a request waits for a slot
  (:class:`~..exceptions.DeadlineExceededError` through the handle),
  graceful drain on shutdown, ``/healthz`` readiness via
  :class:`~.engine.ReadinessMixin`. Admission is FIFO (what the JAX
  engine's fair scheduler does with one tenant).

The loop is one background thread: one consumer keeps slot assignment and
the queue's FIFO order trivially correct. Not ported yet (each raises
``NotImplementedError`` naming ``ROADMAP.md`` Queue 1 item 12): tenants,
their budgets and preemption, LoRA adapters.
"""

from __future__ import annotations

import dataclasses
import queue as std_queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..exceptions import (DeadlineExceededError, ServerClosedError,
                          ServerOverloadedError)
from ..ops.paged_attention import paged_attention_supported
from ..parallel.kv_blocks import (TRASH_BLOCK, BlockManager, blocks_for,
                                  init_paged_kv_cache, paged_chunked_prefill,
                                  paged_decode_step, paged_prefill,
                                  paged_verify_step, prefix_route_digest)
from ..parallel.transformer import (Transformer, check_dense, decode_step,
                                    gen_weights, init_kv_cache, prefill,
                                    verify_step)
from .batcher import RequestQueue, bucket_for
from .engine import ReadinessMixin
from .metrics import ServeMetrics
from .spec import SpecConfig, accept_greedy, accept_sampled

_DEFAULT = object()    # "knob not passed" sentinel (None is a real value)
_LATER = "a later slice of the PyTorch port (ROADMAP.md Queue 1 item 12)"
# The prefix registry's salt of base-model traffic: the JAX engine's
# reserved NUL frame, so a base key can never equal a tenant's.
_BASE_SALT = b"\x00"


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
    """Engine knobs (the JAX ``GenerationConfig`` without the tenants).

    ``max_slots`` is the decode batch width and ``max_len`` the per-
    request cache depth (prompt + generated tokens). ``kv_layout``:

    * ``"paged"`` (the default): a pool of ``n_blocks`` blocks of
      ``block_size`` positions, the reserved trash block included;
      ``None`` sizes it for every slot at full depth (``max_slots ·
      ceil(max_len/block_size) + 1``). ``prefix_reuse`` shares full
      block-aligned prompt prefixes copy-on-write across streams.
    * ``"contiguous"``: every slot reserves ``max_len`` rows up front.

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
    lands (FIFO kept), ``"miss"`` admits it at once on the device-tier
    hits only (a recompute, never a stale read).

    The tenant knobs (``tenant_*``, ``preempt``) come with the tenants
    and LoRA: a non-default value raises ``NotImplementedError``.
    ``preempt`` defaults to False here: without tenant priority classes
    the JAX engine's preemption never fires, which is this engine's
    behaviour.
    """

    max_slots: int = 8
    max_len: int = 512
    max_queue: int = 256
    default_deadline_ms: Optional[float] = None
    default_max_new_tokens: int = 64
    eos_id: Optional[int] = None
    kv_layout: str = "paged"
    block_size: int = 16
    n_blocks: Optional[int] = None
    prefix_reuse: bool = False
    chunked_prefill: bool = False
    chunk_blocks: int = 1
    host_blocks: int = 0
    host_admission: str = "wait"
    tenant_weights: Optional[Dict[str, float]] = None
    tenant_priorities: Optional[Dict[str, int]] = None
    tenant_block_budgets: Optional[Dict[str, int]] = None
    tenant_slo_ttft_ms: Optional[Dict[str, float]] = None
    preempt: bool = False

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
            for knob in ("prefix_reuse", "chunked_prefill", "host_blocks"):
                if getattr(self, knob):
                    raise ValueError(f"{knob} requires kv_layout='paged'")
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
        for knob in ("tenant_weights", "tenant_priorities",
                     "tenant_block_budgets", "tenant_slo_ttft_ms",
                     "preempt"):
            if getattr(self, knob):
                raise NotImplementedError(
                    f"GenerationConfig.{knob} comes in {_LATER}")

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
    # Whether this request holds a max_queue admission ticket.
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


class GenerationEngine(ReadinessMixin):
    """Continuous-batching generation server over one transformer.

    Args:
      model: the :class:`~..parallel.transformer.Transformer` to serve
        (dense FFN only), already on ``device``.
      config: :class:`GenerationConfig`.
      device: where the cache lives and the model runs; ``"cuda"`` (the
        default) raises on a host without CUDA, ``"cpu"`` runs the
        kernels' plain PyTorch versions.
      spec: :class:`~.spec.SpecConfig` turns on speculative decoding
        (``None``: off). A step where no slot drafted anything is the
        plain decode step.
      adapters: LoRA adapters are not ported yet; anything but ``None``
        raises ``NotImplementedError``.
    """

    def __init__(self, model: Transformer,
                 config: GenerationConfig = GenerationConfig(), *,
                 device: DeviceLike = "cuda", adapters: Any = None,
                 spec: Optional[SpecConfig] = None):
        if adapters is not None:
            raise NotImplementedError(f"LoRA adapters come in {_LATER}")
        cfg = model.cfg
        check_dense(cfg, "GenerationEngine")
        self._device = resolve_device(device)
        if model.device != self._device:
            raise ValueError(f"model is on {model.device}, the engine's "
                             f"device is {self._device}; move it first")
        if self._device.type == "cuda" and not paged_attention_supported(
                cfg.d_head, config.block_size, cfg.dtype):
            raise ValueError(
                f"the CUDA kernels take bf16 with d_head 128; got "
                f"{cfg.dtype} with d_head {cfg.d_head}")
        if spec is not None and spec.k + 1 > config.max_len:
            raise ValueError(
                f"spec k={spec.k} needs k+1 <= max_len={config.max_len}")
        self._model_cfg = cfg
        self._cfg = config
        with torch.no_grad():
            self._weights = gen_weights(model)
        self._queue = RequestQueue(config.max_queue)
        self._metrics = ServeMetrics()
        s = config.max_slots
        self._paged = config.kv_layout == "paged"
        if self._paged:
            self._n_blocks = config.resolved_n_blocks
            self._cache = init_paged_kv_cache(cfg, self._n_blocks,
                                              config.block_size, s,
                                              device=self._device)
            self._blocks = BlockManager(self._n_blocks, config.block_size,
                                        host_blocks=config.host_blocks)
            self._tables = np.full((s, config.blocks_per_slot),
                                   TRASH_BLOCK, np.int32)
            self._slot_blocks: List[List[int]] = [[] for _ in range(s)]
        else:
            self._cache = init_kv_cache(cfg, s, config.max_len,
                                        device=self._device)
            self._blocks = None
        self._chunked = self._paged and config.chunked_prefill
        # Host-tier prefetches staged by admissions, applied at the top
        # of the loop: a decode step never waits on a host→device copy.
        self._host_cap = config.host_blocks if self._paged else 0
        self._prefetch_q: deque = deque()
        self._prefetch_inflight: set = set()
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
        # (block-starved, or waiting on a host-tier prefetch); FIFO: the
        # head request holds the line.
        self._held: deque = deque()
        self._peak_active = 0
        self._slots: List[Optional[_GenRequest]] = [None] * s
        self._positions = np.full((s,), -1, np.int32)
        self._last = np.zeros((s,), np.int32)
        self._closed = False
        self._warmed = False
        self._abort = False
        self._thread = threading.Thread(target=self._loop,
                                        name="hvd-torch-generate-loop",
                                        daemon=True)
        self._thread.start()

    # -- the device programs -----------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        # A copy, never a view: the loop mutates these host arrays.
        return torch.tensor(arr, device=self._device)

    @torch.no_grad()
    def _prefill(self, tokens: np.ndarray, slot: int, length: int,
                 write_row: Optional[np.ndarray]) -> np.ndarray:
        """Prefill one padded prompt; returns the logits row of its last
        real position (the only row sampling reads)."""
        toks = self._to_device(tokens)
        if self._paged:
            _, logits = paged_prefill(
                self._weights, toks, self._cache, slot,
                self._to_device(write_row), self._model_cfg, length=length)
        else:
            _, logits = prefill(self._weights, toks, self._cache, slot,
                                self._model_cfg, length=length)
        return logits[length - 1].cpu().numpy()

    @torch.no_grad()
    def _chunked_prefill(self, tokens: np.ndarray, slot: int, length: int,
                         start: int, write_rows: np.ndarray,
                         read_row: np.ndarray) -> np.ndarray:
        """The chunked prefill of a suffix starting at ``start``; returns
        the logits row of the last prompt position."""
        _, logits = paged_chunked_prefill(
            self._weights, self._to_device(tokens), self._cache, slot,
            self._to_device(write_rows), self._to_device(read_row), start,
            self._model_cfg, length=length,
            chunk_blocks=self._cfg.chunk_blocks)
        return logits[length - start - 1].cpu().numpy()

    @torch.no_grad()
    def _decode(self, last: np.ndarray, positions: np.ndarray,
                tables: Optional[np.ndarray]) -> np.ndarray:
        """One decode step for every slot; returns ``[S, vocab]`` logits."""
        toks, pos = self._to_device(last), self._to_device(positions)
        if self._paged:
            _, logits = paged_decode_step(
                self._weights, toks, self._cache, pos,
                self._to_device(tables), self._model_cfg)
        else:
            _, logits = decode_step(self._weights, toks, self._cache, pos,
                                    self._model_cfg)
        return logits.cpu().numpy()

    @torch.no_grad()
    def _verify(self, drafts: np.ndarray, positions: np.ndarray,
                tables: Optional[np.ndarray]) -> np.ndarray:
        """One verify forward over ``[S, k + 1]`` draft columns; returns
        ``[S, k + 1, vocab]`` logits."""
        toks, pos = self._to_device(drafts), self._to_device(positions)
        if self._paged:
            _, logits = paged_verify_step(
                self._weights, toks, self._cache, pos,
                self._to_device(tables), self._model_cfg)
        else:
            _, logits = verify_step(self._weights, toks, self._cache, pos,
                                    self._model_cfg)
        return logits.cpu().numpy()

    def warmup(self) -> Tuple[Any, ...]:
        """Run the decode step, the verify step (with ``spec``) and every
        prefill bucket (the chunked ones on a chunked engine) once before
        traffic. Paged writes land in the trash block, contiguous ones in
        rows past every slot's length, so the cache stays usable.
        Returns the shapes warmed."""
        s = self._cfg.max_slots
        nb = self._cfg.blocks_per_slot
        tables = np.full((s, nb), TRASH_BLOCK, np.int32)
        idle = np.full((s,), -1, np.int32)
        self._decode(np.zeros((s,), np.int32), idle, tables)
        spec_keys: Tuple[Any, ...] = ()
        if self._spec is not None:
            w = self._spec.k + 1
            self._verify(np.zeros((s, w), np.int32), idle, tables)
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
        self._cache["lengths"].zero_()
        self._warmed = True
        return ("decode",) + spec_keys + tuple(buckets)

    # -- client API --------------------------------------------------------

    def submit(self, tokens: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               eos_id: Any = _DEFAULT,
               deadline_ms: Optional[float] = None) -> GenerationHandle:
        """Enqueue one prompt; returns a :class:`GenerationHandle`
        streaming the sampled tokens. Raises
        :class:`ServerOverloadedError` when the admission queue is full,
        :class:`ServerClosedError` after shutdown, ``ValueError`` on a
        malformed prompt or one the pool could never hold (all eagerly,
        in the caller's thread).

        ``max_new_tokens`` is clamped to the cache room left after the
        prompt (the stream then finishes with reason ``"length"``);
        ``eos_id=None`` disables EOS for this request even when the
        engine has a default."""
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
        if self._paged:
            need = self._blocks_needed(toks.size, max_new)
            if need > self._blocks.usable:
                raise ValueError(
                    f"request needs {need} KV blocks (prompt {toks.size} "
                    f"+ up to {max_new} generated, block_size="
                    f"{self._cfg.block_size}) but the pool holds only "
                    f"{self._blocks.usable} usable blocks — raise "
                    f"n_blocks or lower max_new_tokens")
        sampling = SamplingParams() if sampling is None else sampling
        eos = self._cfg.eos_id if eos_id is _DEFAULT else eos_id
        if deadline_ms is None:
            deadline_ms = self._cfg.default_deadline_ms
        now = time.monotonic()
        handle = GenerationHandle()
        req = _GenRequest(
            tokens=toks, max_new=max_new, sampling=sampling, eos=eos,
            handle=handle, enqueued_at=now,
            deadline_at=(None if deadline_ms is None
                         else now + deadline_ms / 1e3),
            rng=np.random.default_rng(sampling.seed))
        try:
            depth = self._queue.put(req)   # raises Closed / Overloaded
        except ServerOverloadedError:
            reason, detail = self._overload_reason(toks.size, max_new)
            self._metrics.on_overload(reason)
            err = ServerOverloadedError(
                f"request queue full ({self._cfg.max_queue}); "
                f"{reason}: {detail}")
            err.retry_after_ms = self._metrics.retry_after_ms(
                len(self._queue))
            raise err from None
        self._metrics.on_submit(depth)
        return handle

    def generate(self, tokens: Sequence[int],
                 timeout: Optional[float] = None, **kw) -> Dict:
        """Synchronous :meth:`submit` (+ ``handle.result(timeout)``)."""
        return self.submit(tokens, **kw).result(timeout)

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

    def stats(self) -> Dict:
        """The ``/stats`` snapshot: :class:`ServeMetrics` plus the slot,
        bucket and (paged) block-pool view (``batch_fill_ratio`` is
        decode-slot occupancy)."""
        snap = self._metrics.snapshot()
        snap["max_slots"] = self._cfg.max_slots
        snap["max_len"] = self._cfg.max_len
        snap["active_slots"] = sum(r is not None for r in self._slots)
        snap["peak_active_slots"] = self._peak_active
        snap["prefill_buckets"] = list(self._buckets)
        snap["kv_layout"] = self._cfg.kv_layout
        if self._paged:
            snap["block_size"] = self._cfg.block_size
            snap["blocks"] = self._blocks.gauges()
            hits = snap["generation"]["prefix_hits_total"]
            misses = snap["generation"]["prefix_misses_total"]
            snap["prefix_hit_rate"] = (hits / (hits + misses)
                                       if hits + misses else None)
            snap["chunked_prefill"] = self._cfg.chunked_prefill
            snap["prefix_digests"] = list(self.prefix_digests())
        snap["last_prefill_bucket"] = self._last_prefill_bucket
        snap["spec_k"] = self._spec.k if self._spec is not None else 0
        snap["device"] = str(self._device)
        snap["max_queue"] = self._cfg.max_queue
        return snap

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
        in-flight streams. Idempotent."""
        if self._closed:
            return
        self._closed = True
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
        if cancelled:
            self._metrics.on_shutdown_cancel(cancelled)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=exc[0] is None)

    # -- the continuous-batching loop --------------------------------------

    def _loop(self):
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            try:
                if self._abort:
                    err = ServerClosedError(
                        "server shut down before completion")
                    for req in self._held:
                        req.handle._fail(err)
                    self._held.clear()
                    self._fail_active(err)
                    return
                if self._prefetch_q:
                    self._apply_prefetches()
                free = [i for i, r in enumerate(self._slots) if r is None]
                idle = len(free) == self._cfg.max_slots and not self._held
                # Pull everything queued into the held line; block only
                # when fully idle.
                want = len(self._queue) or (len(free) if idle else 0)
                if want > 0:
                    batch = self._queue.take_batch(want, 0.0, hold=True)
                    if not batch and idle:
                        return      # closed and drained, nothing in flight
                    for r in batch:
                        r.held_ticket = True
                    self._held.extend(batch)
                self._expire_held()
                while self._held and free:
                    req = self._held[0]
                    if req.held_ticket:
                        req.held_ticket = False
                        self._queue.release_held()
                    outcome = self._admit(req, free[0])
                    if outcome == "starved":
                        break       # FIFO: the head holds the line
                    self._held.popleft()
                    if outcome == "ok":
                        free.pop(0)
                if any(r is not None for r in self._slots):
                    if self._spec is None:
                        self._decode_once()
                    else:
                        self._spec_once()
                elif self._held and self._prefetch_q:
                    pass    # a staged prefetch lands at the next top
                elif self._held:
                    # Starved with nothing in flight: the submit-time pool
                    # check makes this unreachable. Fail loudly rather
                    # than spin.
                    req = self._held.popleft()
                    req.handle._fail(ServerOverloadedError(
                        "KV block pool cannot cover an admitted request "
                        "with the engine idle — admission accounting bug"))
            except Exception as e:  # noqa: BLE001 — deliver, don't die
                self._fail_active(e)

    def _fail_active(self, exc: BaseException) -> None:
        for i, req in enumerate(self._slots):
            if req is not None:
                req.handle._fail(exc)
                self._release_slot(i)

    def _release_slot(self, i: int) -> None:
        """Vacate slot ``i``: a paged slot's blocks return to the pool
        (refcount-aware: a shared prefix block frees only when its last
        reader ends) and its table row points at the trash block
        again."""
        self._slots[i] = None
        self._positions[i] = -1
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
        self._metrics.on_deadline_expired(wait_ms)
        req.handle._fail(DeadlineExceededError(
            f"deadline expired after {wait_ms:.1f} ms in queue"))

    def _paged_reserve(self, req: _GenRequest):
        """Reserve the blocks ``req`` needs: prefix-registry hits are
        retained (shared), the rest freshly allocated. Returns ``(hits,
        fresh, n_total)``, or None when the pool cannot cover it yet, or
        ``"wait"`` when the chain continues in the host tier under
        ``host_admission="wait"`` (the request holds the line while the
        staged prefetch lands). Hits are looked up again after every
        sweep (an eviction can take entries the first lookup matched);
        cold registered prefixes are offloaded to the host tier (when
        there is one) before any is dropped."""
        n_total = self._blocks_needed(req.tokens.size, req.max_new)
        while True:
            hits = (self._blocks.lookup_prefix(req.tokens,
                                               salt=_BASE_SALT)
                    if self._cfg.prefix_reuse else [])
            hits = hits[:n_total]
            if self._host_cap:
                cont = self._blocks.host_lookup(
                    req.tokens, len(hits), salt=_BASE_SALT)
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
            free = self._blocks.free_count
            if free >= need:
                self._blocks.retain(hits)
                return hits, self._blocks.alloc(need), n_total
            if self._host_cap and self._offload_for(need - free):
                continue
            if not self._blocks.reclaim(need):
                return None

    # -- host tier (offload / prefetch) ------------------------------------

    def _offload_for(self, shortfall: int) -> bool:
        """Move up to ``shortfall`` cold registered-prefix blocks to the
        host tier (the block's K/V of every layer copied to host memory,
        then committed: the manager checks again under its lock, so a hit
        landing meanwhile cancels that block's offload). Returns whether
        any device block was freed."""
        moved = 0
        for key, blk in self._blocks.offload_candidates(shortfall):
            payload = {n: self._cache[n][:, blk].to("cpu", copy=True)
                       for n in ("k", "v")}
            if self._blocks.offload_commit(key, payload):
                moved += 1
        if moved:
            self._metrics.on_kv_offload(moved)
        return moved > 0

    def _stage_prefetch(self, cont, req: _GenRequest) -> None:
        """Queue host→device copies for a chain continuation found in the
        host tier; applied at the loop's next top, never inside a decode
        step. Idempotent per key while a copy is pending; ``req`` records
        the keys it staged."""
        now = time.monotonic()
        for key, payload in cont:
            req.prefetch_keys.add(key)
            if key in self._prefetch_inflight:
                continue
            self._prefetch_inflight.add(key)
            self._prefetch_q.append((key, payload, now))

    def _apply_prefetches(self) -> None:
        """Land staged prefetches: allocate a device block (offloading or
        reclaiming a cold one first if the pool is dry), write the staged
        bytes, promote the registry entry (idempotent against an
        admission that registered the chain cold meanwhile). Entries that
        cannot get a block yet stay queued; the loop never blocks
        here."""
        for _ in range(len(self._prefetch_q)):
            key, payload, t0 = self._prefetch_q.popleft()
            if (self._blocks.free_count < 1
                    and not self._offload_for(1)
                    and not self._blocks.reclaim(1)):
                self._prefetch_q.append((key, payload, t0))
                continue
            blk = self._blocks.alloc(1)[0]
            for n in ("k", "v"):
                self._cache[n][:, blk] = payload[n].to(self._device)
            self._blocks.promote(key, blk)
            self._prefetch_inflight.discard(key)
            self._metrics.on_kv_prefetch(time.monotonic() - t0)

    def _admit(self, req: _GenRequest, slot: int) -> str:
        """Prefill ``req`` into ``slot`` and emit its first token. Returns
        ``"ok"`` (slot occupied), ``"done"`` (expired, failed, or finished
        on its first token — slot stays free) or ``"starved"`` (paged:
        not enough free KV blocks yet, or its chain is still on its way
        back from the host tier — the request stays held)."""
        now = time.monotonic()
        if req.expired(now):
            self._fail_expired(req, now)
            return "done"
        reservation = None
        row: List[int] = []
        read_row = None
        if self._paged:
            reservation = self._paged_reserve(req)
            if not isinstance(reservation, tuple):
                return "starved"
        req.t_admit = now
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
                    read_row)
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
                logits = self._prefill(toks, slot, length, write_row)
        except Exception as e:  # noqa: BLE001
            if self._paged:
                self._blocks.release(row)
            req.handle._fail(e)
            return "done"
        if self._paged and self._cfg.prefix_reuse and n_full > 0:
            # Pin the prompt's full blocks for later admissions: the
            # prefix now lives in the pool whether or not this stream
            # survives its first token.
            self._blocks.register_prefix(
                req.tokens, row, n_full, salt=_BASE_SALT,
                route_digest=prefix_route_digest(req.tokens, bs))
        req.t_first = time.monotonic()
        self._metrics.on_first_token((req.t_first - req.enqueued_at) * 1e3)
        tok = req.sample(logits)
        req.n_out = 1
        self._emit(req, tok)
        reason = self._finish_reason(req, tok, next_pos=length)
        if reason:
            self._finish(req, reason)
            if self._paged:
                self._blocks.release(row)
            return "done"
        self._slots[slot] = req
        self._positions[slot] = length
        self._last[slot] = tok
        if self._paged:
            self._slot_blocks[slot] = row
            self._tables[slot] = read_row
        return "ok"

    def _emit(self, req: _GenRequest, tok: int) -> None:
        self._metrics.on_tokens()
        req.handle._emit(tok)

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
                                 self._tables if self._paged else None)
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
                self._emit(req, tok)
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
                                 self._tables if self._paged else None)
        exec_ms = (time.monotonic() - t0) * 1e3
        active = [i for i, r in enumerate(self._slots) if r is not None]
        self._peak_active = max(self._peak_active, len(active))
        self._metrics.on_batch(self._cfg.max_slots, len(active), exec_ms,
                               len(self._queue) + len(self._held))
        for i in active:
            req = self._slots[i]
            tok = req.sample(logits_np[i])
            req.n_out += 1
            self._emit(req, tok)
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
        now = time.monotonic()
        gen_s = now - req.t_first
        self._metrics.on_generation_end(req.n_out, gen_s)
        # queue_ms is the admission wait (enqueue → slot), not TTFT.
        self._metrics.on_response((now - req.enqueued_at) * 1e3,
                                  (req.t_admit - req.enqueued_at) * 1e3)
        req.handle._finish({
            "tokens": list(req.handle._tokens),
            "finish_reason": reason,
            "n_tokens": req.n_out,
            "ttft_ms": (req.t_first - req.enqueued_at) * 1e3,
            "tokens_per_sec": ((req.n_out - 1) / gen_s
                               if req.n_out > 1 and gen_s > 0 else None),
            # Per-request speculation accounting (None: spec off).
            "spec_accept_rate": (
                (req.spec_accepted / req.spec_proposed
                 if req.spec_proposed else 0.0)
                if self._spec is not None else None),
        })

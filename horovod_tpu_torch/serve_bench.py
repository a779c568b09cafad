"""Load generator for the port's serving plane (:mod:`horovod_tpu_torch.
serve`): the latency/throughput curve of the single-shot ``Engine`` and
of the continuous-batching ``GenerationEngine``.

Port of the JAX package's ``bin/serve_bench.py``, which stays that
package's tool: the same flags and defaults, the same open-loop arrival
schedule and prompts (draw for draw: arrival rng 0, the tenant pick rng
4321, the prefix-mix rng 97, per-tenant prompt rngs 7000+i, system
prefixes from 1234 / 4100+j, sampling seeds 9000 + 131·tenant + k;
:func:`gen_arrivals`), the same JSON rows, the same exit status.

Open-loop (arrival times are scheduled at the target rate regardless of
completion: a closed-loop generator hides overload by self-throttling),
mixed request sizes, per-request deadline. ``--mode predict`` drives the
single-shot :class:`~.serve.Engine` over a small MLP and reports achieved
throughput, e2e latency p50/p99, batch fill and the two drop classes;
``--mode generate`` drives the generation engine and reports, per
operating point, TTFT p50/p99, per-user and aggregate tokens/s, slot
occupancy, peak bytes and the KV, tenant, speculation and fleet gauges,
one JSON line a point (``--json FILE`` appends them to a file)::

    python -m horovod_tpu_torch.serve_bench --device cpu --qps 200
    python -m horovod_tpu_torch.serve_bench --device cpu --mode generate \\
        --qps 20 --duration 5
    python -m horovod_tpu_torch.serve_bench --mode generate \\
        --model bench_lm --kv-layout paged --paged-kernel --max-len 2048 \\
        --prefix-tokens 1024 --prefix-mix 0.5 --qps 4,16   # on the card

It runs on the card unless ``--device cpu`` is given; without a GPU and
without ``--device cpu`` it exits non-zero. ``peak_bytes_per_chip`` is
``torch.cuda.max_memory_allocated`` over the point (reset at its start),
null on the CPU.

``--model`` is the port's own flag: ``tiny`` (the default) is the JAX
tool's bench model (vocab 256, d_model 64, 4 heads, 2 layers, d_ff 128,
f32; ``--model-dim`` widens it), ``bench_lm`` the bench LM at full width
(vocab 32768, d_model 2048, 16 heads of 128, 8 layers, d_ff 8192, bf16
weights, f32 unembed), the model whose shapes the card's kernels take:
the tiny model's f32 and d_head 16 route to the plain versions.
Weights are drawn by ``torch.Generator(device).manual_seed(0)`` (a
subprocess replica draws the same from its spec's seed), so digests of a
CLI run differ from the JAX tool's; :func:`build_gen_engine` takes a
model, so a caller can serve JAX's own tree through
``convert.params_from_jax`` and compare digests.

``--adapters N`` serves N seeded LoRA tenants (``a0..aN-1``, trees from
``torch.Generator(device).manual_seed(100 + i)``, ``b_scale=0.5``) beside
``base``; ``--adapter-only T`` replays the same schedule submitting only
T's requests, the single-tenant reference of the per-tenant
``stream_digests``. ``--replicas N`` serves through a ``FleetRouter``
(``--autoscale`` grows from ``--min-replicas`` under load and shrinks
back, ``--replica-procs`` makes each replica a subprocess whose spec
carries ``device`` and the parent's numerics flags), and a fleet run
ends with one ``{"fleet": true, ...}`` summary line. ``--chaos CLAUSE``
arms the serving-plane fault injector (``testing/faults.py``).

Exit status is non-zero if any *in-deadline* request was dropped (an
overload reject or a failure) at any operating point, or if no request
completed; in generate mode also on zero aggregate tokens/s.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time
from typing import Iterator, Optional

import numpy as np
import torch

from .bench import _LM_GPU


def _percentile(xs, q):
    return float(np.percentile(xs, q * 100)) if xs else float("nan")


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_bytes_per_chip(device: torch.device) -> Optional[int]:
    """Peak allocated bytes on the card since the point's reset, or None
    on the CPU (where the JAX tool's probe reads no allocator stats
    either)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


# The generate-mode bench model of the JAX tool (f32): bytes per cached
# token position = 2 (K and V) · n_layers · d_model · 4.
_GEN_MODEL = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128)
# The bench LM (bf16 weights, f32 unembed): the shapes the kernels take.
_BENCH_LM = {k: _LM_GPU[k] for k in ("vocab", "d_model", "n_heads",
                                    "n_layers", "d_ff")}


def _gen_model(args):
    """Bench model dims. ``--model-dim`` widens the tiny model (d_ff =
    2·d) so a drill can sit in the regime where prefill compute per chunk
    is much larger than a block copy."""
    if getattr(args, "model", "tiny") == "bench_lm":
        return dict(_BENCH_LM)
    d = int(getattr(args, "model_dim", 0) or 0)
    if not d:
        return dict(_GEN_MODEL)
    return dict(vocab=256, d_model=d, n_heads=4, n_layers=2, d_ff=2 * d)


def _gen_dtypes(args):
    """(weights dtype, unembed dtype) of the bench model."""
    if getattr(args, "model", "tiny") == "bench_lm":
        return torch.bfloat16, torch.float32
    return torch.float32, torch.float32


def _gen_bpt(args):
    m = _gen_model(args)
    itemsize = torch.empty((), dtype=_gen_dtypes(args)[0]).element_size()
    return 2 * m["n_layers"] * m["d_model"] * itemsize


def _gen_capacity(args):
    """Resolve (max_slots, n_blocks, cache_bytes) for the generate engine.
    With ``--cache-mb`` the budget is fixed and capacity derives from the
    layout: contiguous, slots = budget // (max_len · bytes/token); paged,
    the pool is budget // block bytes (the trash block charged against
    it) and slots = how many typical requests (longest bench prompt +
    generated tokens) the usable pool holds, capped at 64."""
    if not args.cache_mb:
        n_blocks = args.n_blocks if args.n_blocks else None
        return args.slots, n_blocks, None
    bpt = _gen_bpt(args)
    budget = int(args.cache_mb * 2 ** 20)
    if args.kv_layout == "contiguous":
        slots = max(1, budget // (args.max_len * bpt))
        return slots, None, slots * args.max_len * bpt
    block_bytes = args.block_size * bpt
    n_blocks = max(2, budget // block_bytes)
    typical = args.prefix_tokens + 16 + args.gen_tokens - 1
    per_req = -(-typical // args.block_size)
    slots = max(1, min(64, (n_blocks - 1) // per_req))
    return slots, n_blocks, n_blocks * block_bytes


class _BenchMLP(torch.nn.Module):
    """Small but not trivial: two hidden layers of 256, so a batch is
    visible on the timeline, small enough that the bench measures the
    serving plane, not the model. Weights ~ N(0, 1/fan_in) from a seeded
    generator, biases zero (flax ``Dense``'s scale)."""

    def __init__(self, features: int, device: torch.device,
                 seed: int = 0):
        super().__init__()
        gen = torch.Generator(device=device).manual_seed(seed)
        dims = (features, 256, 256, 10)
        self.layers = torch.nn.ModuleList()
        for fan_in, fan_out in zip(dims[:-1], dims[1:]):
            lin = torch.nn.Linear(fan_in, fan_out, device=device)
            with torch.no_grad():
                lin.weight.copy_(torch.randn(
                    (fan_out, fan_in), generator=gen, device=device)
                    / fan_in ** 0.5)
                lin.bias.zero_()
            self.layers.append(lin)

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i + 1 < len(self.layers):
                x = torch.relu(x)
        return x


def build_engine(args, model: Optional[torch.nn.Module] = None):
    """The predict-mode engine: ``serve.Engine`` over ``model`` (a
    ``_BenchMLP`` drawn from seed 0 when omitted), warmed up."""
    from . import serve
    device = torch.device(args.device)
    if model is None:
        model = _BenchMLP(args.features, device)
    cfg = serve.ServeConfig(max_batch=args.max_batch,
                            batch_timeout_ms=args.batch_timeout_ms,
                            max_queue=args.max_queue,
                            default_deadline_ms=args.deadline_ms)
    eng = serve.Engine(lambda m, x: m(x), model,
                       item_shape=(args.features,), config=cfg,
                       device=device)
    t0 = time.monotonic()
    eng.warmup()
    print(f"warmup: {len(serve.bucket_sizes(args.max_batch))} buckets "
          f"run in {time.monotonic() - t0:.2f} s")
    return eng


def _bench_tenants(args):
    """Tenant names + normalized arrival weights for this run: ``base``
    plus ``a0..aN-1`` (uniform unless ``--adapter-mix``)."""
    tenants = ["base"] + [f"a{i}" for i in range(args.adapters)]
    if args.adapter_mix:
        weights = [float(w) for w in args.adapter_mix.split(",")]
        if len(weights) != len(tenants) or any(w < 0 for w in weights) \
                or not sum(weights) > 0:
            raise SystemExit(
                f"--adapter-mix needs {len(tenants)} non-negative "
                f"comma-separated weights (base first, then "
                f"{tenants[1:]}), got {args.adapter_mix!r}")
    else:
        weights = [1.0] * len(tenants)
    total = sum(weights)
    return tenants, [w / total for w in weights]


def _parse_tenant_map(spec: str, what: str, cast):
    """``"base:1,a0:4"`` → ``{"base": cast("1"), "a0": cast("4")}``: the
    parser behind --tenant-weights / --priority-mix / --tenant-slo-ms."""
    out = {}
    if not spec:
        return out
    for pair in spec.split(","):
        name, sep, val = pair.partition(":")
        name = name.strip()
        if not sep or not name:
            raise SystemExit(
                f"{what} must be comma-separated tenant:value pairs "
                f"(e.g. 'base:1,a0:4'), got {pair!r}")
        try:
            out[name] = cast(val)
        except ValueError:
            raise SystemExit(f"{what}: bad value {val!r} for {name!r}")
    return out


_ADAPTER_SEED, _ADAPTER_B_SCALE = 100, 0.5


def _bench_adapters(args, cfg, device):
    """The run's LoRA plane: (lora_cfg, {name: adapter tree}), each tree
    drawn from ``torch.Generator(device).manual_seed(100 + i)`` with B
    randomized, so the tenants are distinct fine-tunes."""
    if not args.adapters:
        return None, None
    from .parallel.lora import LoraConfig, init_adapter
    lora = LoraConfig(rank=args.adapter_rank)
    trees = {f"a{i}": init_adapter(
        torch.Generator(device=device).manual_seed(_ADAPTER_SEED + i), cfg,
        lora, b_scale=_ADAPTER_B_SCALE, device=device)
        for i in range(args.adapters)}
    return lora, trees


def gen_model_config(args):
    """The generate-mode ``TransformerConfig``."""
    from .parallel.transformer import TransformerConfig
    dtype, unembed = _gen_dtypes(args)
    return TransformerConfig(**_gen_model(args), dtype=dtype,
                             unembed_dtype=unembed,
                             attn_backend=("pallas" if args.model ==
                                           "bench_lm" else "xla"))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def build_gen_engine(args, model=None):
    """The generate-mode engine (a ``GenerationEngine``, or a
    ``FleetRouter`` of them with ``--replicas``/``--autoscale``/
    ``--replica-procs``), warmed up. ``model`` (a ``Transformer`` on
    ``args.device``) replaces the seeded draw: a test passes
    ``convert.params_from_jax`` of JAX's tree."""
    from . import serve
    from .parallel.transformer import Transformer
    device = torch.device(args.device)
    cfg = gen_model_config(args)
    if model is None:
        model = Transformer(cfg, generator=torch.Generator(
            device=device).manual_seed(0), device=device)
    elif args.replica_procs:
        raise ValueError("a given model cannot reach subprocess replicas: "
                         "each child draws its weights from the spec's "
                         "seed")
    slots, n_blocks, cache_bytes = _gen_capacity(args)
    gcfg = serve.GenerationConfig(
        max_slots=slots, max_len=args.max_len,
        max_queue=args.max_queue, default_deadline_ms=args.deadline_ms,
        default_max_new_tokens=args.gen_tokens,
        kv_layout=args.kv_layout,
        **({"tenant_weights": args.tenant_weights_map}
           if args.tenant_weights_map else {}),
        **({"tenant_priorities": args.priority_mix_map}
           if args.priority_mix_map else {}),
        **({"tenant_slo_ttft_ms": args.tenant_slo_ms_map}
           if args.tenant_slo_ms_map else {}),
        preempt_retries=args.preempt_retries,
        **({"block_size": args.block_size, "n_blocks": n_blocks,
            "prefix_reuse": args.prefix_reuse,
            "paged_kernel": args.paged_kernel,
            "chunked_prefill": args.chunked_prefill,
            "chunk_blocks": args.chunk_blocks,
            "host_blocks": args.host_blocks,
            "host_admission": args.host_admission}
           if args.kv_layout == "paged" else {}))
    if cache_bytes is None:
        if args.kv_layout == "paged":
            cache_bytes = (gcfg.resolved_n_blocks * gcfg.block_size
                           * _gen_bpt(args))
        else:
            cache_bytes = slots * args.max_len * _gen_bpt(args)
    lora, adapter_trees = _bench_adapters(args, cfg, device)
    spec_cfg = serve.SpecConfig(k=args.spec_k) if args.spec_k else None

    def _registry():
        if not adapter_trees:
            return None
        reg = serve.AdapterRegistry(cfg, lora, capacity=len(adapter_trees),
                                    device=device)
        for name, tree in sorted(adapter_trees.items()):
            reg.load(name, tree)
        return reg

    if args.replicas > 1 or args.autoscale or args.replica_procs:
        # Fleet mode: N replicas (each its own slots, pool and adapter
        # table, over the shared read-only model) behind one router.
        if args.replica_procs:
            spec = {
                "model": dict(_gen_model(args),
                              dtype=_dtype_name(cfg.dtype),
                              unembed_dtype=_dtype_name(cfg.unembed_dtype),
                              attn_backend=cfg.attn_backend),
                "seed": 0,
                "device": args.device,
                "generation": dataclasses.asdict(gcfg),
            }
            if spec_cfg is not None:
                spec["spec"] = spec_cfg.to_spec()
            if adapter_trees:
                # Seeds, not bytes: each child draws the same trees.
                spec["adapters"] = {
                    "rank": args.adapter_rank, "alpha": lora.alpha,
                    "capacity": len(adapter_trees),
                    "entries": [{"name": f"a{i}", "seed": _ADAPTER_SEED + i,
                                 "b_scale": _ADAPTER_B_SCALE}
                                for i in range(args.adapters)],
                }
            # The factory adds this process's numerics flags
            # (``torch_backends``) to every child's spec.
            factory = serve.spawn_replica_factory(spec)
        else:
            def factory(name):
                return serve.GenerationEngine(
                    model, gcfg, device=device, adapters=_registry(),
                    spec=spec_cfg)
        initial = args.min_replicas if args.autoscale else args.replicas
        eng = serve.FleetRouter(
            factory=factory, initial=initial,
            adapter_source=(adapter_trees.__getitem__
                            if adapter_trees and not args.replica_procs
                            else None))
        eng.bench_cache_bytes = cache_bytes    # per replica
        t0 = time.monotonic()
        warmed = eng.warmup()
        print(f"warmup [{args.kv_layout}, fleet {len(warmed)} replica(s) "
              f"x slots={slots}]: {time.monotonic() - t0:.2f} s")
        if args.autoscale:
            eng.bench_autoscaler = serve.FleetAutoscaler(
                eng, min_replicas=args.min_replicas,
                max_replicas=args.replicas,
                high_watermark=args.scale_high,
                low_watermark=args.scale_low,
                breach_up=2, breach_down=2,
                cooldown_s=1.0, interval_s=0.25).start()
        return eng
    eng = serve.GenerationEngine(model, gcfg, device=device,
                                 adapters=_registry(), spec=spec_cfg)
    eng.bench_cache_bytes = cache_bytes
    t0 = time.monotonic()
    warmed = eng.warmup()
    n_verify = sum(1 for k in warmed
                   if isinstance(k, tuple) and k and k[0] == "verify")
    print(f"warmup [{args.kv_layout}, slots={slots}]: decode + "
          f"{len(warmed) - 1 - n_verify} prefill buckets"
          f"{f' + {n_verify} verify' if n_verify else ''} "
          f"in {time.monotonic() - t0:.2f} s")
    return eng


def stream_digest(streams) -> str:
    """Completion-order-free digest of token streams: JAX's
    ``sha256(repr(sorted(streams)))``, which matches only over tuples of
    Python ints (a numpy or tensor element reprs differently)."""
    streams = [tuple(int(t) for t in s) for s in streams]
    return hashlib.sha256(repr(sorted(streams)).encode()).hexdigest()


@dataclasses.dataclass
class Arrival:
    """One scheduled arrival of a generate-mode point. ``submit`` is
    False for another tenant's arrival in an ``--adapter-only`` run;
    ``seed`` is the sampling seed (None when greedy); ``cls`` is the
    TTFT class, ``"cold"`` or ``"hit"``."""
    tenant: str
    prompt: list
    shared: bool
    cls: str
    seed: Optional[int]
    submit: bool


def gen_arrivals(args, rng: np.random.RandomState,
                 n: int) -> Iterator[Arrival]:
    """The generate-mode schedule of one point, draw for draw the JAX
    tool's: the tenant from the pick rng (4321) by the ``--adapter-mix``
    weights, the shared-prefix verdict from the mix rng (97, drawn every
    arrival), the prompt from the tenant's rng (``rng`` itself when only
    ``base`` runs, else 7000+i): a length in [4, 17), then the tokens in
    [1, 255). Shared arrivals prepend one of ``--prefix-count`` system
    prefixes (seed 1234 for the first, 4100+j after), round-robin. The
    k-th submitted request of tenant t samples with seed
    9000 + 131·t + k."""
    sys_prefixes = [np.random.RandomState(1234 if j == 0 else 4100 + j)
                    .randint(1, 255, size=args.prefix_tokens).tolist()
                    for j in range(max(1, args.prefix_count))]
    mix_rng = np.random.RandomState(97)
    tenants, weights = _bench_tenants(args)
    pick_rng = np.random.RandomState(4321)
    prompt_rngs = ({"base": rng} if len(tenants) == 1
                   else {t: np.random.RandomState(7000 + i)
                         for i, t in enumerate(tenants)})
    sent_by_tenant = {t: 0 for t in tenants}
    shared_sent = 0
    seen_prefixes = set()
    for _ in range(n):
        t = (tenants[0] if len(tenants) == 1
             else tenants[pick_rng.choice(len(tenants), p=weights)])
        trng = prompt_rngs[t]
        draw = mix_rng.random_sample()
        shared = args.prefix_tokens > 0 and draw < args.prefix_mix
        pfx_idx = shared_sent % len(sys_prefixes)
        if shared:
            shared_sent += 1
        length = trng.randint(4, 17)
        prompt = (sys_prefixes[pfx_idx] if shared else []) + trng.randint(
            1, 255, size=length).tolist()
        if args.adapter_only and t != args.adapter_only:
            yield Arrival(t, prompt, shared, "cold", None, False)
            continue
        # The first shared arrival of a prefix pays the cold prefill.
        cls = "cold"
        if shared:
            cls = "cold" if pfx_idx not in seen_prefixes else "hit"
            seen_prefixes.add(pfx_idx)
        sent_by_tenant[t] += 1
        seed = (9000 + 131 * tenants.index(t) + sent_by_tenant[t]
                if args.temperature > 0 else None)
        yield Arrival(t, prompt, shared, cls, seed, True)


def run_gen_point(eng, qps: float, duration: float,
                  rng: np.random.RandomState, args) -> tuple:
    """One generation operating point: open-loop prompt arrivals from
    :func:`gen_arrivals`; TTFT and per-user tokens/s come from the
    engine-stamped result dicts. Returns ``(row, streams_by_tenant)``."""
    from .exceptions import DeadlineExceededError, ServerOverloadedError
    from .serve import SamplingParams
    device = torch.device(args.device)
    _reset_peak(device)
    gen0 = eng.stats().get("generation") or {}
    n = max(1, int(qps * duration))
    period = 1.0 / qps
    tenants, weights = _bench_tenants(args)
    handles = []
    overload = 0
    sent_by_tenant = {t: 0 for t in tenants}
    start = time.monotonic()
    for i, a in enumerate(gen_arrivals(args, rng, n)):
        delay = start + i * period - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        if not a.submit:
            continue        # reference run: same schedule, one tenant
        sent_by_tenant[a.tenant] += 1
        try:
            kw = {} if a.tenant == "base" else {"adapter": a.tenant}
            if a.seed is not None:
                kw["sampling"] = SamplingParams(
                    temperature=args.temperature, top_k=args.top_k,
                    seed=a.seed)
            handles.append((a.tenant, a.cls, eng.submit(a.prompt, **kw)))
        except ServerOverloadedError:
            overload += 1
    ttft_ms, tps_user, tokens_out = [], [], 0
    ttft_cls = {"hit": [], "cold": []}
    expired, failed = 0, 0
    streams = []
    streams_by_tenant = {t: [] for t in tenants}
    done_by_tenant = {t: 0 for t in tenants}
    ttft_by_tenant = {t: [] for t in tenants}
    for t, cls, h in handles:
        try:
            r = h.result(timeout=120)
            ttft_ms.append(r["ttft_ms"])
            ttft_by_tenant[t].append(r["ttft_ms"])
            ttft_cls[cls].append(r["ttft_ms"])
            tokens_out += r["n_tokens"]
            streams.append(tuple(r["tokens"]))
            streams_by_tenant[t].append(tuple(r["tokens"]))
            done_by_tenant[t] += 1
            if r["tokens_per_sec"] is not None:
                tps_user.append(r["tokens_per_sec"])
        except DeadlineExceededError:
            expired += 1
        except Exception:  # noqa: BLE001 — counted as a failed request
            failed += 1
    wall = time.monotonic() - start
    snap = eng.stats()
    gen = snap["generation"]
    row = {
        "qps_target": qps,
        "sent": sum(sent_by_tenant.values()),
        "completed": len(ttft_ms),
        "ttft_p50_ms": _percentile(ttft_ms, 0.50),
        "ttft_p99_ms": _percentile(ttft_ms, 0.99),
        "tokens_per_sec": tokens_out / wall,
        "tps_user_p50": _percentile(tps_user, 0.50),
        "overload_drops": overload,
        "deadline_drops": expired,
        "failed": failed,
        "slot_fill": snap["batch_fill_ratio"],
        "kv_layout": snap["kv_layout"],
        "max_slots": snap["max_slots"],
        "max_len": snap["max_len"],
        "cache_bytes": getattr(eng, "bench_cache_bytes", None),
        "peak_concurrent_streams": snap["peak_active_slots"],
        "peak_bytes_per_chip": _peak_bytes_per_chip(device),
        "rejected_slots_full": snap["rejected_slots_full"],
        "rejected_blocks_exhausted": snap["rejected_blocks_exhausted"],
        "prefix_hits_total": gen["prefix_hits_total"],
        "prefix_misses_total": gen["prefix_misses_total"],
        "prefix_hit_blocks_total": gen["prefix_hit_blocks_total"],
        "prefix_mix": args.prefix_mix,
        "prefix_count": max(1, args.prefix_count),
        "prefix_hit_rate": (
            lambda h, m: (h / (h + m)) if (h + m) > 0 else None)(
                gen["prefix_hits_total"]
                - gen0.get("prefix_hits_total", 0),
                gen["prefix_misses_total"]
                - gen0.get("prefix_misses_total", 0)),
        "ttft_hit_p50_ms": (_percentile(ttft_cls["hit"], 0.50)
                            if ttft_cls["hit"] else None),
        "ttft_cold_p50_ms": (_percentile(ttft_cls["cold"], 0.50)
                             if ttft_cls["cold"] else None),
        "chunked_prefill": bool(snap.get("chunked_prefill", False)),
        "host_blocks": args.host_blocks,
        "kv_offload_blocks_total": gen.get("kv_offload_blocks_total", 0),
        "kv_prefetch_blocks_total": gen.get("kv_prefetch_blocks_total", 0),
        "prefill_chunks_total": gen.get("prefill_chunks_total", 0),
        "prefill_chunks_skipped_total":
            gen.get("prefill_chunks_skipped_total", 0),
        "last_prefill_bucket": snap.get("last_prefill_bucket"),
        "stream_digest": stream_digest(streams),
        "adapters": args.adapters,
        "adapter_mix": dict(zip(tenants, weights)),
        "adapter_only": args.adapter_only or None,
        "temperature": args.temperature,
        "chaos": args.chaos or None,
        "topology": "process" if args.replica_procs else "thread",
        "tenant_sent": sent_by_tenant,
        "tenant_completed": done_by_tenant,
        "tenant_ttft_ms": {
            t: {"p50": _percentile(xs, 0.50), "p99": _percentile(xs, 0.99)}
            for t, xs in ttft_by_tenant.items() if xs},
        "stream_digests": {t: stream_digest(s)
                           for t, s in streams_by_tenant.items()},
        "rejected_tenant_quota": snap.get("rejected_tenant_quota", 0),
        "tenants": snap.get("tenants") or {},
        "tenant_weights": args.tenant_weights_map or {},
        "priority_mix": args.priority_mix_map or {},
        "tenant_slo_ms": args.tenant_slo_ms_map or {},
        "preemptions": gen.get("preemptions_total", 0),
        "preempt_resumed": gen.get("preempt_resumed_total", 0),
        "preempt_exhausted": gen.get("preempt_exhausted_total", 0),
        "spec_k": int(snap.get("spec_k") or 0),
        "spec_accept_rate": (snap.get("spec") or {}).get("accept_rate"),
        "tokens_per_step": (snap.get("spec") or {}).get("tokens_per_step"),
    }
    if snap.get("adapters_resident") is not None:
        row["adapters_resident"] = snap["adapters_resident"]
    if snap["kv_layout"] == "paged" and "block_size" in snap:
        row["block_size"] = snap["block_size"]
        row["blocks"] = snap.get("blocks")
    if "fleet" in snap:
        row["replicas_ready"] = snap["fleet"]["n_ready"]
        row["replicas"] = snap["fleet"]["replicas"]
        row["scale_events"] = snap["fleet"]["scale_events"]
        row["dispatch"] = snap["fleet"]["dispatch_total"]
        row["failover"] = snap["fleet"]["failover_total"]
        row["stranded"] = snap["fleet"]["streams_stranded_total"]
        if "adapter_dispatch" in snap["fleet"]:
            row["adapter_dispatch"] = snap["fleet"]["adapter_dispatch"]
        if "prefix_dispatch" in snap["fleet"]:
            row["prefix_dispatch"] = snap["fleet"]["prefix_dispatch"]
    return row, streams_by_tenant


def run_point(eng, qps: float, duration: float, rng: np.random.RandomState,
              item_shape) -> dict:
    """One predict-mode operating point; returns its row of the curve."""
    from .exceptions import DeadlineExceededError, ServerOverloadedError
    snap0 = eng.stats()
    n = max(1, int(qps * duration))
    period = 1.0 / qps
    futures = []
    overload = 0
    start = time.monotonic()
    for i in range(n):
        delay = start + i * period - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        x = rng.randn(*item_shape).astype(np.float32)
        try:
            fut = eng.submit(x)
            # Stamp completion on the done callback: collecting results
            # after the send loop would credit early responses with the
            # whole send phase.
            fut.t_done = None
            fut.add_done_callback(
                lambda f, t=time.monotonic: setattr(f, "t_done", t()))
            futures.append((fut, time.monotonic()))
        except ServerOverloadedError:
            overload += 1
    lat_ms, expired, failed = [], 0, 0
    for fut, t_sub in futures:
        try:
            fut.result(timeout=60)
            # result() can return just before the done callback runs.
            for _ in range(1000):
                if fut.t_done is not None:
                    break
                time.sleep(0)
            lat_ms.append(((fut.t_done or time.monotonic()) - t_sub) * 1e3)
        except DeadlineExceededError:
            expired += 1
        except Exception:  # noqa: BLE001 — counted as a failed request
            failed += 1
    wall = time.monotonic() - start
    snap = eng.stats()
    d_rows = snap["batch_rows_total"] - snap0["batch_rows_total"]
    d_live = (snap["batch_live_rows_total"]
              - snap0["batch_live_rows_total"])
    return {
        "qps_target": qps,
        "qps_achieved": len(lat_ms) / wall,
        "sent": n,
        "completed": len(lat_ms),
        "p50_ms": _percentile(lat_ms, 0.50),
        "p99_ms": _percentile(lat_ms, 0.99),
        "overload_drops": overload,
        "deadline_drops": expired,
        "failed": failed,
        "batch_fill": (d_live / d_rows) if d_rows else None,
    }


def fleet_settle(eng, args, lost_streams: int, streams_by_tenant=None):
    """Traffic has stopped: wait for the autoscaler to drain the extra
    replicas and shrink back to the floor, then return the fleet summary
    row (scale events, final membership, dispatch, lost streams, the
    failover totals and the whole run's per-tenant digests)."""
    scaler = getattr(eng, "bench_autoscaler", None)
    if scaler is not None:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            c = eng.counts()
            if (c["ready"] <= args.min_replicas and c["warming"] == 0
                    and c["draining"] == 0):
                break
            time.sleep(0.25)
        scaler.stop()
    snap = eng.stats()
    row = {
        "fleet": True,
        "autoscale": bool(args.autoscale),
        "min_replicas": args.min_replicas,
        "max_replicas": args.replicas,
        "ready_final": snap["fleet"]["n_ready"],
        "draining_final": snap["fleet"]["n_draining"],
        "queue_depth_final": snap["queue_depth"],
        "scale_events": snap["fleet"]["scale_events"],
        "dispatch": snap["fleet"]["dispatch_total"],
        "drained_lost_streams": lost_streams,
        "failover": snap["fleet"]["failover_total"],
        "stranded": snap["fleet"]["streams_stranded_total"],
        "chaos": args.chaos or None,
        "topology": "process" if args.replica_procs else "thread",
        "spec_k": int(snap.get("spec_k") or 0),
        "spec_accept_rate": (snap.get("spec") or {}).get("accept_rate"),
        "tokens_per_step": (snap.get("spec") or {}).get("tokens_per_step"),
    }
    if streams_by_tenant is not None:
        row["stream_digests"] = {t: stream_digest(s)
                                 for t, s in streams_by_tenant.items()}
    if "adapter_dispatch" in snap["fleet"]:
        row["adapter_dispatch"] = snap["fleet"]["adapter_dispatch"]
    if "prefix_dispatch" in snap["fleet"]:
        row["prefix_dispatch"] = snap["fleet"]["prefix_dispatch"]
    return row


def _emit(row: dict, args) -> None:
    print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(row) + "\n")


def run_predict(args, model=None) -> int:
    eng = build_engine(args, model)
    rng = np.random.RandomState(0)
    points = [float(q) for q in str(args.qps).split(",")]
    print(f"{'qps→':>8}{'qps':>9}{'p50 ms':>9}{'p99 ms':>9}"
          f"{'fill':>7}{'overload':>10}{'deadline':>10}")
    dropped_in_deadline = 0
    for q in points:
        row = run_point(eng, q, args.duration, rng, (args.features,))
        # Overload rejects and failures hit requests still within their
        # deadline: the drops the gate counts. Deadline expiries are the
        # contract working, reported but not gated.
        dropped_in_deadline += row["overload_drops"] + row["failed"]
        fill = row["batch_fill"]
        print(f"{row['qps_target']:>8.0f}{row['qps_achieved']:>9.1f}"
              f"{row['p50_ms']:>9.2f}{row['p99_ms']:>9.2f}"
              f"{(fill if fill is not None else 0):>7.2f}"
              f"{row['overload_drops']:>10}{row['deadline_drops']:>10}")
        _emit(row, args)
        if not (np.isfinite(row["p50_ms"]) and np.isfinite(row["p99_ms"])):
            print("FAIL: empty latency report (no request completed)")
            eng.shutdown(drain=False)
            return 1
    eng.shutdown()
    if dropped_in_deadline:
        print(f"FAIL: {dropped_in_deadline} in-deadline requests dropped")
        return 1
    print("SERVE BENCH OK")
    return 0


def run_generate(args, model=None) -> int:
    eng = build_gen_engine(args, model)
    fleet = hasattr(eng, "counts")      # FleetRouter duck-type marker
    rng = np.random.RandomState(0)
    points = [float(q) for q in str(args.qps).split(",")]
    print(f"{'qps→':>8}{'done':>7}{'ttft p50':>10}{'ttft p99':>10}"
          f"{'tok/s':>9}{'tok/s/u':>9}{'fill':>7}{'overload':>10}"
          f"{'deadline':>10}")
    dropped_in_deadline = 0
    failed_total = 0
    total_tps = 0.0
    all_streams: dict = {}
    for q in points:
        row, streams_by_tenant = run_gen_point(eng, q, args.duration,
                                               rng, args)
        for t, s in streams_by_tenant.items():
            all_streams.setdefault(t, []).extend(s)
        dropped_in_deadline += row["overload_drops"] + row["failed"]
        failed_total += row["failed"]
        total_tps += row["tokens_per_sec"]
        print(f"{row['qps_target']:>8.0f}{row['completed']:>7}"
              f"{row['ttft_p50_ms']:>10.2f}{row['ttft_p99_ms']:>10.2f}"
              f"{row['tokens_per_sec']:>9.1f}{row['tps_user_p50']:>9.1f}"
              f"{(row['slot_fill'] or 0):>7.2f}"
              f"{row['overload_drops']:>10}{row['deadline_drops']:>10}")
        _emit(row, args)
        if not (np.isfinite(row["ttft_p50_ms"])
                and np.isfinite(row["ttft_p99_ms"])):
            print("FAIL: empty TTFT report (no request completed)")
            eng.shutdown(drain=False)
            return 1
    if fleet:
        _emit(fleet_settle(eng, args, failed_total, all_streams), args)
    if args.spec_k:
        sp = eng.stats().get("spec") or {}
        ar, tps = sp.get("accept_rate"), sp.get("tokens_per_step")
        print(f"spec: k={args.spec_k}"
              f" accept_rate={ar if ar is None else round(ar, 4)}"
              f" tokens_per_step={tps if tps is None else round(tps, 3)}")
    eng.shutdown()
    if dropped_in_deadline:
        print(f"FAIL: {dropped_in_deadline} in-deadline requests dropped")
        return 1
    if not total_tps > 0:
        print("FAIL: zero aggregate tokens/sec")
        return 1
    print("SERVE BENCH OK")
    return 0


def parser() -> argparse.ArgumentParser:
    """Every flag of the JAX tool, with its name and default, plus the
    port's ``--device`` and ``--model``."""
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve_bench",
        description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="'cuda' (default; exits without a GPU) or 'cpu'")
    p.add_argument("--model", default="tiny", choices=("tiny", "bench_lm"),
                   help="[generate] tiny: the JAX tool's f32 bench model "
                        "(plain attention on the card); bench_lm: the "
                        "bench LM at full width, bf16 (the kernels)")
    p.add_argument("--mode", choices=("predict", "generate"),
                   default="predict",
                   help="predict: single-shot Engine; generate: the "
                        "continuous-batching GenerationEngine")
    p.add_argument("--qps", default="200",
                   help="target request rate; comma-separate for a curve")
    p.add_argument("--duration", type=float, default=5.0,
                   help="seconds per operating point")
    p.add_argument("--features", type=int, default=64)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--batch-timeout-ms", type=float, default=5.0)
    p.add_argument("--max-queue", type=int, default=512)
    p.add_argument("--deadline-ms", type=float, default=1000.0,
                   help="per-request deadline (0 disables)")
    p.add_argument("--slots", type=int, default=8,
                   help="[generate] concurrent decode slots")
    p.add_argument("--max-len", type=int, default=128,
                   help="[generate] KV-cache depth (prompt + generated)")
    p.add_argument("--gen-tokens", type=int, default=16,
                   help="[generate] tokens generated per request")
    p.add_argument("--kv-layout", choices=("contiguous", "paged"),
                   default="contiguous",
                   help="[generate] KV-cache layout")
    p.add_argument("--block-size", type=int, default=16,
                   help="[generate, paged] positions per KV block")
    p.add_argument("--n-blocks", type=int, default=0,
                   help="[generate, paged] pool size incl. the trash "
                        "block (0 = match the contiguous footprint)")
    p.add_argument("--prefix-reuse", action="store_true",
                   help="[generate, paged] share full block-aligned "
                        "prompt prefixes copy-on-write")
    p.add_argument("--paged-kernel", action="store_true",
                   help="[generate, paged] the paged decode-attention "
                        "kernel where the model's shapes take it")
    p.add_argument("--prefix-tokens", type=int, default=0,
                   help="[generate] fixed system-prompt tokens prepended "
                        "to the shared arrivals")
    p.add_argument("--model-dim", type=int, default=0,
                   help="widen the tiny bench model (d_ff = 2*dim; 0 "
                        "keeps it)")
    p.add_argument("--prefix-count", type=int, default=1,
                   help="distinct shared system prefixes, rotated "
                        "round-robin across shared arrivals")
    p.add_argument("--prefix-mix", type=float, default=1.0,
                   help="[generate, --prefix-tokens] fraction of "
                        "requests carrying the shared system prompt")
    p.add_argument("--chunked-prefill", action="store_true",
                   help="[generate, paged, --prefix-reuse] chunked "
                        "prefill from the first non-shared block")
    p.add_argument("--chunk-blocks", type=int, default=1,
                   help="[generate, --chunked-prefill] blocks per "
                        "prefill chunk (power of two)")
    p.add_argument("--host-blocks", type=int, default=0,
                   help="[generate, paged, --prefix-reuse] host-tier "
                        "block pool (0 = device-only)")
    p.add_argument("--host-admission", choices=("wait", "miss"),
                   default="wait",
                   help="[generate, --host-blocks] admission while a "
                        "host-tier prefetch is in flight")
    p.add_argument("--adapters", type=int, default=0,
                   help="[generate] seeded LoRA tenants a0..aN-1 beside "
                        "the base model")
    p.add_argument("--adapter-rank", type=int, default=4,
                   help="[generate, --adapters] LoRA rank")
    p.add_argument("--adapter-mix", default="",
                   help="[generate, --adapters] comma-separated arrival "
                        "weights, base first then a0..aN-1")
    p.add_argument("--adapter-only", default="",
                   help="[generate, --adapters] replay the schedule "
                        "submitting only this tenant's requests")
    p.add_argument("--tenant-weights", default="",
                   help="[generate] fair-scheduling weights, "
                        "tenant:weight pairs")
    p.add_argument("--priority-mix", default="",
                   help="[generate] strict priority classes, "
                        "tenant:priority pairs")
    p.add_argument("--tenant-slo-ms", default="",
                   help="[generate] per-tenant TTFT SLO targets, "
                        "tenant:ms pairs")
    p.add_argument("--preempt-retries", type=int, default=3,
                   help="[generate] evictions a stream survives before "
                        "preempted_exhausted")
    p.add_argument("--replicas", type=int, default=1,
                   help="[generate] engine replicas behind one "
                        "FleetRouter (with --autoscale, the ceiling)")
    p.add_argument("--replica-procs", action="store_true",
                   help="[generate] each replica a subprocess worker "
                        "(python -m horovod_tpu_torch.serve.proc_replica)")
    p.add_argument("--autoscale", action="store_true",
                   help="[generate] grow and shrink the fleet between "
                        "--min-replicas and --replicas")
    p.add_argument("--min-replicas", type=int, default=1,
                   help="[generate, --autoscale] fleet floor")
    p.add_argument("--scale-high", type=float, default=4.0,
                   help="[generate, --autoscale] grow watermark: queued "
                        "work per ready replica")
    p.add_argument("--scale-low", type=float, default=0.5,
                   help="[generate, --autoscale] shrink watermark")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="[generate] sampling temperature (0 = greedy); "
                        ">0 samples with a per-(tenant, arrival) seed")
    p.add_argument("--top-k", type=int, default=0,
                   help="[generate, --temperature>0] top-k cutoff "
                        "(0 = full vocab)")
    p.add_argument("--spec-k", type=int, default=0,
                   help="[generate] speculative decoding: up to K drafted "
                        "tokens a step (0 = off)")
    p.add_argument("--chaos", default="",
                   help="[generate] serving-plane HVD_FAULT_SPEC clause(s) "
                        "armed for this run, e.g. 'replica_kill=r1@stream=3'")
    p.add_argument("--cache-mb", type=float, default=0,
                   help="[generate] fixed KV-cache byte budget (0 = use "
                        "--slots)")
    p.add_argument("--json", default="",
                   help="append one JSON line per operating point (and "
                        "the fleet line) to this file")
    return p


def check_args(p: argparse.ArgumentParser, args) -> None:
    """The JAX tool's argument checks (each a ``p.error``, exit 2), in
    its order, then the port's device check. May arm ``--chaos``."""
    if args.deadline_ms == 0:
        args.deadline_ms = None
    if args.replicas < 1:
        p.error("--replicas must be >= 1")
    if args.min_replicas < 1:
        p.error("--min-replicas must be >= 1 (a fleet of zero serves "
                "nothing)")
    if args.autoscale and args.min_replicas > args.replicas:
        p.error("--min-replicas must be <= --replicas (the grow ceiling)")
    if args.adapters < 0:
        p.error("--adapters must be >= 0")
    if args.adapters and args.mode != "generate":
        p.error("--adapters applies to --mode generate only")
    if args.replica_procs and args.mode != "generate":
        p.error("--replica-procs applies to --mode generate only")
    if args.spec_k < 0:
        p.error("--spec-k must be >= 0 (0 = speculation off)")
    if args.spec_k and args.mode != "generate":
        p.error("--spec-k applies to --mode generate only")
    if args.temperature < 0:
        p.error("--temperature must be >= 0 (0 = greedy)")
    if args.top_k < 0:
        p.error("--top-k must be >= 0 (0 = full vocab)")
    if args.chaos:
        if args.mode != "generate":
            p.error("--chaos applies to --mode generate only (serving-"
                    "plane clauses fire inside the generation engine "
                    "loop)")
        from .testing import faults
        try:
            clauses = faults.parse_spec(args.chaos)
        except faults.FaultSpecError as e:
            p.error(str(e))
        if not any(f.target == "serve" for f in clauses):
            p.error(f"--chaos {args.chaos!r} has no serving-plane clause "
                    f"(replica_kill= / replica_hang= / "
                    f"replica_proc_kill= / slow_step=)")
        if any(f.action == "replica_proc_kill" for f in clauses) \
                and not args.replica_procs:
            p.error("--chaos replica_proc_kill needs --replica-procs: "
                    "the clause SIGKILLs the replica's own PROCESS, "
                    "which in a thread fleet is the bench itself")
        if any(f.action in ("replica_kill", "replica_hang",
                            "replica_proc_kill") for f in clauses) \
                and args.replicas <= 1 and not args.autoscale:
            p.error("--chaos replica_kill/replica_hang needs a fleet "
                    "(--replicas >= 2 or --autoscale): replica names "
                    "are stamped by the FleetRouter")
    if args.adapter_mix and not args.adapters:
        p.error("--adapter-mix needs --adapters N")
    if not 0.0 <= args.prefix_mix <= 1.0:
        p.error("--prefix-mix must be in [0, 1]")
    if args.model_dim and (args.model_dim < 4 or args.model_dim % 4):
        p.error("--model-dim must be a positive multiple of 4 (the "
                "bench model has 4 heads)")
    if args.model_dim and args.model != "tiny":
        p.error("--model-dim widens the tiny model only")
    if args.prefix_count < 1:
        p.error("--prefix-count must be >= 1")
    if args.prefix_count > 1 and not args.prefix_tokens:
        p.error("--prefix-count > 1 needs --prefix-tokens N")
    if args.prefix_mix != 1.0:
        if args.mode != "generate":
            p.error("--prefix-mix applies to --mode generate only")
        if not args.prefix_tokens:
            p.error("--prefix-mix needs --prefix-tokens N (without a "
                    "shared system prompt there is nothing to mix)")
    if args.chunked_prefill or args.host_blocks:
        what = "--chunked-prefill" if args.chunked_prefill \
            else "--host-blocks"
        if args.mode != "generate" or args.kv_layout != "paged":
            p.error(f"{what} needs --mode generate --kv-layout paged")
        if not args.prefix_reuse:
            p.error(f"{what} needs --prefix-reuse (its whole point is "
                    f"the prefix cache)")
    if args.chunk_blocks < 1:
        p.error("--chunk-blocks must be >= 1")
    if args.host_blocks < 0:
        p.error("--host-blocks must be >= 0")
    try:
        args.tenant_weights_map = _parse_tenant_map(
            args.tenant_weights, "--tenant-weights", float)
        args.priority_mix_map = _parse_tenant_map(
            args.priority_mix, "--priority-mix", int)
        args.tenant_slo_ms_map = _parse_tenant_map(
            args.tenant_slo_ms, "--tenant-slo-ms", float)
    except SystemExit as e:
        p.error(str(e))
    if (args.tenant_weights_map or args.priority_mix_map
            or args.tenant_slo_ms_map) and args.mode != "generate":
        p.error("--tenant-weights/--priority-mix/--tenant-slo-ms apply "
                "to --mode generate only")
    if args.mode == "generate":
        try:
            tenants, _ = _bench_tenants(args)
        except SystemExit as e:
            p.error(str(e))
        if args.adapter_only and args.adapter_only not in tenants:
            p.error(f"--adapter-only must be one of {tenants} "
                    f"(set --adapters first)")
        for what, m in (("--tenant-weights", args.tenant_weights_map),
                        ("--priority-mix", args.priority_mix_map),
                        ("--tenant-slo-ms", args.tenant_slo_ms_map)):
            bad = [t for t in m if t not in tenants]
            if bad:
                p.error(f"{what} names unknown tenant(s) {bad}: this "
                        f"run's tenants are {tenants} (set --adapters)")
    elif args.adapter_only:
        p.error("--adapter-only applies to --mode generate only")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "horovod_tpu_torch.serve_bench runs on a CUDA device, but "
            "torch.cuda.is_available() is False; pass --device cpu")
    if args.chaos:
        # Armed through the one env knob every injection rides; the
        # engine loops read it, so before any engine is built.
        from .testing import faults
        os.environ["HVD_FAULT_SPEC"] = args.chaos
        faults.reset()


def main(argv=None, model=None) -> int:
    """Parse ``argv`` and run the bench; returns the exit status.
    ``model`` (the predict MLP or the generate ``Transformer``) replaces
    the seeded draw."""
    p = parser()
    args = p.parse_args(argv)
    armed = os.environ.get("HVD_FAULT_SPEC")
    check_args(p, args)
    try:
        if args.mode == "generate":
            return run_generate(args, model)
        return run_predict(args, model)
    finally:
        if args.chaos:
            # Disarm, so a caller's later engines in this process run
            # clean (child replicas read the spec at their start).
            from .testing import faults
            if armed is None:
                os.environ.pop("HVD_FAULT_SPEC", None)
            else:
                os.environ["HVD_FAULT_SPEC"] = armed
            faults.reset()


if __name__ == "__main__":
    sys.exit(main())

"""Serving plane of the port: the single-shot bucketed batching
:class:`Engine`, the continuous-batching generation engine (paged or
contiguous KV, prefix reuse, chunked prefill, the host tier, speculative
decoding, multi-tenant LoRA adapters with the fair scheduler, block
budgets and preemption), their HTTP front end with Prometheus
``/metrics``, the serving fleet (:class:`FleetRouter` over thread or
subprocess replicas, deterministic failover, :class:`FleetAutoscaler`),
and the restore of a trained checkpoint or adapter into serving weights
— f32, bf16 or int8 (re-exported as the JAX package's ``serve`` does).

    from horovod_tpu_torch import convert, serve
    params = serve.restore_for_inference(ckpt_dir, dtype="int8")["params"]
    model = convert.params_from_jax(params, cfg)
    gen = serve.GenerationEngine(model, serve.GenerationConfig(
        max_slots=8, max_len=512))
    eng = serve.Engine(lambda m, x: m(x, train=False), resnet,
                       item_shape=(224, 224, 3))
    gen.warmup(); eng.warmup()
    serve.HttpServer(eng, generate=gen).start()

    # A fleet: two replicas behind one door, failover and autoscaling.
    router = serve.FleetRouter(factory=lambda name: serve.GenerationEngine(
        model, serve.GenerationConfig(max_slots=8, max_len=512)), initial=2)
    router.warmup()
    serve.FleetAutoscaler(router, min_replicas=1, max_replicas=4).start()
    serve.HttpServer(generate=router).start()
"""

from ..exceptions import (DeadlineExceededError, FailoverExhaustedError,
                          PreemptedError, ReplicaTimeoutError,
                          ServerClosedError, ServerOverloadedError)
from ..parallel.checkpoint import (INFERENCE_DTYPES, restore_adapter,
                                   restore_for_inference, save_adapter)
from ..parallel.kv_blocks import (BlockManager, blocks_for,
                                  init_paged_kv_cache, paged_decode_step,
                                  paged_kv_cache_specs, paged_prefill,
                                  paged_verify_step)
from ..parallel.lora import (LoraConfig, adapter_bytes, check_adapter_name,
                             init_adapter, stack_adapters)
from ..parallel.transformer import (decode_step, init_kv_cache,
                                    kv_cache_specs, prefill, verify_step)

from .adapters import AdapterRegistry
from .batcher import (Request, RequestQueue, bucket_for, bucket_sizes,
                      pad_rows)
from .engine import SERVE_PHASES, Engine, ReadinessMixin, ServeConfig
from .generate import (GenerationConfig, GenerationEngine, GenerationHandle,
                       SamplingParams, prefill_buckets)
from .metrics import FleetMetrics, ServeMetrics, collect_stats
from .sched import FairScheduler
from .router import FleetRouter, ReplicaHandle
from .fleet import FleetAutoscaler, heartbeat_liveness
from .server import HttpServer
from .spec import DraftProposer, NgramProposer, SpecConfig

__all__ = ["Engine", "ServeConfig", "SERVE_PHASES", "Request",
           "bucket_sizes", "pad_rows", "INFERENCE_DTYPES",
           "GenerationEngine", "GenerationConfig", "GenerationHandle",
           "SamplingParams", "prefill_buckets", "HttpServer",
           "RequestQueue", "bucket_for", "ReadinessMixin", "ServeMetrics",
           "collect_stats", "restore_for_inference", "DraftProposer",
           "NgramProposer", "SpecConfig", "AdapterRegistry",
           "FairScheduler", "LoraConfig", "adapter_bytes",
           "check_adapter_name", "init_adapter", "stack_adapters",
           "save_adapter", "restore_adapter", "BlockManager", "blocks_for",
           "init_paged_kv_cache", "paged_prefill", "paged_decode_step",
           "paged_verify_step", "init_kv_cache", "prefill", "decode_step",
           "verify_step", "kv_cache_specs", "paged_kv_cache_specs",
           "PreemptedError", "DeadlineExceededError",
           "ServerClosedError", "ServerOverloadedError", "FleetMetrics",
           "FleetRouter", "ReplicaHandle", "FleetAutoscaler",
           "heartbeat_liveness", "FailoverExhaustedError",
           "ReplicaTimeoutError", "ProcReplicaClient",
           "spawn_replica_factory"]

_PROC_REPLICA_NAMES = ("ProcReplicaClient", "spawn_replica_factory")


def __getattr__(name):
    # Lazy (PEP 562): ``python -m horovod_tpu_torch.serve.proc_replica``,
    # the worker's entry point, imports this package first, and an eager
    # import of the module here would put it in sys.modules before runpy
    # runs it as __main__ (run twice, with a RuntimeWarning in every
    # child).
    if name in _PROC_REPLICA_NAMES:
        from . import proc_replica
        return getattr(proc_replica, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

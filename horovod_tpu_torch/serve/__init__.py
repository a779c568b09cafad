"""Serving plane of the port: the single-shot bucketed batching
:class:`Engine`, the continuous-batching generation engine (paged or
contiguous KV, prefix reuse, chunked prefill, the host tier, speculative
decoding, multi-tenant LoRA adapters with the fair scheduler, block
budgets and preemption), their HTTP front end with Prometheus
``/metrics``, and the restore of a trained checkpoint or adapter into
serving weights — f32, bf16 or int8 (re-exported as the JAX package's
``serve`` does).

    from horovod_tpu_torch import convert, serve
    params = serve.restore_for_inference(ckpt_dir, dtype="int8")["params"]
    gen = serve.GenerationEngine(convert.params_from_jax(params, cfg),
                                 serve.GenerationConfig(max_slots=8,
                                                        max_len=512))
    eng = serve.Engine(lambda m, x: m(x, train=False), resnet,
                       item_shape=(224, 224, 3))
    gen.warmup(); eng.warmup()
    serve.HttpServer(eng, generate=gen).start()
"""

from ..exceptions import (DeadlineExceededError, PreemptedError,
                          ServerClosedError, ServerOverloadedError)
from ..parallel.checkpoint import (INFERENCE_DTYPES, restore_adapter,
                                   restore_for_inference, save_adapter)
from ..parallel.kv_blocks import (BlockManager, blocks_for,
                                  init_paged_kv_cache, paged_decode_step,
                                  paged_prefill, paged_verify_step)
from ..parallel.lora import (LoraConfig, adapter_bytes, check_adapter_name,
                             init_adapter, stack_adapters)
from ..parallel.transformer import (decode_step, init_kv_cache, prefill,
                                    verify_step)

from .adapters import AdapterRegistry
from .batcher import (Request, RequestQueue, bucket_for, bucket_sizes,
                      pad_rows)
from .engine import SERVE_PHASES, Engine, ReadinessMixin, ServeConfig
from .generate import (GenerationConfig, GenerationEngine, GenerationHandle,
                       SamplingParams, prefill_buckets)
from .metrics import ServeMetrics, collect_stats
from .sched import FairScheduler
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
           "verify_step", "PreemptedError", "DeadlineExceededError",
           "ServerClosedError", "ServerOverloadedError"]

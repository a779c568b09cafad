"""Serving plane of the port: the continuous-batching generation engine
(paged or contiguous KV, prefix reuse, chunked prefill, the host tier,
speculative decoding, multi-tenant LoRA adapters with the fair scheduler,
block budgets and preemption) and its HTTP front end, and the restore of
a trained checkpoint or adapter into serving weights (re-exported as the
JAX package's ``serve`` does)."""

from ..exceptions import (DeadlineExceededError, PreemptedError,
                          ServerClosedError, ServerOverloadedError)
from ..parallel.checkpoint import (restore_adapter, restore_for_inference,
                                   save_adapter)
from ..parallel.lora import (LoraConfig, adapter_bytes, check_adapter_name,
                             init_adapter, stack_adapters)

from .adapters import AdapterRegistry
from .batcher import RequestQueue, bucket_for
from .engine import ReadinessMixin
from .generate import (GenerationConfig, GenerationEngine, GenerationHandle,
                       SamplingParams, prefill_buckets)
from .metrics import ServeMetrics
from .sched import FairScheduler
from .server import HttpServer
from .spec import DraftProposer, NgramProposer, SpecConfig

__all__ = ["GenerationEngine", "GenerationConfig", "GenerationHandle",
           "SamplingParams", "prefill_buckets", "HttpServer",
           "RequestQueue", "bucket_for", "ReadinessMixin", "ServeMetrics",
           "restore_for_inference", "DraftProposer", "NgramProposer",
           "SpecConfig", "AdapterRegistry", "FairScheduler", "LoraConfig",
           "adapter_bytes", "check_adapter_name", "init_adapter",
           "stack_adapters", "save_adapter", "restore_adapter",
           "PreemptedError", "DeadlineExceededError", "ServerClosedError",
           "ServerOverloadedError"]

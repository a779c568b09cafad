"""Serving plane of the port: the continuous-batching generation engine
(paged or contiguous KV, prefix reuse, chunked prefill, the host tier,
speculative decoding) and its HTTP front end, and the restore of a
trained checkpoint into serving weights (``restore_for_inference``,
re-exported as the JAX package's ``serve`` does)."""

from ..parallel.checkpoint import restore_for_inference

from .batcher import RequestQueue, bucket_for
from .engine import ReadinessMixin
from .generate import (GenerationConfig, GenerationEngine, GenerationHandle,
                       SamplingParams, prefill_buckets)
from .metrics import ServeMetrics
from .server import HttpServer
from .spec import DraftProposer, NgramProposer, SpecConfig

__all__ = ["GenerationEngine", "GenerationConfig", "GenerationHandle",
           "SamplingParams", "prefill_buckets", "HttpServer",
           "RequestQueue", "bucket_for", "ReadinessMixin", "ServeMetrics",
           "restore_for_inference", "DraftProposer", "NgramProposer",
           "SpecConfig"]

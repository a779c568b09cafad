"""Serving plane of the port: the paged continuous-batching generation
engine and its HTTP front end."""

from .batcher import RequestQueue, bucket_for
from .engine import ReadinessMixin
from .generate import (GenerationConfig, GenerationEngine, GenerationHandle,
                       SamplingParams, prefill_buckets)
from .metrics import ServeMetrics
from .server import HttpServer

__all__ = ["GenerationEngine", "GenerationConfig", "GenerationHandle",
           "SamplingParams", "prefill_buckets", "HttpServer",
           "RequestQueue", "bucket_for", "ReadinessMixin", "ServeMetrics"]

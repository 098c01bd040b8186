"""Serving stack of the port: scheduler-driven continuous batching over
fixed decode lanes, on dense KV lanes or the paged KV pool.

* :mod:`.scheduler` — FIFO admission + time-slice preemption;
* :mod:`.kvcache` — the dense per-lane (KV or SSM state) and the paged
  KV backends;
* :mod:`.buckets` — the shared length-bucket ladders;
* :mod:`.sampling` — per-request temperature / top-k / top-p;
* :mod:`.metrics` — TTFT / inter-token latency / throughput;
* :mod:`.engine` — the orchestrator, each tick split into ``schedule`` /
  ``dispatch`` / ``emit``;
* :mod:`.gateway` — the async HTTP/SSE front-end: a pipelined tick loop
  that waits on each tick's CUDA event off the event loop, per-token
  streaming, admission backpressure, cancellation on disconnect.
"""
from .buckets import LENGTH_BUCKETS, REDUCED_BUCKETS
from .engine import LaneState, Request, ServingEngine, TickWork, length_bucket
from .kvcache import (NULL_PAGE, DenseKVCache, PagedKVCache, PageHandle,
                      make_kv_cache)
from .metrics import ServingMetrics
from .sampling import SamplingParams
from .scheduler import Scheduler

__all__ = ["ServingEngine", "Request", "LaneState", "TickWork",
           "length_bucket", "LENGTH_BUCKETS", "REDUCED_BUCKETS",
           "DenseKVCache", "PagedKVCache", "PageHandle", "NULL_PAGE",
           "make_kv_cache", "ServingMetrics",
           "SamplingParams", "Scheduler"]

"""Async serving gateway: pipelined tick loop + HTTP/SSE front-end.

The gateway turns the single-process
:class:`~repro_torch.serving.engine.ServingEngine` into something a
client (a load generator, ``curl``, a browser) can talk to:

* :mod:`.pipeline` — :class:`PipelinedEngine`, the asyncio tick loop.
  It splits each engine tick into the engine's ``schedule`` /
  ``dispatch`` / ``emit`` phases and waits on the tick's CUDA event in a
  worker thread, so network I/O and the next tick's admission work
  overlap whatever device work is still running (double-buffered ticks).
  Greedy outputs are identical to the synchronous ``Engine.run()`` loop.
* :mod:`.server` — :class:`GatewayServer`, a dependency-free asyncio
  HTTP/1.1 server with per-token SSE streaming, a bounded admission
  queue with backpressure (429 + ``Retry-After`` when full), per-request
  cancellation on client disconnect (pages and prefix refcounts release
  cleanly), and graceful drain on shutdown.
* :mod:`.client` — minimal asyncio HTTP/SSE client helpers shared by
  ``serve --gateway`` and the tests.

The concurrency knobs — pipeline depth x admission batch
(:class:`GatewayPolicyKnobs`) — are fixed, or tuned at run time by the
``GatewayPolicy`` region of a ``tuner`` (``PipelinedEngine(tuner=...)``).
"""
from .client import get_json, post_json, sse_generate
from .pipeline import GatewayPolicyKnobs, PipelinedEngine, TokenStream
from .server import GatewayServer

__all__ = ["PipelinedEngine", "TokenStream", "GatewayPolicyKnobs",
           "GatewayServer", "sse_generate", "post_json", "get_json"]

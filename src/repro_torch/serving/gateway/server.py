"""Dependency-free asyncio HTTP/1.1 + SSE front-end for the gateway.

A copy of the JAX package's server: it needs nothing beyond the
standard library, so it is built on ``asyncio.start_server`` directly —
a small HTTP/1.1 request parser, an SSE response writer, and three
routes.

* ``POST /v1/generate`` — body ``{"prompt": [ids], "max_new_tokens": n,
  "sampling": {temperature, top_k, top_p, seed}}``.  The handler stamps
  ``submit_t`` the moment the request is parsed — *before* any queueing
  — so queue-wait percentiles measure the full gateway-side delay.  The
  response streams Server-Sent Events: ``data: {"tokens": [...]}`` per
  emission, then one ``event: done`` frame carrying ``n_tokens``,
  ``queue_wait_s``, ``ttft_s`` and ``cached_tokens``.  A full admission
  queue answers ``429`` with a ``Retry-After`` hint instead of queueing
  unboundedly (backpressure is the contract: the load generator counts
  these); a draining gateway answers ``503``.
* ``GET /healthz`` — liveness + drain state.
* ``GET /v1/stats`` — the pipeline's counters, its knobs and its host
  time by tick phase.

Client disconnects are detected two ways — the socket reaches EOF (a
watcher task polls the reader), or an SSE write fails — and both funnel
into ``PipelinedEngine.cancel``, which applies the cancellation at the
next tick boundary and releases the lane's pages and prefix refcounts.
A disconnect therefore never leaks pool pages (asserted by test).

Shutdown is a graceful drain: stop accepting connections, let admitted
work finish streaming, then close.
"""
from __future__ import annotations

import asyncio
import json
import time

from ..sampling import SamplingParams
from .pipeline import Draining, PipelinedEngine, QueueFull

__all__ = ["GatewayServer"]

_MAX_BODY = 8 * 1024 * 1024


def _sampling_from(obj: dict | None) -> SamplingParams | None:
    if not obj:
        return None
    return SamplingParams(temperature=float(obj.get("temperature", 0.0)),
                          top_k=int(obj.get("top_k", 0)),
                          top_p=float(obj.get("top_p", 1.0)),
                          seed=int(obj.get("seed", 0)))


async def _read_request(reader: asyncio.StreamReader):
    """Parse one HTTP/1.1 request; returns (method, path, headers, body)
    or None on EOF / malformed input."""
    try:
        line = await reader.readline()
    except (ConnectionResetError, asyncio.IncompleteReadError):
        return None
    if not line:
        return None
    parts = line.decode("latin-1").strip().split()
    if len(parts) != 3:
        return None
    method, path, _version = parts
    headers: dict[str, str] = {}
    while True:
        raw = await reader.readline()
        if raw in (b"\r\n", b"\n", b""):
            break
        if b":" in raw:
            k, v = raw.decode("latin-1").split(":", 1)
            headers[k.strip().lower()] = v.strip()
    length = int(headers.get("content-length", "0") or "0")
    if length > _MAX_BODY:
        return None
    body = await reader.readexactly(length) if length else b""
    return method, path, headers, body


def _response(status: str, payload: dict, extra: dict | None = None) -> bytes:
    body = json.dumps(payload).encode()
    headers = [f"HTTP/1.1 {status}",
               "Content-Type: application/json",
               f"Content-Length: {len(body)}",
               "Connection: close"]
    for k, v in (extra or {}).items():
        headers.append(f"{k}: {v}")
    return ("\r\n".join(headers) + "\r\n\r\n").encode() + body


def _sse_frame(data: dict, event: str | None = None) -> bytes:
    head = f"event: {event}\n" if event else ""
    return (head + "data: " + json.dumps(data) + "\n\n").encode()


class GatewayServer:
    """HTTP/SSE front door for one :class:`PipelinedEngine`."""

    def __init__(self, pipe: PipelinedEngine, host: str = "127.0.0.1",
                 port: int = 0, retry_after_s: int = 1):
        self.pipe = pipe
        self.host = host
        self.port = port
        self.retry_after_s = retry_after_s
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        """Bind the listener and start the pipelined tick loop."""
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self.pipe.start()

    async def drain(self) -> None:
        """Graceful shutdown: refuse new connections, serve out every
        admitted request's stream, then stop the tick loop."""
        if self._server is not None:
            self._server.close()
        await self.pipe.drain()
        if self._server is not None:
            await self._server.wait_closed()

    # ------------------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            parsed = await _read_request(reader)
            if parsed is None:
                return
            method, path, _headers, body = parsed
            if method == "GET" and path == "/healthz":
                writer.write(_response("200 OK", {
                    "ok": self.pipe._loop_error is None,
                    "draining": self.pipe._draining}))
                await writer.drain()
            elif method == "GET" and path == "/v1/stats":
                writer.write(_response("200 OK", self.pipe.stats()))
                await writer.drain()
            elif method == "POST" and path == "/v1/generate":
                await self._generate(reader, writer, body)
            else:
                writer.write(_response("404 Not Found",
                                       {"error": f"no route {path}"}))
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, TimeoutError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _generate(self, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter, body: bytes) -> None:
        submit_t = time.monotonic()   # arrival: queue wait starts here
        try:
            spec = json.loads(body.decode() or "{}")
            prompt = [int(t) for t in spec["prompt"]]
            max_new = int(spec.get("max_new_tokens", 16))
            sampling = _sampling_from(spec.get("sampling"))
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            writer.write(_response("400 Bad Request", {"error": str(e)}))
            await writer.drain()
            return
        try:
            stream = self.pipe.submit(prompt, max_new_tokens=max_new,
                                      sampling=sampling, submit_t=submit_t)
        except QueueFull:
            writer.write(_response(
                "429 Too Many Requests",
                {"error": "admission queue full"},
                {"Retry-After": str(self.retry_after_s)}))
            await writer.drain()
            return
        except Draining:
            writer.write(_response("503 Service Unavailable",
                                   {"error": "gateway draining"}))
            await writer.drain()
            return

        rid = stream.req.rid
        writer.write(("HTTP/1.1 200 OK\r\n"
                      "Content-Type: text/event-stream\r\n"
                      "Cache-Control: no-cache\r\n"
                      "Connection: close\r\n\r\n").encode())
        # EOF on the request socket = the client went away mid-stream
        watcher = asyncio.ensure_future(reader.read())
        try:
            while True:
                getter = asyncio.ensure_future(stream.next_event())
                await asyncio.wait({getter, watcher},
                                   return_when=asyncio.FIRST_COMPLETED)
                if not getter.done():     # disconnect won the race
                    getter.cancel()
                    self.pipe.cancel(rid)
                    return
                kind, payload = getter.result()
                if kind == "tokens":
                    writer.write(_sse_frame({"tokens": payload}))
                else:                     # done / cancelled: final frame
                    writer.write(_sse_frame(payload, event=kind))
                    await writer.drain()
                    return
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            self.pipe.cancel(rid)
        finally:
            watcher.cancel()

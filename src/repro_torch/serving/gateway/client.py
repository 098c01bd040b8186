"""Minimal asyncio HTTP/SSE client for the gateway.

A copy of the JAX package's client, used by ``serve --gateway`` and the
tests: just enough HTTP/1.1 over ``asyncio.open_connection`` to POST
JSON, read a JSON response, and iterate an SSE stream — no third-party
HTTP stack.

:func:`sse_generate` is the closed-loop clients' workhorse: it POSTs one
generate request, then yields each SSE event as ``(kind, payload)``
pairs, stamping client-side receive times so TTFT/ITL can be measured
*end to end* (network + queueing + compute), not just inside the engine.
Non-200 responses surface as a single ``("http_error", {...})`` event
(the 429 backpressure path included) rather than an exception, so the
closed loop can count rejections and retry.
"""
from __future__ import annotations

import asyncio
import json

__all__ = ["sse_generate", "post_json", "get_json"]


async def _request(host: str, port: int, method: str, path: str,
                   body: bytes = b""):
    reader, writer = await asyncio.open_connection(host, port)
    head = (f"{method} {path} HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n").encode()
    writer.write(head + body)
    await writer.drain()
    status_line = await reader.readline()
    status = int(status_line.split()[1])
    headers: dict[str, str] = {}
    while True:
        raw = await reader.readline()
        if raw in (b"\r\n", b"\n", b""):
            break
        if b":" in raw:
            k, v = raw.decode("latin-1").split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return reader, writer, status, headers


async def _read_body(reader: asyncio.StreamReader,
                     headers: dict[str, str]) -> bytes:
    n = int(headers.get("content-length", "0") or "0")
    return await reader.readexactly(n) if n else await reader.read()


async def post_json(host: str, port: int, path: str,
                    payload: dict) -> tuple[int, dict]:
    """POST JSON, return ``(status, parsed-body)``."""
    body = json.dumps(payload).encode()
    reader, writer, status, headers = await _request(
        host, port, "POST", path, body)
    try:
        raw = await _read_body(reader, headers)
        return status, (json.loads(raw.decode()) if raw else {})
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass


async def get_json(host: str, port: int, path: str) -> tuple[int, dict]:
    """GET a JSON route, return ``(status, parsed-body)``."""
    reader, writer, status, headers = await _request(
        host, port, "GET", path)
    try:
        raw = await _read_body(reader, headers)
        return status, (json.loads(raw.decode()) if raw else {})
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass


async def sse_generate(host: str, port: int, prompt: list[int],
                       max_new_tokens: int = 16,
                       sampling: dict | None = None,
                       disconnect_after: int | None = None):
    """POST ``/v1/generate`` and yield SSE events as ``(kind, payload)``.

    ``kind`` is ``"tokens"`` (payload: token-id list), ``"done"`` /
    ``"cancelled"`` (payload: the final info dict), or ``"http_error"``
    (payload: ``{"status": ..., "body": ..., "retry_after": ...}``) when
    the gateway answers with a non-200 — a 429 bounce shows up here.

    ``disconnect_after`` closes the socket after that many *token
    events* without reading the rest of the stream — the client-abandons-
    mid-stream path the leak test drives.
    """
    payload: dict = {"prompt": prompt, "max_new_tokens": max_new_tokens}
    if sampling:
        payload["sampling"] = sampling
    body = json.dumps(payload).encode()
    reader, writer, status, headers = await _request(
        host, port, "POST", "/v1/generate", body)
    try:
        if status != 200:
            raw = await _read_body(reader, headers)
            try:
                parsed = json.loads(raw.decode()) if raw else {}
            except json.JSONDecodeError:
                parsed = {"raw": raw.decode("latin-1", "replace")}
            yield "http_error", {"status": status, "body": parsed,
                                 "retry_after": headers.get("retry-after")}
            return
        token_events = 0
        event_name = None
        data_lines: list[str] = []
        while True:
            raw = await reader.readline()
            if not raw:
                return
            line = raw.decode().rstrip("\n").rstrip("\r")
            if line.startswith("event:"):
                event_name = line[len("event:"):].strip()
            elif line.startswith("data:"):
                data_lines.append(line[len("data:"):].strip())
            elif line == "" and data_lines:      # frame boundary
                data = json.loads("\n".join(data_lines))
                kind = event_name or "tokens"
                event_name, data_lines = None, []
                if kind == "tokens":
                    token_events += 1
                    yield kind, data["tokens"]
                    if disconnect_after is not None \
                            and token_events >= disconnect_after:
                        return          # finally closes the socket early
                else:
                    yield kind, data
                    if kind in ("done", "cancelled"):
                        return
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass

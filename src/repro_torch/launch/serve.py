"""Serve entry point of the port: the serving engine on synthetic requests.

Builds the arch with random weights from ``--seed`` on ``--device``
(default ``cuda``; it raises without a card), submits ``--requests``
synthetic prompts, runs the engine to completion and reports throughput
and latency percentiles.  ``--full`` serves the published widths of the
arch; ``--reduced`` (the default, as in the JAX package's serve) serves the
small test config.  ``--cache paged`` serves from the paged KV pool
(``--pages``, ``--page-size``), and ``--prefill-chunk N`` streams prompts
into it N tokens per tick.  ``--kv-dtype int8`` stores the pool's pages
as int8 with per-row float32 scales, and ``--num-splits N`` splits each
paged decode and verify step's page walk into N parallel segments
(split-KV).  ``--draft`` decodes speculatively (paged only): a draft made
of the target's leading half of layers proposes ``--spec-k`` tokens per
tick and the target verifies them in one chunk.  ``--prefix-cache``
(paged + chunked prefill) seeds admissions with indexed pages of earlier
prompts, and ``--shared-prefix N`` puts one common N-token system prompt
in front of every request.  ``--arch falcon-mamba-7b`` serves the
Mamba-1 stack from dense lanes that hold its recurrent state; the paged
pool, and with it ``--cache paged``, ``--draft`` and ``--prefix-cache``,
does not apply to it and raises.  ``--gateway`` serves the same prompts
through the async HTTP/SSE gateway (:mod:`repro_torch.serving.gateway`)
on ``--port`` (0: any free port) of 127.0.0.1: one real TCP client per
request streams its tokens, a client bounced with 429 (more than
``--queue-limit`` waiting) retries after ``Retry-After``, and the report
gains the pipeline's counters and goodput under the ``--slo-ttft`` and
``--slo-itl`` SLOs.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --full --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128 --kv-dtype int8 --num-splits 8
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128 --draft --spec-k 4 --num-splits 8
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128 --prefix-cache --shared-prefix 256
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --full
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128 --gateway
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --cache paged --prefill-chunk 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch falcon-mamba-7b
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_arch
from ..device import resolve
from ..models import build_model
from ..serving import Request, SamplingParams, ServingEngine
from ..serving.gateway import GatewayServer, PipelinedEngine, sse_generate
from ..serving.gateway.pipeline import goodput_stats


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serve run shape as one typed object (the fields of the JAX
    package's ``ServeConfig`` that this slice runs, plus ``reduced`` and
    ``device``)."""

    arch: str = "yi-6b"
    n_requests: int = 8
    n_lanes: int = 4
    max_len: int = 96
    prompt_len: int = 16
    max_new: int = 12
    seed: int = 0
    cache: str = "dense"
    n_pages: int | None = None
    page_size: int = 16
    timeslice: int | None = None
    prefill_chunk: int | None = None
    kv_dtype: str = "fp"
    num_splits: int | None = None
    draft: bool = False
    spec_k: int = 4
    prefix_cache: bool = False
    shared_prefix: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    gateway: bool = False
    port: int = 0
    queue_limit: int = 64
    slo_ttft_s: float = 30.0
    slo_itl_s: float = 5.0
    reduced: bool = True
    device: str = "cuda"

    #: argparse dest -> field, for the names that differ
    _ARG_FIELDS = {"requests": "n_requests", "lanes": "n_lanes",
                   "pages": "n_pages", "slo_ttft": "slo_ttft_s",
                   "slo_itl": "slo_itl_s"}

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "ServeConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for dest, value in vars(args).items():
            name = cls._ARG_FIELDS.get(dest, dest)
            if name in fields:
                kw[name] = value
        return cls(**kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def serve_config(scfg: ServeConfig) -> dict:
    """Serve ``scfg.n_requests`` synthetic requests; returns the report."""
    if scfg.kv_dtype == "auto":
        raise NotImplementedError(
            "--kv-dtype auto picks the pool dtype by run-time tuning, which "
            "is not ported yet: ROADMAP queue 1, item 11")
    if scfg.kv_dtype not in ("fp", "int8"):
        raise ValueError(f"unknown kv_dtype {scfg.kv_dtype!r}")
    dev = resolve(scfg.device)
    cfg = get_arch(scfg.arch)
    if scfg.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    if not model.supports_paged_cache:
        for flag, asked in (("--cache paged", scfg.cache == "paged"),
                            ("--draft", scfg.draft),
                            ("--prefix-cache", scfg.prefix_cache)):
            if asked:
                raise ValueError(
                    f"{flag} needs the paged KV pool, which arch "
                    f"{cfg.name!r} does not use: it keeps recurrent SSM "
                    "state in dense lanes (serve it with --cache dense)")
    params = model.init(scfg.seed, dev)
    draft_model = draft_params = None
    if scfg.draft:
        # self-speculative draft: the target's leading layers (views) with
        # the embedding and head shared
        draft_model = model.draft_model()
        draft_params = model.slice_draft_params(params, draft_model)
    engine = ServingEngine(model, params, n_lanes=scfg.n_lanes,
                           max_len=scfg.max_len, cache=scfg.cache,
                           n_pages=scfg.n_pages, page_size=scfg.page_size,
                           timeslice=scfg.timeslice,
                           prefill_chunk=scfg.prefill_chunk,
                           draft_model=draft_model,
                           draft_params=draft_params,
                           spec_k=scfg.spec_k if scfg.draft else None,
                           prefix_cache=scfg.prefix_cache,
                           kv_dtype=scfg.kv_dtype,
                           # split-KV applies to the paged decode and
                           # verify only, as in the JAX package's serve
                           num_splits=(scfg.num_splits
                                       if scfg.cache == "paged" else None))
    return serve_engine(engine, scfg)


def draw_prompts(scfg: ServeConfig, vocab_size: int) -> list[list[int]]:
    """The synthetic prompts, drawn from ``scfg.seed``: the shared system
    prompt first, then each request's own tokens behind it."""
    rng = np.random.default_rng(scfg.seed)
    prefix = (rng.integers(0, vocab_size, size=scfg.shared_prefix)
              .tolist() if scfg.shared_prefix else [])
    return [prefix + rng.integers(
        0, vocab_size, size=rng.integers(4, scfg.prompt_len)).tolist()
        for _ in range(scfg.n_requests)]


def _serve_gateway(engine: ServingEngine, prompts: list[list[int]],
                   scfg: ServeConfig) -> tuple[dict, dict]:
    """Serve ``prompts`` through the HTTP/SSE gateway: every request is a
    real TCP client on 127.0.0.1 streaming SSE frames (a 429 bounce waits
    ``Retry-After`` and retries), the engine ticks in the pipelined
    asyncio loop.  Returns the tokens each client received, keyed by its
    prompt's index (the synchronous serve's rid), and the gateway report:
    the pipeline's counters, goodput under the SLOs, the retries and the
    count of the streams' final events by kind."""
    sampling = None
    if scfg.temperature > 0.0 or scfg.top_k or scfg.top_p < 1.0:
        sampling = {"temperature": scfg.temperature, "top_k": scfg.top_k,
                    "top_p": scfg.top_p}

    async def one(port: int, i: int, prompt: list[int]):
        tokens, bounced = [], 0
        while True:        # honor Retry-After on a 429 bounce
            final = None
            async for kind, payload in sse_generate(
                    "127.0.0.1", port, prompt, max_new_tokens=scfg.max_new,
                    sampling=(dict(sampling, seed=scfg.seed + i)
                              if sampling else None)):
                if kind == "tokens":
                    tokens.extend(payload)
                else:
                    final = (kind, payload)
            if final and final[0] == "http_error" \
                    and final[1]["status"] == 429:
                bounced += 1
                await asyncio.sleep(float(final[1]["retry_after"] or 1))
                continue
            return tokens, bounced, final

    async def run():
        pipe = PipelinedEngine(engine, queue_limit=scfg.queue_limit)
        srv = GatewayServer(pipe, port=scfg.port)
        await srv.start()
        t0 = time.monotonic()
        results = await asyncio.gather(
            *[one(srv.port, i, p) for i, p in enumerate(prompts)])
        wall = time.monotonic() - t0
        await srv.drain()
        return pipe, results, wall

    pipe, results, wall = asyncio.run(run())
    outputs = {i: tokens for i, (tokens, _, _) in enumerate(results)}
    report = {
        "requests": len(prompts),
        "wall_s": wall,
        "client_retries_429": sum(r[1] for r in results),
        "streams": dict(collections.Counter(
            r[2][0] if r[2] else "closed" for r in results)),
        **{k: v for k, v in pipe.stats().items() if k != "draining"},
        **goodput_stats(engine.finished, wall, scfg.slo_ttft_s,
                        scfg.slo_itl_s),
    }
    return outputs, report


def serve_engine(engine: ServingEngine, scfg: ServeConfig) -> dict:
    """Submit the requests ``scfg`` describes to ``engine`` (through the
    gateway with ``scfg.gateway``), run them to the end and return the
    report."""
    prompts = draw_prompts(scfg, engine.model.cfg.vocab_size)
    gateway_report = None
    if scfg.gateway:
        outputs, gateway_report = _serve_gateway(engine, prompts, scfg)
    else:
        for rid, prompt in enumerate(prompts):
            engine.submit(Request(rid=rid, prompt=prompt,
                                  max_new_tokens=scfg.max_new,
                                  sampling=SamplingParams(
                                      temperature=scfg.temperature,
                                      top_k=scfg.top_k, top_p=scfg.top_p,
                                      seed=scfg.seed + rid)))
        finished = engine.run(max_steps=scfg.n_requests
                              * (scfg.max_new + 4 + scfg.shared_prefix))
        outputs = {int(r.rid): [int(t) for t in r.out_tokens]
                   for r in finished}
    summary = engine.metrics.summary()
    prefix_stats = None
    if engine.kv.prefix_cache:
        kvp = engine.kv.stats()["prefix"]
        prefix_stats = {**summary["prefix_cache"],
                        **{k: kvp[k] for k in ("pages_saved", "cow_copies",
                                               "evictions", "cached_pages")}}
    return {
        "config": scfg.to_dict(),
        "device": (torch.cuda.get_device_name(engine.device)
                   if engine.device.type == "cuda" else "cpu"),
        "outputs": outputs,
        "finished": len(engine.finished), "requests": scfg.n_requests,
        "decode_steps": engine.steps,
        "prefill_chunks": engine.prefill_chunks,
        "generated_tokens": summary["generated_tokens"],
        "tokens_per_s": summary["tokens_per_s"],
        "p50_queue_wait_s": summary["queue_wait_s"]["p50"],
        "p99_queue_wait_s": summary["queue_wait_s"]["p99"],
        "mean_ttft_s": summary["ttft_s"]["mean"],
        "p50_ttft_s": summary["ttft_s"]["p50"],
        "p99_ttft_s": summary["ttft_s"]["p99"],
        "p50_itl_s": summary["itl_s"]["p50"],
        "p99_itl_s": summary["itl_s"]["p99"],
        "wall_s": summary["wall_s"],
        "preemptions": summary["preemptions"],
        "spec": engine.spec_stats() if engine.spec_k else None,
        "cache": engine.kv.stats(),
        "prefix_cache": prefix_stats,
        "kv_dtype": engine.kv.kv_dtype,
        "gateway": gateway_report,
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="prompts are drawn with lengths in [4, prompt_len)")
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", choices=("dense", "paged"), default="dense",
                    help="KV backend: per-lane strips or the paged pool")
    ap.add_argument("--pages", type=int, default=None,
                    help="paged pool size (default: every lane at max-len, "
                         "plus the null page)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--timeslice", type=int, default=None,
                    help="preempt a lane after N decode steps when work is "
                         "queued (serve more requests than lanes)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="stream prompts into the paged cache N tokens per "
                         "tick (needs --cache paged)")
    ap.add_argument("--kv-dtype", choices=("fp", "int8", "auto"),
                    default="fp",
                    help="paged pool storage: the cache dtype, or int8 pages "
                         "with per-row float32 scales (auto needs run-time "
                         "tuning, not ported)")
    ap.add_argument("--num-splits", type=int, default=None,
                    help="split each paged decode and verify step's page "
                         "walk into N parallel segments (split-KV; paged "
                         "cache only)")
    ap.add_argument("--draft", action="store_true",
                    help="paged: speculative decoding with a self-"
                         "speculative draft (the target's leading layers)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculative tick")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged + chunked: seed admissions with the indexed "
                         "pages of earlier prompts (copy-on-write)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend one common N-token system prompt to every "
                         "request")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k sampling filter (0 disables)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 disables)")
    ap.add_argument("--gateway", action="store_true",
                    help="serve through the async HTTP/SSE gateway "
                         "(pipelined ticks, real localhost TCP clients)")
    ap.add_argument("--port", type=int, default=0,
                    help="gateway: listen port (0 = ephemeral)")
    ap.add_argument("--queue-limit", type=int, default=64,
                    help="gateway: admission-queue bound (429 beyond)")
    ap.add_argument("--slo-ttft", type=float, default=30.0,
                    help="gateway: TTFT SLO in seconds (goodput counts "
                         "only requests inside it)")
    ap.add_argument("--slo-itl", type=float, default=5.0,
                    help="gateway: p95 inter-token-latency SLO in seconds")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="serve the reduced test config (default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="serve the arch at its published widths")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    out = serve_config(ServeConfig.from_args(ap.parse_args(argv)))

    def fmt(x, spec):
        return format(x, spec) if x is not None else "n/a"

    print(f"[serve] {out['finished']}/{out['requests']} requests, "
          f"{out['generated_tokens']} tokens in {out['wall_s']:.2f}s "
          f"({out['tokens_per_s']:.1f} tok/s, "
          f"ttft p50 {fmt(out['p50_ttft_s'], '.4f')}s "
          f"p99 {fmt(out['p99_ttft_s'], '.4f')}s, "
          f"itl p50 {fmt(out['p50_itl_s'], '.4f')}s, "
          f"preemptions {out['preemptions']}, kv {out['kv_dtype']}) on "
          f"{out['device']}")
    if out["spec"] is not None:
        print(f"[serve] speculative: {out['spec']}")
    if out["prefix_cache"] is not None:
        print(f"[serve] prefix cache: {out['prefix_cache']}")
    if out["gateway"] is not None:
        g = out["gateway"]
        per_tick = {k: v / max(g["ticks"], 1)
                    for k, v in g["host_ms"].items()}
        print(f"[serve] gateway: {g['goodput_tok_s']:.1f} good tok/s (SLO "
              f"{g['slo_attainment']:.0%}), {g['overlapped_ticks']}/"
              f"{g['ticks']} ticks overlapped, {g['rejected_429']} bounced, "
              f"streams {g['streams']}, host ms a tick: schedule+dispatch "
              f"{per_tick['schedule_dispatch']:.2f}, wait "
              f"{per_tick['wait']:.2f}, emit {per_tick['emit']:.2f}")


if __name__ == "__main__":
    main()

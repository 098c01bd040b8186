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
paged decode step's page walk into N parallel segments (split-KV).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --full --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128 --kv-dtype int8 --num-splits 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --cache paged --prefill-chunk 8
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import get_arch
from ..device import resolve
from ..models import build_model
from ..serving import Request, SamplingParams, ServingEngine


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
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    reduced: bool = True
    device: str = "cuda"

    #: argparse dest -> field, for the names that differ
    _ARG_FIELDS = {"requests": "n_requests", "lanes": "n_lanes",
                   "pages": "n_pages"}

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
    params = model.init(scfg.seed, dev)
    engine = ServingEngine(model, params, n_lanes=scfg.n_lanes,
                           max_len=scfg.max_len, cache=scfg.cache,
                           n_pages=scfg.n_pages, page_size=scfg.page_size,
                           timeslice=scfg.timeslice,
                           prefill_chunk=scfg.prefill_chunk,
                           kv_dtype=scfg.kv_dtype,
                           # split-KV applies to the paged decode only, as
                           # in the JAX package's serve
                           num_splits=(scfg.num_splits
                                       if scfg.cache == "paged" else None))
    rng = np.random.default_rng(scfg.seed)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=rng.integers(4, scfg.prompt_len)).tolist()
               for _ in range(scfg.n_requests)]
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=scfg.max_new,
                              sampling=SamplingParams(
                                  temperature=scfg.temperature,
                                  top_k=scfg.top_k, top_p=scfg.top_p,
                                  seed=scfg.seed + rid)))
    finished = engine.run(max_steps=scfg.n_requests * (scfg.max_new + 4))
    summary = engine.metrics.summary()
    return {
        "config": scfg.to_dict(),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "outputs": {int(r.rid): [int(t) for t in r.out_tokens]
                    for r in finished},
        "finished": len(finished), "requests": scfg.n_requests,
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
        "cache": engine.kv.stats(),
        "kv_dtype": engine.kv.kv_dtype,
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
                    help="split each paged decode step's page walk into N "
                         "parallel segments (split-KV; paged cache only)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k sampling filter (0 disables)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 disables)")
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


if __name__ == "__main__":
    main()

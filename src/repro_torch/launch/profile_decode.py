"""Where a decode tick's time goes: trace engine ticks with torch.profiler.

Fills every lane of the engine with a request (one prefill each, or
chunk by chunk with ``--prefill-chunk``), runs ticks until every lane is
decoding and one more, then traces ``--steps`` decode ticks of the
engine's compiled steps (CUDA graphs replayed), switches the same engine
to its eager steps (the step attributes' ``fn``), runs one tick and
traces ``--steps`` more, and prints for each:
the host time per tick, the device time per tick (sum of the kernels'
own times), the device busy share (device time / host time), the device
operations (kernels, copies, memsets) launched per tick, and the kernels
that take the most device time.  ``--cache paged`` traces the
paged decode tick, ``--kv-dtype int8`` over int8 pages and
``--num-splits N`` with split-KV decode (and verify); ``--draft --spec-k
K`` traces speculative ticks (draft proposals, one verify, the accept
rule) and adds the tokens they emitted per tick.  With ``--trace`` it
also writes a Chrome trace of the graphed ticks, and one of the eager
ticks beside it (``.eager`` before the suffix).

Usage (on the card)::

    PYTHONPATH=src python -m repro_torch.launch.profile_decode --full \
        --trace decode_trace.json
    PYTHONPATH=src python -m repro_torch.launch.profile_decode --full \
        --cache paged --prefill-chunk 128
    PYTHONPATH=src python -m repro_torch.launch.profile_decode --full \
        --cache paged --prefill-chunk 128 --kv-dtype int8 --num-splits 8
    PYTHONPATH=src python -m repro_torch.launch.profile_decode --full \
        --cache paged --prefill-chunk 128 --draft --spec-k 4 --num-splits 8
    PYTHONPATH=src python -m repro_torch.launch.profile_decode --full \
        --arch moonshot-v1-16b-a3b --cache paged --prefill-chunk 128
    PYTHONPATH=src python -m repro_torch.launch.profile_decode --full \
        --arch zamba2-7b --max-len 4700 --prompt-len 4094
    PYTHONPATH=src python -m repro_torch.launch.profile_decode --full \
        --arch pixtral-12b --cache paged --prefill-chunk 128
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get_arch
from ..device import resolve
from ..models import build_model
from ..serving import Request, ServingEngine
from ..serving.compiled import CompiledStep


def _device_us(event) -> float:
    """A profiler event's own device time in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def _trace_ticks(engine, steps: int, activities, trace: str | None,
                 top: int) -> dict:
    """Trace ``steps`` ticks of ``engine``: host and device ms a tick,
    the busy share, device operations and tokens a tick, the top
    kernels."""
    def emitted() -> int:
        return sum(len(r.out_tokens)
                   for r in [*engine.active.values(), *engine.finished])

    tokens0 = emitted()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    tokens = emitted() - tokens0
    if trace:
        prof.export_chrome_trace(trace)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=_device_us, reverse=True)
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    rows = [(e.key, _device_us(e) / 1e3 / steps, e.count / steps)
            for e in kernels[:top]]
    return {"host_ms_per_tick": host_ms, "device_ms_per_tick": device_ms,
            "busy_share": device_ms / host_ms if host_ms else 0.0,
            "launches_per_tick": sum(e.count for e in kernels) / steps,
            "tokens_per_tick": tokens / steps, "spec": engine.spec_stats(),
            "kernels": rows}


def profile_decode(arch: str = "yi-6b", reduced: bool = True,
                   n_lanes: int = 4, max_len: int = 1024,
                   prompt_len: int = 512, steps: int = 8, top: int = 12,
                   device: str = "cuda", trace: str | None = None,
                   cache: str = "dense",
                   prefill_chunk: int | None = None, kv_dtype: str = "fp",
                   num_splits: int | None = None,
                   spec_k: int | None = None) -> dict:
    dev = resolve(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(0, dev)
    draft = {}
    if spec_k is not None:
        dmodel = model.draft_model()
        draft = dict(draft_model=dmodel, spec_k=spec_k,
                     draft_params=model.slice_draft_params(params, dmodel))
    engine = ServingEngine(model, params, n_lanes=n_lanes,
                           max_len=max_len, cache=cache,
                           prefill_chunk=prefill_chunk, kv_dtype=kv_dtype,
                           num_splits=num_splits, **draft)
    rng = np.random.default_rng(0)
    for rid in range(n_lanes):
        prompt = rng.integers(0, cfg.vocab_size, size=prompt_len - 1)
        # room for every traced tick (graphed, then eager) to emit its
        # most tokens
        engine.submit(Request(rid=rid, prompt=prompt.tolist(),
                              max_new_tokens=(2 * steps + 6)
                              * (1 + (spec_k or 0))))
    engine.step()                  # admissions (prefill) + the first tick
    while engine.scheduler.prefill_lanes():
        engine.step()              # the rest of a chunked prefill
    engine.step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = _trace_ticks(engine, steps, activities, trace, top)
    out["graphs"] = engine.graph_stats()
    # the same engine on its eager steps, one untraced tick first
    for name in ("_decode", "_prefill_step", "_verify", "_draft_decode"):
        step = getattr(engine, name, None)
        if isinstance(step, CompiledStep):
            setattr(engine, name, step.fn)
    engine.step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    eager_trace = None
    if trace:
        stem, dot, suffix = trace.rpartition(".")
        eager_trace = (f"{stem}.eager.{suffix}" if dot
                       else f"{trace}.eager")
    out["eager"] = _trace_ticks(engine, steps, activities, eager_trace, top)
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--cache", choices=("dense", "paged"), default="dense")
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--kv-dtype", choices=("fp", "int8"), default="fp")
    ap.add_argument("--num-splits", type=int, default=None)
    ap.add_argument("--draft", action="store_true",
                    help="trace speculative ticks (self-speculative draft)")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the traced ticks here")
    args = ap.parse_args(argv)
    out = profile_decode(args.arch, args.reduced, args.lanes, args.max_len,
                         args.prompt_len, args.steps, device=args.device,
                         trace=args.trace, cache=args.cache,
                         prefill_chunk=args.prefill_chunk,
                         kv_dtype=args.kv_dtype, num_splits=args.num_splits,
                         spec_k=args.spec_k if args.draft else None)
    for label, res in (("graphed", out), ("eager", out["eager"])):
        print(f"[profile] {args.arch} "
              f"{'reduced' if args.reduced else 'full'}, {args.lanes} lanes, "
              f"{args.cache} cache, kv {args.kv_dtype}, num_splits "
              f"{args.num_splits}, {label}: host "
              f"{res['host_ms_per_tick']:.3f} ms/tick, device "
              f"{res['device_ms_per_tick']:.3f} ms/tick, busy share "
              f"{res['busy_share']:.3f}, {res['launches_per_tick']:.1f} "
              f"device operations/tick, {res['tokens_per_tick']:.2f} tokens "
              f"per tick" + (f", speculative {res['spec']}" if args.draft
                             else "")
              + (f", graphs {out['graphs']}" if label == "graphed" else ""))
        for name, ms, count in res["kernels"]:
            print(f"  {ms:9.4f} ms/tick  x{count:5.1f}  {name[:100]}")


if __name__ == "__main__":
    main()

"""Where a decode tick's time goes: trace engine ticks with torch.profiler.

Fills every lane of the engine with a request (one prefill each, or
chunk by chunk with ``--prefill-chunk``), runs ticks until every lane is
decoding and one more, then traces ``--steps`` decode ticks and prints:
the host time per tick, the device time per tick (sum of the kernels'
own times), the device busy share (device time / host time), and the
kernels that take the most device time.  ``--cache paged`` traces the
paged decode tick, ``--kv-dtype int8`` over int8 pages and
``--num-splits N`` with split-KV decode.  With ``--trace`` it also writes
a Chrome trace.

Usage (on the card)::

    PYTHONPATH=src python -m repro_torch.launch.profile_decode --full \
        --trace decode_trace.json
    PYTHONPATH=src python -m repro_torch.launch.profile_decode --full \
        --cache paged --prefill-chunk 128
    PYTHONPATH=src python -m repro_torch.launch.profile_decode --full \
        --cache paged --prefill-chunk 128 --kv-dtype int8 --num-splits 8
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


def _device_us(event) -> float:
    """A profiler event's own device time in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_decode(arch: str = "yi-6b", reduced: bool = True,
                   n_lanes: int = 4, max_len: int = 1024,
                   prompt_len: int = 512, steps: int = 8, top: int = 12,
                   device: str = "cuda", trace: str | None = None,
                   cache: str = "dense",
                   prefill_chunk: int | None = None, kv_dtype: str = "fp",
                   num_splits: int | None = None) -> dict:
    dev = resolve(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    engine = ServingEngine(model, model.init(0, dev), n_lanes=n_lanes,
                           max_len=max_len, cache=cache,
                           prefill_chunk=prefill_chunk, kv_dtype=kv_dtype,
                           num_splits=num_splits)
    rng = np.random.default_rng(0)
    for rid in range(n_lanes):
        prompt = rng.integers(0, cfg.vocab_size, size=prompt_len - 1)
        engine.submit(Request(rid=rid, prompt=prompt.tolist(),
                              max_new_tokens=steps + 4))
    engine.step()                  # admissions (prefill) + the first tick
    while engine.scheduler.prefill_lanes():
        engine.step()              # the rest of a chunked prefill
    engine.step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
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
            "kernels": rows}


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
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the traced ticks here")
    args = ap.parse_args(argv)
    out = profile_decode(args.arch, args.reduced, args.lanes, args.max_len,
                         args.prompt_len, args.steps, device=args.device,
                         trace=args.trace, cache=args.cache,
                         prefill_chunk=args.prefill_chunk,
                         kv_dtype=args.kv_dtype, num_splits=args.num_splits)
    print(f"[profile] {args.arch} {'reduced' if args.reduced else 'full'}, "
          f"{args.lanes} lanes, {args.cache} cache, kv {args.kv_dtype}, "
          f"num_splits {args.num_splits}: host {out['host_ms_per_tick']:.3f} ms/tick, "
          f"device {out['device_ms_per_tick']:.3f} ms/tick, busy share "
          f"{out['busy_share']:.3f}")
    for name, ms, count in out["kernels"]:
        print(f"  {ms:9.4f} ms/tick  x{count:5.1f}  {name[:100]}")


if __name__ == "__main__":
    main()

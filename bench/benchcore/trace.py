"""The traced sub-window of a ``--trace 1`` run.

``torch.profiler`` (CPU and CUDA activities) runs over a short steady
part of the window, between two synchronisations, so every device
operation of the work launched inside it falls inside it.  Its Chrome
trace is written to a temporary file, read back and deleted; what the
per-layer readers need is kept:

* every device operation (kernels, copies, memsets): name, start, length;
* the harness's own ranges (``record_function`` around its calls into the
  program) and, for each, the device time of the kernels launched inside
  it (a graph replay's kernels carry the correlation id of its
  ``cudaGraphLaunch``);
* busy seconds (the union of the device operations' intervals), the
  window's length, the top device operations by time and the idle gaps by
  what the host was doing (the harness range open on the host at the
  gap's middle).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: an idle gap whose middle no harness range covers
_OUTSIDE = "outside the harness's ranges"


class Tracer:
    """Start and stop the profiler around a sub-window (on the CPU, as the
    tests run it, host activity alone)."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.prof = None
        self.active = False
        self.result = None

    def warm_up(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        initialises the device tracing (seconds), which would otherwise
        fall inside the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities):
            torch.zeros(8, device="cuda" if self.cuda else "cpu").sum()
            if self.cuda:
                torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.t0 = time.perf_counter()
        self.active = True

    def stop(self) -> dict:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.active = False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        self.result = summarize(events, self.t1 - self.t0)
        return self.result


def _union(intervals: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _open_at(spans: list, starts: list, t: float, first: bool = False,
             depth: int = 16) -> list[str]:
    """Names of the ranges of ``spans`` (sorted (start, end, name)) open
    at ``t``, the latest-started first; ranges nest a few deep, so only
    the last ``depth`` to start before ``t`` are looked at."""
    out = []
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(spans[max(0, i - depth):i]):
        if b >= t:
            out.append(name)
            if first:
                break
    return out


def summarize(events: list[dict], window_s: float, top: int = 10) -> dict:
    """What the readers need from a Chrome trace's events (times in
    microseconds there, seconds here)."""
    device, ranges, launches = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            device.append((e.get("name", ""), ts, dur,
                           (e.get("args") or {}).get("correlation")))
        elif cat == "user_annotation" and e.get("name", "").startswith(
                ("bench.", "engine.", "train.")):
            ranges.append((e["name"], ts, ts + dur, e.get("tid")))
        elif cat == "cuda_runtime":
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, e.get("tid"))
    # the device time launched inside each named range
    by_range: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for name, _, _, _ in ranges:
        by_range[name][0] += 1
    spans = defaultdict(list)
    for name, a, b, tid in ranges:
        spans[tid].append((a, b, name))
    starts = {}
    for tid, lst in spans.items():
        lst.sort()
        starts[tid] = [a for a, _, _ in lst]
    for name, ts, dur, corr in device:
        where = launches.get(corr)
        if where is None:
            continue
        t, tid = where
        for rname in _open_at(spans.get(tid, []), starts.get(tid, []), t):
            by_range[rname][1] += dur
    busy = _union([(ts, ts + dur) for _, ts, dur, _ in device])
    busy_us = sum(b - a for a, b in busy)
    ops = defaultdict(float)
    for name, _, dur, _ in device:
        ops[name] += dur
    # idle gaps between device work, by the harness range open on the
    # host at the gap's middle (the innermost: the latest to start)
    idle = defaultdict(float)
    host = sorted((a, b, n) for n, a, b, _ in ranges)
    host_starts = [a for a, _, _ in host]
    for (_, end), (start, _) in zip(busy, busy[1:]):
        open_ = _open_at(host, host_starts, 0.5 * (end + start), first=True)
        idle[open_[0] if open_ else _OUTSIDE] += start - end
    kernels = [(name, dur * 1e-6) for name, _, dur, _ in device]
    return {
        "window_s": window_s,
        "busy_s": busy_us * 1e-6,
        "kernels": kernels,
        "by_range": {k: {"count": v[0], "device_s": v[1] * 1e-6}
                     for k, v in by_range.items()},
        "device_ops": sorted(((k, v * 1e-6) for k, v in ops.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(((k, v * 1e-6) for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:top],
    }


def kernel_seconds(trace: dict, patterns) -> float:
    """Device seconds of the kernels whose names hold any of
    ``patterns``."""
    return sum(s for name, s in trace["kernels"]
               if any(p in name for p in patterns))

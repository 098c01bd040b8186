"""What the serving drivers share: the port's engine built from a cell's
file, the timeline of a run (warm-up, the arrival ramp, the measured
window, the traced sub-window at its end), the harness's ranges around its
calls into the engine, and the check of the served tokens against the
reference.

The window drives ``PipelinedEngine.run`` (the gateway's asyncio tick loop,
``max_inflight`` 2) over ``ServingEngine(cache="paged", prefill_chunk=
...)``: the chunked prefill through the pages and the graphed paged decode.
Requests are submitted in-process with ``submit_t`` set to the time they
were due, so a request's latency counts the time it waited for the loop.
"""
from __future__ import annotations

import asyncio
import gc
import time
from contextlib import nullcontext

import numpy as np

from traffic import generate

from . import check
from .program import port_config
from .trace import Tracer
from .weights import dims, make_weights


def _dtype(name: str):
    import torch
    return getattr(torch, name)


def build(ctx):
    """(model dims, weights, engine, pipelined engine) for the cell."""
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.gateway.pipeline import (GatewayPolicyKnobs,
                                                      PipelinedEngine)

    cfg = port_config(ctx.config, ctx.port_overrides)
    model = build_model(cfg)
    weights = make_weights(ctx.config, ctx.seed, ctx.device,
                           _dtype(ctx.config["param_dtype"]))
    e = ctx.cell["engine"]
    engine = ServingEngine(model, weights, n_lanes=e["lanes"],
                           max_len=e["max_len"], cache="paged",
                           page_size=e["page_size"],
                           prefill_chunk=e["prefill_chunk"],
                           prefix_cache=e["prefix_cache"])
    pe = PipelinedEngine(engine, queue_limit=e["queue_limit"],
                         knobs=GatewayPolicyKnobs(
                             max_inflight=e["max_inflight"],
                             admit_batch=e["admit_batch"]))
    return dims(ctx.config), weights, engine, pe


def warm_up(ctx, engine) -> None:
    """Run the cell's shapes once before any arrival: the decode step and
    the prompt chunk (a prompt of two chunks and a few tokens on one lane),
    each captured as its CUDA graph."""
    from repro_torch.serving import Request

    n = ctx.cell["engine"]["prefill_chunk"] + 8
    rng = np.random.default_rng([ctx.seed, 3])
    engine.submit(Request(rid=-1, prompt=rng.integers(
        0, ctx.config["vocab_size"], size=n).tolist(), max_new_tokens=4))
    while engine.active or engine.scheduler.has_queued:
        engine.step()
    engine.finished.clear()
    ctx.sync()


class Hooks:
    """The harness's ranges around its calls into the engine, and the work
    each traced tick drove (prompt chunks and decoding lanes' positions),
    recorded while the tracer runs."""

    def __init__(self, engine, tracer: Tracer):
        import torch

        self.engine, self.tracer = engine, tracer
        self.rf = torch.profiler.record_function
        self.chunks: list[tuple[int, int, bool]] = []
        self.decodes: list[list[int]] = []
        sched, disp, emit = engine.schedule, engine.dispatch, engine.emit
        dec, pre = engine._decode, engine._prefill_step
        engine.schedule = lambda: self._schedule(sched)
        engine.dispatch = lambda: self._dispatch(disp)
        engine.emit = lambda work: self._range("engine.emit", emit, work)
        engine._decode = lambda *a: self._range("bench.decode_step", dec, *a)
        engine._prefill_step = lambda *a: self._range("bench.prefill_chunk",
                                                      pre, *a)

    def _range(self, name, fn, *args):
        with (self.rf(name) if self.tracer.active else nullcontext()):
            return fn(*args)

    def _lanes(self) -> dict:
        return {i: (l.rid, l.phase, l.pos)
                for i, l in enumerate(self.engine.scheduler.lanes)
                if l.rid is not None}

    def _schedule(self, fn):
        if not self.tracer.active:
            return fn()
        before = self._lanes()
        with self.rf("engine.schedule"):
            fn()
        for i, (rid, phase, pos) in self._lanes().items():
            prev = before.get(i)
            if prev is not None and prev[0] == rid:
                if prev[1] != "prefill" or pos <= prev[2]:
                    continue
                start = prev[2]
            elif pos == 0:
                continue
            else:
                start = 0
            self.chunks.append((start, pos, phase == "decode"))

    def _dispatch(self, fn):
        if not self.tracer.active:
            return fn()
        sch = self.engine.scheduler
        with self.rf("engine.dispatch"):
            work = fn()
        if work is not None:
            self.decodes.append([sch.lanes[i].pos for i in work.decoding])
        return work


def _snapshot(pe, reqs) -> dict:
    eng = pe.engine
    return {"t": time.monotonic(), "ticks": pe.ticks,
            "schedule_dispatch_s": pe.schedule_dispatch_s,
            "emit_s": pe.emit_s, "wait_s": pe.wait_s, "steps": eng.steps,
            "chunks": eng.prefill_chunks, "backlog": pe.backlog,
            "active": len(eng.active),
            "tokens": sum(len(r.out_tokens) for _, r in reqs)}


async def _until(t: float, loop_task) -> None:
    """Sleep until monotonic time ``t``; raise at once if the engine's
    loop has died."""
    while True:
        if loop_task.done():
            loop_task.result()
            raise RuntimeError("the engine's loop ended before the window")
        left = t - time.monotonic()
        if left <= 0:
            return
        await asyncio.sleep(min(left, 0.05))


def submit(ctx, pe, spec, due: float, rec: dict) -> None:
    """Send one request of the plan, timed from ``due``; a refused one
    (``QueueFull``) is recorded as failed."""
    from repro_torch.serving.gateway.pipeline import QueueFull

    try:
        stream = pe.submit(generate.prompt_tokens(
            spec, ctx.seed, ctx.config["vocab_size"]), spec.output_len,
            submit_t=due)
        rec["reqs"].append((due, stream.req))
    except QueueFull:
        rec["refused"].append(due)


def track_lanes(engine) -> dict:
    """{request id: the highest lane it occupied}, kept as the engine's
    scheduler places requests."""
    lanes: dict = {}
    occupy = engine.scheduler.occupy

    def place(lane_id, req, *args, **kwargs):
        lanes[req.rid] = max(lane_id, lanes.get(req.rid, -1))
        return occupy(lane_id, req, *args, **kwargs)
    engine.scheduler.occupy = place
    return lanes


async def _timeline(ctx, feed, pe, plan, rec, tracer, hooks) -> None:
    """The driver's arrivals, the window's marks and the traced
    sub-window."""
    loop_task = pe.start()
    t_base = time.monotonic()
    t0 = t_base + ctx.cell["ramp_s"]
    t1 = t0 + ctx.seconds
    rec["t_base"], rec["window"] = t_base, (t0, t1)
    feeder = asyncio.get_running_loop().create_task(
        feed(ctx, pe, plan, rec, lambda t: _until(t, loop_task)))
    try:
        await _until(t0, loop_task)
        rec["marks"]["t0"] = _snapshot(pe, rec["reqs"])
        if tracer is not None:
            await _until(t1 - ctx.cell["trace_s"], loop_task)
            rec["marks"]["trace"] = _snapshot(pe, rec["reqs"])
            tracer.start()
        await _until(t1, loop_task)
        rec["marks"]["t1"] = _snapshot(pe, rec["reqs"])
        if feeder.done():
            feeder.result()
    finally:
        feeder.cancel()
        pe.stop()
        await asyncio.gather(loop_task, feeder, return_exceptions=True)
    loop_task.result()
    if tracer is not None:
        rec["trace"] = tracer.stop()
        rec["trace_chunks"] = hooks.chunks
        rec["trace_decodes"] = hooks.decodes


def run(ctx, plan: list, feed, attempts) -> dict:
    """One serving run of the cell: set-up, the window, the check.  The
    driver gives the requests (``plan``), the coroutine that sends them
    (``feed(ctx, pe, plan, rec, until)``) and the count of the window's
    attempts (``attempts(rec, plan)``)."""
    m, weights, engine, pe = build(ctx)
    warm_up(ctx, engine)
    lanes = track_lanes(engine)
    tracer = Tracer(ctx.cuda) if ctx.trace else None
    if tracer is not None:
        tracer.warm_up()
    hooks = Hooks(engine, tracer) if ctx.trace else None
    rec = {"kind": "serve", "dims": m, "reqs": [], "refused": [],
           "marks": {}, "trace": None}
    asyncio.run(_timeline(ctx, feed, pe, plan, rec, tracer, hooks))
    t0, t1 = rec["window"]
    rec["setup_s"] = t0 - ctx.t_start
    rec["window_s"] = rec["marks"]["t1"]["t"] - rec["marks"]["t0"]["t"]
    rec["memory_peak_bytes"] = ctx.memory_peak()
    rec["attempted"] = attempts(rec, plan)
    rec["failed"] = len([d for d in rec["refused"] if t0 <= d < t1])
    finished = [r for _, r in rec["reqs"]
                if r.finish_t is not None and t0 <= r.finish_t <= t1]
    del pe, engine, hooks
    gc.collect()
    ctx.free()
    rec["readings"] = (served_readings(ctx, weights, m, finished, lanes)
                       if ctx.check else {})
    return rec


def served_readings(ctx, weights, m, finished, lanes: dict) -> dict:
    """The widest logit gap of the served tokens of a sample of the
    requests finished in the window, against the reference; under
    ``ctx.control`` also the control's gap at the same positions.  The
    sample holds the request with the most tokens, the one served on the
    highest lane (so a fault in the upper lanes of the batch is seen), and
    the rest drawn from the seed."""
    from reference.llama import served_logits

    if not finished:
        return {"logit_gap": None, "checked_requests": 0}
    k = min(ctx.cell["check"]["requests"], len(finished))
    every = range(len(finished))
    pick = list(dict.fromkeys((
        max(every, key=lambda i: len(finished[i].out_tokens)),
        max(every, key=lambda i: lanes.get(finished[i].rid, -1)))))[:k]
    rest = [i for i in every if i not in pick]
    rng = np.random.default_rng([ctx.seed, 4])
    pick += list(rng.choice(rest, size=k - len(pick), replace=False))
    sample = [finished[i] for i in pick]
    seqs = [r.prompt + r.out_tokens[:-1] for r in sample]
    rows = [list(range(len(r.prompt) - 1, len(r.prompt) - 1
                       + len(r.out_tokens))) for r in sample]
    ref = served_logits(weights, m, seqs, rows, "f32")
    out = {"logit_gap": max(check.served_gap(lg, r.out_tokens)
                            for lg, r in zip(ref, sample)),
           "checked_requests": k,
           "checked_tokens": sum(len(r.out_tokens) for r in sample)}
    if ctx.control:
        ctl = served_logits(weights, m, seqs, rows, "fp8")
        out["control_gap"] = max(check.control_gap(a, b)
                                 for a, b in zip(ref, ctl))
    return out

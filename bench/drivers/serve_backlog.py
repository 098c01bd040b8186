"""Offline serving: a backlog of ``backlog`` requests is kept queued from
the start, so no lane is ever empty; judged by the tokens generated in
the window."""
import asyncio
import time

from benchcore import serving
from traffic import generate


def plan(ctx) -> list:
    return generate.serve_requests(ctx.traffic, ctx.cell["backlog_requests"],
                                   ctx.seed)


async def feed(ctx, pe, plan, rec, until) -> None:
    """Keep ``backlog`` requests queued, each due when it is sent."""
    for spec in plan:
        while pe.backlog >= ctx.cell["backlog"]:
            await asyncio.sleep(0.005)
        serving.submit(ctx, pe, spec, time.monotonic(), rec)
    raise RuntimeError("the traffic ran out before the window closed")


def attempts(rec, plan) -> int:
    """The requests admitted before the window closed that were served in
    it or are still on a lane."""
    t0 = rec["window"][0]
    return sum(1 for _, r in rec["reqs"] if r.admit_t is not None
               and (r.finish_t is None or r.finish_t >= t0))


def run(ctx) -> dict:
    return serving.run(ctx, plan(ctx), feed, attempts)

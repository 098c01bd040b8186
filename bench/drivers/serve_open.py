"""Open-loop serving: requests arrive at the cell's fixed ``rate_per_s``
(the generator's stratified exponential gaps; the arrival process starts
``ramp_s`` before the window, so the window opens at steady occupancy),
each timed from the moment it was due."""
from benchcore import serving
from traffic import generate


def plan(ctx) -> list:
    rate = ctx.cell["rate_per_s"]
    n = generate.open_loop_count(rate, ctx.cell["ramp_s"] + ctx.seconds)
    return generate.serve_requests(ctx.traffic, n, ctx.seed, rate)


async def feed(ctx, pe, plan, rec, until) -> None:
    """Send each request at its due time, until the window closes."""
    t1 = rec["window"][1]
    for spec in plan:
        due = rec["t_base"] + spec.offset_s
        if due >= t1:
            return
        await until(due)
        serving.submit(ctx, pe, spec, due, rec)
    raise RuntimeError("the traffic ran out before the window closed")


def attempts(rec, plan) -> int:
    """The requests due in the window: those sent, those refused, and
    those the sender never got to (the loop held it past their time),
    which are kept in ``rec["unsent"]`` and count with no first token."""
    t0, t1 = rec["window"]
    sent = len(rec["reqs"]) + len(rec["refused"])
    rec["unsent"] = [d for d in (rec["t_base"] + s.offset_s
                                 for s in plan[sent:]) if d < t1]
    due = [d for d, _ in rec["reqs"]] + rec["refused"] + rec["unsent"]
    return sum(1 for d in due if t0 <= d < t1)


def run(ctx) -> dict:
    return serving.run(ctx, plan(ctx), feed, attempts)

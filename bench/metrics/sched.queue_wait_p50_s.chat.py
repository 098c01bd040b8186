"""Median wait from a request's due time to its admission to a lane
(``Request.admit_t``), over the requests due in the untraced part of the
window (one not admitted by then counts at its wait so far)."""
from benchcore import readers
from benchcore.stats import percentile

UNIT, BETTER, SOURCE = "s", "lower", "program_counter"
LAYER = "scheduler (serving/scheduler.py, engine admission)"
MOVES = "ttft_p95_s"


def read(rec: dict) -> float | None:
    end = "trace" if "trace" in rec["marks"] else "t1"
    t_end = rec["marks"][end]["t"]
    waits = [min(r.admit_t if r.admit_t is not None else t_end, t_end) - d
             for d, r in readers.window_requests(rec, end)]
    return percentile(waits, 50)

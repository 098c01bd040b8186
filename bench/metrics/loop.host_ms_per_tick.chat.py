"""The gateway loop's host milliseconds a tick in schedule + dispatch and
in emit (``PipelinedEngine``'s own clocks, not its wait on the tick's
event), over the untraced part of the window."""
UNIT, BETTER, SOURCE = "ms", "lower", "program_counter"
LAYER = "gateway pipeline (serving/gateway/pipeline.py)"
MOVES = "itl_p95_ms"


def read(rec: dict) -> float | None:
    a, b = rec["marks"]["t0"], rec["marks"].get("trace", rec["marks"]["t1"])
    ticks = b["ticks"] - a["ticks"]
    if ticks <= 0:
        return None
    host = (b["schedule_dispatch_s"] - a["schedule_dispatch_s"]
            + b["emit_s"] - a["emit_s"])
    return 1e3 * host / ticks

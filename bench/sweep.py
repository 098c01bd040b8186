"""Find an open-loop cell's knee once, when the cell is defined: run its
traffic at each of several fixed rates (one process, the weights made
again for each) and print, for each, the backlog and the lanes in use at
the window's start and end, the requests due and finished, and the tails.
The highest rate whose backlog does not grow through the window is the
knee; the cell's ``rate_per_s`` is set at about four fifths of it.

    python3 bench/sweep.py --workload yi-6b.chat --rates 4,6,8,10 --seconds 20
"""
import argparse
import json
import sys
import time

import run as bench  # bench/run.py: sets the paths and caches

from benchcore import readers
from benchcore.program import add_program_path
from benchcore.stats import percentile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)
    add_program_path(bench.ROOT)
    for rate in (float(r) for r in args.rates.split(",")):
        ctx = bench.Context(bench.ROOT, args.workload, args.seed,
                            args.seconds, False)
        ctx.check = False
        ctx.t_start = time.monotonic()
        bench.build_libraries(ctx)
        ctx.cell = dict(ctx.cell, rate_per_s=rate)
        driver = bench.spec.load_module("drivers", ctx.cell["driver"])
        rec = driver.run(ctx)
        a, b = rec["marks"]["t0"], rec["marks"]["t1"]
        t0, t1 = rec["window"]
        done = sum(1 for _, r in rec["reqs"] if r.finish_t is not None
                   and t0 <= r.finish_t <= t1)
        print(json.dumps({
            "rate": rate, "backlog": [a["backlog"], b["backlog"]],
            "active": [a["active"], b["active"]],
            "due": len(readers.window_requests(rec)), "finished": done,
            "refused": rec["failed"],
            "ttft_p50_s": percentile(readers.ttfts(rec), 50),
            "ttft_p95_s": percentile(readers.ttfts(rec), 95),
            "itl_p50_ms": 1e3 * percentile(readers.token_gaps(rec), 50),
            "itl_p95_ms": 1e3 * percentile(readers.token_gaps(rec), 95),
            "tok_s": readers.window_tokens(rec) / (t1 - t0),
            "setup_s": rec["setup_s"]}), flush=True)
        ctx.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())

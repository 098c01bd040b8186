"""The readings a cell's limits are set from, in one process: for each
seed, a run of the cell (its window ``--seconds`` long) with the numbers
its check compares, and, computed on the same sequences or batches, the
lower-precision control's (the reference with fp8 products in the
program's place), which has to read as not correct.  With ``--fault`` a
fault of ``benchcore.faults`` is planted under the timed path first.  The
benchmark's own runs never run the control or a fault.

    python3 bench/control.py --workload yi-6b.chat --seeds 1,2,3 --seconds 10
"""
import argparse
import json
import sys

import run as bench  # bench/run.py: sets the paths and caches

from benchcore import faults
from benchcore.program import add_program_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--no-control", action="store_true",
                    help="the program's readings only")
    ap.add_argument("--fault", choices=sorted(faults.ALL),
                    help="plant this fault under the timed path")
    args = ap.parse_args(argv)
    add_program_path(bench.ROOT)
    if args.fault:
        faults.ALL[args.fault]()
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = bench.Context(bench.ROOT, args.workload, seed, args.seconds,
                            False, control=not args.no_control)
        out, rec = bench.run_cell(ctx)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": out["correct"],
                          "metrics": {k: v["value"]
                                      for k, v in out["metrics"].items()},
                          "readings": rec["readings"]}), flush=True)
        del rec
        ctx.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())

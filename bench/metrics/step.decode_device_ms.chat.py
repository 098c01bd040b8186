"""Device milliseconds of one decode step (the decode graph's replay):
the kernels launched inside the harness's ``bench.decode_step`` range,
over the ranges, in the traced window."""
UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "compiled steps and model (serving/compiled.py, models/transformer.py)"
MOVES = "itl_p95_ms"


def read(rec: dict) -> float | None:
    tr = rec.get("trace")
    r = (tr or {}).get("by_range", {}).get("bench.decode_step")
    if not r or r["count"] == 0 or r["device_s"] <= 0:
        return None
    return 1e3 * r["device_s"] / r["count"]

"""Every token generated inside the window over the window's seconds (an
offline batch's throughput)."""
from benchcore import readers

UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(rec: dict) -> float:
    t0, t1 = rec["window"]
    return readers.window_tokens(rec) / (t1 - t0)

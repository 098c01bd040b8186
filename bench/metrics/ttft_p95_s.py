"""95th percentile of the time to first token of every request due in the
window, timed from when it was due (a request still without a first token
at the window's end counts at its wait so far)."""
from benchcore import readers
from benchcore.stats import percentile

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(rec: dict) -> float | None:
    return percentile(readers.ttfts(rec), 95)

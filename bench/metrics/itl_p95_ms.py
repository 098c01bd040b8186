"""95th percentile of every gap between consecutive tokens of a request
whose later token came inside the window."""
from benchcore import readers
from benchcore.stats import percentile

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(rec: dict) -> float | None:
    v = percentile(readers.token_gaps(rec), 95)
    return None if v is None else 1e3 * v

"""The share of the traced window in which no operation ran on the device
(100 x (1 - busy / window), busy the union of the device operations'
intervals)."""
from benchcore import readers

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "train_tok_s"


def read(rec: dict) -> float | None:
    return readers.idle_share(rec)

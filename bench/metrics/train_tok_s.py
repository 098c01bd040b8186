"""Tokens trained in the window's whole steps over the window's seconds,
synchronised at both ends."""
UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(rec: dict) -> float:
    return rec["tokens"] / rec["window_s"]

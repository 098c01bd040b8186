"""Set-up: from the process's start to the window's start (loading,
making the weights, building or loading the kernels, warming up and
capturing the cell's graphs, and an open loop's arrival ramp)."""
UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(rec: dict) -> float:
    return rec["setup_s"]

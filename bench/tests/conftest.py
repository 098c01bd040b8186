"""The benchmark's CPU tests: ``python -m pytest bench/tests`` from the
checkout's root (the tests marked ``gpu`` need a CUDA card and skip
without one).  A whole run of a cell is driven here on the port's CPU
route at a test's size (:func:`benchcore.program.small_conf`)."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "bench", ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import run as bench_run  # noqa: E402
from benchcore.program import small_conf  # noqa: E402
from benchcore import spec  # noqa: E402

# one thread a test process: the test-size model's operations are tiny,
# and several test processes share the cores
torch.set_num_threads(1)

#: what a CPU run of a cell changes in the cell's file: a short ramp, a
#: small pool, a small window and check; the open loop's rate fills every
#: lane, so a fault in the upper lanes serves requests
CPU_CELL = {
    "serve_open": {"rate_per_s": 80.0, "ramp_s": 1.0, "trace_s": 0.5,
                   "engine": {"lanes": 4, "max_len": 96, "page_size": 8,
                              "prefill_chunk": 16},
                   "check": {"requests": 8}},
    "serve_backlog": {"ramp_s": 0.5, "trace_s": 0.5, "backlog": 4,
                      "backlog_requests": 400,
                      "engine": {"lanes": 4, "max_len": 96, "page_size": 8,
                                 "prefill_chunk": 16},
                      "check": {"requests": 8}},
    "train": {"trace_steps": 1},
}
CPU_TRAFFIC = {
    "serve": {"prompt": {"median": 24, "sigma": 0.5, "min": 4, "max": 48},
              "output": {"median": 6, "sigma": 0.5, "min": 3, "max": 12}},
    "train": {"batch": 2, "seq_len": 16},
}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and \
            isinstance(base.get(k), dict) else v
    return out


def cpu_context(name: str, seed: int = 7, seconds: float = 1.5,
                trace: bool = False, control: bool = False,
                root: Path = ROOT) -> "bench_run.Context":
    """A run of cell ``name`` on the CPU at a test's size."""
    cell = spec.load_cell(name, root)
    small, over = small_conf(spec.load_config(cell["config"], root))
    ctx = bench_run.Context(root, name, seed, seconds, trace, device="cpu",
                            control=control, config=small,
                            port_overrides=over)
    ctx.cell = _merge(ctx.cell, CPU_CELL[cell["driver"]])
    ctx.traffic = _merge(ctx.traffic, CPU_TRAFFIC[ctx.traffic["kind"]])
    return ctx


@pytest.fixture
def cpu_run():
    return cpu_context

"""The benchmark of the port ``repro_torch`` on one NVIDIA H100.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One process, one run: it loads the cell's
files (``bench/cells/<cell>.json`` and what it names), makes the weights
and traffic from ``--seed``, warms up the cell's shapes (set-up), drives
the cell's window driver for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones, each
read by ``bench/metrics/<metric>.py``), ``device``, ``breakdown`` (traced
runs) and ``checks`` (each number compared, with its limit), the
comparisons also as the last lines of standard error.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and when the process holds ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` once the window has closed.

The program's nvcc libraries build into ``build/repro_torch_kernels``
inside the checkout (the port's own fixed path); the caches a library
could keep (Triton, PyTorch extensions, CUDA's JIT) are pointed into
``build/bench_cache`` inside the checkout, so only a checkout's first run
builds.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
CACHE = ROOT / "build" / "bench_cache"


def _setup_paths() -> None:
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


_setup_paths()

from benchcore import check, spec  # noqa: E402
from benchcore.program import add_program_path, forbidden_modules  # noqa: E402


class Context:
    """What a driver reads: the cell's files, the run's arguments, and the
    device's few operations (a sync, the peak, freeing the cache)."""

    def __init__(self, root: Path, name: str, seed: int, seconds: float,
                 trace: bool, device: str = "cuda", control: bool = False,
                 config: dict | None = None, port_overrides: dict | None = None,
                 t_start: float | None = None):
        import torch

        self.root, self.name, self.seed = Path(root), name, seed
        self.seconds, self.trace, self.control = seconds, trace, control
        self.check = True           # a knee sweep runs without the check
        self.device = torch.device(device)
        self.bench = spec.load_benchmark(self.root)
        self.workload = spec.workload(self.bench, name)
        self.cell = spec.load_cell(name, self.root)
        if (self.cell["config"], self.cell["traffic"]) != (
                self.workload["config"], self.workload["traffic"]):
            raise ValueError(f"{name}: the cell file and BENCHMARK.json "
                             "name different configs or traffic")
        self.config = config or spec.load_config(self.cell["config"],
                                                 self.root)
        self.traffic = spec.load_traffic(self.cell["traffic"], self.root)
        self.port_overrides = port_overrides
        self.t_start = T_START if t_start is None else t_start

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        import torch
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            import torch
            torch.cuda.empty_cache()


def build_libraries(ctx: Context) -> None:
    """The program's nvcc libraries the cell's kernels load (the cell's
    ``libraries``), built side by side where missing; a library a cell
    does not name still builds when its kernel first runs."""
    if ctx.cuda and ctx.cell.get("libraries"):
        from repro_torch.kernels import build
        build.build_all(ctx.cell["libraries"])


def run_cell(ctx: Context) -> tuple[dict, dict]:
    """Drive the cell; returns (the result line, the driver's record)."""
    build_libraries(ctx)
    driver = spec.load_module("drivers", ctx.cell["driver"], ctx.root)
    rec = driver.run(ctx)
    rec["device_name"] = _device_name(ctx)
    ok, rows = check.judge(rec["readings"], ctx.cell["check"]["limits"])
    if rec["attempted"] <= 0:
        ok = False
        rows.append(("attempted", rec["attempted"], 1))
    kind = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for m in spec.cell_metrics(ctx.bench, ctx.name, kind):
        value = spec.load_module("metrics", m["name"], ctx.root).read(rec)
        if value is None:
            if kind == "end_to_end":
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.cuda else "cpu",
              "kind": _device_name(ctx), "count": ctx.workload["chips"],
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": bool(ok), "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]), "metrics": metrics,
           "device": device}
    if ctx.trace and rec.get("trace") is not None:
        tr = rec["trace"]
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = {"device_ops": [list(x) for x in tr["device_ops"]],
                            "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in rows}
    return out, rec


def _device_name(ctx: Context) -> str:
    if not ctx.cuda:
        return "cpu"
    import torch
    return torch.cuda.get_device_name(ctx.device)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = spec.workload(spec.load_benchmark(ROOT), args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"bench: no program under test: {ROOT / 'src' / 'repro_torch'}"
              " is missing", file=sys.stderr)
        return 2
    add_program_path(ROOT)
    import repro_torch

    if ROOT not in Path(repro_torch.__file__).resolve().parents:
        print(f"bench: repro_torch was loaded from {repro_torch.__file__}, "
              "not from this checkout", file=sys.stderr)
        return 2
    print(f"bench: {args.workload} seed {args.seed} on "
          f"{_power_limit()}", file=sys.stderr)
    ctx = Context(ROOT, args.workload, args.seed, args.seconds,
                  bool(args.trace))
    out, _ = run_cell(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded forbidden modules: {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

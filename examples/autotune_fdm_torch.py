"""Paper §5 Sample 8 end-to-end on the PyTorch/CUDA port: auto-tune the
ppOpen-APPL/FDM stress kernel's 8 loop-split/fusion variants — at BOTH
levels of the stack, entirely through the ``repro_torch.at`` session API
(the same flow as ``examples/autotune_fdm.py`` on the JAX package).

    PYTHONPATH=src python examples/autotune_fdm_torch.py               # on the card
    PYTHONPATH=src python examples/autotune_fdm_torch.py --device cpu  # plain version

Level 1 (the paper, literally): the annotated Python loop nest is expanded
by ``AutoTuner.preprocess`` into the 8 candidates, each wall-clock
measured through a named executor backend, and the winner committed
through an install-time select region (then persisted in the session's
record store).

Level 2 (the GPU adaptation): the same update as the CUDA kernel K7 with
the fused-vs-split trade-off (SplitPointCopyDef == recomputing the QG
plane in the second launch) and its tile PPs, on a 256^3 grid (one GPU
rank's subdomain of a Seism3D-type run), each variant held against the
plain PyTorch version and timed with CUDA events.  ``--device cpu`` runs
the plain version alone, on a 16^3 grid.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import torch

import repro_torch.at as at
from repro_torch.core.executor import CudaEventExecutor
from repro_torch.device import resolve
from repro_torch.kernels import ref
from repro_torch.kernels.fdm_stress import ARRAYS, STATE, fdm_stress

TILES = ((8, 8, 128), (4, 8, 256), (16, 16, 16), (2, 4, 128))
TOL = 2e-4          # |kernel - plain| <= TOL + TOL * |plain|, float32


def level1(workdir: str) -> dict:
    """The annotated loop nest: 8 candidates, an install-time winner."""
    from fdm_sample import _fdm_inputs, fdm_stress as fdm_loops

    tuner = at.AutoTuner(workdir, executor="fdm-wallclock")
    tuner.set_bps(numprocs=1, start=8, end=8, dist=8)

    regions = tuner.preprocess(fdm_loops)
    region = regions["FDMStress"]
    print(f"Sample 8 candidates ({len(region.subregions)}):")
    for i, sub in enumerate(region.subregions, 1):
        print(f"  #{i} {sub.name}")
    assert len(region.subregions) == 8

    n = 10
    arrs, state = _fdm_inputs(n=n)

    if "fdm-wallclock" not in at.executors:
        @at.executors.register("fdm-wallclock")
        def fdm_executor(region, bp_env):
            def measure(asg):
                idx = asg["FDMStress_SELECT"]
                st = {k: v.copy() for k, v in state.items()}
                t0 = time.perf_counter()
                region.subregions[idx].fn(n, n, n, **arrs, **st, DT=0.1)
                return time.perf_counter() - t0
            return measure

    tuner.run("install", ["FDMStress"])
    best = int(tuner.best("FDMStress")["FDMStress_SELECT"])
    print(f"install-time winner: #{best + 1} "
          f"({region.subregions[best].name})")
    print(f"({tuner.executor_calls} variants measured; winner persisted in "
          f"{at.ATRecordStore(workdir).path})\n")
    return {"candidates": len(region.subregions), "winner": best,
            "measured": tuner.executor_calls}


def fdm_grid(shape, device, seed=0):
    """Sample 8's inputs on ``device`` from a seed: rig in [0.5, 2)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*s):
        return torch.randn(s, generator=gen, device=device)

    nx, ny, nz = shape
    arrays = {n: normal(*shape) for n in ARRAYS if n != "rig"}
    arrays.update(absx=normal(nx), absy=normal(ny), absz=normal(nz))
    arrays["rig"] = torch.rand(shape, generator=gen, device=device) * 1.5 + 0.5
    state = {n: normal(*shape) for n in STATE}
    return arrays, state


def level2(device: torch.device, n: int) -> dict:
    """K7's fused and split variants against the plain version."""
    arrays, state = fdm_grid((n, n, n), device)
    want = ref.fdm_stress_ref(arrays, state, 0.1)
    if device.type != "cuda":
        assert all(torch.isfinite(v).all() for v in want.values())
        print(f"plain version on {device}, {n}^3 grid: 6 finite outputs "
              f"(the CUDA kernel K7 runs only on the card)")
        return {"device": str(device), "grid": n}
    print(f"K7 variants on {torch.cuda.get_device_name(device)}, {n}^3 "
          f"float32 grid, against the plain version (tol {TOL}), device "
          f"ms from CUDA events (min of 5):")
    results = {}
    for variant in ("fused", "split"):
        for tiles in TILES:
            kw = dict(variant=variant, bx=tiles[0], by=tiles[1], bz=tiles[2])
            got = fdm_stress(arrays, state, 0.1, **kw)
            torch.cuda.synchronize(device)
            err = 0.0
            for k in STATE:
                diff = (got[k] - want[k]).abs()
                assert bool((diff <= TOL + TOL * want[k].abs()).all()), \
                    f"{variant} {tiles} {k}: max err {float(diff.max())}"
                err = max(err, float(diff.max()))
            ms = 1e3 * CudaEventExecutor(
                lambda _: lambda: fdm_stress(arrays, state, 0.1, **kw),
                repeats=5, warmup=1, device=device)({})
            results[variant, tiles] = (err, ms)
            print(f"  {variant:6s} tiles {tiles}: max_err={err:.2e} "
                  f"{ms:.4f} ms (QG "
                  f"{'computed once' if variant == 'fused' else 'recomputed — SplitPointCopyDef'})")
    best = min(results, key=lambda key: results[key][1])
    print(f"fastest: {best[0]} tiles {best[1]} "
          f"{results[best][1]:.4f} ms")
    return {"device": str(device), "grid": n, "results": results,
            "fastest": best}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernel K7, default) or cpu (its "
                             "plain version)")
    args = parser.parse_args(argv)
    device = resolve(args.device)
    n = 256 if device.type == "cuda" else 16
    out = {"level1": level1(tempfile.mkdtemp(prefix="oat_fdm_torch_")),
           "level2": level2(device, n)}
    print("\nOK — paper Sample 8 reproduced at loop-nest AND kernel level.")
    return out


if __name__ == "__main__":
    main()

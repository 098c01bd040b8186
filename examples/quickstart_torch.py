"""Quickstart of the PyTorch/CUDA port: the complete ppOpen-AT flow on a
real kernel in ~60 lines, entirely through the ``repro_torch.at`` session
API (the same flow as ``examples/quickstart.py`` on the JAX package).

    PYTHONPATH=src python examples/quickstart_torch.py

1. annotate a matmul with #OAT$ directives (paper Sample 1/4 style);
2. ``AutoTuner.preprocess`` expands it into unrolled variants under ./OAT/;
3. ``AutoTuner.run("install")`` searches the (i, j) unroll space with a
   custom executor registered by name in ``at.executors``;
4. the tuned variant runs, numerically identical to the baseline;
5. a SECOND session pointed at the same workdir warm-loads the optimum
   from the persistent record store — zero measurements.
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

import repro_torch.at as at


def matmul_kernel(N, A, B, C):
    #OAT$ install unroll region start
    #OAT$ name MyMatMul
    #OAT$ varied (i, j) from 1 to 4
    #OAT$ search AD-HOC
    for i in range(N):
        for j in range(N):
            for k in range(N):
                A[i, j] = A[i, j] + B[i, k] * C[k, j]
    #OAT$ install unroll region end
    return A


n = 16
rng = np.random.default_rng(0)
b, c = rng.normal(size=(n, n)), rng.normal(size=(n, n))


@at.executors.register("unrolled-matmul")
def measure_variant(region, bp_env):
    """Wall-clock one unrolled variant on a 16x16 matmul."""
    def measure(asg):
        variant = region.fn(i=asg["MyMatMul_I"], j=asg["MyMatMul_J"])
        a = np.zeros((n, n))
        t0 = time.perf_counter()
        variant(n, a, b, c)
        return time.perf_counter() - t0
    return measure


def make_session(workdir):
    tuner = at.AutoTuner(workdir, executor="unrolled-matmul")
    tuner.set_bps(numprocs=1, start=16, end=16, dist=16)
    regions = tuner.preprocess(matmul_kernel)
    return tuner, regions


def main():
    workdir = tempfile.mkdtemp(prefix="oat_quickstart_")
    tuner, regions = make_session(workdir)
    print(f"registered regions: {list(regions)}")
    print(f"generated code: {workdir}/OAT/OAT_matmul_kernel.py")

    tuner.run("install", ["MyMatMul"])
    best = tuner.best("MyMatMul")
    besti, bestj = best["MyMatMul_I"], best["MyMatMul_J"]
    print(f"tuned unroll factors: i={besti} j={bestj} "
          f"(searched {tuner.executor_calls} variants, AD-HOC)")

    a = np.zeros((n, n))
    regions["MyMatMul"].fn(i=besti, j=bestj)(n, a, b, c)
    np.testing.assert_allclose(a, b @ c, rtol=1e-10)
    print("tuned variant matches numpy matmul — OK")
    print(open(os.path.join(workdir, "OAT_InstallParam.dat")).read())

    # the tuning database makes the result durable: a fresh session on the
    # same workdir loads the optimum without re-timing anything
    tuner2, _ = make_session(workdir)
    tuner2.run("install", ["MyMatMul"])
    assert tuner2.executor_calls == 0, "warm path must not re-measure"
    assert tuner2.best("MyMatMul") == best
    print(f"second session: warm-loaded i={besti} j={bestj} from "
          f"{at.ATRecordStore(workdir).path} with 0 measurements — OK")


if __name__ == "__main__":
    main()

"""Serving example of the PyTorch/CUDA port: continuous batching + run-time AT.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

Serves a reduced yi-6b from the paged pool (on the card unless ``--device
cpu``) twice in one workdir with ``autotune``: the first serve measures
each candidate of its ``DecodeBucket`` and ``PrefillBucket`` regions once
(on the card the kernels' tiles, for the reduced config's float32 query
the SIMT templates' one tile; on the CPU the plain attention, which reads
no tile) and commits the winners; the second
warm-loads them from the record file and measures nothing.  Then the
paper's run-time AT on a simulated decode (Samples 6/7): the first calls
of a length bucket measure the variants, the winner runs every call after.
Each simulated variant reports its cost in its result, and the region
commits on that (its ``according`` criterion ``min (cost)``), so the
winner does not depend on how busy the host is.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import at
from repro_torch.launch.serve import ServeConfig, serve_config
from repro_torch.tuning import DecodeAutoTuner


def main(device: str = "cuda"):
    workdir = tempfile.mkdtemp(prefix="serve_at_")
    scfg = ServeConfig(arch="yi-6b", n_requests=6, n_lanes=3, max_len=80,
                       max_new=8, cache="paged", prefill_chunk=16,
                       autotune=True, workdir=workdir, device=device)
    for run in ("cold", "warm"):
        out = serve_config(scfg)
        a = out["autotune"]
        print(f"{run}: served {out['finished']}/{out['requests']} requests, "
              f"{out['generated_tokens']} tokens, {out['tokens_per_s']:.1f} "
              f"tok/s on {out['device']}; {a['measurements']} measurements, "
              f"{len(a['warm_regions'])} regions warm-loaded, decode "
              f"committed {a['committed']['decode']}")
    assert a["measurements"] == 0 and a["executor_calls"] == 0
    print("warm restart made 0 measurements — OK")

    # run-time AT on a simulated decode (paper Samples 6/7)
    session = at.AutoTuner(tempfile.mkdtemp(prefix="serve_at_sim_"))
    timings = {32: 3e-3, 64: 1e-3, 128: 2e-3}       # simulated kernel costs

    def make_decode(block_k):
        def fn():
            return {"block_k": block_k, "cost": timings[block_k]}
        return fn

    tuner = DecodeAutoTuner(session, make_decode, buckets=(512,),
                            block_ks=(32, 64, 128))
    tuner.regions[512].according = at.According.parse("min (cost)")
    for i in range(5):
        out = tuner.decode(300)
        phase = "tuning" if i < 3 else "committed"
        print(f"call {i}: block_k={out['block_k']} [{phase}]")
    assert tuner.committed()[512] == 1     # 64 is fastest
    print("run-time AT committed block_k=64 (fastest) — OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)

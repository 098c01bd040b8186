"""Two trees on one card, alternated.

Runs ``chip_smoke.py``'s phase 5 (yi-6b full, dense) and phase 9 (paged)
serves from this tree ("change") and from another checkout ("parent",
by default ``build/parent``: unpack ``git archive <commit>`` there),
each run in a process of its own, in the order warm-up, parent, change,
change, parent, and prints each run's tokens/s, p50 TTFT, p50 ITL and
wall seconds; ``chiprun_out/ab_serve.json`` keeps them.  The kernels are
built once: the parent's build directory points at this tree's, so the
two trees must not differ in a kernel source.  Needs the card::

    python3 chip_ab.py [PARENT_DIR]

With ``--g7 TREE ...`` it times instead the bf16 prefill kernels at G 7
(28 q / 4 kv heads of 128, phase 39 (c)'s shapes: K4 and K6c on a chunk
of 128 at 384, K5b and K6d with K5c at 8 splits on the verify shape) in
each tree, whose kernel sources may differ: each tree builds its own
padded prefill library (all side by side), then each tree's timing runs
in a fresh process three times, the trees in a rotated order; each line
is the median of 5 means of 50 calls (``chip_smoke.time_ms``) and the
max abs error against plain.  ``chiprun_out/ab_g7.json`` keeps them::

    python3 chip_ab.py --g7 build/ab_pre . build/ab_fast
"""
import json
import os
import subprocess
import sys

CHILD = r'''
import json, chip_smoke as cs
smi = cs.phase_card()
cs.phase_build()
dense, _ = cs.phase_serve(smi)
paged, _ = cs.phase_paged_serve(smi, dense)
keys = ("tokens_per_s", "p50_ttft_s", "p50_itl_s", "wall_s")
print("AB" + json.dumps({"dense": {k: dense[k] for k in keys},
                         "paged": {k: paged[k] for k in keys}}))
'''


G7_BUILD = r'''
import sys
sys.path.insert(0, "src")
from repro_torch.kernels import build
build.load("paged_prefill" + build.PADDED)
'''

G7_CHILD = r'''
import json, statistics, sys, torch
import chip_smoke as cs
from repro_torch.kernels import ops, ref
BF16 = torch.bfloat16
CHUNK = ("G 7 chunk at 384", 28, 4, 128, 16, 32, [384], [128], 128, BF16)
VERIFY = ("G 7 verify", 28, 4, 128, 16, 64, [839, 720, 190, 544, 0],
          [5, 5, 5, 5, 0], 5, BF16)
out = {}
for label, case, quant, ns, seed in (("K4", CHUNK, False, 1, 4723),
                                     ("K6c", CHUNK, True, 1, 5176),
                                     ("K5b+K5c", VERIFY, False, 8, 4769),
                                     ("K6d+K5c", VERIFY, True, 8, 5229)):
    q, pools, table, start, lens = cs.split_case(case, seed, quant)
    want = ref.paged_prefill_ref(q, pools.k, pools.v, table, start, lens,
                                 k_scale=pools.k_scale, v_scale=pools.v_scale)
    live = [b for b, v in enumerate(case[7]) if v]
    run = lambda: ops.paged_prefill(q, pools, table, start, lens,
                                    num_splits=ns)
    err = cs.compare(run()[live], want[live], BF16)
    out[label] = [statistics.median(cs.time_ms(run, 50)[0]
                                    for _ in range(5)), err]
print("AB" + json.dumps(out))
'''


def g7(trees: list[str]) -> int:
    """The ``--g7`` comparison of ``trees`` (see the module docstring)."""
    builds = [subprocess.Popen([sys.executable, "-c", G7_BUILD], cwd=tree)
              for tree in trees]
    if any(b.wait(timeout=900) for b in builds):
        print("a build FAILED")
        return 1
    out = []
    n = len(trees)
    for rnd in range(3):
        for i in range(n):
            tree = trees[(i + rnd) % n]
            p = subprocess.run([sys.executable, "-c", G7_CHILD], cwd=tree,
                               env={**os.environ, "PYTHONPATH": "src"},
                               capture_output=True, text=True, timeout=300)
            line = [x for x in p.stdout.splitlines() if x.startswith("AB")]
            if p.returncode or not line:
                print(tree, "FAILED", p.returncode, p.stdout[-3000:],
                      p.stderr[-3000:])
                return 1
            out.append((tree, json.loads(line[0][2:])))
            print(tree, json.dumps(out[-1][1]), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/ab_g7.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--g7"]:
        return g7(sys.argv[2:])
    parent = sys.argv[1] if len(sys.argv) > 1 else "build/parent"
    os.makedirs(os.path.join(parent, "build"), exist_ok=True)
    link = os.path.join(parent, "build", "repro_torch_kernels")
    if not os.path.exists(link):
        os.symlink(os.path.abspath("build/repro_torch_kernels"), link)
    out = []
    for tag in ("warm-up", "parent", "change", "change", "parent"):
        tree = parent if tag == "parent" else "."
        p = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                           capture_output=True, text=True, timeout=600)
        line = [x for x in p.stdout.splitlines() if x.startswith("AB")]
        if p.returncode or not line:
            print(tag, "FAILED", p.returncode, p.stdout[-3000:],
                  p.stderr[-3000:])
            return 1
        rec = json.loads(line[0][2:])
        out.append((tag, rec))
        print(tag, json.dumps(rec), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/ab_serve.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

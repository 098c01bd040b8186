"""Host-bound serve throughput of two trees on one card, alternated.

Runs ``chip_smoke.py``'s phase 5 (yi-6b full, dense) and phase 9 (paged)
serves from this tree ("change") and from another checkout ("parent",
by default ``build/parent``: unpack ``git archive <commit>`` there),
each run in a process of its own, in the order warm-up, parent, change,
change, parent, and prints each run's tokens/s, p50 TTFT, p50 ITL and
wall seconds; ``chiprun_out/ab_serve.json`` keeps them.  The kernels are
built once: the parent's build directory points at this tree's, so the
two trees must not differ in a kernel source.  Needs the card::

    python3 chip_ab.py [PARENT_DIR]
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


def main() -> int:
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

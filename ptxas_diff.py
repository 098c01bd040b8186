"""Compare the ``-Xptxas -v`` reports of two builds of the port's CUDA
sources, kernel instance by kernel instance: registers, spill stores and
static shared memory.

    python3 ptxas_diff.py OLD_BUILD_DIR NEW_BUILD_DIR

Each directory is a ``build/repro_torch_kernels`` of
``kernels/build.py`` (a ``<source>-<hash>.log`` beside each library).  An
instance is named by its mangled entry name without its anonymous
namespace, up to the end of its template arguments (a parameter added to
the kernel does not rename it), and one or two trailing ``false``
template arguments that the old build's name lacks (mode flags added to
a template) are dropped before matching, so an instance built before and
after such a change is compared with itself.  Prints one
line per instance that differs and a summary line; exits 1 when any
instance that both builds have differs, or when an old instance has no
match.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path


def instances(build_dir: Path) -> dict[str, tuple[int, int, int]]:
    """{mangled name: (registers, spill-store bytes, smem bytes)} of every
    entry function in the directory's logs."""
    out = {}
    for log in sorted(build_dir.glob("*.log")):
        for chunk in log.read_text().split("Compiling entry function")[1:]:
            name = re.match(r"\s*'([^']+)'", chunk)
            regs = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores", chunk)
            smem = re.search(r"(\d+) bytes smem", chunk)
            if name and regs:
                out[name.group(1)] = (
                    int(regs.group(1)), int(spill.group(1)) if spill else 0,
                    int(smem.group(1)) if smem else 0)
    return out


def keys(name: str, unflag: bool = False) -> list[str]:
    """The mangled name without its anonymous namespace (named by a hash
    of the source, so it differs between builds), up to its template
    arguments' end (the ``E``s before the return type ``v``); with
    ``unflag`` (a new build's name) also without one or two trailing
    ``bool`` template arguments ``false`` (``Lb0E`` before those ``E``s),
    the forms the instance's old name may have."""
    name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", name)
    if "Ev" in name:
        name = name[:name.index("Ev") + 2]
    out = [name]
    if unflag:
        for _ in range(2):
            name = re.sub(r"Lb0E(E+v)$", r"\1", name)
            out.append(name)
    return out


def main(old_dir: str, new_dir: str) -> int:
    old, new = instances(Path(old_dir)), instances(Path(new_dir))
    by_key = {}
    for name, v in new.items():
        for k in keys(name, unflag=True)[1:]:
            by_key.setdefault(k, v)
    for name, v in new.items():
        by_key[keys(name)[0]] = v
    same = differ = missing = 0
    for name, v in sorted(old.items()):
        w = by_key.get(keys(name)[0])
        if w is None:
            missing += 1
            print(f"missing  {name}")
        elif w != v:
            differ += 1
            print(f"differs  {name}: (registers, spill B, smem B) {v} -> {w}")
        else:
            same += 1
    print(f"ptxas_diff: {same} instances the same, {differ} differ, "
          f"{missing} missing, {len(new) - same - differ} new")
    return 1 if differ or missing else 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))

"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes), named by a hash of its source, the shared ``csrc/*.cuh``
headers and the flags, under ``<checkout>/build/repro_torch_kernels/``.
A library is rebuilt when any of those change and is reused otherwise.  Sources that need a
build are compiled in parallel, one nvcc process each.

Nothing here runs at import: the CPU tests import every module of the
port, and this machine's CPU-only install has no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built on the machine with the card")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source, every
    header of ``csrc`` (a source may include any of them) and the flags."""
    data = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        data += header.name.encode() + header.read_bytes()
    digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named source (default: all of ``csrc``) whose library
    is missing, all nvcc processes started together.  Raises with nvcc's
    output if any fails.  The compiler's ``-Xptxas -v`` report (registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        todo[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])     # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _loaded[name] = lib
    return lib

"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes), named by a hash of its source, the shared ``csrc/*.cuh``
headers and the flags, under ``<checkout>/build/repro_torch_kernels/``.
The attention sources of :data:`PADDED_SOURCES` build three times, into
``<name>`` (the instances of their own), ``<name>_padded`` (the padded
ones up to 256, ``-DREPRO_PADDED=1``: ``csrc/common.cuh``) and
``<name>_wide`` (the wide rungs 384 and 512, ``-DREPRO_WIDE=1``), so that
the three parts compile side by side; the own instances of a source in
:data:`OWN_PARTS` split further (``paged_prefill``'s over int8 pools into
``paged_prefill_int8``, ``-DREPRO_INT8_POOLS=1``).  A library is rebuilt
when any of those change and is reused otherwise.  Libraries that need a
build are compiled in parallel, one nvcc process each, at most one a CPU
core at a time and the slowest first (:data:`SLOWEST_FIRST`), so that no
long compile starts last.

Nothing here runs at import: the CPU tests import every module of the
port, and this machine's CPU-only install has no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the sources whose padded and wide instances build into libraries of
#: their own
PADDED_SOURCES = ("flash_attention", "paged_attention", "paged_decode",
                  "paged_prefill")
PADDED = "_padded"
WIDE = "_wide"
#: the library suffix of each part and the flags it adds
PARTS = {"": (), PADDED: ("-DREPRO_PADDED=1",), WIDE: ("-DREPRO_WIDE=1",)}
#: the own instances of csrc/paged_prefill.cu over int8 pools (K6c, K6d)
#: build into a library of their own, apart from those over bf16 pools
#: (K4, K5b): 76 instances in one library took 100 s of nvcc, the
#: build's longest (H100 machine, 8 cores)
INT8_POOLS = "_int8"
#: source -> {the suffix of a library of some of its own instances: the
#: flags it adds}
OWN_PARTS = {"paged_prefill": {INT8_POOLS: ("-DREPRO_INT8_POOLS=1",)}}
#: the libraries by nvcc seconds alone, slowest first, on the H100
#: machine (each library's ``.log``); a library not named here starts
#: after these
SLOWEST_FIRST = ("matmul", "paged_attention_padded", "paged_prefill_padded",
                 "paged_decode_padded", "paged_prefill",
                 "paged_prefill_int8", "paged_decode", "paged_attention",
                 "flash_attention", "paged_prefill_wide",
                 "flash_attention_padded", "paged_decode_wide",
                 "paged_attention_wide", "ssm_scan", "flash_attention_wide",
                 "fdm_stress")

_loaded: dict[str, ctypes.CDLL] = {}


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """The source of library ``name`` and the flags it adds."""
    for stem, parts in OWN_PARTS.items():
        for suffix, flags in parts.items():
            if name == stem + suffix:
                return CSRC / f"{stem}.cu", flags
    for suffix, flags in PARTS.items():
        if suffix and name.endswith(suffix):
            return CSRC / f"{name[:-len(suffix)]}.cu", flags
    return CSRC / f"{name}.cu", ()


def library_names() -> list[str]:
    """Every library the sources build into."""
    stems = sorted(p.stem for p in CSRC.glob("*.cu"))
    return (stems + [s + suffix for suffix in PARTS if suffix for s in stems
                     if s in PADDED_SOURCES]
            + [s + suffix for s in stems for suffix in OWN_PARTS.get(s, ())])


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built on the machine with the card")
    return path


def library_path(name: str) -> Path:
    """Where library ``name`` builds to, keyed by its source, every header
    of ``csrc`` (a source may include any of them) and the flags."""
    source, extra = _source(name)
    data = source.read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        data += header.name.encode() + header.read_bytes()
    flags = " ".join(NVCC_FLAGS + extra)
    digest = hashlib.sha256(data + flags.encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_order(names) -> list[str]:
    """``names`` in the order their nvcc processes start: the slowest
    first (:data:`SLOWEST_FIRST`), then the others by name."""
    rank = {n: i for i, n in enumerate(SLOWEST_FIRST)}
    return sorted(names, key=lambda n: (rank.get(n, len(rank)), n))


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named library (default: all, :func:`library_names`)
    that is missing: at most as many nvcc processes at once as this
    process has CPU cores, started in :func:`build_order`.  Raises with
    nvcc's output if any fails.  The compiler's ``-Xptxas -v`` report (registers, shared
    memory, spills) is kept beside each library as ``.log``, after a first
    line with the library's seconds of nvcc, from its start to its end."""
    if names is None:
        names = library_names()
    paths = {n: library_path(n) for n in names}
    todo = {n: paths[n] for n in build_order(names) if not paths[n].exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    jobs = len(os.sched_getaffinity(0))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    waiting, procs, seconds = list(todo), {}, {}
    # poll, since they run side by side and finish in any order; a process
    # starts when one ends
    while len(seconds) < len(todo):
        running = [n for n in procs if n not in seconds]
        while waiting and len(running) < jobs:
            n = waiting.pop(0)
            p = todo[n]
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            # the report goes to a file, not a pipe: nvcc would block on a
            # full pipe while this loop polls it
            out = open(p.with_suffix(f".{os.getpid()}.out"), "w+")
            source, extra = _source(n)
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(source)]
            procs[n] = (subprocess.Popen(cmd, stdout=out,
                                         stderr=subprocess.STDOUT,
                                         text=True),
                        tmp, out, time.monotonic())
            running.append(n)
        for n in running:
            proc, _, _, t0 = procs[n]
            if proc.poll() is not None:
                seconds[n] = time.monotonic() - t0
        time.sleep(0.05)
    failed = []
    for n, (proc, tmp, out, _) in procs.items():
        out.seek(0)
        text = out.read()
        out.close()
        os.unlink(out.name)
        todo[n].with_suffix(".log").write_text(
            f"nvcc seconds: {seconds[n]:.1f}\n{text}")
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n} (exit {proc.returncode}) ---\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])     # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``<source>``, ``<source>_padded``,
    ``<source>_wide`` or a part of :data:`OWN_PARTS`), built first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _loaded[name] = lib
    return lib

"""Install-time AT: machine-dependent kernel performance parameters.

The paper's install-time phase tunes PPs that depend only on the machine
(Sample 1: unroll depth).  Here those are the tile shapes of the GEMM K8
(``kernels/matmul.py``): the ``MatmulBlocks`` region, with the JAX
package's region and PP names so the two tuning DBs stay comparable.
Its ``varied`` values are Hopper's, :data:`~..kernels.matmul.TILE_VALUES`
(32, 64, 128): the kernel keeps a ``bm x bn`` float32 sum in registers,
and a 256 x 256 one would take the whole register file of an SM.

Declared through the ``repro_torch.at`` session API.  Executor backends
(``at.executors``):

* ``analytic-cost`` (default here) — :func:`matmul_blocks_cost`: grid
  steps, with a penalty for tiles whose shared memory leaves room for
  only one block on an SM, and ``inf`` for a tile over the per-block
  shared-memory limit;
* ``cuda-event`` (registered by this module) — CUDA-event device time of
  the real K8 on the card at the registered (m, n, k) in bfloat16; with
  ``device="cpu"`` (tests) the host-clock time of the plain version.

Results are published to :func:`repro_torch.at.tuned` under ``matmul``
— :func:`..kernels.ops.mm` launches K8 with them — and persist in the
session's record store, so a second process on the same machine
warm-loads them without re-timing.

``FlashBlocks`` waits until the port's K1 takes ``block_q``/``block_k``
tiles and ``SsmChunk`` until K9 is ported: no region is declared whose
PPs reach no kernel.
"""
from __future__ import annotations

import math

import torch

from .. import at
from ..core import ATContext, Varied
from ..core.executor import CudaEventExecutor, WallClockExecutor
from ..device import resolve
from ..kernels import ref
from ..kernels.matmul import TILE_VALUES, matmul, smem_bytes, \
    smem_per_block_limit

BF16_BYTES = 2


def matmul_blocks_cost(bm: int, bn: int, bk: int, *, m: int, n: int, k: int,
                       smem_limit: int) -> float:
    """Analytic install-time cost of K8's tile (bm, bn, bk) in bfloat16.

    A tile whose block needs more shared memory than ``smem_limit`` bytes
    cannot be launched on the card at all: it costs ``inf`` and no
    executor ever launches it (a candidate the card cannot run, not a
    fallback).  Otherwise the cost is the number of block-steps (blocks x
    K steps; fewer, larger tiles amortise the per-step load and sync),
    raised 4x per unit by which the block's shared memory passes half the
    limit, where only one block fits on an SM and nothing hides its
    loads.
    """
    used = smem_bytes(bm, bn, bk, BF16_BYTES)
    if used > smem_limit:
        return math.inf
    over = max(0.0, used / (smem_limit / 2) - 1.0)
    steps = math.ceil(m / bm) * math.ceil(n / bn) * math.ceil(k / bk)
    return steps * (1.0 + 4.0 * over)


def register_kernel_regions(session: "at.AutoTuner | ATContext", *,
                            m: int = 2048, n: int = 2048, k: int = 2048,
                            seq: int = 2048, d_head: int = 128,
                            d_inner: int = 4096, d_state: int = 16,
                            smem_limit: int | None = None) -> None:
    """Declare the install-time regions for every kernel PP.

    ``(m, n, k)`` is the GEMM shape the ``MatmulBlocks`` region is costed
    and timed at.  ``smem_limit`` is the per-block shared-memory limit in
    bytes; ``None`` reads it from the card (the opt-in limit, 232,448 on
    an H100).  ``seq``, ``d_head``, ``d_inner`` and ``d_state`` size the
    JAX package's ``FlashBlocks`` and ``SsmChunk`` regions, which wait
    for their kernels' tiles here; they are accepted so that callers of
    either package pass the same arguments.
    """
    session = at.AutoTuner.for_context(session)
    if smem_limit is None:
        smem_limit = smem_per_block_limit(resolve("cuda"))

    @session.autotune(
        "install", "variable", name="MatmulBlocks",
        varied=Varied(("bm", "bn", "bk"), values=TILE_VALUES),
        search="ad-hoc", executor="analytic-cost",
        publish=("matmul", {"bm": "block_m", "bn": "block_n",
                            "bk": "block_k"}),
        metadata={"shape": (m, n, k), "smem_limit": smem_limit})
    def matmul_blocks(bm=64, bn=64, bk=64):
        return matmul_blocks_cost(bm, bn, bk, m=m, n=n, k=k,
                                  smem_limit=smem_limit)


_KERNEL_REGIONS = ("MatmulBlocks",)


def run_install_tuning(session: "at.AutoTuner | ATContext",
                       wall_clock: bool = False, *,
                       device: str | torch.device = "cuda") -> dict:
    """Execute install-time AT and publish tuned PPs to the kernel layer.

    ``wall_clock=True`` switches the kernel regions to the ``cuda-event``
    executor, which times K8 on ``device`` (the card; ``"cpu"`` times the
    plain version with the host clock, for tests).  A session whose
    record store already holds results for this machine re-loads them
    without invoking any executor.
    """
    session = at.AutoTuner.for_context(session)
    session.ensure_default_bps(numprocs=1, start=1024, end=4096, dist=1024)
    names = [n for n in _KERNEL_REGIONS if n in session.ctx.registry]
    for name in names:
        # set (not just override) so a later call with the other setting
        # restores the analytic default
        metadata = session.ctx.registry.get(name).metadata
        metadata["executor"] = "cuda-event" if wall_clock else "analytic-cost"
        metadata["device"] = str(device)
    session.run("install", names)
    tuned: dict[str, dict] = {}
    for region_name in names:
        spec = session._publish_maps.get(region_name)
        if spec is None:
            continue
        _, mapping = spec
        pps = {}
        for src, dst in mapping.items():
            e = session.ctx.store.entry(f"{region_name}_{src.upper()}")
            if e is not None:
                pps[dst] = int(e.value)
        if pps:
            tuned[region_name] = pps
    return tuned


@at.executors.register("cuda-event")
def _cuda_event_executor(region, bp_env):
    """Device time of K8 at the region's (m, n, k) in bfloat16, from CUDA
    events (minimum over 10 launches after 2 untimed ones); on a CPU
    device, the host-clock time of the plain version."""
    m, n, k = region.metadata["shape"]
    limit = region.metadata["smem_limit"]
    device = resolve(region.metadata.get("device", "cuda"))
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    y = torch.randn((k, n), generator=gen, device=device).to(torch.bfloat16)

    def tiles(assignment):
        bare = {key.split("_", 1)[1].lower(): v
                for key, v in assignment.items()}
        return dict(block_m=bare["bm"], block_n=bare["bn"],
                    block_k=bare["bk"])

    if device.type == "cuda":
        timer = CudaEventExecutor(
            lambda asg: lambda: matmul(x, y, **tiles(asg)), repeats=10,
            warmup=2, device=device)
    else:
        timer = WallClockExecutor(lambda asg: lambda: ref.matmul_ref(x, y),
                                  repeats=1, warmup=1)

    def measure(assignment):
        t = tiles(assignment)
        if smem_bytes(t["block_m"], t["block_n"], t["block_k"],
                      BF16_BYTES) > limit:
            return math.inf     # the card cannot launch it: never timed
        return timer(assignment)
    return measure

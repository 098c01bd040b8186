"""Install-time AT: machine-dependent kernel performance parameters.

The paper's install-time phase tunes PPs that depend only on the machine
(Sample 1: unroll depth).  Here those are the tile shapes of the GEMM K8
(``kernels/matmul.py``), the ``MatmulBlocks`` region, the tile of the
prefill attention K1 (``kernels/flash_attention.py``), the
``FlashBlocks`` region, and the chunk of the selective scan K9
(``kernels/ssm_scan.py``), the ``SsmChunk`` region, with the JAX
package's region and PP names so the two tuning DBs stay comparable.
``MatmulBlocks``' ``varied`` values are Hopper's,
:data:`~..kernels.matmul.TILE_VALUES` (32, 64, 128): the kernel keeps a
``bm x bn`` float32 sum in registers, and a 256 x 256 one would take the
whole register file of an SM.  ``FlashBlocks``' are K1's instances,
:data:`~..kernels.flash_attention.TILE_VALUES` (64, 128) for both
``block_q`` and ``block_k``, where the JAX package's TPU tiles run 128 ..
1024.  ``SsmChunk`` keeps the JAX package's values (32 .. 512) and its
d-spline fit (``Fitting.dspline()``): it measures the chunks the fit
samples and infers the optimum among the candidates.

Declared through the ``repro_torch.at`` session API.  Executor backends
(``at.executors``):

* ``analytic-cost`` (default here) — :func:`matmul_blocks_cost`,
  :func:`flash_blocks_cost` and :func:`ssm_chunk_cost`: block steps (K1:
  the causal walk's live tile pairs), with a penalty for a block whose
  loads nothing hides (its shared memory leaves room for only one block
  on an SM, and it has no ring of stages), and ``inf`` for one over the
  per-block shared-memory limit;
* ``cuda-event`` (registered by this module) — CUDA-event device time of
  the real K8 at the registered (m, n, k), of the real K1 at (1, 32 q /
  4 kv heads, seq, d_head), causal, or of the real K9 at (1, seq,
  d_inner, d_state), on the card in bfloat16; with ``device="cpu"``
  (tests) the host-clock time of the plain versions.

Results are published to :func:`repro_torch.at.tuned` under ``matmul``,
``flash_attention`` and ``ssm_scan`` — :func:`..kernels.ops.mm` launches
K8, :func:`..kernels.ops.attention` K1 and :func:`..kernels.ops.ssm_scan`
K9 with them — and persist in the session's record store, so a second
process on the same machine warm-loads them without re-timing.
"""
from __future__ import annotations

import math

import torch

from .. import at
from ..core import ATContext, Fitting, Varied
from ..core.executor import CudaEventExecutor, WallClockExecutor
from ..device import resolve
from ..kernels import flash_attention as k1
from ..kernels import ref
from ..kernels import ssm_scan as k9
from ..kernels.matmul import TILE_VALUES, WGMMA_KERNEL, matmul, route, \
    smem_bytes, smem_per_block_limit, stage_bytes

BF16_BYTES = 2
#: the JAX package's SsmChunk candidates
CHUNK_VALUES = (32, 64, 128, 256, 512)
#: the heads FlashBlocks times K1 at: yi-6b's 32 query heads over 4 kv
#: heads (G 8), the main path's prefill
FLASH_HEADS = (32, 4)


def _occupancy_penalty(used: int, smem_limit: int) -> float:
    """1, raised 4x per unit by which a block's shared memory passes half
    the per-block limit, where only one block fits on an SM and nothing
    hides its loads."""
    return 1.0 + 4.0 * max(0.0, used / (smem_limit / 2) - 1.0)


def matmul_blocks_cost(bm: int, bn: int, bk: int, *, m: int, n: int, k: int,
                       smem_limit: int) -> float:
    """Analytic install-time cost of K8's tile (bm, bn, bk) in bfloat16.

    The tile is the one :func:`~..kernels.matmul.route` runs at (m, n, k)
    on fresh, hence 16-byte aligned, operands.  A tile whose block needs
    more shared memory than ``smem_limit`` bytes cannot be launched on the
    card at all: it costs ``inf`` and no executor ever launches it (a
    candidate the card cannot run, not a fallback).  Otherwise the cost
    is the number of block-steps (blocks x K steps; fewer, larger tiles
    amortise the per-step load and sync), raised 4x per unit by which the
    shared memory the block's loads leave exposed passes half the limit,
    where only one block fits on an SM and nothing hides its loads.  The
    ``mma.sync`` kernel's single stage is all exposed; the wgmma kernel's
    ring loads later stages while the products of one run, so only one
    stage counts.
    """
    kernel, (bm, bn, bk) = route(torch.bfloat16, n, k, (bm, bn, bk), 0, 0)
    used = smem_bytes(bm, bn, bk, BF16_BYTES)
    if used > smem_limit:
        return math.inf
    if kernel == WGMMA_KERNEL:
        used = stage_bytes(bm, bn, bk)
    steps = math.ceil(m / bm) * math.ceil(n / bn) * math.ceil(k / bk)
    return steps * _occupancy_penalty(used, smem_limit)


def flash_blocks_cost(block_q: int, block_k: int, *, seq: int, d_head: int,
                      smem_limit: int) -> float:
    """Analytic install-time cost of K1's tile (block_q, block_k) in
    bfloat16 at ``seq`` tokens and head dim ``d_head``, causal.

    A tile without an instance at ``d_head``
    (:func:`~..kernels.flash_attention.attention_tiles`) or whose block
    needs more shared memory than ``smem_limit`` bytes
    (:func:`~..kernels.flash_attention.smem_bytes`) costs ``inf``: the card
    cannot run it, so no executor ever launches it.  Otherwise the cost is
    the causal walk's live tile pairs, the key tiles that each query tile
    walks (``flash_attention.cu``'s ``t_lo``/``t_hi``: query tile i sees
    the key tiles up to its last row) summed over the query tiles, times
    the occupancy penalty of the block's shared memory."""
    if (block_q, block_k) not in k1.attention_tiles(torch.bfloat16, d_head):
        return math.inf
    used = k1.smem_bytes(block_q, block_k, d_head)
    if used > smem_limit:
        return math.inf
    n_k = math.ceil(seq / block_k)
    pairs = sum(min(n_k, (q0 + block_q - 1) // block_k + 1)
                for q0 in range(0, seq, block_q))
    return pairs * _occupancy_penalty(used, smem_limit)


def ssm_chunk_cost(chunk: int, *, seq: int, d_inner: int, d_state: int,
                   smem_limit: int) -> float:
    """Analytic install-time cost of K9's ``chunk`` at (seq, d_inner,
    d_state).

    The footprint is K9's own shared memory per block
    (:func:`..kernels.ssm_scan.smem_bytes` for bfloat16 inputs, the type
    the region times) for the chunk the kernel runs, cut to ``seq``.  Over
    ``smem_limit`` the chunk cannot be launched: ``inf``, never timed.
    Otherwise the cost is the staging rounds of all work items (groups
    of :data:`~..kernels.ssm_scan.CHANNELS` channels x tiles of the
    sequence, each a load, a transpose and three barriers) times the
    occupancy penalty."""
    if d_state not in k9.STATES:
        return math.inf
    used = k9.smem_bytes(d_state, min(chunk, seq))
    if used > smem_limit:
        return math.inf
    blocks = math.ceil(d_inner / k9.CHANNELS)
    return blocks * math.ceil(seq / chunk) * _occupancy_penalty(
        used, smem_limit)


def register_kernel_regions(session: "at.AutoTuner | ATContext", *,
                            m: int = 2048, n: int = 2048, k: int = 2048,
                            seq: int = 2048, d_head: int = 128,
                            d_inner: int = 4096, d_state: int = 16,
                            smem_limit: int | None = None) -> None:
    """Declare the install-time regions for every kernel PP.

    ``(m, n, k)`` is the GEMM shape the ``MatmulBlocks`` region is costed
    and timed at, ``(seq, d_head)`` the prefill attention's of the
    ``FlashBlocks`` region, and ``(seq, d_inner, d_state)`` the selective
    scan's of the ``SsmChunk`` region (batch 1).  ``smem_limit`` is the
    per-block shared-memory limit in bytes; ``None`` reads it from the
    card (the opt-in limit, 232,448 on an H100).
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

    # a head dim on a wide rung has one K1 tile, whose values stand alone
    flash_values = (tuple(sorted(set(k1.WIDE_TILE)))
                    if k1.route("flash_attention", torch.bfloat16,
                                d_head).wide else k1.TILE_VALUES)

    @session.autotune(
        "install", "variable", name="FlashBlocks",
        varied=Varied(("block_q", "block_k"), values=flash_values),
        search="ad-hoc", executor="analytic-cost",
        publish=("flash_attention", {"block_q": "block_q",
                                     "block_k": "block_k"}),
        metadata={"shape": (seq, d_head), "smem_limit": smem_limit})
    def flash_blocks(block_q=64, block_k=64):
        return flash_blocks_cost(block_q, block_k, seq=seq, d_head=d_head,
                                 smem_limit=smem_limit)

    @session.autotune(
        "install", "variable", name="SsmChunk",
        varied=Varied(("chunk",), values=CHUNK_VALUES),
        fitting=Fitting.dspline(), executor="analytic-cost",
        publish=("ssm_scan", {"chunk": "chunk"}),
        metadata={"shape": (seq, d_inner, d_state),
                  "smem_limit": smem_limit})
    def ssm_chunk(chunk=64):
        return ssm_chunk_cost(chunk, seq=seq, d_inner=d_inner,
                              d_state=d_state, smem_limit=smem_limit)


_KERNEL_REGIONS = ("MatmulBlocks", "FlashBlocks", "SsmChunk")


def run_install_tuning(session: "at.AutoTuner | ATContext",
                       wall_clock: bool = False, *,
                       device: str | torch.device = "cuda") -> dict:
    """Execute install-time AT and publish tuned PPs to the kernel layer.

    ``wall_clock=True`` switches the kernel regions to the ``cuda-event``
    executor, which times K8, K1 and K9 on ``device`` (the card; ``"cpu"``
    times the plain versions with the host clock, for tests).  A session whose
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
    """Device time of the region's kernel from CUDA events (minimum over
    10 launches after 2 untimed ones): K8 at the region's (m, n, k), K1 at
    (1, seq, d_head) over :data:`FLASH_HEADS`, K9 at (1, seq, d_inner,
    d_state), in bfloat16.  On a CPU device, the
    host-clock time of the plain version.  A candidate over the per-block
    shared-memory limit is never launched: it costs ``inf``."""
    device = resolve(region.metadata.get("device", "cuda"))
    gen = torch.Generator(device=device).manual_seed(0)
    make = {"MatmulBlocks": _matmul_variants,
            "FlashBlocks": _flash_variants,
            "SsmChunk": _ssm_variants}[region.name]
    run, plain, fits = make(region.metadata, gen, device)

    def bare(assignment):
        return {key.split("_", 1)[1].lower(): v
                for key, v in assignment.items()}

    if device.type == "cuda":
        timer = CudaEventExecutor(lambda asg: run(**bare(asg)), repeats=10,
                                  warmup=2, device=device)
    else:
        timer = WallClockExecutor(lambda asg: plain, repeats=1, warmup=1)

    def measure(assignment):
        if not fits(**bare(assignment)):
            return math.inf     # the card cannot launch it: never timed
        return timer(assignment)
    return measure


def _matmul_variants(metadata: dict, gen: torch.Generator,
                     device: torch.device):
    """(K8 launcher by tile, plain call, does-the-tile-fit) at the
    region's (m, n, k)."""
    m, n, k = metadata["shape"]
    limit = metadata["smem_limit"]
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    y = torch.randn((k, n), generator=gen, device=device).to(torch.bfloat16)

    def run(bm, bn, bk):
        return lambda: matmul(x, y, block_m=bm, block_n=bn, block_k=bk)

    def fits(bm, bn, bk):
        return smem_bytes(bm, bn, bk, BF16_BYTES) <= limit

    return run, lambda: ref.matmul_ref(x, y), fits


def _flash_variants(metadata: dict, gen: torch.Generator,
                    device: torch.device):
    """(K1 launcher by tile, plain call, does-the-tile-fit) at batch 1,
    :data:`FLASH_HEADS` and the region's (seq, d_head), causal."""
    seq, d = metadata["shape"]
    limit = metadata["smem_limit"]
    h, hkv = FLASH_HEADS
    q, k, v = (torch.randn((1, n, seq, d), generator=gen,
                           device=device).to(torch.bfloat16)
               for n in (h, hkv, hkv))

    def run(block_q, block_k):
        return lambda: k1.flash_attention(q, k, v, block_q=block_q,
                                          block_k=block_k)

    def fits(block_q, block_k):
        return k1.smem_bytes(block_q, block_k, d) <= limit

    return run, lambda: ref.attention_ref(q, k, v), fits


def _ssm_variants(metadata: dict, gen: torch.Generator,
                  device: torch.device):
    """(K9 launcher by chunk, plain call, does-the-chunk-fit) at batch 1
    and the region's (seq, d_inner, d_state), with falcon-mamba's A
    (-1 .. -N for every channel) and a positive dt."""
    seq, di, n = metadata["shape"]
    limit = metadata["smem_limit"]

    def draw(*shape, scale=1.0):
        t = torch.randn(shape, generator=gen, device=device) * scale
        return t.to(torch.bfloat16)

    x, b, c = draw(1, seq, di), draw(1, seq, n), draw(1, seq, n)
    dt = torch.nn.functional.softplus(draw(1, seq, di) - 2.0)
    a = -torch.arange(1, n + 1, dtype=torch.float32,
                      device=device).expand(di, n).contiguous()
    d = torch.ones((di,), dtype=torch.bfloat16, device=device)

    def run(chunk):
        return lambda: k9.selective_scan(x, dt, a, b, c, d, chunk=chunk)

    def fits(chunk):
        return k9.smem_bytes(n, min(chunk, seq)) <= limit

    return run, lambda: ref.selective_scan_ref(x, dt, a, b, c, d), fits

"""K8's choice of kernel and its shared-memory formula, on the CPU.

``kernels/matmul.py`` picks one of three hand-written kernels of
``csrc/matmul.cu`` by type, tile and shape (:func:`route`): bfloat16
tiles with ``block_m`` 64 or 128 run the wgmma kernel fed by a TMA ring,
which needs 16-byte row strides and bases (K and N multiples of 8, x and
y 16-byte aligned); other bfloat16 calls run the ``mma.sync`` kernel at
``block_m`` 32; float32 runs the fp32 kernel.  :func:`smem_bytes` is the
install cost model's input and must equal the kernel's own formula (held
on the card by ``chip_smoke.py`` and ``test_torch_cuda_kernels.py``).
Both are plain Python, so they are checked here.
"""
import itertools
import math

import pytest
import torch

from repro_torch import at
from repro_torch.kernels import matmul as mmk
from repro_torch.tuning import (matmul_blocks_cost, register_kernel_regions,
                                run_install_tuning)

H100_SMEM_PER_BLOCK = 232_448
H100_SMEM_PER_SM = 233_472          # 228 KB an SM, shared by its blocks
BF16 = torch.bfloat16
ALIGNED = 256                       # a base address torch would give


@pytest.mark.parametrize("tiles", sorted(mmk.TILES))
def test_aligned_bf16_shapes_run_wgmma_from_block_m_64(tiles):
    """The yi-6b projection (K 4096, N 11008) and a ragged aligned shape
    (K 328, N 136) take the wgmma kernel at the tile asked for when
    ``block_m`` is 64 or 128, the mma.sync kernel at it when 32."""
    for n, k in ((11008, 4096), (136, 328), (24, 8)):
        kernel, run = mmk.route(BF16, n, k, tiles, ALIGNED, ALIGNED)
        want = mmk.WGMMA_KERNEL if tiles[0] >= 64 else mmk.MMA_KERNEL
        assert (kernel, run) == (want, tiles)


@pytest.mark.parametrize("n,k,x_ptr,y_ptr", [
    (200, 300, ALIGNED, ALIGNED),       # K % 8: x's rows are 600 bytes
    (9, 72, ALIGNED, ALIGNED),          # N % 8: y's rows are 18 bytes
    (136, 328, ALIGNED + 2, ALIGNED),   # x not 16-byte aligned
    (136, 328, ALIGNED, ALIGNED + 8),   # y not 16-byte aligned
])
@pytest.mark.parametrize("bn,bk", [(32, 32), (128, 64), (64, 128)])
def test_shapes_tma_cannot_describe_run_mma_at_block_m_32(n, k, x_ptr, y_ptr,
                                                         bn, bk):
    for bm in mmk.TILE_VALUES:
        assert mmk.route(BF16, n, k, (bm, bn, bk), x_ptr, y_ptr) == (
            mmk.MMA_KERNEL, (32, bn, bk))


def test_float32_runs_the_fp32_kernel_at_its_tile():
    for tiles in mmk.TILES:
        for n, k, ptr in ((11008, 4096, ALIGNED), (200, 300, ALIGNED + 4)):
            assert mmk.route(torch.float32, n, k, tiles, ptr, ptr) == (
                mmk.F32_KERNEL, tiles)


@pytest.mark.parametrize("elem_bytes", [2, 4], ids=["bf16", "fp32"])
def test_smem_bytes_positive_under_the_limit_and_monotone(elem_bytes):
    """Every instantiated tile fits one block's limit, and a larger tile
    along any axis never takes less shared memory."""
    smem = {t: mmk.smem_bytes(*t, elem_bytes) for t in mmk.TILES}
    assert all(0 < b <= H100_SMEM_PER_BLOCK for b in smem.values())
    for t in mmk.TILES:
        for axis in range(3):
            for v in mmk.TILE_VALUES:
                if v > t[axis]:
                    bigger = t[:axis] + (v,) + t[axis + 1:]
                    assert smem[bigger] >= smem[t], (t, bigger)


def test_wgmma_ring_formula():
    """The ring holds as many stages (2 to 8) as fit 96 KB per consumer
    warpgroup (one per 64 rows), each the (bm, bk) x tile and the (bk, bn)
    y tile in bf16, plus 1024 bytes that align it: an SM takes one block
    of block_m 128 or two of 64."""
    for bm, bn, bk in itertools.product((64, 128), mmk.TILE_VALUES,
                                        mmk.TILE_VALUES):
        stage = 2 * (bm * bk + bk * bn)
        stages = mmk.ring_stages(bm, bn, bk)
        budget = 96 * 1024 * bm // 64
        assert stages == min(8, max(2, budget // stage))
        assert mmk.smem_bytes(bm, bn, bk) == stages * stage + 1024
        if bm == 64:
            assert 2 * mmk.smem_bytes(bm, bn, bk) <= H100_SMEM_PER_SM
    assert mmk.ring_stages(128, 128, 64) == 6
    assert mmk.ring_stages(128, 128, 128) == 3
    # the mma.sync kernel's padded single stage at block_m 32
    assert mmk.smem_bytes(32, 64, 32) == 2 * (32 * 40 + 32 * 72)


YI6B_MLP = dict(m=512, n=11008, k=4096)


def test_ring_tiles_pay_no_occupancy_penalty_for_their_ring():
    """The analytic cost charges a wgmma tile's occupancy on one stage of
    its ring, which the producer refills while the products run, and an
    mma.sync tile on its whole single stage: at the yi-6b MLP shape every
    tile costs its block-steps, and (128, 128, 128) the fewest."""
    costs = {t: matmul_blocks_cost(*t, smem_limit=H100_SMEM_PER_BLOCK,
                                   **YI6B_MLP) for t in mmk.TILES}
    for (bm, bn, bk), cost in costs.items():
        steps = (math.ceil(512 / bm) * math.ceil(11008 / bn)
                 * math.ceil(4096 / bk))
        assert cost == steps, (bm, bn, bk)
    assert min(costs, key=costs.get) == (128, 128, 128)
    assert costs[(128, 128, 128)] == 4 * 86 * 32


def test_unaligned_shapes_are_costed_at_the_tile_that_runs():
    """Where TMA cannot describe the operands (K = 300), a tile with
    block_m 64 or 128 runs the mma.sync kernel at block_m 32, and costs
    what that tile costs."""
    shape = dict(m=77, n=200, k=300)
    for bn, bk in itertools.product(mmk.TILE_VALUES, repeat=2):
        at32 = matmul_blocks_cost(32, bn, bk,
                                  smem_limit=H100_SMEM_PER_BLOCK, **shape)
        for bm in (64, 128):
            assert matmul_blocks_cost(bm, bn, bk,
                                      smem_limit=H100_SMEM_PER_BLOCK,
                                      **shape) == at32


def test_analytic_install_search_commits_the_fewest_block_steps(tmp_path):
    """The ad-hoc search under the analytic cost at the yi-6b MLP shape
    walks block_k, block_n, then block_m from (32, 32, 32) and commits
    (128, 128, 128), the tile with the fewest block-steps."""
    session = at.AutoTuner(str(tmp_path))
    register_kernel_regions(session, **YI6B_MLP,
                            smem_limit=H100_SMEM_PER_BLOCK)
    tiles = run_install_tuning(session)["MatmulBlocks"]
    assert (tiles["block_m"], tiles["block_n"], tiles["block_k"]) == (
        128, 128, 128)


def test_matmul_refuses_cpu_tensors_and_counts_nothing():
    x, y = torch.ones(8, 16, dtype=BF16), torch.ones(16, 8, dtype=BF16)
    launches = mmk.matmul.launches
    with pytest.raises(ValueError, match="CUDA"):
        mmk.matmul(x, y, block_m=128)
    assert mmk.matmul.launches == launches

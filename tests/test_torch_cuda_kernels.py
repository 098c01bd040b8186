"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device: the kernels are built by nvcc for sm_90a
and have no CPU mode, so without a card every test here skips.  No JAX
import, so the file runs on a machine that has only the port's
dependencies::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Tolerance 2e-4 in float32; 2e-2 in bfloat16, where the kernel and the
plain version round their outputs to bf16 from float32 sums taken in
different orders.
"""
import numpy as np
import pytest
import torch

import repro_torch.at as at
from repro_torch.core.executor import CudaEventExecutor, WallClockExecutor
from repro_torch.kernels import fdm_stress as fk
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mmk
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssm_scan as k9

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only there)")
    return torch.device("cuda")


def rand(shape, seed, device, dtype, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).to(device, dtype)


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,s,d,causal,window", [
    (8, 2, 128, 32, True, None), (8, 8, 100, 64, False, None),
    (4, 1, 192, 16, True, 16), (32, 4, 300, 128, True, None),
    (32, 4, 200, 128, True, 64), (32, 8, 300, 80, True, 64)])
def test_attention_kernel_matches_plain(cuda_device, dtype, h, hkv, s, d,
                                        causal, window):
    q = rand((2, h, s, d), 20, cuda_device, dtype, 0.3)
    k = rand((2, hkv, s, d), 21, cuda_device, dtype, 0.3)
    v = rand((2, hkv, s, d), 22, cuda_device, dtype)
    n = fa.flash_attention.launches
    got = ops.attention(q, k, v, causal=causal, window=window)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1
    assert fa.flash_attention.last_kernel == (
        fa.TC_KERNEL if dtype == torch.bfloat16 else "flash_attention_kernel")
    assert got.dtype == dtype
    close(got, want, dtype)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 4), (24, 8), (32, 4)])
@pytest.mark.parametrize("s,causal,window", [
    (512, True, None), (300, True, None), (129, True, 64), (200, False, None),
    (77, False, 16), (1, True, None)])
def test_tc_attention_kernel_matches_plain(cuda_device, h, hkv, d, s, causal,
                                           window):
    """The bf16 K1 on the tensor cores: G 1, 2, 3 and 8; ragged S (300,
    129, 77, one token), a window with and without the causal mask, and
    non-causal; one launch of the tensor-core kernel per call."""
    q = rand((2, h, s, d), 40 + d, cuda_device, torch.bfloat16)
    k = rand((2, hkv, s, d), 41 + d, cuda_device, torch.bfloat16)
    v = rand((2, hkv, s, d), 42 + d, cuda_device, torch.bfloat16)
    n = fa.flash_attention.launches
    got = ops.attention(q, k, v, causal=causal, window=window)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1
    assert fa.flash_attention.last_kernel == fa.TC_KERNEL
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    close(got, want, torch.bfloat16)


@pytest.mark.parametrize("d,tile", [
    (d, t) for d in (16, 32, 64, 128)
    for t in fa.attention_tiles(torch.bfloat16, d)])
def test_tc_attention_instances_fit_the_card(cuda_device, d, tile):
    """Every bf16 K1 instance keeps the blocks per SM its launch bounds
    ask for (2 for the 4-warp tiles whose shared memory fits twice, else
    1), uses the shared memory of ``fa.smem_bytes``, and builds without
    spilling at the main path's width (every D = 128 tile)."""
    info = fa.tc_info(d, *tile)
    assert info["smem_bytes"] == fa.smem_bytes(*tile, d)
    two = tile[0] == 64 and 2 * (info["smem_bytes"] + 1024) <= 228 * 1024
    assert info["blocks_per_sm"] >= (2 if two else 1)
    if d == 128:
        assert info["local_bytes"] == 0


@pytest.mark.parametrize("tile", fa.attention_tiles(torch.bfloat16, 128),
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("h,hkv,s,causal,window", [
    (32, 4, 512, True, None), (24, 8, 300, True, None),
    (32, 32, 129, True, 64), (32, 4, 200, False, None),
    (24, 8, 77, False, 16), (32, 4, 1, True, None)])
def test_tc_attention_every_tile_matches_plain(cuda_device, h, hkv, s,
                                               causal, window, tile):
    """Each D = 128 tile of the bf16 K1 against plain (G 8, 3 and 1;
    ragged S, windows, one token), bit-equal to the default tile (every
    tile takes the same 64-key softmax steps), one launch counted under
    its tile; ``ops.attention`` launches the tile ``at.tuned`` holds."""
    q = rand((2, h, s, 128), 60, cuda_device, torch.bfloat16)
    k = rand((2, hkv, s, 128), 61, cuda_device, torch.bfloat16)
    v = rand((2, hkv, s, 128), 62, cuda_device, torch.bfloat16)
    kw = dict(causal=causal, window=window)
    n = fa.flash_attention.by_tile[tile]
    got = fa.flash_attention(q, k, v, **kw, block_q=tile[0], block_k=tile[1])
    torch.cuda.synchronize()
    assert fa.flash_attention.by_tile[tile] == n + 1
    close(got, ref.attention_ref(q, k, v, **kw), torch.bfloat16)
    assert torch.equal(got, fa.flash_attention(q, k, v, **kw))
    at.clear_published()
    try:
        at.publish("flash_attention", block_q=tile[0], block_k=tile[1])
        n = fa.flash_attention.by_tile[tile]
        assert torch.equal(ops.attention(q, k, v, **kw), got)
        assert fa.flash_attention.by_tile[tile] == n + 1
    finally:
        at.clear_published()


def test_attention_tiles_without_an_instance_raise_on_the_card(cuda_device):
    """A tile K1 has no instance for raises before anything launches:
    32 rows, 256 keys, a 128 tile at D 64, any tile but its own for the
    float32 SIMT template."""
    q = rand((1, 8, 64, 128), 63, cuda_device, torch.bfloat16)
    k = rand((1, 2, 64, 128), 64, cuda_device, torch.bfloat16)
    n = fa.flash_attention.launches
    for tile in (dict(block_q=32), dict(block_k=256),
                 dict(block_q=128, block_k=32)):
        with pytest.raises(ValueError, match="no instance"):
            fa.flash_attention(q, k, k, **tile)
    with pytest.raises(ValueError, match="no instance"):
        fa.flash_attention(q[..., :64].contiguous(), k[..., :64].contiguous(),
                           k[..., :64].contiguous(), block_q=128)
    with pytest.raises(ValueError, match="no instance"):
        fa.flash_attention(q.float(), k.float(), k.float(), block_k=64)
    assert fa.flash_attention.launches == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d", [(32, 4, 128), (32, 32, 128), (4, 2, 16),
                                     (12, 4, 64), (16, 1, 32)])
def test_decode_kernel_matches_plain(cuda_device, dtype, h, hkv, d):
    q = rand((3, h, 1, d), 23, cuda_device, dtype, 0.4)
    k = rand((3, hkv, 300, d), 24, cuda_device, dtype, 0.4)
    v = rand((3, hkv, 300, d), 25, cuda_device, dtype)
    kv_len = torch.tensor([1, 257, 300], dtype=torch.int32,
                          device=cuda_device)
    n = fa.flash_decode.launches
    got = ops.decode_attention(q, k, v, kv_len)
    want = ref.decode_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert fa.flash_decode.launches == n + 1
    assert fa.flash_decode.last_kernel == (
        pa.DECODE_TC_KERNEL if dtype == torch.bfloat16
        else fa.DECODE_SIMT_KERNEL)
    close(got, want, dtype)


def test_decode_kernel_kv_len_zero_row_is_exactly_zero(cuda_device):
    q = rand((2, 8, 1, 64), 26, cuda_device, torch.float32)
    k = rand((2, 2, 64, 64), 27, cuda_device, torch.float32)
    kv_len = torch.tensor([0, 64], dtype=torch.int32, device=cuda_device)
    out = fa.flash_decode(q, k, k, kv_len)
    assert torch.all(out[0] == 0)
    close(out[1], ref.decode_ref(q, k, k, kv_len)[1], torch.float32)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = rand((1, 2, 8, 520), 28, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="head dim 520"):
        fa.flash_attention(q, q, q)
    q = rand((1, 2, 8, 32), 29, cuda_device, torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q, q)
    q = rand((1, 8, 2, 32), 30, cuda_device, torch.float32).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)


def paged_inputs(b, h, hkv, d, psz, nblk, kv_len, dtype, device, seed, c=1):
    """q (B, H, c, D), pools with one spare page per sequence, and a table
    of shuffled distinct pages whose entries past kv_len point at page 0."""
    n_pages = b * nblk + 1
    q = rand((b, h, c, d), seed, device, dtype, 0.4)
    kp = rand((n_pages, hkv, psz, d), seed + 1, device, dtype, 0.4)
    vp = rand((n_pages, hkv, psz, d), seed + 2, device, dtype)
    pages = np.random.default_rng(seed + 3).permutation(
        np.arange(1, n_pages)).reshape(b, nblk).astype(np.int32)
    for i, n in enumerate(kv_len):
        pages[i, -(-n // psz):] = 0
    table = torch.from_numpy(pages).to(device)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=device)
    return q, kp, vp, table, lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d,psz", [(32, 4, 128, 16), (32, 32, 128, 16),
                                         (8, 2, 16, 8), (12, 4, 64, 8),
                                         (16, 1, 32, 16)])
def test_paged_decode_kernel_matches_plain(cuda_device, dtype, h, hkv, d,
                                           psz):
    q, kp, vp, table, kv_len = paged_inputs(3, h, hkv, d, psz, 20,
                                            [1, 157, 20 * psz], dtype,
                                            cuda_device, 40)
    n = pa.flash_paged_decode.launches
    got = ops.paged_decode(q, ops.PagedPools(kp, vp), table, kv_len)
    want = ref.paged_decode_ref(q, kp, vp, table, kv_len)
    torch.cuda.synchronize()
    assert pa.flash_paged_decode.launches == n + 1
    assert pa.flash_paged_decode.last_kernel == (
        pa.DECODE_TC_KERNEL if dtype == torch.bfloat16
        else pa.DECODE_SIMT_KERNEL)
    assert got.dtype == dtype
    close(got, want, dtype)


def test_paged_decode_kernel_kv_len_zero_row_is_exactly_zero(cuda_device):
    q, kp, vp, table, kv_len = paged_inputs(2, 8, 2, 64, 16, 4, [0, 50],
                                            torch.float32, cuda_device, 50)
    out = pa.flash_paged_decode(q, kp, vp, table, kv_len)
    assert torch.all(out[0] == 0)
    close(out[1], ref.paged_decode_ref(q, kp, vp, table, kv_len)[1],
          torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d,psz,c,start,valid", [
    (32, 4, 128, 16, 128, 0, 128), (32, 4, 128, 16, 128, 384, 128),
    (32, 4, 128, 16, 128, 200, 128), (32, 4, 128, 16, 128, 256, 44),
    (32, 32, 128, 16, 64, 100, 64), (8, 2, 16, 8, 8, 12, 5),
    (4, 1, 32, 8, 100, 30, 100)])
def test_paged_prefill_kernel_matches_plain(cuda_device, dtype, h, hkv, d,
                                            psz, c, start, valid):
    """Two sequences: one chunk at ``start`` with ``valid`` real rows, one
    at 0; rows at positions >= kv_len are padding and not compared."""
    kv_len = [start + valid, valid]
    nblk = -(-(start + c) // psz)
    q, kp, vp, table, lens = paged_inputs(2, h, hkv, d, psz, nblk, kv_len,
                                          dtype, cuda_device, 60, c=c)
    starts = torch.tensor([start, 0], dtype=torch.int32, device=cuda_device)
    n = pa.flash_paged_prefill.launches
    got = ops.paged_prefill(q, ops.PagedPools(kp, vp), table, starts, lens)
    want = ref.paged_prefill_ref(q, kp, vp, table, starts, lens)
    torch.cuda.synchronize()
    assert pa.flash_paged_prefill.launches == n + 1
    assert pa.flash_paged_prefill.last_kernel == (
        "paged_prefill_tc_kernel" if dtype == torch.bfloat16
        else "paged_prefill_kernel")
    close(got[:, :, :valid], want[:, :, :valid], dtype)


def test_paged_prefill_kernel_row_without_keys_is_exactly_zero(cuda_device):
    q, kp, vp, table, lens = paged_inputs(2, 4, 2, 32, 8, 2, [0, 9],
                                          torch.float32, cuda_device, 70,
                                          c=4)
    starts = torch.tensor([0, 5], dtype=torch.int32, device=cuda_device)
    out = pa.flash_paged_prefill(q, kp, vp, table, starts, lens)
    assert torch.all(out[0] == 0)
    close(out[1], ref.paged_prefill_ref(q, kp, vp, table, starts, lens)[1],
          torch.float32)


def test_paged_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q, kp, vp, table, lens = paged_inputs(2, 4, 2, 32, 8, 2, [3, 9],
                                          torch.float32, cuda_device, 80)
    with pytest.raises(ValueError, match="CUDA"):
        pa.flash_paged_decode(q.cpu(), kp, vp, table, lens)
    with pytest.raises(ValueError, match="int32"):
        pa.flash_paged_decode(q, kp, vp, table.long(), lens)
    with pytest.raises(ValueError, match="page_table"):
        pa.flash_paged_decode(q, kp, vp, table[:1], lens)
    with pytest.raises(ValueError, match="dtype"):
        pa.flash_paged_decode(q, kp.bfloat16(), vp.bfloat16(), table, lens)
    with pytest.raises(ValueError, match="one query token"):
        pa.flash_paged_decode(torch.cat([q, q], 2), kp, vp, table, lens)
    wide = [torch.cat([t] * 17, -1)[..., :520].contiguous()
            for t in (q, kp, vp)]
    with pytest.raises(ValueError, match="head dim 520"):
        pa.flash_paged_decode(*wide, table, lens)
    with pytest.raises(ValueError, match="start and kv_len"):
        pa.flash_paged_prefill(q, kp, vp, table, lens[:1], lens)


# --------------------------------------------------------------------------
# split-KV decode (K5a + K5c) and int8 pages (K6a, K6b, K6c)
# --------------------------------------------------------------------------


def quantize(pool):
    """int8 codes and float32 per-row scales of a pool, on its device."""
    from repro_torch.distributed.compression import quantize_int8_rows
    return quantize_int8_rows(pool)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d,psz", [(32, 4, 128, 16), (32, 32, 128, 16),
                                         (8, 2, 16, 8), (12, 4, 64, 8)])
@pytest.mark.parametrize("ns", [2, 3, 8])
def test_split_decode_kernels_match_plain(cuda_device, dtype, h, hkv, d, psz,
                                          ns):
    """K5a + K5c against the split and the one-pass plain versions; a lane
    of 33 keys leaves most of its splits empty.  A bf16 query makes one
    launch, the merged route (K5c in K5a's epilogue); float32 makes two,
    K5a's SIMT template and then K5c."""
    q, kp, vp, table, kv_len = paged_inputs(3, h, hkv, d, psz, 20,
                                            [33, 157, 20 * psz], dtype,
                                            cuda_device, 90)
    n = (pa.paged_decode_split.launches, pa.split_combine.launches,
         pa.flash_paged_decode.launches, pa.paged_decode_split_merged.launches)
    got = ops.paged_decode(q, ops.PagedPools(kp, vp), table, kv_len,
                           num_splits=ns)
    torch.cuda.synchronize()
    merged = dtype == torch.bfloat16
    assert (pa.paged_decode_split.launches, pa.split_combine.launches,
            pa.flash_paged_decode.launches,
            pa.paged_decode_split_merged.launches) == (
        n[0] + (not merged), n[1] + (not merged), n[2], n[3] + merged)
    assert got.dtype == dtype
    close(got, ref.paged_decode_split_ref(q, kp, vp, table, kv_len, ns), dtype)
    close(got, ref.paged_decode_ref(q, kp, vp, table, kv_len), dtype)


@pytest.mark.parametrize("quant", [False, True])
def test_split_decode_ns1_is_the_one_pass_kernel_and_zero_rows(cuda_device,
                                                               quant):
    q, kp, vp, table, kv_len = paged_inputs(3, 32, 4, 128, 16, 8, [0, 77, 128],
                                            torch.bfloat16, cuda_device, 95)
    if quant:
        (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
        run = lambda ns: pa.flash_paged_decode_quant(  # noqa: E731
            q, k8, v8, ks, vs, table, kv_len, num_splits=ns)
    else:
        run = lambda ns: pa.flash_paged_decode(  # noqa: E731
            q, kp, vp, table, kv_len, num_splits=ns)
    assert torch.equal(run(None), run(1))
    for ns in (None, 2, 8, 64):                   # 64 clamps to the 8 pages
        out = run(ns)
        torch.cuda.synchronize()
        assert torch.all(out[0] == 0)             # kv_len 0: exactly 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d,psz", [(32, 4, 128, 16), (32, 32, 128, 16),
                                         (8, 2, 16, 8), (16, 1, 32, 16)])
@pytest.mark.parametrize("ns", [1, 8])
def test_int8_decode_kernels_match_plain(cuda_device, dtype, h, hkv, d, psz,
                                         ns):
    """K6a (ns 1) and K6b + K5c (ns 8) against the plain int8 versions;
    with a bf16 query ns 8 is the merged route's one launch."""
    q, kp, vp, table, kv_len = paged_inputs(3, h, hkv, d, psz, 20,
                                            [1, 157, 20 * psz], dtype,
                                            cuda_device, 100)
    (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
    kernel = (pa.flash_paged_decode_quant if ns == 1
              else pa.paged_decode_split_quant_merged
              if dtype == torch.bfloat16 else pa.paged_decode_split_quant)
    n = kernel.launches
    got = ops.paged_decode(q, ops.PagedPools(k8, v8, ks, vs), table, kv_len,
                           num_splits=ns)
    torch.cuda.synchronize()
    assert kernel.launches == n + 1
    assert kernel.last_kernel == (
        pa.DECODE_TC_KERNEL if dtype == torch.bfloat16
        else pa.DECODE_SIMT_KERNEL)
    assert got.dtype == dtype
    close(got, ref.paged_decode_ref(q, k8, v8, table, kv_len, k_scale=ks,
                                    v_scale=vs), dtype)
    close(got, ref.paged_decode_split_ref(q, k8, v8, table, kv_len, ns,
                                          k_scale=ks, v_scale=vs), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d,psz,c,start,valid", [
    (32, 4, 128, 16, 128, 0, 128), (32, 4, 128, 16, 128, 384, 128),
    (32, 4, 128, 16, 128, 200, 128), (32, 4, 128, 16, 128, 256, 44),
    (8, 2, 16, 8, 8, 12, 5)])
def test_int8_prefill_kernel_matches_plain(cuda_device, dtype, h, hkv, d, psz,
                                           c, start, valid):
    kv_len = [start + valid, valid]
    nblk = -(-(start + c) // psz)
    q, kp, vp, table, lens = paged_inputs(2, h, hkv, d, psz, nblk, kv_len,
                                          dtype, cuda_device, 110, c=c)
    (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
    starts = torch.tensor([start, 0], dtype=torch.int32, device=cuda_device)
    n = pa.flash_paged_prefill_quant.launches
    got = ops.paged_prefill(q, ops.PagedPools(k8, v8, ks, vs), table, starts,
                            lens)
    want = ref.paged_prefill_ref(q, k8, v8, table, starts, lens, k_scale=ks,
                                 v_scale=vs)
    torch.cuda.synchronize()
    assert pa.flash_paged_prefill_quant.launches == n + 1
    assert pa.flash_paged_prefill_quant.last_kernel == (
        "paged_prefill_tc_kernel" if dtype == torch.bfloat16
        else "paged_prefill_kernel")
    close(got[:, :, :valid], want[:, :, :valid], dtype)


def test_int8_prefill_kernel_row_without_keys_is_exactly_zero(cuda_device):
    q, kp, vp, table, lens = paged_inputs(2, 4, 2, 32, 8, 2, [0, 9],
                                          torch.float32, cuda_device, 120,
                                          c=4)
    (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
    starts = torch.tensor([0, 5], dtype=torch.int32, device=cuda_device)
    out = pa.flash_paged_prefill_quant(q, k8, v8, ks, vs, table, starts, lens)
    assert torch.all(out[0] == 0)
    close(out[1], ref.paged_prefill_ref(q, k8, v8, table, starts, lens,
                                        k_scale=ks, v_scale=vs)[1],
          torch.float32)


def test_int8_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q, kp, vp, table, lens = paged_inputs(2, 4, 2, 32, 8, 2, [3, 9],
                                          torch.bfloat16, cuda_device, 130)
    (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
    dec = pa.flash_paged_decode_quant
    with pytest.raises(ValueError, match="int8"):
        dec(q, kp, vp, ks, vs, table, lens)               # bf16 pools
    with pytest.raises(ValueError, match="float32"):
        dec(q, k8, v8, ks.bfloat16(), vs, table, lens)
    with pytest.raises(ValueError, match="float32"):
        dec(q, k8, v8, ks[:, :, :4].contiguous(), vs, table, lens)
    with pytest.raises(ValueError, match="float32"):
        dec(q, k8, v8, ks.cpu(), vs, table, lens)
    with pytest.raises(ValueError, match="float32"):
        dec(q, k8, v8, ks.transpose(1, 2).contiguous().transpose(1, 2), vs,
            table, lens)
    with pytest.raises(ValueError, match="CUDA"):
        dec(q, k8.cpu(), v8, ks, vs, table, lens)
    with pytest.raises(ValueError, match="q dtype"):
        dec(q.half(), k8, v8, ks, vs, table, lens)
    with pytest.raises(ValueError, match="dtype"):
        pa.flash_paged_decode(q, k8, v8, table, lens)      # fp wrapper
    with pytest.raises(ValueError, match="start and kv_len"):
        pa.flash_paged_prefill_quant(q, k8, v8, ks, vs, table, lens[:1], lens)


# --------------------------------------------------------------------------
# split prefill / verify (K5b + K5c) and its int8 form (K6d + K5c)
# --------------------------------------------------------------------------


def chunk_inputs(b, h, hkv, d, psz, nblk, starts, valid, dtype, device, seed,
                 c, quant):
    """A chunk of c rows per sequence at ``starts`` with ``valid`` rows
    committed (kv_len = start + valid; 0 valid and start 0 is an idle
    lane); fp pools, or int8 pools with their scales."""
    kv_len = [s + v for s, v in zip(starts, valid)]
    q, kp, vp, table, lens = paged_inputs(b, h, hkv, d, psz, nblk, kv_len,
                                          dtype, device, seed, c=c)
    start = torch.tensor(starts, dtype=torch.int32, device=device)
    if quant:
        (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
        return q, ops.PagedPools(k8, v8, ks, vs), table, start, lens
    return q, ops.PagedPools(kp, vp), table, start, lens


SPLIT_CASES = {
    # verify: 4 lanes of k + 1 = 5 rows and an idle lane (kv_len 0)
    "verify yi-6b": (32, 4, 128, 16, 64, [839, 720, 190, 544, 0],
                     [5, 5, 5, 5, 0], 5),
    "verify deepseek-7b": (32, 32, 128, 16, 64, [839, 720, 190, 544, 0],
                           [5, 5, 5, 5, 0], 5),
    # prefill chunks: at 384, mid-page and ragged, two q tiles of 64
    "chunk at 384": (32, 4, 128, 16, 32, [384, 0], [128, 128], 128),
    "ragged mid-page": (8, 2, 16, 8, 40, [200, 3], [44, 77], 80),
    "verify reduced": (8, 2, 64, 8, 20, [33, 100, 0], [3, 5, 0], 5),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("ns", [2, 3, 8])
def test_split_prefill_kernels_match_plain(cuda_device, dtype, quant, case,
                                           ns):
    """K5b / K6d partials against ``paged_prefill_split_ref``'s, and with
    K5c the output against the split and the one-pass plain versions;
    rows of a lane with no key exactly 0, and every row that sees no key
    of a split exactly (-1e30, 0, 0) there.  The bf16 K5b and K6d are the
    tensor-core kernel's partials mode: their partials are compared with
    the plain version cut at the kernel's own tiles (32 // G chunk rows,
    128 keys), m and l at the fp32 tolerance, and acc within what rounding
    P to bf16 can move it by, 2^-8 sum_j p_j |v_j| (|v| dequantized for
    int8 pools), plus 2e-4 (1 + |acc|) for fp32 sums taken in another
    order.  The bf16 tolerance on acc itself cannot hold there: acc is
    unnormalised, and where its terms cancel, the roundings of hundreds of
    p_j add up to more than 2e-2 + 2e-2 |acc| (the fp32 K5b's and K6d's
    acc stay at it)."""
    h, hkv, d, psz, nblk, starts, valid, c = SPLIT_CASES[case]
    q, pools, table, start, kv_len = chunk_inputs(
        len(starts), h, hkv, d, psz, nblk, starts, valid, dtype, cuda_device,
        140, c, quant)
    scales = dict(k_scale=pools.k_scale, v_scale=pools.v_scale)
    split = pa.paged_prefill_split_quant if quant else pa.paged_prefill_split
    tc = dtype == torch.bfloat16
    tiles = (dict(block_q=pa.TC_TILE_ROWS // (h // hkv),
                  block_k=pa.TC_TILE_KEYS) if tc else {})
    merged = (pa.paged_prefill_split_quant_merged if quant
              else pa.paged_prefill_split_merged)
    n = (split.launches, pa.split_combine.launches, merged.launches)
    got = ops.paged_verify(q, pools, table, start, kv_len, num_splits=ns)
    torch.cuda.synchronize()
    # bf16: one launch, K5c in the split kernel's epilogue; float32: two
    assert (split.launches, pa.split_combine.launches, merged.launches) == (
        n[0] + (not tc), n[1] + (not tc), n[2] + tc)
    assert got.dtype == dtype and got.shape == q.shape
    want, (m, l, acc) = ref.paged_prefill_split_ref(
        q, pools.k, pools.v, table, start, kv_len, ns, **scales, **tiles)
    one_pass = ref.paged_prefill_ref(q, pools.k, pools.v, table, start,
                                     kv_len, **scales)
    args = (q, pools.k, pools.v) + ((pools.k_scale, pools.v_scale)
                                    if quant else ())
    gm, gl, gacc = split(*args, table, start, kv_len, ns)
    torch.cuda.synchronize()
    assert split.last_kernel == (pa.TC_KERNEL if tc
                                 else "paged_prefill_kernel")
    close(gm, m, torch.float32)
    close(gl, l, torch.float32 if tc else dtype)
    if not tc:
        close(gacc, acc, dtype)
    else:
        # sum_j p_j |v_j| of every split: the plain version over |v| (the
        # codes' magnitudes times their positive scales for int8 pools)
        _, (_, _, acc_abs) = ref.paged_prefill_split_ref(
            q, pools.k, pools.v.float().abs(), table, start, kv_len, ns,
            **scales, **tiles)
        bound = 2.0 ** -8 * acc_abs + 2e-4 * (1 + acc.abs())
        assert bool(((gacc - acc).abs() <= bound).all())
    empty = m == ref.NEG_INF
    assert torch.all(gm[empty] == ref.NEG_INF)
    assert torch.all(gl[empty] == 0) and torch.all(gacc[empty] == 0)
    for i, v in enumerate(valid):
        if v == 0:
            assert torch.all(got[i] == 0)
            assert torch.all(gl[i] == 0) and torch.all(gacc[i] == 0)
            continue
        close(got[i, :, :v], want[i, :, :v], dtype)
        close(got[i, :, :v], one_pass[i, :, :v], dtype)


@pytest.mark.parametrize("quant", [False, True])
def test_split_prefill_ns1_is_the_one_pass_kernel(cuda_device, quant):
    """num_splits 1 (and None) take K4 / K6c's own launch alone: no split
    kernel, merged or not, and no combine."""
    q, pools, table, start, kv_len = chunk_inputs(
        3, 32, 4, 128, 16, 20, [100, 0, 0], [5, 5, 0], torch.bfloat16,
        cuda_device, 150, 5, quant)
    one = pa.flash_paged_prefill_quant if quant else pa.flash_paged_prefill
    split = pa.paged_prefill_split_quant if quant else pa.paged_prefill_split
    merged = (pa.paged_prefill_split_quant_merged if quant
              else pa.paged_prefill_split_merged)
    n = (one.launches, split.launches, pa.split_combine.launches,
         merged.launches)
    base = ops.paged_verify(q, pools, table, start, kv_len)
    ns1 = ops.paged_verify(q, pools, table, start, kv_len, num_splits=1)
    torch.cuda.synchronize()
    assert (one.launches, split.launches, pa.split_combine.launches,
            merged.launches) == (n[0] + 2, n[1], n[2], n[3])
    assert torch.equal(base, ns1)
    assert torch.all(base[2] == 0)
    # 64 splits clamp to the table's 20 pages
    wide = ops.paged_verify(q, pools, table, start, kv_len, num_splits=64)
    torch.cuda.synchronize()
    assert torch.all(wide[2] == 0)
    close(wide[:2], base[:2], torch.bfloat16)


def test_split_prefill_wrappers_reject_what_the_kernels_do_not_take(
        cuda_device):
    q, pools, table, start, kv_len = chunk_inputs(
        2, 4, 2, 32, 8, 4, [3, 0], [4, 2], torch.bfloat16, cuda_device, 160,
        4, False)
    kp, vp = pools.k, pools.v
    split = pa.paged_prefill_split
    with pytest.raises(ValueError, match="CUDA"):
        split(q.cpu(), kp, vp, table, start, kv_len, 2)
    with pytest.raises(ValueError, match="dtype"):
        split(q.float(), kp, vp, table, start, kv_len, 2)
    with pytest.raises(ValueError, match="start and kv_len"):
        split(q, kp, vp, table, start[:1], kv_len, 2)
    with pytest.raises(ValueError, match="page_table"):
        split(q, kp, vp, table[:1], start, kv_len, 2)
    with pytest.raises(ValueError, match="num_splits"):
        split(q, kp, vp, table, start, kv_len, 0)
    wide = [torch.cat([t] * 17, -1)[..., :520].contiguous()
            for t in (q, kp, vp)]
    with pytest.raises(ValueError, match="head dim 520"):
        split(*wide, table, start, kv_len, 2)
    (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
    quant = pa.paged_prefill_split_quant
    with pytest.raises(ValueError, match="int8"):
        quant(q, kp, vp, ks, vs, table, start, kv_len, 2)
    with pytest.raises(ValueError, match="float32"):
        quant(q, k8, v8, ks.cpu(), vs, table, start, kv_len, 2)
    with pytest.raises(ValueError, match="CUDA"):
        quant(q, k8.cpu(), v8, ks, vs, table, start, kv_len, 2)
    with pytest.raises(ValueError, match="q dtype"):
        quant(q.half(), k8, v8, ks, vs, table, start, kv_len, 2)
    with pytest.raises(ValueError, match="dtype"):
        pa.flash_paged_prefill(q, k8, v8, table, start, kv_len, num_splits=2)


# --------------------------------------------------------------------------
# K8 matmul, K7 fdm_stress, and the install path's executors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", ["none", "gelu", "silu", "relu"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(77, 300, 200), (128, 1024, 256),
                                   (1, 8, 24), (130, 72, 9)])
def test_matmul_kernel_matches_plain(cuda_device, dtype, epilogue, with_bias,
                                     m, k, n):
    x = rand((m, k), 30, cuda_device, dtype, k ** -0.5)
    y = rand((k, n), 31, cuda_device, dtype)
    bias = rand((n,), 32, cuda_device, dtype) if with_bias else None
    launches = mmk.matmul.launches
    got = ops.mm(x, y, bias, epilogue=epilogue, block_m=32, block_n=64,
                 block_k=32)
    want = ref.matmul_ref(x, y, bias, epilogue)
    torch.cuda.synchronize()
    assert mmk.matmul.launches == launches + 1
    assert mmk.matmul.last_tiles == (32, 64, 32)
    assert got.dtype == dtype and got.shape == (m, n)
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_every_tile_matches_plain(cuda_device, dtype):
    x = rand((77, 300), 33, cuda_device, dtype, 300 ** -0.5)
    y = rand((300, 200), 34, cuda_device, dtype)
    bias = rand((200,), 35, cuda_device, torch.float32)
    want = ref.matmul_ref(x, y, bias, "gelu", torch.float32)
    for tiles in sorted(mmk.TILES):
        got = mmk.matmul(x, y, bias, block_m=tiles[0], block_n=tiles[1],
                         block_k=tiles[2], epilogue="gelu",
                         out_dtype=torch.float32)
        torch.cuda.synchronize()
        close(got, want, dtype)
        assert mmk.kernel_smem_bytes(dtype, *tiles) == mmk.smem_bytes(
            *tiles, 4 if dtype == torch.float32 else 2)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("epilogue", ["none", "gelu", "silu", "relu"])
@pytest.mark.parametrize("m,k,n", [(200, 328, 136), (77, 300, 200)],
                         ids=["aligned", "unaligned"])
def test_matmul_bf16_tiles_run_the_routed_kernel(cuda_device, m, k, n,
                                                 epilogue, with_bias):
    """Every bf16 tile on a shape TMA can describe (K, N multiples of 8)
    and on one it cannot (K 300): block_m 64 and 128 run the wgmma kernel
    on the first, every other call the mma.sync kernel at block_m 32, as
    ``route`` says; each within the bf16 tolerance of the plain version."""
    x = rand((m, k), 40, cuda_device, torch.bfloat16, k ** -0.5)
    y = rand((k, n), 41, cuda_device, torch.bfloat16)
    bias = rand((n,), 42, cuda_device, torch.float32) if with_bias else None
    want = ref.matmul_ref(x, y, bias, epilogue)
    aligned = k % 8 == 0 and n % 8 == 0
    for tiles in sorted(mmk.TILES):
        got = mmk.matmul(x, y, bias, block_m=tiles[0], block_n=tiles[1],
                         block_k=tiles[2], epilogue=epilogue)
        torch.cuda.synchronize()
        if aligned and tiles[0] >= 64:
            assert mmk.matmul.last_kernel == mmk.WGMMA_KERNEL
            assert mmk.matmul.last_tiles == tiles
        else:
            assert mmk.matmul.last_kernel == mmk.MMA_KERNEL
            assert mmk.matmul.last_tiles == (32,) + tiles[1:]
        close(got, want, torch.bfloat16)


@pytest.mark.parametrize("tiles", sorted(t for t in mmk.TILES if t[0] >= 64))
def test_matmul_wgmma_instances_fit_the_card(cuda_device, tiles):
    """Each wgmma instance launches at its shared memory (the cost
    model's formula) without spilling."""
    info = mmk.wgmma_info(*tiles)
    assert info["blocks_per_sm"] >= 1
    assert info["smem_bytes"] == mmk.smem_bytes(*tiles)
    assert info["local_bytes"] == 0


def test_mm_launches_the_published_tiles(cuda_device):
    x = rand((64, 128), 36, cuda_device, torch.bfloat16)
    y = rand((128, 96), 37, cuda_device, torch.bfloat16)
    at.clear_published()
    try:
        at.publish("matmul", block_m=128, block_n=32, block_k=64)
        ops.mm(x, y)
        assert mmk.matmul.last_tiles == (128, 32, 64)
        assert mmk.matmul.last_kernel == mmk.WGMMA_KERNEL
        ops.mm(x, y, block_k=32)
        assert mmk.matmul.last_tiles == (128, 32, 32)
    finally:
        at.clear_published()
    assert mmk.smem_per_block_limit(cuda_device) >= 48 * 1024


def test_matmul_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x = rand((16, 32), 38, cuda_device, torch.bfloat16)
    y = rand((32, 8), 39, cuda_device, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        mmk.matmul(x.cpu(), y.cpu())
    with pytest.raises(ValueError, match="both be float32"):
        mmk.matmul(x, y.float())
    with pytest.raises(ValueError, match="inner dims"):
        mmk.matmul(x, y[:16])
    with pytest.raises(ValueError, match="contiguous"):
        mmk.matmul(x.t(), x)
    with pytest.raises(ValueError, match="not instantiated"):
        mmk.matmul(x, y, block_m=256)
    with pytest.raises(ValueError, match="bias"):
        mmk.matmul(x, y, x[0])
    with pytest.raises(ValueError, match="out_dtype"):
        mmk.matmul(x, y, out_dtype=torch.float16)


def fdm_case(shape, seed, device):
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    arrays = {n: t(rng.standard_normal(shape)) for n in fk.ARRAYS
              if n not in ("rig", "absx", "absy", "absz")}
    arrays.update(rig=t(rng.uniform(0.5, 2.0, shape)),
                  absx=t(rng.standard_normal(nx)),
                  absy=t(rng.standard_normal(ny)),
                  absz=t(rng.standard_normal(nz)))
    state = {n: t(rng.standard_normal(shape)) for n in fk.STATE}
    return arrays, state


@pytest.mark.parametrize("variant", ["fused", "split"])
@pytest.mark.parametrize("tiles", [(8, 8, 128), (4, 16, 8), (1, 1, 1),
                                   (64, 64, 64)])
@pytest.mark.parametrize("shape", [(12, 10, 16), (60, 50, 130)])
def test_fdm_stress_kernel_matches_plain(cuda_device, variant, tiles, shape):
    arrays, state = fdm_case(shape, 40, cuda_device)
    launches = fk.fdm_stress.launches
    got = fk.fdm_stress(arrays, state, 0.1, variant=variant, bx=tiles[0],
                        by=tiles[1], bz=tiles[2])
    want = ref.fdm_stress_ref(arrays, state, 0.1)
    torch.cuda.synchronize()
    assert fk.fdm_stress.launches == launches + (1 if variant == "fused"
                                                 else 2)
    for name in fk.STATE:
        close(got[name], want[name], torch.float32)


def test_fdm_stress_wrapper_rejects_what_the_kernel_does_not_take(
        cuda_device):
    arrays, state = fdm_case((6, 5, 4), 41, cuda_device)
    with pytest.raises(ValueError, match="float32 only"):
        fk.fdm_stress({**arrays, "lam": arrays["lam"].double()}, state, 0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fk.fdm_stress({**arrays, "q": arrays["q"].cpu()}, state, 0.1)
    with pytest.raises(ValueError, match="absy"):
        fk.fdm_stress({**arrays, "absy": arrays["absx"]}, state, 0.1)
    with pytest.raises(ValueError, match="unknown variant"):
        fk.fdm_stress(arrays, state, 0.1, variant="fission")
    with pytest.raises(ValueError, match="missing"):
        fk.fdm_stress({k: v for k, v in arrays.items() if k != "dzvy"},
                      state, 0.1)


def test_cuda_executors_time_completion(cuda_device):
    """A variant that spins the card for ~10 ms (20M cycles at the H100's
    ~2 GHz) costs at least 8 ms in both executors: they time the work,
    not its launch."""
    def spin(_):
        def run():
            torch.cuda._sleep(20_000_000)
            return torch.empty(1, device=cuda_device)
        return run

    assert CudaEventExecutor(spin, repeats=3, device=cuda_device)({}) >= 8e-3
    assert WallClockExecutor(spin, repeats=3)({}) >= 8e-3


# --------------------------------------------------------------------------
# K9 selective_scan
# --------------------------------------------------------------------------

SSM_CHUNKS = (32, 64, 128, 256, 512)     # the SsmChunk candidates


def ssm_case(bsz, length, di, n, seed, device, dtype):
    """x, dt (positive), a (negative, float32), b, c, d on ``device``."""
    x = rand((bsz, length, di), seed, device, dtype)
    dt = torch.nn.functional.softplus(
        rand((bsz, length, di), seed + 1, device, torch.float32)).to(dtype)
    a = -torch.exp(rand((di, n), seed + 2, device, torch.float32))
    return (x, dt, a, rand((bsz, length, n), seed + 3, device, dtype),
            rand((bsz, length, n), seed + 4, device, dtype),
            rand((di,), seed + 5, device, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("final_state", [False, True])
@pytest.mark.parametrize("bsz,length,di,n", [
    (2, 96, 16, 8), (3, 90, 100, 16), (2, 33, 64, 4), (1, 257, 512, 16),
    (2, 5, 40, 32), (1, 64, 8192, 16)])
def test_ssm_scan_kernel_matches_plain(cuda_device, dtype, final_state, bsz,
                                       length, di, n):
    args = ssm_case(bsz, length, di, n, 40, cuda_device, dtype)
    launches = k9.selective_scan.launches
    got = ops.ssm_scan(*args, chunk=32, return_final_state=final_state)
    want = ref.selective_scan_ref(*args, return_final_state=True)
    torch.cuda.synchronize()
    assert k9.selective_scan.launches == launches + 1
    assert k9.selective_scan.last_chunk == min(32, length)
    y = got[0] if final_state else got
    assert y.dtype == dtype and y.shape == (bsz, length, di)
    close(y, want[0], dtype)
    if final_state:
        assert got[1].dtype == torch.float32
        assert got[1].shape == (bsz, di, n)
        close(got[1], want[1], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_every_chunk_matches_plain(cuda_device, dtype):
    """Every SsmChunk candidate, over a ragged L (the last chunk masked;
    512 is cut to L), with and without the final state; the shared-memory
    formula of the cost model equals the kernel's for both input types."""
    args = ssm_case(2, 300, 256, 16, 50, cuda_device, dtype)
    want_y, want_h = ref.selective_scan_ref(*args, return_final_state=True)
    for chunk in SSM_CHUNKS:
        y, h = k9.selective_scan(*args, chunk=chunk, return_final_state=True)
        torch.cuda.synchronize()
        assert k9.selective_scan.last_chunk == min(chunk, 300)
        close(y, want_y, dtype)
        close(h, want_h, dtype)
        close(k9.selective_scan(*args, chunk=chunk), want_y, dtype)
    for n in k9.STATES:
        for chunk in SSM_CHUNKS:
            for elem in (2, 4):
                assert (k9.kernel_smem_bytes(n, chunk, elem)
                        == k9.smem_bytes(n, chunk, elem))


def test_ssm_scan_launches_the_published_chunk(cuda_device):
    args = ssm_case(1, 200, 64, 16, 60, cuda_device, torch.bfloat16)
    at.clear_published()
    try:
        at.publish("ssm_scan", chunk=128)
        ops.ssm_scan(*args)
        assert k9.selective_scan.last_chunk == 128
        ops.ssm_scan(*args, return_final_state=True, chunk=64)
        assert k9.selective_scan.last_chunk == 64
    finally:
        at.clear_published()


def test_ssm_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x, dt, a, b, c, d = ssm_case(1, 16, 32, 8, 70, cuda_device,
                                 torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k9.selective_scan(x.cpu(), dt, a, b, c, d)
    with pytest.raises(ValueError, match="share one type"):
        k9.selective_scan(x, dt.float(), a, b, c, d)
    with pytest.raises(ValueError, match="float32"):
        k9.selective_scan(x, dt, a.to(torch.bfloat16), b, c, d)
    with pytest.raises(ValueError, match="d_state"):
        k9.selective_scan(x, dt, a[:, :3].contiguous(), b[..., :3]
                          .contiguous(), c[..., :3].contiguous(), d)
    with pytest.raises(ValueError, match="contiguous"):
        k9.selective_scan(x, dt, a, b.transpose(1, 2).contiguous()
                          .transpose(1, 2), c, d)
    with pytest.raises(ValueError, match="shape"):
        k9.selective_scan(x, dt, a, b, c, d[:8].contiguous())
    with pytest.raises(ValueError, match="chunk"):
        k9.selective_scan(x, dt, a, b, c, d, chunk=0)
    # a chunk whose shared memory the card cannot give fails at launch
    x1, dt1, a1, b1, c1, d1 = ssm_case(1, 4096, 32, 1, 71, cuda_device,
                                       torch.float32)
    with pytest.raises(RuntimeError, match="launch failed"):
        k9.selective_scan(x1, dt1, a1, b1, c1, d1, chunk=4096)


# --------------------------------------------------------------------------
# K3 / K6a with a bf16 query: the cluster kernel (csrc/paged_decode.cu)
# --------------------------------------------------------------------------


def decode_pools(kp, vp, quant):
    """The pools (and scales) a decode kernel reads, and its wrapper."""
    if quant:
        (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
        return (k8, v8, ks, vs), pa.flash_paged_decode_quant
    return (kp, vp), pa.flash_paged_decode


def plain_decode(q, pools, table, lens):
    k, v, *scales = pools
    ks, vs = scales if scales else (None, None)
    return ref.paged_decode_ref(q, k, v, table, lens, k_scale=ks,
                                v_scale=vs)


@pytest.mark.parametrize("cluster", pa.CLUSTER_SIZES)
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("h,hkv,d,psz", [(32, 4, 128, 16), (32, 32, 128, 16),
                                         (12, 4, 64, 8), (16, 1, 32, 16),
                                         (40, 1, 16, 12)])
def test_tc_decode_every_cluster_size_matches_plain(cuda_device, h, hkv, d,
                                                    psz, quant, cluster):
    """Every cluster size through the wrapper's private keyword: G 8, 1,
    3, 16 and 40 (three 16-row slabs), pages of 12 (runs that straddle a
    tile), a lane of kv_len 0 (exactly 0), one shorter than a tile (empty
    ranks), one mid-page and one full."""
    kv_len = [0, 37, 157, 20 * psz]
    q, kp, vp, table, lens = paged_inputs(4, h, hkv, d, psz, 20, kv_len,
                                          torch.bfloat16, cuda_device, 120)
    pools, kernel = decode_pools(kp, vp, quant)
    n = kernel.launches
    got = kernel(q, *pools, table, lens, _cluster=cluster)
    torch.cuda.synchronize()
    assert kernel.launches == n + 1
    assert kernel.last_kernel == pa.DECODE_TC_KERNEL
    assert torch.all(got[0] == 0)
    close(got[1:], plain_decode(q, pools, table, lens)[1:], torch.bfloat16)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("psz", [8, 16, 12])
def test_tc_decode_never_uses_the_slots_past_kv_len(cuda_device, psz, quant):
    """The slots past kv_len in each lane's last live page hold NaN (int8
    pools: codes 127 and NaN scales): the output is finite, equals the
    kernel's on the same pools with those slots zeroed, and matches the
    plain version there."""
    kv_len = [37, 157, 5, 300]
    q, kp, vp, table, lens = paged_inputs(4, 32, 4, 128, psz, 40, kv_len,
                                          torch.bfloat16, cuda_device, 130)
    pools, kernel = decode_pools(kp, vp, quant)
    dirty = [t.clone() for t in pools]
    zeroed = [t.clone() for t in pools]
    for i, n in enumerate(kv_len):
        if n % psz:
            page = int(table[i, n // psz])
            for t, z in zip(dirty, zeroed):
                t[page, :, n % psz:] = (
                    127 if t.dtype == torch.int8 else float("nan"))
                z[page, :, n % psz:] = 0
    got = kernel(q, *dirty, table, lens)
    want = kernel(q, *zeroed, table, lens)
    torch.cuda.synchronize()
    assert kernel.last_kernel == pa.DECODE_TC_KERNEL
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    close(got, plain_decode(q, zeroed, table, lens), torch.bfloat16)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", pa.DECODE_KINDS)
def test_tc_decode_instances_fit_the_card(cuda_device, d, kind):
    """Every instance (K3, K6a, and K2 and K5a as the dense and partials
    modes) fits the two CTAs an SM that ``cluster_size`` counts on at a
    64-entry table, the card holds clusters of every size, and D 128
    builds without spilling."""
    info = pa.decode_tc_info(d, kind, 64)
    assert info["blocks_per_sm"] >= pa.DECODE_CTAS_PER_SM == 2
    assert all(n >= 1 for n in info["clusters"].values())
    if d == 128:
        assert info["local_bytes"] == 0


# --------------------------------------------------------------------------
# K2 and K5a with a bf16 query: the dense and partials modes of the cluster
# kernel (csrc/paged_decode.cu)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cluster", pa.CLUSTER_SIZES)
@pytest.mark.parametrize("h,hkv,d,s", [(32, 4, 128, 1024), (32, 32, 128, 1000),
                                       (12, 4, 64, 300), (16, 1, 32, 77),
                                       (40, 1, 16, 130)])
def test_tc_dense_decode_every_cluster_size_matches_plain(cuda_device, h,
                                                          hkv, d, s, cluster):
    """K2 on the dense mode at every cluster size: G 8, 1, 3, 16 and 40, S
    not always a multiple of the 64-key tile, a lane of kv_len 0 (exactly
    0), one shorter than a tile, one of S and one past S (clamped)."""
    kv_len = [0, 37, s, s + 5]
    q = rand((4, h, 1, d), 140, cuda_device, torch.bfloat16)
    k = rand((4, hkv, s, d), 141, cuda_device, torch.bfloat16)
    v = rand((4, hkv, s, d), 142, cuda_device, torch.bfloat16)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
    n = fa.flash_decode.launches
    got = fa.flash_decode(q, k, v, lens, _cluster=cluster)
    torch.cuda.synchronize()
    assert fa.flash_decode.launches == n + 1
    assert fa.flash_decode.last_kernel == pa.DECODE_TC_KERNEL
    assert torch.all(got[0] == 0)
    close(got[1:], ref.decode_ref(q, k, v, lens)[1:], torch.bfloat16)


def test_tc_dense_decode_never_uses_the_rows_past_kv_len(cuda_device):
    """NaN in every strip row past kv_len: the output is finite and equal
    to the kernel's on the strips with those rows zeroed."""
    kv_len = [37, 157, 5, 300]
    q = rand((4, 32, 1, 128), 143, cuda_device, torch.bfloat16)
    k = rand((4, 4, 300, 128), 144, cuda_device, torch.bfloat16)
    v = rand((4, 4, 300, 128), 145, cuda_device, torch.bfloat16)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
    dirty, zeroed = (k.clone(), v.clone()), (k.clone(), v.clone())
    for i, n in enumerate(kv_len):
        for t, z in zip(dirty, zeroed):
            t[i, :, n:] = float("nan")
            z[i, :, n:] = 0
    got = fa.flash_decode(q, *dirty, lens)
    want = fa.flash_decode(q, *zeroed, lens)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    close(got, ref.decode_ref(q, *zeroed, lens), torch.bfloat16)


def test_decode_wrappers_route_by_query_type(cuda_device):
    """bf16: K2 and K5a on the cluster kernel; float32: the SIMT templates."""
    for dtype, dense, split in (
            (torch.bfloat16, pa.DECODE_TC_KERNEL, pa.DECODE_TC_KERNEL),
            (torch.float32, fa.DECODE_SIMT_KERNEL, pa.DECODE_SIMT_KERNEL)):
        q = rand((2, 8, 1, 64), 146, cuda_device, dtype)
        k = rand((2, 2, 100, 64), 147, cuda_device, dtype)
        fa.flash_decode(q, k, k)
        assert fa.flash_decode.last_kernel == dense
        q, kp, vp, table, kv_len = paged_inputs(2, 8, 2, 64, 16, 8, [77, 128],
                                                dtype, cuda_device, 148)
        pa.paged_decode_split(q, kp, vp, table, kv_len, 4)
        assert pa.paged_decode_split.last_kernel == split


@pytest.mark.parametrize("ns", [2, 3, 8, 16])
@pytest.mark.parametrize("h,hkv,d,psz", [(32, 4, 128, 16), (32, 32, 128, 16),
                                         (12, 4, 64, 8), (40, 1, 16, 12)])
def test_tc_split_decode_partials_match_plain(cuda_device, h, hkv, d, psz,
                                              ns):
    """K5a's partials against the plain version cut at its 64-key tiles:
    m and l at the fp32 tolerance, acc within 2^-8 sum_j p_j |v_j| + 2e-4
    (1 + |acc|) (P rounded to bf16), splits with no key exactly (-1e30,
    0, 0); and the merged output against both plain versions."""
    kv_len = [0, 37, 157, 20 * psz]
    q, kp, vp, table, lens = paged_inputs(4, h, hkv, d, psz, 20, kv_len,
                                          torch.bfloat16, cuda_device, 150)
    n = pa.paged_decode_split.launches
    m, l, acc = pa.paged_decode_split(q, kp, vp, table, lens, ns)
    torch.cuda.synchronize()
    assert pa.paged_decode_split.launches == n + 1
    assert pa.paged_decode_split.last_kernel == pa.DECODE_TC_KERNEL
    _, (wm, wl, wacc) = ref.paged_decode_split_tiles_ref(
        q, kp, vp, table, lens, ns, block_k=pa.DECODE_TILE_KEYS)
    _, (_, _, acc_abs) = ref.paged_decode_split_tiles_ref(
        q, kp, vp.float().abs(), table, lens, ns,
        block_k=pa.DECODE_TILE_KEYS)
    close(m, wm, torch.float32)
    close(l, wl, torch.float32)
    assert bool(((acc - wacc).abs()
                 <= 2.0 ** -8 * acc_abs + 2e-4 * (1 + wacc.abs())).all())
    empty = wm == ref.NEG_INF
    assert bool((m[empty] == ref.NEG_INF).all() and (l[empty] == 0).all()
                and (acc[empty] == 0).all())
    out = pa.flash_paged_decode(q, kp, vp, table, lens, num_splits=ns)
    torch.cuda.synchronize()
    assert torch.all(out[0] == 0)
    close(out[1:], ref.paged_decode_ref(q, kp, vp, table, lens)[1:],
          torch.bfloat16)
    close(out[1:], ref.paged_decode_split_ref(q, kp, vp, table, lens,
                                              ns)[1:], torch.bfloat16)


@pytest.mark.parametrize("ns", [1, 2, 8, 16])
@pytest.mark.parametrize("h,hkv,d,psz", [(32, 4, 128, 16), (32, 32, 128, 16),
                                         (8, 4, 64, 8), (40, 1, 16, 12)])
def test_tc_int8_split_decode_partials_match_plain(cuda_device, h, hkv, d,
                                                   psz, ns):
    """K6b (bf16 q, int8 pools) on the cluster kernel's partials mode: its
    partials against the plain version with the pools' scales cut at its
    64-key tiles, m and l at the fp32 tolerance, acc within 2^-8 sum_j p_j
    |v_j| + 2e-4 (1 + |acc|), splits with no key exactly (-1e30, 0, 0);
    merged, against both plain versions."""
    kv_len = [0, 37, 157, 20 * psz]
    q, kp, vp, table, lens = paged_inputs(4, h, hkv, d, psz, 20, kv_len,
                                          torch.bfloat16, cuda_device, 160)
    (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
    n = pa.paged_decode_split_quant.launches
    m, l, acc = pa.paged_decode_split_quant(q, k8, v8, ks, vs, table, lens,
                                            ns)
    torch.cuda.synchronize()
    assert pa.paged_decode_split_quant.launches == n + 1
    assert pa.paged_decode_split_quant.last_kernel == pa.DECODE_TC_KERNEL
    tiles = dict(k_scale=ks, v_scale=vs, block_k=pa.DECODE_TILE_KEYS)
    _, (wm, wl, wacc) = ref.paged_decode_split_tiles_ref(
        q, k8, v8, table, lens, ns, **tiles)
    _, (_, _, acc_abs) = ref.paged_decode_split_tiles_ref(
        q, k8, v8.float().abs(), table, lens, ns, **tiles)
    close(m, wm, torch.float32)
    close(l, wl, torch.float32)
    assert bool(((acc - wacc).abs()
                 <= 2.0 ** -8 * acc_abs + 2e-4 * (1 + wacc.abs())).all())
    empty = wm == ref.NEG_INF
    assert bool((m[empty] == ref.NEG_INF).all() and (l[empty] == 0).all()
                and (acc[empty] == 0).all())
    if ns > 1:
        out = pa.flash_paged_decode_quant(q, k8, v8, ks, vs, table, lens,
                                          num_splits=ns)
        torch.cuda.synchronize()
        assert torch.all(out[0] == 0)
        want = ref.paged_decode_ref(q, k8, v8, table, lens, k_scale=ks,
                                    v_scale=vs)
        close(out[1:], want[1:], torch.bfloat16)


def test_int8_split_decode_routes_by_query_type(cuda_device):
    """K6b: bf16 on the cluster kernel's partials mode, float32 on the
    SIMT template."""
    for dtype, kernel in ((torch.bfloat16, pa.DECODE_TC_KERNEL),
                          (torch.float32, pa.DECODE_SIMT_KERNEL)):
        q, kp, vp, table, kv_len = paged_inputs(2, 8, 2, 64, 16, 8, [77, 128],
                                                dtype, cuda_device, 165)
        (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
        pa.paged_decode_split_quant(q, k8, v8, ks, vs, table, kv_len, 4)
        assert pa.paged_decode_split_quant.last_kernel == kernel


@pytest.mark.parametrize("psz", [8, 16, 12])
def test_tc_int8_split_decode_never_uses_the_slots_past_kv_len(cuda_device,
                                                               psz):
    """K6b with codes 127 and NaN scales in the slots past kv_len of each
    lane's last live page: every partial is finite and bit-equal to the
    kernel's on the same pools with those slots zeroed."""
    kv_len = [37, 157, 5, 300]
    q, kp, vp, table, lens = paged_inputs(4, 32, 4, 128, psz, 40, kv_len,
                                          torch.bfloat16, cuda_device, 170)
    pools = [*quantize(kp), *quantize(vp)]       # k8, ks, v8, vs
    dirty = [t.clone() for t in pools]
    zeroed = [t.clone() for t in pools]
    for i, n in enumerate(kv_len):
        if n % psz:
            page = int(table[i, n // psz])
            for t, z in zip(dirty, zeroed):
                t[page, :, n % psz:] = (
                    127 if t.dtype == torch.int8 else float("nan"))
                z[page, :, n % psz:] = 0
    got, want = (pa.paged_decode_split_quant(q, k8, v8, ks, vs, table, lens,
                                             8)
                 for k8, ks, v8, vs in (dirty, zeroed))
    torch.cuda.synchronize()
    assert pa.paged_decode_split_quant.last_kernel == pa.DECODE_TC_KERNEL
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert torch.equal(g, w)


# --------------------------------------------------------------------------
# K4 / K6c with a bf16 query: the tensor-core kernel (csrc/paged_prefill.cu)
# --------------------------------------------------------------------------

TC_KERNEL = pa.TC_KERNEL


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("psz", [8, 16, 32])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("h,hkv", [(32, 32), (32, 4), (8, 2), (32, 1)])
def test_tc_prefill_kernel_matches_plain(cuda_device, h, hkv, d, psz, quant):
    """G 1, 8, 4 and 32 (one chunk row a tile); for each chunk size C (5, 8, 44, 128, 200) three
    lanes: a chunk whose start falls mid-page, a ragged chunk at 0 (its
    last key tile part-filled) and an idle lane (kv_len 0) that must come
    out exactly 0.  One launch of the tensor-core kernel per call."""
    for i, c in enumerate((5, 8, 44, 128, 200)):
        start = 3 * psz + psz // 2 + i
        valid = [c, max(1, c - 3), 0]
        kv_len = [start + c, valid[1], 0]
        nblk = -(-(start + c) // psz)
        q, kp, vp, table, lens = paged_inputs(
            3, h, hkv, d, psz, nblk, kv_len, torch.bfloat16, cuda_device,
            200 + d + psz + c, c=c)
        starts = torch.tensor([start, 0, 0], dtype=torch.int32,
                              device=cuda_device)
        if quant:
            (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
            pools = ops.PagedPools(k8, v8, ks, vs)
            kernel = pa.flash_paged_prefill_quant
        else:
            pools = ops.PagedPools(kp, vp)
            kernel = pa.flash_paged_prefill
        n = kernel.launches
        got = ops.paged_prefill(q, pools, table, starts, lens)
        want = ref.paged_prefill_ref(q, pools.k, pools.v, table, starts, lens,
                                     k_scale=pools.k_scale,
                                     v_scale=pools.v_scale)
        torch.cuda.synchronize()
        assert kernel.launches == n + 1
        assert kernel.last_kernel == TC_KERNEL
        assert got.dtype == torch.bfloat16
        for lane, v in enumerate(valid[:2]):
            close(got[lane, :, :v], want[lane, :, :v], torch.bfloat16)
        assert torch.all(got[2] == 0)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_tc_prefill_kernel_at_the_verify_shape(cuda_device, quant):
    """yi-6b verify chunks of 5 at four lanes' ends and an idle lane,
    ``num_splits=1``: the tensor-core kernel, the idle lane exactly 0."""
    starts = [839, 720, 190, 544, 0]
    kv_len = [s + 5 for s in starts[:4]] + [0]
    q, kp, vp, table, lens = paged_inputs(5, 32, 4, 128, 16, 64, kv_len,
                                          torch.bfloat16, cuda_device, 300,
                                          c=5)
    start = torch.tensor(starts, dtype=torch.int32, device=cuda_device)
    pools = ops.PagedPools(kp, vp)
    if quant:
        (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
        pools = ops.PagedPools(k8, v8, ks, vs)
    kernel = pa.flash_paged_prefill_quant if quant else pa.flash_paged_prefill
    n = kernel.launches
    got = ops.paged_verify(q, pools, table, start, lens, num_splits=1)
    torch.cuda.synchronize()
    assert kernel.launches == n + 1 and kernel.last_kernel == TC_KERNEL
    assert torch.all(got[4] == 0)
    close(got[:4], ref.paged_prefill_ref(q, pools.k, pools.v, table, start,
                                         lens, k_scale=pools.k_scale,
                                         v_scale=pools.v_scale)[:4],
          torch.bfloat16)


def test_tc_prefill_wrappers_reject_group_sizes_the_tile_does_not_take(
        cuda_device):
    """G 3 divides no row tile at D 64 (32 rows only) and was refused; it
    now runs on the flattened (position, head) rows of the padded instance
    of width 64, its tile named by its rows, K4, K6c and K6d's partials
    merged against plain; the float32 query of the same shape goes to
    the SIMT template."""
    q, kp, vp, table, lens = paged_inputs(1, 12, 4, 64, 8, 2, [9],
                                          torch.bfloat16, cuda_device, 310,
                                          c=4)
    start = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    assert pa.flattened(64, 3)
    want = ref.paged_prefill_ref(q, kp, vp, table, start, lens)
    close(padded_launch(pa.flash_paged_prefill, 64, lambda:
                        pa.flash_paged_prefill(q, kp, vp, table, start,
                                               lens)), want, torch.bfloat16)
    assert pa.flash_paged_prefill.by_tile[(32, 128)] > 0
    (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
    want8 = ref.paged_prefill_ref(q, k8, v8, table, start, lens,
                                  k_scale=ks, v_scale=vs)
    close(pa.flash_paged_prefill_quant(q, k8, v8, ks, vs, table, start,
                                       lens), want8, torch.bfloat16)
    m, l, acc = pa.paged_prefill_split_quant(q, k8, v8, ks, vs, table, start,
                                             lens, 2)
    close(pa.split_combine(m, l, acc, torch.bfloat16), want8, torch.bfloat16)
    out = pa.flash_paged_prefill(q.float(), kp.float(), vp.float(), table,
                                 start, lens)
    assert pa.flash_paged_prefill.last_kernel == "paged_prefill_kernel"
    close(out, ref.paged_prefill_ref(q.float(), kp.float(), vp.float(),
                                     table, start, lens), torch.float32)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", pa.TC_KINDS)
def test_tc_prefill_instances_fit_the_card(cuda_device, d, kind):
    """Every instance (K4, K6c, and the partials modes K5b and K6d) fits
    one block per SM at a 64-entry table, and builds without spilling at the main
    path's width (D 128)."""
    info = pa.tc_info(d, kind, 64)
    assert info["blocks_per_sm"] >= 1
    if d == 128:
        assert info["local_bytes"] == 0


# --------------------------------------------------------------------------
# K5c in the epilogue of the bf16 split kernels: the merged routes
# --------------------------------------------------------------------------


def counters_all_zero() -> bool:
    torch.cuda.synchronize()
    return all(int(c.count_nonzero()) == 0 for c in pa.arrival_counters())


def merged_decode_case(device, h, hkv, d, psz, quant, seed):
    """A merged decode call's inputs: four lanes (an empty one, one shorter
    than a tile, a ragged one and a full table) and its entry."""
    q, kp, vp, table, lens = paged_inputs(4, h, hkv, d, psz, 20,
                                          [0, 37, 157, 20 * psz],
                                          torch.bfloat16, device, seed)
    if quant:
        (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
        return (q, k8, v8, ks, vs, table, lens), \
            pa.paged_decode_split_quant_merged, pa.paged_decode_split_quant
    return (q, kp, vp, table, lens), pa.paged_decode_split_merged, \
        pa.paged_decode_split


@pytest.mark.parametrize("ns", [2, 3, 8, 16])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("h,hkv,d,psz", [(32, 4, 128, 16), (32, 32, 128, 16),
                                         (12, 4, 64, 8), (40, 1, 16, 12)])
def test_merged_split_decode_is_bit_equal_to_split_combine(
        cuda_device, h, hkv, d, psz, quant, ns):
    """K5a / K6b with K5c in the epilogue: one launch, whose output is
    bit-equal to K5c (``split_combine``) over the partials that same launch
    wrote, and equal to the two-launch route's output; G 8, 1, 3 and 40
    (three 16-row slabs); every arrival counter zero afterwards."""
    args, merged, split = merged_decode_case(cuda_device, h, hkv, d, psz,
                                             quant, 180)
    n = (merged.launches, split.launches, pa.split_combine.launches)
    o, parts = merged(*args, ns, return_partials=True)
    torch.cuda.synchronize()
    assert (merged.launches, split.launches, pa.split_combine.launches) == (
        n[0] + 1, n[1], n[2])
    assert merged.last_kernel == pa.DECODE_TC_KERNEL
    assert counters_all_zero()
    want = pa.split_combine(*parts, torch.bfloat16).reshape(o.shape)
    assert torch.equal(o, want)
    assert torch.equal(o, pa.split_combine(*split(*args, ns),
                                           torch.bfloat16).reshape(o.shape))
    assert torch.all(o[0] == 0)                  # kv_len 0: exactly 0


@pytest.mark.parametrize("ns", [2, 3, 8, 16])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_merged_split_verify_is_bit_equal_to_split_combine(cuda_device, case,
                                                           quant, ns):
    """K5b / K6d with K5c in the epilogue, at the split cases (verify
    chunks with an idle lane, prefill chunks of two q tiles): bit-equal to
    ``split_combine`` over the launch's own partials, every arrival
    counter zero afterwards, an idle lane exactly 0."""
    h, hkv, d, psz, nblk, starts, valid, c = SPLIT_CASES[case]
    q, pools, table, start, kv_len = chunk_inputs(
        len(starts), h, hkv, d, psz, nblk, starts, valid, torch.bfloat16,
        cuda_device, 190, c, quant)
    merged = (pa.paged_prefill_split_quant_merged if quant
              else pa.paged_prefill_split_merged)
    sc = (pools.k_scale, pools.v_scale) if quant else ()
    n = (merged.launches, pa.split_combine.launches)
    o, parts = merged(q, pools.k, pools.v, *sc, table, start, kv_len, ns,
                      return_partials=True)
    torch.cuda.synchronize()
    assert (merged.launches, pa.split_combine.launches) == (n[0] + 1, n[1])
    assert merged.last_kernel == TC_KERNEL
    assert counters_all_zero()
    assert torch.equal(o, pa.split_combine(*parts, torch.bfloat16))
    for i, v in enumerate(valid):
        if v == 0:
            assert torch.all(o[i] == 0)


def test_arrival_counters_stay_zero_on_a_second_stream_and_when_grown(
        cuda_device):
    """One workspace per stream, made once: a call on a side stream makes
    its own; a larger grid grows the workspace; after every call every
    counter is 0, and the outputs equal the default stream's."""
    args, merged, _ = merged_decode_case(cuda_device, 32, 4, 128, 16, False,
                                         200)
    base = merged(*args, 8)
    assert counters_all_zero()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = merged(*args, 8)
        key = (cuda_device.index or 0, side.cuda_stream)
    torch.cuda.current_stream().wait_stream(side)
    assert counters_all_zero()
    assert torch.equal(base, other)
    assert key in pa._ARRIVALS
    before = pa._ARRIVALS[key].numel()
    # deepseek-7b's 32 kv heads over 4 lanes: 128 tiles, a larger grid
    wide, wmerged, _ = merged_decode_case(cuda_device, 32, 32, 128, 16,
                                          False, 201)
    with torch.cuda.stream(side):
        side.wait_stream(torch.cuda.default_stream())
        wmerged(*wide, 8)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert pa._ARRIVALS[key].numel() > before
    assert counters_all_zero()
    for _ in range(3):              # back to back on one stream
        merged(*args, 16)
        wmerged(*wide, 3)
    assert counters_all_zero()


def test_merged_split_routes_reject_a_float32_query(cuda_device):
    """The merged routes take a bf16 query; float32 keeps K5a + K5c."""
    args, merged, _ = merged_decode_case(cuda_device, 8, 2, 64, 16, False, 210)
    q = args[0].float()
    with pytest.raises(ValueError, match="bfloat16"):
        merged(q, *args[1:], 4)
    n = (pa.paged_decode_split.launches, pa.split_combine.launches)
    pa.flash_paged_decode(q, args[1].float(), args[2].float(), *args[3:],
                          num_splits=4)
    assert (pa.paged_decode_split.launches,
            pa.split_combine.launches) == (n[0] + 1, n[1] + 1)


# --------------------------------------------------------------------------
# the tiles (the run-time AT's block_k, block_q x block_k): every instance
# --------------------------------------------------------------------------


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
@pytest.mark.parametrize("kind", pa.DECODE_KINDS)
def test_tc_decode_tile_instances_fit_the_card(cuda_device, kind, block_k):
    """Every key tile of the D = 128 decode instances holds the CTAs an SM
    the cluster rule counts (``DECODE_CTAS_PER_SM``) at a 64-entry table,
    and builds without spilling."""
    info = pa.decode_tc_info(128, kind, 64, block_k=block_k)
    assert info["blocks_per_sm"] >= pa.DECODE_CTAS_PER_SM
    assert all(n >= 1 for n in info["clusters"].values())
    assert info["local_bytes"] == 0


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
@pytest.mark.parametrize("quant", [False, True], ids=["K3", "K6a"])
@pytest.mark.parametrize("h,hkv", [(32, 4), (32, 32)])
def test_tc_decode_every_tile_matches_plain(cuda_device, h, hkv, quant,
                                            block_k):
    """K3 and K6a at every key tile, at clusters of 1 and 8 and at the
    cluster rule's size: G 8 and 1, an empty lane (exactly 0), one shorter
    than every tile, a ragged one and a full table; ``by_tile`` counts
    the launches."""
    kv_len = [0, 37, 157, 320]
    q, kp, vp, table, lens = paged_inputs(4, h, hkv, 128, 16, 20, kv_len,
                                          torch.bfloat16, cuda_device, 400)
    pools, kernel = decode_pools(kp, vp, quant)
    want = plain_decode(q, pools, table, lens)
    n = kernel.by_tile[block_k]
    for cluster in (1, 8, None):
        got = kernel(q, *pools, table, lens, block_k=block_k,
                     _cluster=cluster)
        torch.cuda.synchronize()
        assert kernel.last_kernel == pa.DECODE_TC_KERNEL
        assert torch.all(got[0] == 0)
        close(got[1:], want[1:], torch.bfloat16)
    assert kernel.by_tile[block_k] == n + 3


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
@pytest.mark.parametrize("h,hkv,s", [(32, 4, 1000), (32, 32, 300)])
def test_tc_dense_decode_every_tile_matches_plain(cuda_device, h, hkv, s,
                                                  block_k):
    """K2 (the dense mode) at every key tile: S not a multiple of any
    tile, an empty lane exactly 0, a lane past S clamped to S."""
    kv_len = torch.tensor([0, 37, 517, 2 * s], dtype=torch.int32,
                          device=cuda_device)
    q = rand((4, h, 1, 128), 410, cuda_device, torch.bfloat16)
    k = rand((4, hkv, s, 128), 411, cuda_device, torch.bfloat16)
    v = rand((4, hkv, s, 128), 412, cuda_device, torch.bfloat16)
    got = fa.flash_decode(q, k, v, kv_len, block_k=block_k)
    torch.cuda.synchronize()
    assert fa.flash_decode.last_kernel == pa.DECODE_TC_KERNEL
    assert torch.all(got[0] == 0)
    close(got[1:], ref.decode_ref(q, k, v, kv_len)[1:], torch.bfloat16)


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
@pytest.mark.parametrize("quant", [False, True], ids=["K5a", "K6b"])
def test_tc_split_decode_every_tile_matches_plain(cuda_device, quant,
                                                  block_k):
    """K5a and K6b at every key tile, 3 and 8 splits: the partials against
    ``ref.paged_decode_split_tiles_ref`` cut at the same tile, the merged
    route bit-equal to K5c over its own partials and within tolerance of
    the one-pass plain version; the arrival counters zero afterwards."""
    args, merged, split = merged_decode_case(cuda_device, 32, 4, 128, 16,
                                             quant, 420)
    q, *pools, table, lens = args
    ks, vs = (pools[2], pools[3]) if quant else (None, None)
    for ns in (3, 8):
        out, (m, l, acc) = merged(*args, ns, block_k=block_k,
                                  return_partials=True)
        _, (wm, wl, wacc) = ref.paged_decode_split_tiles_ref(
            q, pools[0], pools[1], table, lens, ns, k_scale=ks, v_scale=vs,
            block_k=block_k)
        torch.cuda.synchronize()
        assert merged.by_tile[block_k] >= 1
        np.testing.assert_allclose(m.cpu().numpy(), wm.cpu().numpy(),
                                   rtol=2e-2, atol=2e-2)
        close(l, wl, torch.bfloat16)
        combined = pa.split_combine(m, l, acc, q.dtype)
        assert torch.equal(out.reshape(combined.shape), combined)
        assert torch.all(out[0] == 0)
        close(out[1:], plain_decode(q, pools, table, lens)[1:],
              torch.bfloat16)
    assert counters_all_zero()


@pytest.mark.parametrize("rows", pa.TC_ROW_TILES)
@pytest.mark.parametrize("block_k", pa.TC_BLOCK_KS)
@pytest.mark.parametrize("kind", pa.TC_KINDS)
def test_tc_prefill_tile_instances_fit_the_card(cuda_device, kind, block_k,
                                                rows):
    """Every tile of the D = 128 prefill instances fits a block an SM at
    a 64-entry table and builds without spilling."""
    info = pa.tc_info(128, kind, 64, rows=rows, block_k=block_k)
    assert info["blocks_per_sm"] >= 1
    assert info["local_bytes"] == 0


@pytest.mark.parametrize("rows", pa.TC_ROW_TILES)
@pytest.mark.parametrize("block_k", pa.TC_BLOCK_KS)
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("h,hkv", [(32, 4), (32, 32), (24, 8), (40, 8)])
def test_tc_prefill_every_tile_matches_plain(cuda_device, h, hkv, quant,
                                             block_k, rows):
    """K4 / K6c in one pass and K5b / K6d with K5c merged (3 splits) at
    every tile of the D = 128 instances, G 8, 1, 3 and 5 (block_q = rows
    // G, a power of two: G 3 at the 48-row tile only, G 5 at the 80-row
    tile only, G 8 and 1 at the others): a chunk of 44 starting mid-page,
    a ragged chunk at 0 and an idle lane (exactly 0); ``by_tile`` counts
    the launches; counters zero after.  A tile a G does not take raises
    ``ValueError``."""
    g = h // hkv
    block_q = rows // g
    c, start = 44, 3 * 16 + 8
    valid = [c, c - 3, 0]
    kv_len = [start + c, valid[1], 0]
    q, kp, vp, table, lens = paged_inputs(3, h, hkv, 128, 16, 32, kv_len,
                                          torch.bfloat16, cuda_device, 430,
                                          c=c)
    starts = torch.tensor([start, 0, 0], dtype=torch.int32,
                          device=cuda_device)
    if quant:
        (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
        pools = ops.PagedPools(k8, v8, ks, vs)
        one, merged = pa.flash_paged_prefill_quant, \
            pa.paged_prefill_split_quant_merged
    else:
        pools = ops.PagedPools(kp, vp)
        one, merged = pa.flash_paged_prefill, pa.paged_prefill_split_merged
    want = ref.paged_prefill_ref(q, pools.k, pools.v, table, starts, lens,
                                 k_scale=pools.k_scale,
                                 v_scale=pools.v_scale)
    tile = (block_q, block_k)
    if rows % g or block_q not in pa.prefill_tiles(torch.bfloat16, 128,
                                                   g)[0]:
        with pytest.raises(ValueError, match="no instance"):
            ops.paged_prefill(q, pools, table, starts, lens, block_q=block_q,
                              block_k=block_k)
        return
    n1, n3 = one.by_tile[tile], merged.by_tile[tile]
    for ns in (1, 3):
        got = ops.paged_prefill(q, pools, table, starts, lens,
                                num_splits=ns, block_q=block_q,
                                block_k=block_k)
        torch.cuda.synchronize()
        for lane, v in enumerate(valid[:2]):
            close(got[lane, :, :v], want[lane, :, :v], torch.bfloat16)
        assert torch.all(got[2] == 0)
    assert one.by_tile[tile] == n1 + 1 and merged.by_tile[tile] == n3 + 1
    assert counters_all_zero()


def test_tile_wrappers_reject_tiles_without_an_instance(cuda_device):
    """A tile the kernels have no instance for raises ``ValueError`` and
    launches nothing: decode block_k 48, 128, 256 and (at D 64) 32; prefill
    block_q 3 and block_k 32; the float32 SIMT templates any tile but
    their own."""
    q, kp, vp, table, lens = paged_inputs(2, 32, 4, 128, 16, 4, [20, 40],
                                          torch.bfloat16, cuda_device, 440)
    n = pa.flash_paged_decode.launches
    for bk in (48, 128, 256):
        with pytest.raises(ValueError, match="no instance"):
            pa.flash_paged_decode(q, kp, vp, table, lens, block_k=bk)
        with pytest.raises(ValueError, match="no instance"):
            pa.flash_paged_decode(q, kp, vp, table, lens, block_k=bk,
                                  num_splits=2)
    with pytest.raises(ValueError, match="no instance"):
        pa.flash_paged_decode(q.float(), kp.float(), vp.float(), table,
                              lens, block_k=64)
    q64, kp64, vp64, table64, lens64 = paged_inputs(
        2, 8, 2, 64, 16, 4, [20, 40], torch.bfloat16, cuda_device, 441)
    with pytest.raises(ValueError, match="no instance"):
        pa.flash_paged_decode(q64, kp64, vp64, table64, lens64, block_k=32)
    assert pa.flash_paged_decode.launches == n
    qc, kpc, vpc, tablec, lensc = paged_inputs(2, 32, 4, 128, 16, 4,
                                               [20, 40], torch.bfloat16,
                                               cuda_device, 442, c=5)
    start = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    for tile in (dict(block_q=3), dict(block_k=32)):
        with pytest.raises(ValueError, match="no instance"):
            pa.flash_paged_prefill(qc, kpc, vpc, tablec, start, lensc,
                                   **tile)
        with pytest.raises(ValueError, match="no instance"):
            pa.paged_prefill_split_merged(qc, kpc, vpc, tablec, start,
                                          lensc, 2, **tile)
    assert counters_all_zero()


# --------------------------------------------------------------------------
# llama4-scout's G 5 (the prefill kernel's 80-row tile) and h2o-danube's
# D 80 (K1, and K2 on the cluster kernel's dense mode)
# --------------------------------------------------------------------------

# (H, Hkv, D, psz, nblk, starts, valid, C) as SPLIT_CASES: llama4-scout's
# verify (4 lanes of 5 rows and an idle lane) and a chunk of 128 at 384
G5_CASES = {
    "verify llama4": (40, 8, 128, 16, 64, [839, 720, 190, 544, 0],
                      [5, 5, 5, 5, 0], 5),
    "chunk llama4 at 384": (40, 8, 128, 16, 32, [384, 0], [128, 128], 128),
}


@pytest.mark.parametrize("ns", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("block_k", pa.TC_BLOCK_KS)
@pytest.mark.parametrize("case", sorted(G5_CASES))
def test_tc_prefill_80_row_tile_matches_plain(cuda_device, case, block_k,
                                              quant, ns):
    """K4 / K6c (ns 1) and K5b / K6d with K5c merged at G 5's default tile,
    80 rows (block_q 16) by 64 and 128 keys: against the one-pass plain
    version; the merged route (a 320-thread block's last-arrival merge)
    bit-equal to ``split_combine`` over its own partials, an idle lane
    exactly 0, the arrival counters zero afterwards."""
    h, hkv, d, psz, nblk, starts, valid, c = G5_CASES[case]
    q, pools, table, start, kv_len = chunk_inputs(
        len(starts), h, hkv, d, psz, nblk, starts, valid, torch.bfloat16,
        cuda_device, 500, c, quant)
    tile = (16, block_k)
    assert pa.default_block_q(d, h // hkv) == 16
    want = ref.paged_prefill_ref(q, pools.k, pools.v, table, start, kv_len,
                                 k_scale=pools.k_scale, v_scale=pools.v_scale)
    if ns == 1:
        one = pa.flash_paged_prefill_quant if quant else pa.flash_paged_prefill
        n = one.by_tile[tile]
        got = ops.paged_prefill(q, pools, table, start, kv_len,
                                block_k=block_k)
        torch.cuda.synchronize()
        assert one.by_tile[tile] == n + 1 and one.last_kernel == TC_KERNEL
    else:
        merged = (pa.paged_prefill_split_quant_merged if quant
                  else pa.paged_prefill_split_merged)
        sc = (pools.k_scale, pools.v_scale) if quant else ()
        n = merged.by_tile[tile]
        got, parts = merged(q, pools.k, pools.v, *sc, table, start, kv_len,
                            ns, block_k=block_k, return_partials=True)
        torch.cuda.synchronize()
        assert merged.by_tile[tile] == n + 1
        assert merged.last_kernel == TC_KERNEL
        assert torch.equal(got, pa.split_combine(*parts, torch.bfloat16))
        assert counters_all_zero()
    for i, v in enumerate(valid):
        if v == 0:
            assert torch.all(got[i] == 0)
            continue
        close(got[i, :, :v], want[i, :, :v], torch.bfloat16)


@pytest.mark.parametrize("tile", fa.attention_tiles(torch.bfloat16, 80),
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("h,hkv,s,causal,window", [
    (32, 8, 700, True, 256), (32, 8, 300, True, None),
    (8, 2, 77, False, 16), (32, 8, 1, True, None)])
def test_tc_attention_d80_every_tile_matches_plain(cuda_device, h, hkv, s,
                                                   causal, window, tile):
    """The bf16 K1 at D 80 (h2o-danube's G 4) at each of its four tiles:
    against plain, with a window that S passes, bit-equal to the default
    tile, one launch counted under its tile."""
    q = rand((2, h, s, 80), 510, cuda_device, torch.bfloat16)
    k = rand((2, hkv, s, 80), 511, cuda_device, torch.bfloat16)
    v = rand((2, hkv, s, 80), 512, cuda_device, torch.bfloat16)
    kw = dict(causal=causal, window=window)
    n = fa.flash_attention.by_tile[tile]
    got = fa.flash_attention(q, k, v, **kw, block_q=tile[0], block_k=tile[1])
    torch.cuda.synchronize()
    assert fa.flash_attention.by_tile[tile] == n + 1
    assert fa.flash_attention.last_kernel == fa.TC_KERNEL
    close(got, ref.attention_ref(q, k, v, **kw), torch.bfloat16)
    assert torch.equal(got, fa.flash_attention(q, k, v, **kw))


@pytest.mark.parametrize("tile", fa.attention_tiles(torch.bfloat16, 80),
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_tc_attention_d80_instances_fit_the_card(cuda_device, tile):
    info = fa.tc_info(80, *tile)
    assert info["smem_bytes"] == fa.smem_bytes(*tile, 80)
    assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
@pytest.mark.parametrize("cluster", pa.CLUSTER_SIZES + (None,))
@pytest.mark.parametrize("h,hkv,s", [(32, 8, 4096), (8, 2, 1000)])
def test_tc_dense_decode_d80_matches_plain(cuda_device, h, hkv, s, cluster,
                                           block_k):
    """K2 (the dense mode) at D 80 at both key tiles and every cluster
    size: a ring of S slots with an empty lane (exactly 0), one shorter
    than a tile, a full one and one past S (clamped)."""
    kv_len = torch.tensor([0, 37, s, s + 9], dtype=torch.int32,
                          device=cuda_device)
    q = rand((4, h, 1, 80), 520, cuda_device, torch.bfloat16)
    k = rand((4, hkv, s, 80), 521, cuda_device, torch.bfloat16)
    v = rand((4, hkv, s, 80), 522, cuda_device, torch.bfloat16)
    n = fa.flash_decode.by_tile[block_k]
    got = fa.flash_decode(q, k, v, kv_len, block_k=block_k, _cluster=cluster)
    torch.cuda.synchronize()
    assert fa.flash_decode.by_tile[block_k] == n + 1
    assert fa.flash_decode.last_kernel == pa.DECODE_TC_KERNEL
    assert torch.all(got[0] == 0)
    close(got[1:], ref.decode_ref(q, k, v, kv_len)[1:], torch.bfloat16)


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
def test_tc_dense_decode_d80_instances_fit_the_card(cuda_device, block_k):
    """The D 80 dense instances hold at least the two CTAs an SM that
    ``cluster_size`` counts on and build without spilling; the paged and
    partials modes have no D 80 instance."""
    info = pa.decode_tc_info(80, "bf16 dense", block_k=block_k)
    assert info["blocks_per_sm"] >= pa.DECODE_CTAS_PER_SM
    assert all(n >= 1 for n in info["clusters"].values())
    assert info["local_bytes"] == 0
    for kind in pa.DECODE_KINDS:
        if kind != "bf16 dense":
            with pytest.raises(RuntimeError):
                pa.decode_tc_info(80, kind, 64, block_k=block_k)


def padded_launch(wrapper, width: int, fn):
    """``fn()``, which must launch ``wrapper`` once on its padded
    instance of ``width``."""
    n = wrapper.by_width[width]
    out = fn()
    assert wrapper.by_width[width] == n + 1
    return out


def test_d80_routes_without_an_instance_raise_on_the_card(cuda_device):
    """The float32 K2 and every paged kernel, which refused D 80, run on
    the padded instances of width 96, against plain."""
    q = rand((2, 8, 1, 80), 530, cuda_device, torch.float32)
    k = rand((2, 2, 64, 80), 531, cuda_device, torch.float32)
    close(padded_launch(fa.flash_decode, 96, lambda: fa.flash_decode(q, k, k)),
          ref.decode_ref(q, k, k), torch.float32)
    qb, kp, vp, table, lens = paged_inputs(2, 8, 2, 80, 16, 4, [20, 40],
                                           torch.bfloat16, cuda_device, 532)
    close(padded_launch(pa.flash_paged_decode, 96, lambda:
                        pa.flash_paged_decode(qb, kp, vp, table, lens)),
          ref.paged_decode_ref(qb, kp, vp, table, lens), torch.bfloat16)
    qc, kpc, vpc, tablec, lensc = paged_inputs(2, 8, 2, 80, 16, 4, [20, 40],
                                               torch.bfloat16, cuda_device,
                                               533, c=5)
    start = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    close(padded_launch(pa.flash_paged_prefill, 96, lambda:
                        pa.flash_paged_prefill(qc, kpc, vpc, tablec, start,
                                               lensc)),
          ref.paged_prefill_ref(qc, kpc, vpc, tablec, start, lensc),
          torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [37, 90])
def test_head_dims_of_odd_rows_match_plain(cuda_device, dtype, d):
    """Head dims whose rows take the padded instances' narrow paths: d 37
    (bf16 rows of 74 bytes and int8 rows of 37, copied byte by byte; an
    odd last column, stored alone) and d 90 (bf16 rows of 180 bytes, by
    4-byte copies; int8 rows of 90, d % 4 == 2, and the merge's 2-column
    tail).  K1, K2, K3/K6a at 1 and 8 splits and K4/K6c at 1 and 4
    splits, each one launch on the padded instance of width 64 or 96,
    against plain."""
    width = fa.padded_width(d)
    h, hkv = 8, 2
    q = rand((2, h, 70, d), 550, cuda_device, dtype)
    k = rand((2, hkv, 70, d), 551, cuda_device, dtype)
    v = rand((2, hkv, 70, d), 552, cuda_device, dtype)
    close(padded_launch(fa.flash_attention, width, lambda:
                        fa.flash_attention(q, k, v, causal=True)),
          ref.attention_ref(q, k, v, causal=True), dtype)
    q1 = rand((2, h, 1, d), 553, cuda_device, dtype)
    kv_len = torch.tensor([70, 33], dtype=torch.int32, device=cuda_device)
    close(padded_launch(fa.flash_decode, width, lambda:
                        fa.flash_decode(q1, k, v, kv_len)),
          ref.decode_ref(q1, k, v, kv_len), dtype)
    bf16 = dtype == torch.bfloat16
    qd, kp, vp, table, lens = paged_inputs(2, h, hkv, d, 16, 20, [250, 41],
                                           dtype, cuda_device, 554)
    qc = rand((2, h, 9, d), 555, cuda_device, dtype, 0.4)
    start = lens - 9
    (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
    for pools, scales in (((kp, vp), {}),
                          ((k8, v8, ks, vs), dict(k_scale=ks, v_scale=vs))):
        quant = bool(scales)
        want = ref.paged_decode_ref(qd, *pools[:2], table, lens, **scales)
        for ns in (1, 8):
            wrapper = (pa.flash_paged_decode_quant if quant
                       else pa.flash_paged_decode) if ns == 1 else (
                (pa.paged_decode_split_quant_merged if quant
                 else pa.paged_decode_split_merged) if bf16 else
                (pa.paged_decode_split_quant if quant
                 else pa.paged_decode_split))
            one = (pa.flash_paged_decode_quant if quant
                   else pa.flash_paged_decode)
            close(padded_launch(wrapper, width, lambda: one(
                qd, *pools, table, lens, num_splits=ns)), want, dtype)
        want = ref.paged_prefill_ref(qc, *pools[:2], table, start, lens,
                                     **scales)
        for ns in (1, 4):
            wrapper = (pa.flash_paged_prefill_quant if quant
                       else pa.flash_paged_prefill) if ns == 1 else (
                (pa.paged_prefill_split_quant_merged if quant
                 else pa.paged_prefill_split_merged) if bf16 else
                (pa.paged_prefill_split_quant if quant
                 else pa.paged_prefill_split))
            one = (pa.flash_paged_prefill_quant if quant
                   else pa.flash_paged_prefill)
            close(padded_launch(wrapper, width, lambda: one(
                qc, *pools, table, start, lens, num_splits=ns)), want, dtype)


# --------------------------------------------------------------------------
# whisper-tiny's cross attention (K1 with a key length of its own, K2 over
# the 1500 encoder frames) and zamba2-7b's D 112 (K1, K2's dense mode)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq", [1, 4, 224])
@pytest.mark.parametrize("h,hkv,d,sk", [(6, 6, 64, 1500), (8, 2, 16, 1500),
                                        (6, 6, 64, 70)])
def test_attention_cross_length_matches_plain(cuda_device, dtype, sq, h, hkv,
                                              d, sk):
    """K1 with Sq != Sk (whisper's cross attention: the decoder's prompt
    over the encoder's frames; a key count that is no multiple of the
    tile), not causal: against the plain version, which aligns the ends;
    one launch, on the tensor cores for a bf16 query."""
    q = rand((2, h, sq, d), 540, cuda_device, dtype, 0.3)
    k = rand((2, hkv, sk, d), 541, cuda_device, dtype, 0.3)
    v = rand((2, hkv, sk, d), 542, cuda_device, dtype)
    n = fa.flash_attention.launches
    got = ops.attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1
    assert fa.flash_attention.last_kernel == (
        fa.TC_KERNEL if dtype == torch.bfloat16 else "flash_attention_kernel")
    assert got.shape == q.shape
    close(got, ref.attention_ref(q, k, v, causal=False), dtype)


def test_attention_cross_length_with_a_mask_raises_on_the_card(cuda_device):
    q = rand((1, 6, 4, 64), 543, cuda_device, torch.bfloat16)
    k = rand((1, 6, 1500, 64), 544, cuda_device, torch.bfloat16)
    n = fa.flash_attention.launches
    for kw in (dict(causal=True), dict(causal=False, window=64)):
        with pytest.raises(ValueError, match="cross attention"):
            fa.flash_attention(q, k, k, **kw)
    assert fa.flash_attention.launches == n


def _nan_tailed(shape, seed, device):
    """A contiguous bf16 tensor of ``shape`` cut from the front of a longer
    buffer whose tail (64 rows of the last strip's width) is NaN: a read
    past the last strip's S rows shows in the output."""
    n = int(np.prod(shape))
    buf = torch.full((n + 64 * shape[-1],), float("nan"), dtype=torch.bfloat16,
                     device=device)
    out = buf[:n].view(shape)
    out.copy_(rand(shape, seed, device, torch.bfloat16))
    return out


@pytest.mark.parametrize("cluster", pa.CLUSTER_SIZES + (None,))
@pytest.mark.parametrize("ragged", [False, True], ids=["whole", "ragged"])
def test_tc_dense_decode_over_1500_frames_matches_plain(cuda_device, cluster,
                                                        ragged):
    """K2 over whisper's cross cache: 1500 rows (the last 64-key tile holds
    28 keys, so its copies must zero-fill past S and never read there), D
    64, G 1, 4 lanes of 6 kv heads, no ``kv_len`` (the cross call) or
    ragged ones; the memory past the last strip is NaN and stays unread."""
    b, h, s, d = 4, 6, 1500, 64
    k = _nan_tailed((b, h, s, d), 545, cuda_device)
    v = _nan_tailed((b, h, s, d), 546, cuda_device)
    q = rand((b, h, 1, d), 547, cuda_device, torch.bfloat16)
    lens = (torch.tensor([1500, 1499, 1473, 64], dtype=torch.int32,
                         device=cuda_device) if ragged else None)
    got = fa.flash_decode(q, k, v, lens, _cluster=cluster)
    torch.cuda.synchronize()
    assert fa.flash_decode.last_kernel == pa.DECODE_TC_KERNEL
    assert bool(torch.isfinite(got).all())
    close(got, ref.decode_ref(q, k, v, lens), torch.bfloat16)


@pytest.mark.parametrize("tile", fa.attention_tiles(torch.bfloat16, 112),
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("h,hkv,s,causal,window", [
    (32, 32, 700, True, 256), (4, 4, 300, True, None),
    (4, 2, 77, False, 16), (4, 4, 1, True, None)])
def test_tc_attention_d112_every_tile_matches_plain(cuda_device, h, hkv, s,
                                                    causal, window, tile):
    """The bf16 K1 at D 112 (zamba2's shared block, G 1) at each of its
    four tiles: against plain, with a window that S passes, bit-equal to
    the default tile, one launch counted under its tile."""
    q = rand((2, h, s, 112), 550, cuda_device, torch.bfloat16)
    k = rand((2, hkv, s, 112), 551, cuda_device, torch.bfloat16)
    v = rand((2, hkv, s, 112), 552, cuda_device, torch.bfloat16)
    kw = dict(causal=causal, window=window)
    n = fa.flash_attention.by_tile[tile]
    got = fa.flash_attention(q, k, v, **kw, block_q=tile[0], block_k=tile[1])
    torch.cuda.synchronize()
    assert fa.flash_attention.by_tile[tile] == n + 1
    assert fa.flash_attention.last_kernel == fa.TC_KERNEL
    close(got, ref.attention_ref(q, k, v, **kw), torch.bfloat16)
    assert torch.equal(got, fa.flash_attention(q, k, v, **kw))


def test_attention_d112_float32_matches_plain(cuda_device):
    q = rand((2, 4, 150, 112), 553, cuda_device, torch.float32, 0.3)
    k = rand((2, 4, 150, 112), 554, cuda_device, torch.float32, 0.3)
    v = rand((2, 4, 150, 112), 555, cuda_device, torch.float32)
    got = fa.flash_attention(q, k, v, causal=True, window=40)
    torch.cuda.synchronize()
    assert fa.flash_attention.last_kernel == "flash_attention_kernel"
    close(got, ref.attention_ref(q, k, v, causal=True, window=40),
          torch.float32)


@pytest.mark.parametrize("tile", fa.attention_tiles(torch.bfloat16, 112),
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_tc_attention_d112_instances_fit_the_card(cuda_device, tile):
    info = fa.tc_info(112, *tile)
    assert info["smem_bytes"] == fa.smem_bytes(*tile, 112)
    assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
@pytest.mark.parametrize("cluster", pa.CLUSTER_SIZES + (None,))
@pytest.mark.parametrize("h,hkv,s", [(32, 32, 4096), (4, 2, 1000)])
def test_tc_dense_decode_d112_matches_plain(cuda_device, h, hkv, s, cluster,
                                            block_k):
    """K2 (the dense mode) at D 112 at both key tiles and every cluster
    size: a ring of S slots with an empty lane (exactly 0), one shorter
    than a tile, a full one and one past S (clamped)."""
    kv_len = torch.tensor([0, 37, s, s + 9], dtype=torch.int32,
                          device=cuda_device)
    q = rand((4, h, 1, 112), 560, cuda_device, torch.bfloat16)
    k = rand((4, hkv, s, 112), 561, cuda_device, torch.bfloat16)
    v = rand((4, hkv, s, 112), 562, cuda_device, torch.bfloat16)
    n = fa.flash_decode.by_tile[block_k]
    got = fa.flash_decode(q, k, v, kv_len, block_k=block_k, _cluster=cluster)
    torch.cuda.synchronize()
    assert fa.flash_decode.by_tile[block_k] == n + 1
    assert fa.flash_decode.last_kernel == pa.DECODE_TC_KERNEL
    assert torch.all(got[0] == 0)
    close(got[1:], ref.decode_ref(q, k, v, kv_len)[1:], torch.bfloat16)


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
def test_tc_dense_decode_d112_instances_fit_the_card(cuda_device, block_k):
    """The D 112 dense instances hold at least the two CTAs an SM that
    ``cluster_size`` counts on and build without spilling; the paged and
    partials modes have no D 112 instance."""
    info = pa.decode_tc_info(112, "bf16 dense", block_k=block_k)
    assert info["blocks_per_sm"] >= pa.DECODE_CTAS_PER_SM
    assert all(n >= 1 for n in info["clusters"].values())
    assert info["local_bytes"] == 0
    for kind in pa.DECODE_KINDS:
        if kind != "bf16 dense":
            with pytest.raises(RuntimeError):
                pa.decode_tc_info(112, kind, 64, block_k=block_k)


def test_d112_routes_without_an_instance_raise_on_the_card(cuda_device):
    """The float32 K2 and the paged kernels, which refused D 112, run on
    the padded instances of width 128, against plain."""
    q = rand((2, 4, 1, 112), 570, cuda_device, torch.float32)
    k = rand((2, 4, 64, 112), 571, cuda_device, torch.float32)
    close(padded_launch(fa.flash_decode, 128,
                        lambda: fa.flash_decode(q, k, k)),
          ref.decode_ref(q, k, k), torch.float32)
    qb, kp, vp, table, lens = paged_inputs(2, 4, 4, 112, 16, 4, [20, 40],
                                           torch.bfloat16, cuda_device, 572)
    close(padded_launch(pa.flash_paged_decode, 128, lambda:
                        pa.flash_paged_decode(qb, kp, vp, table, lens)),
          ref.paged_decode_ref(qb, kp, vp, table, lens), torch.bfloat16)


# --------------------------------------------------------------------------
# pixtral-12b's D 160 (32 q / 8 kv heads: G 4): K1, and K2-K6d, the
# kernels that page, on the tensor cores
# --------------------------------------------------------------------------

D160_TILES = [(bq, bk) for bq in pa.prefill_tiles(torch.bfloat16, 160, 4)[0]
              for bk in pa.TC_BLOCK_KS]


def _nan_past_kv_len(pools, table, kv_len, psz):
    """The pools with NaN (int8 pools: codes 127 and NaN scales) in the
    slots past kv_len of each lane's last live page, and with those slots
    zeroed: (dirty, zeroed)."""
    dirty = [t.clone() for t in pools]
    zeroed = [t.clone() for t in pools]
    for i, n in enumerate(kv_len):
        if n % psz:
            page = int(table[i, n // psz])
            for t, z in zip(dirty, zeroed):
                t[page, :, n % psz:] = (
                    127 if t.dtype == torch.int8 else float("nan"))
                z[page, :, n % psz:] = 0
    return dirty, zeroed


@pytest.mark.parametrize("tile", fa.attention_tiles(torch.bfloat16, 160),
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("h,hkv,s,causal", [
    (8, 2, 1280, True), (4, 1, 300, True), (4, 4, 77, False),
    (4, 1, 1, True)])
def test_tc_attention_d160_every_tile_matches_plain(cuda_device, h, hkv, s,
                                                    causal, tile):
    """The bf16 K1 at D 160 (pixtral's G 4, and G 1) at each of its four
    tiles: causal at S' = 1280 (the vision prefill: 1024 patches and a
    256-token prompt) and at a ragged S, non-causal, one row; against
    plain, bit-equal to the default tile, one launch counted under its
    tile."""
    q = rand((2, h, s, 160), 580, cuda_device, torch.bfloat16)
    k = rand((2, hkv, s, 160), 581, cuda_device, torch.bfloat16)
    v = rand((2, hkv, s, 160), 582, cuda_device, torch.bfloat16)
    n = fa.flash_attention.by_tile[tile]
    got = fa.flash_attention(q, k, v, causal=causal, block_q=tile[0],
                             block_k=tile[1])
    torch.cuda.synchronize()
    assert fa.flash_attention.by_tile[tile] == n + 1
    assert fa.flash_attention.last_kernel == fa.TC_KERNEL
    close(got, ref.attention_ref(q, k, v, causal=causal), torch.bfloat16)
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=causal))


def test_attention_d160_float32_matches_plain(cuda_device):
    """The float32 K1 (the SIMT template, five columns a lane) at D 160."""
    q = rand((2, 8, 150, 160), 583, cuda_device, torch.float32, 0.3)
    k = rand((2, 2, 150, 160), 584, cuda_device, torch.float32, 0.3)
    v = rand((2, 2, 150, 160), 585, cuda_device, torch.float32)
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.last_kernel == "flash_attention_kernel"
    close(got, ref.attention_ref(q, k, v, causal=True), torch.float32)


@pytest.mark.parametrize("tile", fa.attention_tiles(torch.bfloat16, 160),
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_tc_attention_d160_instances_fit_the_card(cuda_device, tile):
    info = fa.tc_info(160, *tile)
    assert info["smem_bytes"] == fa.smem_bytes(*tile, 160)
    assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
@pytest.mark.parametrize("cluster", pa.CLUSTER_SIZES + (None,))
@pytest.mark.parametrize("h,hkv,s", [(32, 8, 1300), (8, 2, 300)])
def test_tc_dense_decode_d160_matches_plain(cuda_device, h, hkv, s, cluster,
                                            block_k):
    """K2 (the dense mode) at D 160, both key tiles, every cluster size
    and the rule's: an empty lane (exactly 0), one shorter than a tile, a
    ragged one and one past S (clamped); the memory past the last strip
    is NaN and stays unread."""
    kv_len = torch.tensor([0, 37, s - 11, s + 9], dtype=torch.int32,
                          device=cuda_device)
    q = rand((4, h, 1, 160), 586, cuda_device, torch.bfloat16)
    k = _nan_tailed((4, hkv, s, 160), 587, cuda_device)
    v = _nan_tailed((4, hkv, s, 160), 588, cuda_device)
    n = fa.flash_decode.by_tile[block_k]
    got = fa.flash_decode(q, k, v, kv_len, block_k=block_k, _cluster=cluster)
    torch.cuda.synchronize()
    assert fa.flash_decode.by_tile[block_k] == n + 1
    assert fa.flash_decode.last_kernel == pa.DECODE_TC_KERNEL
    assert torch.all(got[0] == 0) and bool(torch.isfinite(got).all())
    close(got[1:], ref.decode_ref(q, k, v, kv_len)[1:], torch.bfloat16)


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
@pytest.mark.parametrize("quant", [False, True], ids=["K3", "K6a"])
def test_tc_decode_d160_matches_plain(cuda_device, quant, block_k):
    """K3 and K6a at D 160 and G 4, both key tiles, at clusters of 1, 4 and
    8 and at the rule's size: an empty lane (exactly 0), one shorter than
    a tile, ragged ones with NaN (int8: codes 127 and NaN scales) past
    kv_len in their last live page, table entries past kv_len on the null
    page; the output equals the run over the zeroed slots and the plain
    version's."""
    psz, kv_len = 16, [0, 37, 157, 301]
    q, kp, vp, table, lens = paged_inputs(4, 32, 8, 160, psz, 20, kv_len,
                                          torch.bfloat16, cuda_device, 590)
    pools, kernel = decode_pools(kp, vp, quant)
    dirty, zeroed = _nan_past_kv_len(pools, table, kv_len, psz)
    want = plain_decode(q, zeroed, table, lens)
    n = kernel.by_tile[block_k]
    for cluster in (1, 4, 8, None):
        got = kernel(q, *dirty, table, lens, block_k=block_k,
                     _cluster=cluster)
        clean = kernel(q, *zeroed, table, lens, block_k=block_k,
                       _cluster=cluster)
        torch.cuda.synchronize()
        assert kernel.last_kernel == pa.DECODE_TC_KERNEL
        assert torch.all(got[0] == 0) and bool(torch.isfinite(got).all())
        assert torch.equal(got, clean)
        close(got[1:], want[1:], torch.bfloat16)
    assert kernel.by_tile[block_k] == n + 8


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
@pytest.mark.parametrize("quant", [False, True], ids=["K5a", "K6b"])
def test_tc_split_decode_d160_matches_plain(cuda_device, quant, block_k):
    """K5a and K6b with K5c merged at D 160 and G 4, both key tiles, 3 and
    8 splits: the partials against ``ref.paged_decode_split_tiles_ref``
    cut at the same tile, the output bit-equal to K5c over the launch's
    own partials and within tolerance of the one-pass plain version, an
    empty lane exactly 0; the arrival counters zero afterwards."""
    args, merged, _ = merged_decode_case(cuda_device, 32, 8, 160, 16, quant,
                                         592)
    q, *pools, table, lens = args
    ks, vs = (pools[2], pools[3]) if quant else (None, None)
    n = merged.by_tile[block_k]
    for ns in (3, 8):
        out, (m, l, acc) = merged(*args, ns, block_k=block_k,
                                  return_partials=True)
        _, (wm, wl, wacc) = ref.paged_decode_split_tiles_ref(
            q, pools[0], pools[1], table, lens, ns, k_scale=ks, v_scale=vs,
            block_k=block_k)
        torch.cuda.synchronize()
        np.testing.assert_allclose(m.cpu().numpy(), wm.cpu().numpy(),
                                   rtol=2e-2, atol=2e-2)
        close(l, wl, torch.bfloat16)
        combined = pa.split_combine(m, l, acc, q.dtype)
        assert torch.equal(out.reshape(combined.shape), combined)
        assert torch.all(out[0] == 0)
        close(out[1:], plain_decode(q, pools, table, lens)[1:],
              torch.bfloat16)
    assert merged.by_tile[block_k] == n + 2
    assert merged.last_kernel == pa.DECODE_TC_KERNEL
    assert counters_all_zero()


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
@pytest.mark.parametrize("kind", pa.DECODE_KINDS)
def test_tc_decode_d160_instances_fit_the_card(cuda_device, kind, block_k):
    """Every D 160 decode instance builds without spilling, and the CTAs
    an SM the card holds at a 64-entry table are what the cluster rule
    counts (``DECODE_CTAS``): one at 64 keys, two (of three) at 32."""
    info = pa.decode_tc_info(160, kind, 64, block_k=block_k)
    quant = kind.startswith("int8")
    assert min(info["blocks_per_sm"], pa.DECODE_CTAS_PER_SM) == \
        pa.DECODE_CTAS[(160, block_k, quant)]
    assert all(n >= 1 for n in info["clusters"].values())
    assert info["local_bytes"] == 0


@pytest.mark.parametrize("tile", D160_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_tc_prefill_d160_every_tile_matches_plain(cuda_device, quant, tile):
    """K4 / K6c in one pass and K5b / K6d with K5c merged (3 splits) at
    every tile of the D 160 ladder at G 4 (rows 16, 32 and 64: block_q 4,
    8 and 16, by keys 64 and 128): a chunk of 44 starting mid-page whose
    lane has NaN past kv_len in its last live page (int8: codes 127 and
    NaN scales), a ragged chunk at 0 and an idle lane (exactly 0); the
    output equals the run over the zeroed slots and the plain version's;
    ``by_tile`` counts the launches; counters zero after."""
    block_q, block_k = tile
    psz, c, start = 16, 44, 3 * 16 + 8
    valid = [c, c - 3, 0]
    kv_len = [start + c, valid[1], 0]
    q, kp, vp, table, lens = paged_inputs(3, 32, 8, 160, psz, 32, kv_len,
                                          torch.bfloat16, cuda_device, 594,
                                          c=c)
    starts = torch.tensor([start, 0, 0], dtype=torch.int32,
                          device=cuda_device)
    if quant:
        (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
        pools = (k8, v8, ks, vs)
        one, merged = pa.flash_paged_prefill_quant, \
            pa.paged_prefill_split_quant_merged
    else:
        pools = (kp, vp)
        one, merged = pa.flash_paged_prefill, pa.paged_prefill_split_merged
    dirty, zeroed = _nan_past_kv_len(pools, table, kv_len, psz)
    dirty, zeroed = ops.PagedPools(*dirty), ops.PagedPools(*zeroed)
    want = ref.paged_prefill_ref(q, zeroed.k, zeroed.v, table, starts, lens,
                                 k_scale=zeroed.k_scale,
                                 v_scale=zeroed.v_scale)
    n1, n3 = one.by_tile[tile], merged.by_tile[tile]
    for ns in (1, 3):
        got, clean = (ops.paged_prefill(q, p, table, starts, lens,
                                        num_splits=ns, block_q=block_q,
                                        block_k=block_k)
                      for p in (dirty, zeroed))
        torch.cuda.synchronize()
        assert torch.equal(got, clean)
        for lane, v in enumerate(valid[:2]):
            assert bool(torch.isfinite(got[lane, :, :v]).all())
            close(got[lane, :, :v], want[lane, :, :v], torch.bfloat16)
        assert torch.all(got[2] == 0)
    assert one.by_tile[tile] == n1 + 2 and merged.by_tile[tile] == n3 + 2
    assert one.last_kernel == merged.last_kernel == TC_KERNEL
    assert counters_all_zero()


@pytest.mark.parametrize("tile", D160_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("kind", pa.TC_KINDS)
def test_tc_prefill_d160_instances_fit_the_card(cuda_device, kind, tile):
    """Every tile of the D 160 prefill instances fits a block an SM at a
    64-entry table and builds without spilling."""
    info = pa.tc_info(160, kind, 64, rows=4 * tile[0], block_k=tile[1])
    assert info["blocks_per_sm"] >= 1
    assert info["local_bytes"] == 0


def test_d160_routes_without_an_instance_raise_on_the_card(cuda_device):
    """The float32 K2 and the paged kernels' float32 templates, which
    refused D 160, run on the padded instances of width 160, and the
    prefill kernel takes G 3 at D 160 (no 48-row tile there) on the
    flattened rows of the padded instance of width 160, against plain."""
    q = rand((2, 4, 1, 160), 596, cuda_device, torch.float32)
    k = rand((2, 4, 64, 160), 597, cuda_device, torch.float32)
    close(padded_launch(fa.flash_decode, 160,
                        lambda: fa.flash_decode(q, k, k)),
          ref.decode_ref(q, k, k), torch.float32)
    qf, kp, vp, table, lens = paged_inputs(2, 8, 2, 160, 16, 4, [20, 40],
                                           torch.float32, cuda_device, 598)
    close(padded_launch(pa.flash_paged_decode, 160, lambda:
                        pa.flash_paged_decode(qf, kp, vp, table, lens)),
          ref.paged_decode_ref(qf, kp, vp, table, lens), torch.float32)
    qb, kp, vp, table, lens = paged_inputs(2, 12, 4, 160, 16, 4, [20, 40],
                                           torch.bfloat16, cuda_device, 599,
                                           c=8)
    start = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    assert pa.flattened(160, 3)
    close(padded_launch(pa.flash_paged_prefill, 160, lambda:
                        pa.flash_paged_prefill(qb, kp, vp, table, start,
                                               lens))[:, :, :8],
          ref.paged_prefill_ref(qb, kp, vp, table, start, lens)[:, :, :8],
          torch.bfloat16)
    assert counters_all_zero()

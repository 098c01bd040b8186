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

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa

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
    (32, 4, 200, 128, True, 64)])
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
    assert got.dtype == dtype
    close(got, want, dtype)


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
    close(got, want, dtype)


def test_decode_kernel_kv_len_zero_row_is_exactly_zero(cuda_device):
    q = rand((2, 8, 1, 64), 26, cuda_device, torch.float32)
    k = rand((2, 2, 64, 64), 27, cuda_device, torch.float32)
    kv_len = torch.tensor([0, 64], dtype=torch.int32, device=cuda_device)
    out = fa.flash_decode(q, k, k, kv_len)
    assert torch.all(out[0] == 0)
    close(out[1], ref.decode_ref(q, k, k, kv_len)[1], torch.float32)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = rand((1, 2, 8, 48), 28, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
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
    with pytest.raises(ValueError, match="head dim"):
        pa.flash_paged_decode(q[..., :24].contiguous(), kp[..., :24].contiguous(),
                              vp[..., :24].contiguous(), table, lens)
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
    of 33 keys leaves most of its splits empty."""
    q, kp, vp, table, kv_len = paged_inputs(3, h, hkv, d, psz, 20,
                                            [33, 157, 20 * psz], dtype,
                                            cuda_device, 90)
    n = (pa.paged_decode_split.launches, pa.split_combine.launches,
         pa.flash_paged_decode.launches)
    got = ops.paged_decode(q, ops.PagedPools(kp, vp), table, kv_len,
                           num_splits=ns)
    torch.cuda.synchronize()
    assert (pa.paged_decode_split.launches, pa.split_combine.launches,
            pa.flash_paged_decode.launches) == (n[0] + 1, n[1] + 1, n[2])
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
    """K6a (ns 1) and K6b + K5c (ns 8) against the plain int8 versions."""
    q, kp, vp, table, kv_len = paged_inputs(3, h, hkv, d, psz, 20,
                                            [1, 157, 20 * psz], dtype,
                                            cuda_device, 100)
    (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
    kernel = pa.flash_paged_decode_quant if ns == 1 \
        else pa.paged_decode_split_quant
    n = kernel.launches
    got = ops.paged_decode(q, ops.PagedPools(k8, v8, ks, vs), table, kv_len,
                           num_splits=ns)
    torch.cuda.synchronize()
    assert kernel.launches == n + 1
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

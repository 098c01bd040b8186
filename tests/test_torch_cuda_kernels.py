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
    rows of a lane with no key exactly 0."""
    h, hkv, d, psz, nblk, starts, valid, c = SPLIT_CASES[case]
    q, pools, table, start, kv_len = chunk_inputs(
        len(starts), h, hkv, d, psz, nblk, starts, valid, dtype, cuda_device,
        140, c, quant)
    scales = dict(k_scale=pools.k_scale, v_scale=pools.v_scale)
    split = pa.paged_prefill_split_quant if quant else pa.paged_prefill_split
    n = (split.launches, pa.split_combine.launches)
    got = ops.paged_verify(q, pools, table, start, kv_len, num_splits=ns)
    torch.cuda.synchronize()
    assert (split.launches, pa.split_combine.launches) == (n[0] + 1, n[1] + 1)
    assert got.dtype == dtype and got.shape == q.shape
    want, (m, l, acc) = ref.paged_prefill_split_ref(
        q, pools.k, pools.v, table, start, kv_len, ns, **scales)
    one_pass = ref.paged_prefill_ref(q, pools.k, pools.v, table, start,
                                     kv_len, **scales)
    args = (q, pools.k, pools.v) + ((pools.k_scale, pools.v_scale)
                                    if quant else ())
    gm, gl, gacc = split(*args, table, start, kv_len, ns)
    close(gm, m, torch.float32)
    close(gl, l, dtype)
    close(gacc, acc, dtype)
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
    kernel and no combine."""
    q, pools, table, start, kv_len = chunk_inputs(
        3, 32, 4, 128, 16, 20, [100, 0, 0], [5, 5, 0], torch.bfloat16,
        cuda_device, 150, 5, quant)
    one = pa.flash_paged_prefill_quant if quant else pa.flash_paged_prefill
    split = pa.paged_prefill_split_quant if quant else pa.paged_prefill_split
    n = (one.launches, split.launches, pa.split_combine.launches)
    base = ops.paged_verify(q, pools, table, start, kv_len)
    ns1 = ops.paged_verify(q, pools, table, start, kv_len, num_splits=1)
    torch.cuda.synchronize()
    assert (one.launches, split.launches, pa.split_combine.launches) == \
        (n[0] + 2, n[1], n[2])
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
    with pytest.raises(ValueError, match="head dim"):
        split(q[..., :24].contiguous(), kp[..., :24].contiguous(),
              vp[..., :24].contiguous(), table, start, kv_len, 2)
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


def test_mm_launches_the_published_tiles(cuda_device):
    x = rand((64, 128), 36, cuda_device, torch.bfloat16)
    y = rand((128, 96), 37, cuda_device, torch.bfloat16)
    at.clear_published()
    try:
        at.publish("matmul", block_m=128, block_n=32, block_k=64)
        ops.mm(x, y)
        assert mmk.matmul.last_tiles == (128, 32, 64)
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
    formula of the cost model equals the kernel's."""
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
            assert k9.kernel_smem_bytes(n, chunk) == k9.smem_bytes(n, chunk)


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
# K4 / K6c with a bf16 query: the tensor-core kernel (csrc/paged_prefill.cu)
# --------------------------------------------------------------------------

TC_KERNEL = "paged_prefill_tc_kernel"


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
    """G = H / Hkv must divide the 32-row query tile (G 3 does not); the
    float32 query of the same shape goes to the SIMT template instead."""
    q, kp, vp, table, lens = paged_inputs(1, 12, 4, 64, 8, 2, [9],
                                          torch.bfloat16, cuda_device, 310,
                                          c=4)
    start = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="group size"):
        pa.flash_paged_prefill(q, kp, vp, table, start, lens)
    (k8, ks), (v8, vs) = quantize(kp), quantize(vp)
    with pytest.raises(ValueError, match="group size"):
        pa.flash_paged_prefill_quant(q, k8, v8, ks, vs, table, start, lens)
    out = pa.flash_paged_prefill(q.float(), kp.float(), vp.float(), table,
                                 start, lens)
    assert pa.flash_paged_prefill.last_kernel == "paged_prefill_kernel"
    close(out, ref.paged_prefill_ref(q.float(), kp.float(), vp.float(),
                                     table, start, lens), torch.float32)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_tc_prefill_instances_fit_the_card(cuda_device, d, quant):
    """Every instance fits one block per SM at a 64-entry table, and
    builds without spilling at the main path's width (D 128)."""
    info = pa.tc_info(d, quant, 64)
    assert info["blocks_per_sm"] >= 1
    if d == 128:
        assert info["local_bytes"] == 0

"""The arithmetic and partition of the bf16 paged decode kernel (K3 and K6a
with a bf16 query, ``csrc/paged_decode.cu``), on the CPU.

The kernel cannot run here, so a plain-torch emulation of it stands in: one
cluster of ``c`` CTAs per (lane, kv head), rank r walking the r-th
contiguous share, ceil(tiles / c), of the lane's live 64-key tiles (the last
ranks possibly none); inside a CTA 4 warps, warp w taking keys 16 w .. 16 w
+ 15 of every tile, each with its own online softmax in fp32 (exp2 of
log2-scaled scores, masked keys -1e30); Q.K^T as bf16 products summed in
fp32, an int8 pool's key scale on S's column after the product; P (for
int8 pools P times the value scale) rounded to bf16 before P.V, the row
sums from the fp32 P; the warps' states merged by a max-shift in the CTA,
then the CTAs' states merged by a max-shift across the cluster.  Only the
order of fp32 sums differs from the card.  The emulation is held to

* the plain version ``ref.paged_decode_ref`` at the serve's shapes (yi-6b,
  G 8; deepseek-7b, G 1) and at G 3 and G 16, for every cluster size, over
  bf16 and int8 pools: within the card's bf16 tolerance 2e-2 (rtol = atol),
  and, before the output's own bf16 rounding, within the bound the design
  derives, 2^-8 of sum_j p_j |v_j| / l per output (rounding P moves each
  term by at most bf16's unit roundoff 2^-9) plus 1e-5 for fp32 sums taken
  in another order.  A lane of kv_len 0 comes out exactly 0; a lane
  shorter than one tile leaves every rank but the first empty;
* the JAX package's Pallas kernels ``flash_paged_decode`` and
  ``flash_paged_decode_quant`` in interpret mode, at reduced shapes in
  float32 with q and the bf16 pools holding bf16 values, within the same
  bound.

Inputs come from numpy with a seed; table entries past a lane's live pages
point at page 0.
"""
import inspect
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_paged_decode as jax_paged_decode
from repro.kernels.flash_attention import \
    flash_paged_decode_quant as jax_paged_decode_quant
from repro_torch.distributed.compression import quantize_int8_rows
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

torch.set_num_threads(1)

BF16_TOL = dict(rtol=2e-2, atol=2e-2)      # chip_smoke.py's TOL[bf16]
P_BOUND = 2.0 ** -8                        # of sum_j p_j |v_j| / l
FP32_TERM = 1e-5
LOG2E = math.log2(math.e)
TILE = pa.DECODE_TILE_KEYS                 # keys per tile (a ring stage)
WARPS = 4                                  # key groups of a tile
GROUP = TILE // WARPS


def _merge(states):
    """(m, l, acc) states merged by a max-shift (log2 domain)."""
    m_star = torch.stack([m for m, _, _ in states]).amax(0)
    l = sum(l * torch.exp2(m - m_star) for m, l, _ in states)
    acc = sum(acc * torch.exp2(m - m_star)[..., None]
              for m, _, acc in states)
    return m_star, l, acc


def decode_tc_emulate(q, k_pool, v_pool, table, kv_len, k_scale=None,
                      v_scale=None, cluster=1):
    """The decode kernel's arithmetic and partition in plain torch at
    ``cluster`` CTAs per (lane, kv head); output like q."""
    b, h, _, d = q.shape
    hkv = k_pool.shape[1]
    g = h // hkv
    k = ref.gather_pages(k_pool, table).float()     # bf16 values or codes
    v = ref.gather_pages(v_pool, table).float()
    sk = k.shape[2]
    ones = torch.ones(b, hkv, sk)
    ks = ones if k_scale is None else ref.gather_pages(
        k_scale[..., None], table)[..., 0]
    vs = ones if v_scale is None else ref.gather_pages(
        v_scale[..., None], table)[..., 0]
    # pad the keys to whole tiles: a tile's keys past kv_len are masked
    # scores and zero rows
    pad = -sk % TILE
    kk = torch.repeat_interleave(k, g, dim=1)
    vv = torch.nn.functional.pad(torch.repeat_interleave(v, g, dim=1),
                                 (0, 0, 0, pad))
    ks = torch.repeat_interleave(ks, g, dim=1)
    vs = torch.nn.functional.pad(torch.repeat_interleave(vs, g, dim=1),
                                 (0, pad))
    s = torch.einsum("bhd,bhkd->bhk", q[:, :, 0].float(), kk)
    s = s * ks * np.float32(d ** -0.5 * LOG2E)
    lens = kv_len.clamp(0, sk)
    s = torch.where(torch.arange(sk) < lens[:, None, None], s, ref.NEG_INF)
    s = torch.nn.functional.pad(s, (0, pad), value=ref.NEG_INF)
    out = torch.zeros(b, h, d)
    for i in range(b):
        n_all = -(-int(lens[i]) // TILE)
        per = -(-n_all // cluster)
        ranks = []
        for rank in range(cluster):
            t_lo = min(rank * per, n_all)
            t_hi = min(n_all, t_lo + per)
            warps = []
            for w in range(WARPS):
                m = torch.full((h,), ref.NEG_INF)
                l = torch.zeros(h)
                acc = torch.zeros(h, d)
                for t in range(t_lo, t_hi):
                    j = slice(t * TILE + w * GROUP, t * TILE + (w + 1) * GROUP)
                    st = s[i, :, j]
                    mx = torch.maximum(m, st.amax(-1))
                    # a row that has seen no key yet subtracts 0, so its
                    # masked keys weigh exp2(-1e30) = 0
                    m_use = torch.where(mx == ref.NEG_INF, 0.0, mx)
                    alpha = torch.exp2(m - m_use)
                    p = torch.exp2(st - m_use[:, None])
                    l = l * alpha + p.sum(-1)
                    pv = (p * vs[i, :, j]).to(torch.bfloat16).float()
                    acc = acc * alpha[:, None] + torch.einsum(
                        "hk,hkd->hd", pv, vv[i, :, j])
                    m = mx
                warps.append((m, l, acc))
            ranks.append(_merge(warps))              # the CTA's state
        _, l, acc = _merge(ranks)                    # across the cluster
        out[i] = acc / torch.where(l == 0, 1.0, l)[:, None]
    return out[:, :, None].to(q.dtype)


def shuffled_table(b, nblk, kv_len, psz, seed):
    """Distinct shuffled pages per lane (page 0 is the null page), entries
    past ceil(kv_len / psz) on page 0."""
    pages = np.random.default_rng(seed).permutation(
        np.arange(1, b * nblk + 1)).reshape(b, nblk).astype(np.int32)
    for i, n in enumerate(kv_len):
        pages[i, -(-int(n) // psz):] = 0
    return torch.from_numpy(pages)


def rand(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32))


def case_inputs(h, hkv, d, psz, nblk, kv_len, seed, quant):
    """q and pools in bf16 (int8 pools quantized from them), the table and
    kv_len."""
    b = len(kv_len)
    q = rand((b, h, 1, d), seed).to(torch.bfloat16)
    kp = rand((b * nblk + 1, hkv, psz, d), seed + 1).to(torch.bfloat16)
    vp = rand((b * nblk + 1, hkv, psz, d), seed + 2).to(torch.bfloat16)
    table = shuffled_table(b, nblk, kv_len, psz, seed + 3)
    lens = torch.tensor(kv_len, dtype=torch.int32)
    if quant:
        (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
        return q, (k8, v8, ks, vs), table, lens
    return q, (kp, vp, None, None), table, lens


def weighted_abs_v(q, kp, vp, table, lens, ks, vs):
    """sum_j p_j |v_j| / l per output, p the plain fp32 softmax."""
    return ref.paged_decode_ref(q.float(), kp, vp.abs(), table, lens,
                                k_scale=ks, v_scale=vs)


# (H, Hkv, D, psz, nblk, kv_len): the serve's shapes (chip_smoke.py's
# phase-7 timing lanes) and G 3 and G 16; every case has a lane of kv_len
# 0 and one shorter than a tile
SHAPES = {
    "yi-6b G8": (32, 4, 128, 16, 64, [839, 720, 190, 544, 0, 37]),
    "deepseek-7b G1": (32, 32, 128, 16, 64, [700, 1024, 0, 37]),
    "G3": (12, 4, 64, 8, 20, [0, 37, 85, 157, 160]),
    "G16": (16, 1, 32, 16, 20, [0, 37, 157, 320]),
}


@pytest.mark.parametrize("cluster", pa.CLUSTER_SIZES)
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_emulated_kernel_within_bound_of_plain(shape, quant, cluster):
    h, hkv, d, psz, nblk, kv_len = SHAPES[shape]
    q, (kp, vp, ks, vs), table, lens = case_inputs(h, hkv, d, psz, nblk,
                                                   kv_len, 31, quant)
    got = decode_tc_emulate(q, kp, vp, table, lens, ks, vs, cluster)
    want = ref.paged_decode_ref(q, kp, vp, table, lens, k_scale=ks,
                                v_scale=vs)
    got32 = decode_tc_emulate(q.float(), kp, vp, table, lens, ks, vs,
                              cluster)
    want32 = ref.paged_decode_ref(q.float(), kp, vp, table, lens,
                                  k_scale=ks, v_scale=vs)
    bound = P_BOUND * weighted_abs_v(q, kp, vp, table, lens, ks, vs)
    assert got.dtype == torch.bfloat16
    for i, n in enumerate(kv_len):
        if n == 0:                                # exactly 0
            assert torch.all(got[i] == 0) and torch.all(got32[i] == 0)
            continue
        np.testing.assert_allclose(got[i].float().numpy(),
                                   want[i].float().numpy(), **BF16_TOL)
        err = (got32[i] - want32[i]).abs()
        assert torch.all(err <= bound[i] + FP32_TERM), float(
            (err - bound[i]).max())


def test_short_lane_leaves_trailing_ranks_empty():
    """37 keys are one tile: at 8 CTAs ranks 1..7 walk nothing and keep
    (-1e30, 0, 0), and the merged output equals one CTA's."""
    q, (kp, vp, _, _), table, lens = case_inputs(32, 4, 128, 16, 4, [37],
                                                 41, False)
    one = decode_tc_emulate(q.float(), kp, vp, table, lens, cluster=1)
    eight = decode_tc_emulate(q.float(), kp, vp, table, lens, cluster=8)
    torch.testing.assert_close(one, eight, rtol=0, atol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("h,hkv", [(4, 4), (6, 2), (8, 1), (16, 1)],
                         ids=["G1", "G3", "G8", "G16"])
def test_emulated_kernel_against_jax_kernels_in_interpret_mode(h, hkv, quant):
    """Three lanes (kv_len 0, 11 and 45 over pages of 8, dead entries on
    page 0) in float32; q and the bf16 pools hold bf16 values.  Every
    cluster size against the one JAX result."""
    d, psz, nblk, kv_len = 16, 8, 6, [0, 11, 45]
    q, (kp, vp, ks, vs), table, lens = case_inputs(h, hkv, d, psz, nblk,
                                                   kv_len, 53, quant)
    q = q.float()
    if not quant:
        kp, vp = kp.float(), vp.float()
    args = [jnp.asarray(x.numpy()) for x in (q, kp, vp)]
    if quant:
        args += [jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy())]
        kernel = jax_paged_decode_quant
    else:
        kernel = jax_paged_decode
    want = np.asarray(kernel(*args, jnp.asarray(table.numpy()),
                             jnp.asarray(lens.numpy()), interpret=True))
    bound = (P_BOUND * weighted_abs_v(q, kp, vp, table, lens, ks, vs)
             + FP32_TERM).numpy()
    for cluster in pa.CLUSTER_SIZES:
        got = decode_tc_emulate(q, kp, vp, table, lens, ks, vs,
                                cluster).numpy()
        assert np.all(got[0] == 0)              # kv_len 0: exactly 0
        assert np.all(np.abs(got[1:] - want[1:]) <= bound[1:])


@pytest.mark.parametrize("b,hkv,sms,want", [
    (4, 4, 132, 8),       # yi-6b's four lanes: 16 clusters of 8
    (4, 32, 132, 1),      # deepseek-7b: 128 CTAs at one each
    (1, 4, 132, 8), (8, 4, 132, 4), (4, 8, 132, 4), (16, 4, 132, 2),
    (64, 8, 132, 1), (1, 1, 1, 1), (2, 4, 16, 2)])
def test_cluster_size_from_shapes(b, hkv, sms, want):
    assert pa.cluster_size(b, hkv, sms) == want


def test_cluster_size_is_bounded_and_takes_no_device_argument():
    """Never more than 8, every CTA an SM of its own where a cluster of one
    fits, and the shapes and the SM count its only inputs: nothing of
    kv_len, so the decode step never waits on the host."""
    assert list(inspect.signature(pa.cluster_size).parameters) == [
        "b", "hkv", "sm_count"]
    for b, hkv, sms in itertools.product((1, 2, 3, 4, 8, 33), (1, 2, 4, 8, 32),
                                         (8, 78, 114, 132)):
        c = pa.cluster_size(b, hkv, sms)
        assert c in pa.CLUSTER_SIZES and c <= 8
        assert b * hkv * c <= sms or c == 1
        assert c == 8 or b * hkv * 2 * c > sms

"""The arithmetic and partition of the bf16 decode kernel (K3 and K6a with a
bf16 query, ``csrc/paged_decode.cu``; K2 as its dense mode, K5a and K6b
as its partials mode), on the CPU.

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

The dense mode (K2) walks dense strips (B, Hkv, S, D) with the same
partition, rows found without a table and kv_len clamped to [0, S]; it is
held to ``ref.decode_ref`` and the JAX ``flash_decode`` (interpret mode) in
the same way, at G 1, 2, 3, 8 and 40, every cluster size and an S that is
not a multiple of the 64-key tile.  The partials mode (K5a) is the walk
with one CTA per split in place of a cluster's ranks, each CTA's merged
state stored (m in natural-log units, as K5c reads it): its partials are
held to ``ref.paged_decode_split_tiles_ref`` cut at the same 64-key
tiles, m and l at the fp32 tolerance 2e-4, acc within 2^-8 sum_j p_j |v_j|
+ 2e-4 (1 + |acc|) (the bound the card's ``compare_partials`` applies),
empty splits exactly (-1e30, 0, 0); merged by ``ref.combine_split_states``
they are held to ``ref.paged_decode_ref`` and the JAX
``flash_paged_decode(num_splits=ns)`` within the one-pass bound.  Over
int8 pools the partials mode is K6b: its partials are held to
``ref.paged_decode_split_tiles_ref`` with the pools' scales within the
same bound (G 1, 2 and 8, ragged lanes with an empty one, 1, 2 and 8
splits and more splits than tiles), and merged to ``ref.paged_decode_ref``
and the JAX ``flash_paged_decode_quant(num_splits=ns)``.

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

from repro.kernels.flash_attention import flash_decode as jax_flash_decode
from repro.kernels.flash_attention import flash_paged_decode as jax_paged_decode
from repro.kernels.flash_attention import \
    flash_paged_decode_quant as jax_paged_decode_quant
from repro_torch.distributed.compression import quantize_int8_rows
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from test_torch_prefill_tc import kstep_scores, pad_cols

torch.set_num_threads(1)

BF16_TOL = dict(rtol=2e-2, atol=2e-2)      # chip_smoke.py's TOL[bf16]
P_BOUND = 2.0 ** -8                        # of sum_j p_j |v_j| / l
FP32_TERM = 1e-5
LOG2E = math.log2(math.e)
TILE = pa.DECODE_TILE_KEYS                 # keys per tile (a ring stage)
WARPS = 4                                  # key groups of a tile
GROUP = TILE // WARPS


def tile_warps(block_k: int) -> int:
    """The key groups (warps) of a ``block_k``-key tile, paged_decode.cu's
    ``Tile``: one per 16 keys."""
    return block_k // 16


def _merge(states):
    """(m, l, acc) states merged by a max-shift (log2 domain)."""
    m_star = torch.stack([m for m, _, _ in states]).amax(0)
    l = sum(l * torch.exp2(m - m_star) for m, l, _ in states)
    acc = sum(acc * torch.exp2(m - m_star)[..., None]
              for m, _, acc in states)
    return m_star, l, acc


def emulate_strips(q, k, v, ks, vs, kv_len, parts, partials=False,
                   block_k=TILE, width=None):
    """The decode kernel's arithmetic and partition in plain torch over
    strips k, v (B, Hkv, S, D) (bf16 values or int8 codes) with row
    scales ks, vs (B, Hkv, S) or None: ``parts`` CTAs per (lane, kv head),
    CTA r walking the r-th contiguous share of the lane's live tiles of
    ``block_k`` keys, each split among :func:`tile_warps` key groups.
    Returns the states merged across the CTAs (output like q) or, with
    ``partials``, each CTA's state (m in natural-log units, l, acc) as
    (B, Hkv, parts, G) and (.., D).  ``width`` runs it as the padded
    instance of that width does (test_torch_prefill_tc's ``tc_emulate``;
    the partials keep the d columns of q)."""
    tile, warps = block_k, tile_warps(block_k)
    group = tile // warps
    b, h, _, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    k, v = k.float(), v.float()
    if width is not None:
        q, k, v = pad_cols(q, width), pad_cols(k, width), pad_cols(v, width)
    sk = k.shape[2]
    ones = torch.ones(b, hkv, sk)
    ks = ones if ks is None else ks
    vs = ones if vs is None else vs
    # pad the keys to whole tiles: a tile's keys past kv_len are masked
    # scores and zero rows
    pad = -sk % tile
    kk = torch.repeat_interleave(k, g, dim=1)
    vv = torch.nn.functional.pad(torch.repeat_interleave(v, g, dim=1),
                                 (0, 0, 0, pad))
    ks = torch.repeat_interleave(ks, g, dim=1)
    vs = torch.nn.functional.pad(torch.repeat_interleave(vs, g, dim=1),
                                 (0, pad))
    if width is None:
        s = torch.einsum("bhd,bhkd->bhk", q[:, :, 0].float(), kk)
    else:
        s = kstep_scores("bhd,bhkd->bhk", q[:, :, 0].float(), kk)
    s = s * ks * np.float32(d ** -0.5 * LOG2E)
    lens = kv_len.clamp(0, sk)
    s = torch.where(torch.arange(sk) < lens[:, None, None], s, ref.NEG_INF)
    s = torch.nn.functional.pad(s, (0, pad), value=ref.NEG_INF)
    dp = q.shape[-1]
    out = torch.zeros(b, h, dp)
    states = []
    for i in range(b):
        n_all = -(-int(lens[i]) // tile)
        per = -(-n_all // parts)
        ranks = []
        for rank in range(parts):
            t_lo = min(rank * per, n_all)
            t_hi = min(n_all, t_lo + per)
            states_w = []
            for w in range(warps):
                m = torch.full((h,), ref.NEG_INF)
                l = torch.zeros(h)
                acc = torch.zeros(h, dp)
                for t in range(t_lo, t_hi):
                    j = slice(t * tile + w * group, t * tile + (w + 1) * group)
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
                states_w.append((m, l, acc))
            ranks.append(_merge(states_w))           # the CTA's state
        states.append(ranks)
        _, l, acc = _merge(ranks)                    # across the cluster
        out[i] = acc / torch.where(l == 0, 1.0, l)[:, None]
    if not partials:
        return out[:, :, None, :d].to(q.dtype)
    m, l, acc = (torch.stack([torch.stack([st[j] for st in ranks])
                              for ranks in states]) for j in range(3))
    m = torch.where(m == ref.NEG_INF, ref.NEG_INF, m * math.log(2.0))
    # (B, parts, H[, D]) -> (B, Hkv, parts, G[, D])
    m, l = (x.reshape(b, parts, hkv, g).transpose(1, 2) for x in (m, l))
    return m, l, acc[..., :d].reshape(b, parts, hkv, g, d).transpose(1, 2)


def decode_tc_emulate(q, k_pool, v_pool, table, kv_len, k_scale=None,
                      v_scale=None, cluster=1, block_k=TILE, width=None):
    """K3 / K6a: the pools seen through the table, ``cluster`` CTAs per
    (lane, kv head), ``block_k`` keys a tile; output like q."""
    ks, vs = (None if sc is None else ref.gather_pages(sc[..., None],
                                                       table)[..., 0]
              for sc in (k_scale, v_scale))
    return emulate_strips(q, ref.gather_pages(k_pool, table),
                          ref.gather_pages(v_pool, table), ks, vs, kv_len,
                          cluster, block_k=block_k, width=width)


def dense_tc_emulate(q, k, v, kv_len, cluster=1, block_k=TILE, width=None):
    """K2, the dense mode: the strips (B, Hkv, S, D) themselves."""
    return emulate_strips(q, k, v, None, None, kv_len, cluster,
                          block_k=block_k, width=width)


def split_tc_emulate(q, k_pool, v_pool, table, kv_len, num_splits,
                     k_scale=None, v_scale=None, block_k=TILE):
    """K5a, the partials mode over bf16 pools (K6b: over int8 pools with
    their scales): the fp32 partials (m, l, acc) of ``num_splits``
    splits of the lane's ``block_k``-key tiles."""
    ks, vs = (None if sc is None else ref.gather_pages(sc[..., None],
                                                       table)[..., 0]
              for sc in (k_scale, v_scale))
    return emulate_strips(q, ref.gather_pages(k_pool, table),
                          ref.gather_pages(v_pool, table), ks, vs, kv_len,
                          num_splits, partials=True, block_k=block_k)


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


# --------------------------------------------------------------------------
# K2: the dense mode
# --------------------------------------------------------------------------

# (H, Hkv, D, S, kv_len): G 8 (yi-6b), 1 (deepseek-7b), 2, 3 and 40 (three
# 16-row slabs); S not a multiple of the 64-key tile, a lane of kv_len 0,
# one shorter than a tile, and (yi-6b) one past S, which clamps to S
DENSE_SHAPES = {
    "yi-6b G8": (32, 4, 128, 1000, [1200, 517, 0, 37]),
    "deepseek-7b G1": (32, 32, 128, 300, [300, 0, 129]),
    "G2": (8, 4, 64, 200, [0, 200, 65]),
    "G3": (12, 4, 64, 100, [0, 37, 100]),
    "G40": (40, 1, 16, 130, [0, 130, 64]),
}


def dense_inputs(h, hkv, d, s, kv_len, seed):
    """q and the strips (B, Hkv, S, D) in bf16, kv_len int32."""
    b = len(kv_len)
    q = rand((b, h, 1, d), seed).to(torch.bfloat16)
    k = rand((b, hkv, s, d), seed + 1).to(torch.bfloat16)
    v = rand((b, hkv, s, d), seed + 2).to(torch.bfloat16)
    return q, k, v, torch.tensor(kv_len, dtype=torch.int32)


@pytest.mark.parametrize("cluster", pa.CLUSTER_SIZES)
@pytest.mark.parametrize("shape", list(DENSE_SHAPES))
def test_dense_mode_within_bound_of_plain(shape, cluster):
    h, hkv, d, s, kv_len = DENSE_SHAPES[shape]
    q, k, v, lens = dense_inputs(h, hkv, d, s, kv_len, 61)
    got = dense_tc_emulate(q, k, v, lens, cluster)
    want = ref.decode_ref(q, k, v, lens)
    got32 = dense_tc_emulate(q.float(), k, v, lens, cluster)
    want32 = ref.decode_ref(q.float(), k.float(), v.float(), lens)
    bound = P_BOUND * ref.decode_ref(q.float(), k.float(), v.float().abs(),
                                     lens)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    for i, n in enumerate(kv_len):
        if n == 0:                                # exactly 0
            assert torch.all(got[i] == 0) and torch.all(got32[i] == 0)
            continue
        np.testing.assert_allclose(got[i].float().numpy(),
                                   want[i].float().numpy(), **BF16_TOL)
        err = (got32[i] - want32[i]).abs()
        assert torch.all(err <= bound[i] + FP32_TERM), float(
            (err - bound[i]).max())


def test_dense_mode_is_the_paged_kernel_on_one_page_per_lane():
    """A strip is a pool of B pages of S keys with table[b] = b: the dense
    mode and the paged walk over that pool give the same bits."""
    h, hkv, d, s, kv_len = DENSE_SHAPES["G3"]
    q, k, v, lens = dense_inputs(h, hkv, d, s, kv_len, 67)
    table = torch.arange(len(kv_len), dtype=torch.int32)[:, None]
    for cluster in pa.CLUSTER_SIZES:
        torch.testing.assert_close(
            dense_tc_emulate(q, k, v, lens, cluster),
            decode_tc_emulate(q, k, v, table, lens, cluster=cluster),
            rtol=0, atol=0)


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (6, 2), (8, 1), (40, 1)],
                         ids=["G1", "G2", "G3", "G8", "G40"])
def test_dense_mode_against_jax_flash_decode_in_interpret_mode(h, hkv):
    """Three lanes (kv_len 0, 11 and 100 over S = 100, padded by the JAX
    kernel to its 32-key blocks) in float32 holding bf16 values; every
    cluster size against the one JAX result."""
    q, k, v, lens = dense_inputs(h, hkv, 16, 100, [0, 11, 100], 71)
    q, k, v = q.float(), k.float(), v.float()
    want = np.asarray(jax_flash_decode(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, lens)), block_k=32,
        interpret=True))
    bound = (P_BOUND * ref.decode_ref(q, k, v.abs(), lens)
             + FP32_TERM).numpy()
    for cluster in pa.CLUSTER_SIZES:
        got = dense_tc_emulate(q, k, v, lens, cluster).numpy()
        assert np.all(got[0] == 0)              # kv_len 0: exactly 0
        assert np.all(np.abs(got[1:] - want[1:]) <= bound[1:])


# --------------------------------------------------------------------------
# K5a: the partials mode
# --------------------------------------------------------------------------

def split_partials_bound(q, kp, vp, table, lens, ns, ks=None, vs=None,
                         block_k=TILE):
    """The plain partials at the kernel's ``block_k``-key tiles, and sum_j
    p_j |v_j| of every split (its acc over |v|; int8 pools: over |code|
    times the row's scale)."""
    _, want = ref.paged_decode_split_tiles_ref(q, kp, vp, table, lens, ns,
                                               k_scale=ks, v_scale=vs,
                                               block_k=block_k)
    _, (_, _, acc_abs) = ref.paged_decode_split_tiles_ref(
        q, kp, vp.float().abs(), table, lens, ns, k_scale=ks, v_scale=vs,
        block_k=block_k)
    return want, acc_abs


def check_partials(got, want, acc_abs, shape):
    """m and l at the fp32 tolerance, acc within 2^-8 sum_j p_j |v_j| +
    2e-4 (1 + |acc|), rows that saw no key exactly (-1e30, 0, 0)."""
    (m, l, acc), (wm, wl, wacc) = got, want
    assert m.shape == l.shape == shape[:4] and acc.shape == shape
    np.testing.assert_allclose(m.numpy(), wm.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(l.numpy(), wl.numpy(), rtol=2e-4, atol=2e-4)
    err = (acc - wacc).abs()
    assert torch.all(err <= P_BOUND * acc_abs + 2e-4 * (1 + wacc.abs()))
    empty = wm == ref.NEG_INF
    assert torch.all(m[empty] == ref.NEG_INF) and torch.all(l[empty] == 0)
    assert torch.all(acc[empty] == 0)
    return empty


@pytest.mark.parametrize("ns", [2, 3, 8, 16])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_partials_mode_within_bound_of_plain_partials(shape, ns):
    """Every split's (m, l, acc) against the plain version cut at the same
    tiles; ns 16 leaves the short lanes' trailing splits empty, which must
    be exactly (-1e30, 0, 0)."""
    h, hkv, d, psz, nblk, kv_len = SHAPES[shape]
    q, (kp, vp, _, _), table, lens = case_inputs(h, hkv, d, psz, nblk,
                                                 kv_len, 73, False)
    q = q.float()
    got = split_tc_emulate(q, kp, vp, table, lens, ns)
    want, acc_abs = split_partials_bound(q, kp, vp, table, lens, ns)
    empty = check_partials(got, want, acc_abs,
                           (len(kv_len), hkv, ns, h // hkv, d))
    assert bool(empty.any())                  # the kv_len 0 lane at least


@pytest.mark.parametrize("ns", [2, 3, 8])
@pytest.mark.parametrize("h,hkv", [(4, 4), (6, 2), (8, 1), (16, 1)],
                         ids=["G1", "G3", "G8", "G16"])
def test_merged_partials_against_plain_and_jax(h, hkv, ns):
    """The partials merged as K5c merges them (``combine_split_states``,
    then acc / l) against the one-pass plain version and the JAX
    ``flash_paged_decode(num_splits=ns)`` in interpret mode, float32
    holding bf16 values; a lane of kv_len 0 exactly 0."""
    d, psz, nblk, kv_len = 16, 8, 12, [0, 11, 45, 96]
    q, (kp, vp, _, _), table, lens = case_inputs(h, hkv, d, psz, nblk,
                                                 kv_len, 79, False)
    q, kp, vp = q.float(), kp.float(), vp.float()
    _, l, acc = ref.combine_split_states(
        *split_tc_emulate(q, kp, vp, table, lens, ns))
    got = ref.finalize_split_states(l, acc).reshape(q.shape)
    plain = ref.paged_decode_ref(q, kp, vp, table, lens)
    want = np.asarray(jax_paged_decode(
        *(jnp.asarray(x.numpy()) for x in (q, kp, vp, table, lens)),
        num_splits=ns, interpret=True))
    bound = P_BOUND * weighted_abs_v(q, kp, vp, table, lens, None, None)
    bound = bound + FP32_TERM
    assert torch.all(got[0] == 0)
    assert torch.all((got[1:] - plain[1:]).abs() <= bound[1:])
    assert np.all(np.abs(got[1:].numpy() - want[1:]) <= bound[1:].numpy())


# --------------------------------------------------------------------------
# K6b: the partials mode over int8 pools
# --------------------------------------------------------------------------

# (H, Hkv, D, psz, nblk, kv_len): G 8 (yi-6b), 1 (deepseek-7b) and 2; each
# with a lane of kv_len 0 and one shorter than a tile
INT8_SPLIT_SHAPES = {
    "yi-6b G8": SHAPES["yi-6b G8"],
    "deepseek-7b G1": SHAPES["deepseek-7b G1"],
    "G2": (8, 4, 64, 16, 20, [0, 37, 157, 320]),
}


@pytest.mark.parametrize("ns", [1, 2, 8, 32])
@pytest.mark.parametrize("shape", list(INT8_SPLIT_SHAPES))
def test_int8_partials_mode_within_bound_of_plain_partials(shape, ns):
    """K6b's partials over int8 pools (key scale on S's column, value scale
    folded into P before its bf16 rounding) against the plain version with
    the same scales cut at the same 64-key tiles, within K5a's bound; ns
    32 is more splits than any lane's tiles, whose trailing splits must be
    exactly (-1e30, 0, 0)."""
    h, hkv, d, psz, nblk, kv_len = INT8_SPLIT_SHAPES[shape]
    q, (k8, v8, ks, vs), table, lens = case_inputs(h, hkv, d, psz, nblk,
                                                   kv_len, 83, True)
    q = q.float()
    got = split_tc_emulate(q, k8, v8, table, lens, ns, ks, vs)
    want, acc_abs = split_partials_bound(q, k8, v8, table, lens, ns, ks, vs)
    empty = check_partials(got, want, acc_abs,
                           (len(kv_len), hkv, ns, h // hkv, d))
    assert bool(empty[kv_len.index(0)].all())  # the kv_len 0 lane
    if ns == 32:                              # more splits than tiles
        assert bool(empty[:, :, -1].all())


@pytest.mark.parametrize("ns", [1, 2, 8, 16])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 4), (8, 1)],
                         ids=["G1", "G2", "G8"])
def test_int8_merged_partials_against_plain_and_jax(h, hkv, ns):
    """K6b's partials merged as K5c merges them against the one-pass plain
    version with scales and the JAX ``flash_paged_decode_quant(num_splits=
    ns)`` in interpret mode, float32 q holding bf16 values, within the
    one-pass bound; ns 16 is more splits than the longest lane's two
    tiles; a lane of kv_len 0 exactly 0."""
    d, psz, nblk, kv_len = 16, 8, 12, [0, 11, 45, 96]
    q, (k8, v8, ks, vs), table, lens = case_inputs(h, hkv, d, psz, nblk,
                                                   kv_len, 89, True)
    q = q.float()
    _, l, acc = ref.combine_split_states(
        *split_tc_emulate(q, k8, v8, table, lens, ns, ks, vs))
    got = ref.finalize_split_states(l, acc).reshape(q.shape)
    plain = ref.paged_decode_ref(q, k8, v8, table, lens, k_scale=ks,
                                 v_scale=vs)
    want = np.asarray(jax_paged_decode_quant(
        *(jnp.asarray(x.numpy()) for x in (q, k8, v8, ks, vs, table, lens)),
        num_splits=ns, interpret=True))
    bound = P_BOUND * weighted_abs_v(q, k8, v8, table, lens, ks, vs)
    bound = bound + FP32_TERM
    assert torch.all(got[0] == 0)
    assert torch.all((got[1:] - plain[1:]).abs() <= bound[1:])
    assert np.all(np.abs(got[1:].numpy() - want[1:]) <= bound[1:].numpy())


# (b, hkv, sms, want): the default instance (D 128, 64 keys, bf16 pools)
CLUSTER_CASES = [
    (4, 4, 132, 8),       # yi-6b's four lanes: 16 clusters of 8
    (4, 32, 132, 2),      # deepseek-7b: 256 CTAs, two an SM
    (1, 4, 132, 8), (8, 4, 132, 8), (4, 8, 132, 8), (16, 4, 132, 4),
    (33, 4, 132, 2), (64, 8, 132, 1), (1, 1, 1, 2), (2, 4, 16, 4)]
# (b, hkv, sms, want, (d, block_k, quant)): the instance's own count of
# CTAs an SM.  Every arch's decode at four lanes keeps its c (h2o-danube's
# 8 kv heads at D 80, zamba2's 32 at D 112, whisper's 6 at D 64); at
# pixtral's D 160 a 64-key tile (bf16 or int8 pools) holds one CTA an SM,
# so its 32 (lane, kv head) pairs take c = 4, one wave of 128 CTAs, where
# two an SM would have given 8 (256 CTAs, two waves); the 32-key tile
# holds two of its three
INSTANCE_CASES = [
    (4, 4, 132, 8, (128, 64, False)), (4, 32, 132, 2, (128, 64, False)),
    (4, 8, 132, 8, (80, 64, False)), (4, 32, 132, 2, (112, 64, False)),
    (4, 6, 132, 8, (64, 64, False)), (4, 4, 132, 8, (128, 64, True)),
    (4, 8, 132, 4, (160, 64, False)), (4, 8, 132, 4, (160, 64, True)),
    (4, 8, 132, 8, (160, 32, False)), (4, 8, 132, 8, (160, 32, True)),
    (1, 8, 132, 8, (160, 64, False)), (8, 8, 132, 2, (160, 64, False)),
    (33, 8, 132, 1, (160, 64, False)), (2, 8, 16, 1, (160, 64, False))]


@pytest.mark.parametrize("b,hkv,sms,want,instance", [
    pytest.param(*case, (), id="-".join(map(str, case)))
    for case in CLUSTER_CASES] + [
    pytest.param(*case, id=f"D{case[4][0]}-{case[4][1]}"
                 f"{'-int8' if case[4][2] else ''}-"
                 + "-".join(map(str, case[:4])))
    for case in INSTANCE_CASES])
def test_cluster_size_from_shapes(b, hkv, sms, want, instance):
    assert pa.cluster_size(b, hkv, sms, *instance) == want


def test_cluster_size_is_bounded_and_takes_no_device_argument():
    """Never more than 8, every CTA in the one wave of the CTAs the card
    holds at once (the instance's count an SM: two, one at D 160 and 64
    keys) where a cluster of one fits, and the shapes, the SM count and
    the instance its only inputs: nothing of kv_len, so the decode step
    never waits on the host."""
    assert list(inspect.signature(pa.cluster_size).parameters) == [
        "b", "hkv", "sm_count", "d", "block_k", "quant"]
    assert pa.DECODE_CTAS_PER_SM == 2
    for (d, bk, quant), per_sm in pa.DECODE_CTAS.items():
        assert per_sm == min(pa.DECODE_CTAS_PER_SM,
                             pa.decode_ctas_per_sm(d, bk, quant))
        for b, hkv, sms in itertools.product((1, 2, 3, 4, 8, 33),
                                             (1, 2, 4, 8, 32),
                                             (8, 78, 114, 132)):
            c = pa.cluster_size(b, hkv, sms, d, bk, quant)
            held = per_sm * sms
            assert c in pa.CLUSTER_SIZES and c <= 8
            assert b * hkv * c <= held or c == 1
            assert c == 8 or b * hkv * 2 * c > held


# --------------------------------------------------------------------------
# the key tiles (the run-time AT's block_k): every instance
# --------------------------------------------------------------------------

# yi-6b's heads (G 8, D 128) on shorter lanes: an empty lane, one shorter
# than every tile, and lanes that end mid-tile at 32 and 64 keys
TILE_CASE = (32, 4, 128, 16, 24, [0, 37, 300, 161])


@pytest.mark.parametrize("mode,quant", [
    ("paged", False), ("paged", True), ("dense", False),
    ("partials", False), ("partials", True)],
    ids=["K3", "K6a", "K2", "K5a", "K6b"])
@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
def test_every_decode_tile_within_bound_of_plain(block_k, mode, quant):
    """Each key tile of the D = 128 instances in each mode: the one-pass
    walk (paged at c 8, dense at c 2) within 2^-8 sum_j p_j |v_j| / l +
    1e-5 of the plain version and within the bf16 tolerance after the
    output's rounding; the partials mode (3 splits) against
    ``ref.paged_decode_split_tiles_ref`` cut at the same tile, and merged
    within the one-pass bound.  The empty lane is exactly 0."""
    h, hkv, d, psz, nblk, kv_len = TILE_CASE
    q, (kp, vp, ks, vs), table, lens = case_inputs(h, hkv, d, psz, nblk,
                                                   kv_len, 107, quant)
    bound = P_BOUND * weighted_abs_v(q, kp, vp, table, lens, ks, vs)
    plain = ref.paged_decode_ref(q.float(), kp, vp, table, lens, k_scale=ks,
                                 v_scale=vs)
    if mode == "partials":
        parts = split_tc_emulate(q.float(), kp, vp, table, lens, 3, ks, vs,
                                 block_k=block_k)
        want, acc_abs = split_partials_bound(q.float(), kp, vp, table, lens,
                                             3, ks, vs, block_k=block_k)
        check_partials(parts, want, acc_abs, (len(kv_len), hkv, 3, h // hkv,
                                              d))
        _, l, acc = ref.combine_split_states(*parts)
        got32 = ref.finalize_split_states(l, acc).reshape(q.shape)
        got = got32.to(torch.bfloat16)
    elif mode == "dense":
        k, v = (ref.gather_pages(p, table) for p in (kp, vp))
        got = dense_tc_emulate(q, k, v, lens, 2, block_k=block_k)
        got32 = dense_tc_emulate(q.float(), k, v, lens, 2, block_k=block_k)
    else:
        got = decode_tc_emulate(q, kp, vp, table, lens, ks, vs, 8,
                                block_k=block_k)
        got32 = decode_tc_emulate(q.float(), kp, vp, table, lens, ks, vs, 8,
                                  block_k=block_k)
    assert torch.all(got[0] == 0) and torch.all(got32[0] == 0)
    np.testing.assert_allclose(got[1:].float().numpy(),
                               plain[1:].to(torch.bfloat16).float().numpy(),
                               **BF16_TOL)
    assert torch.all((got32[1:] - plain[1:]).abs() <= bound[1:] + FP32_TERM)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
def test_decode_tiles_against_jax_kernels_in_interpret_mode(block_k, quant):
    """Every key tile against the JAX ``flash_paged_decode(_quant)`` given
    the same ``block_k`` (the TPU kernel's tile is a sub-page one, so it
    takes the whole page of 8 here), in one pass and at 2 splits, float32
    holding bf16 values, within the one-pass bound; G 8 at D 16."""
    d, psz, nblk, kv_len = 16, 8, 24, [0, 11, 45, 150]
    q, (kp, vp, ks, vs), table, lens = case_inputs(8, 1, d, psz, nblk,
                                                   kv_len, 109, quant)
    q = q.float()
    if not quant:
        kp, vp = kp.float(), vp.float()
    args = (q, kp, vp) + ((ks, vs) if quant else ()) + (table, lens)
    kernel = jax_paged_decode_quant if quant else jax_paged_decode
    bound = (P_BOUND * weighted_abs_v(q, kp, vp, table, lens, ks, vs)
             + FP32_TERM).numpy()
    for ns in (1, 2):
        want = np.asarray(kernel(*(jnp.asarray(x.numpy()) for x in args),
                                 block_k=block_k, num_splits=ns,
                                 interpret=True))
        if ns == 1:
            got = decode_tc_emulate(q, kp, vp, table, lens, ks, vs, 2,
                                    block_k=block_k)
        else:
            _, l, acc = ref.combine_split_states(*split_tc_emulate(
                q, kp, vp, table, lens, ns, ks, vs, block_k=block_k))
            got = ref.finalize_split_states(l, acc).reshape(q.shape)
        assert np.all(got[0].numpy() == 0)
        assert np.all(np.abs(got[1:].numpy() - want[1:]) <= bound[1:])


def test_split_clamp_counts_the_tables_block_k_tiles():
    """``num_splits`` is clamped to the table's ``block_k``-key tiles
    (a prefill tile of 128 keys, decode tiles of 32 and 64)."""
    assert pa._num_splits(8, 64 * 16, 128) == 8
    assert pa._num_splits(8, 2 * 16, 128) == 1
    assert pa._num_splits(8, 4 * 16, 32) == 2
    assert pa._num_splits(3, 4 * 16, 64) == 1
    assert pa._num_splits(None, 64, 64) == 1


@pytest.mark.parametrize("dtype,d,block_k,ok", [
    (torch.bfloat16, 128, None, 64), (torch.bfloat16, 128, 32, 32),
    (torch.bfloat16, 128, 128, None), (torch.bfloat16, 128, 48, None),
    (torch.bfloat16, 128, 256, None), (torch.bfloat16, 64, 64, 64),
    (torch.bfloat16, 64, 128, None), (torch.float32, 128, None, 32),
    (torch.float32, 128, 32, 32), (torch.float32, 128, 64, None)])
def test_decode_tile_without_instance_raises(dtype, d, block_k, ok):
    """A key tile the kernel has no instance for raises ``ValueError``
    naming the tiles it has; ``None`` is the default (bf16 64, the float32
    SIMT template's 32)."""
    q = torch.zeros(1, 8, 1, d, dtype=dtype)
    if ok is not None:
        assert pa.decode_tile("k", q, block_k) == ok
    else:
        with pytest.raises(ValueError, match=r"has block_k in \("):
            pa.decode_tile("k", q, block_k)

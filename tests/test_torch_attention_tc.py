"""The error budget and partition of the tensor-core kernels, on the CPU:
K1 with a bf16 query (``flash_attention_tc_kernel``,
``csrc/flash_attention.cu``) and K5b and K6d, the split partials mode of
the paged prefill kernel over bf16 and int8 pools
(``paged_prefill_tc_kernel<bf16 | int8, partials>``,
``csrc/paged_prefill.cu``).

The kernels cannot run here, so plain-torch emulations of their
arithmetic stand in for them: Q.K^T as bf16 products summed in fp32, the
online softmax in fp32 on exp2 of scores scaled by ``scale * log2 e``
over the kernels' key tiles, a row that has seen no key yet subtracting
0 (so masked keys weigh 0), and P rounded to bf16 before P.V with the
row sums taken from the fp32 P.  Only the order of the fp32 sums inside
one mma differs from the card.

* K1: at each tile (``block_q`` query rows, one 16-row slab a warp, by
  ``block_k`` keys a copied K/V tile) the keys are walked in order in
  64-key softmax steps by each slab (a step a slab does not see is
  skipped, which adds exactly nothing, so the emulation walks every
  step); every tile thus takes the same steps and gives the same bits.
* K5b: a query tile of 32 // G chunk rows (the G heads of a kv head
  folded in; G 3's 48-row tile holds 16), whose live 128-key tiles are
  cut into ``ns`` splits of ``ceil(live / ns)`` tiles; each tile is split
  among 4 key groups of 32 keys (2 from 48 rows) whose states merge at
  the end; the split writes its unnormalised
  (m, l, acc), m in natural-log units, and a row that saw no key of the
  split writes exactly (-1e30, 0, 0).
* K6d: K5b over int8 codes (exact in bf16): the key scale multiplies S's
  column after the code product, the value scale folds into P before P's
  rounding, and l is taken from the fp32 P, as ``tc_emulate`` of
  ``test_torch_prefill_tc.py`` does for K6c.

They are held to

* the plain versions (``ref.attention_ref``; ``ref.paged_prefill_split_ref``
  cut at the kernel's own tiles, ``block_q = 32 // G``, ``block_k = 128``)
  at yi-6b widths (H 32, Hkv 4, D 128) and at G = 1, 3 and 8: outputs
  within the card's bf16 tolerance 2e-2 (rtol = atol) and, before the
  output's own bf16 rounding, within 2^-9 max |v|, the budget
  ``test_torch_prefill_tc.py`` holds K4 to; unnormalised partials acc
  within the worst case of P's rounding, 2^-8 sum_j p_j |v_j| (|v|
  dequantized for int8 pools; 2^-8 is bf16's unit roundoff: rounding p_j
  moves it by at most 2^-8 p_j, and by at most 2^-9 absolute since
  p_j <= 1; over many keys the roundings
  cancel, which is why outputs keep within the tighter budget); m and l,
  which P's rounding does not touch, within 1e-5;
* the JAX package's Pallas kernels in interpret mode at reduced float32
  shapes (K1 also at its cases' widths and every tile), with q, k and v
  rounded to bf16 first so that the only difference is P's rounding: the
  2^-9 max |v| bound, plus 1e-5 for fp32 sums taken in another order.

Inputs come from numpy with a seed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_attention
from repro.kernels.flash_attention import flash_paged_prefill as jax_paged_prefill
from repro.kernels.flash_attention import \
    flash_paged_prefill_quant as jax_paged_prefill_quant
from repro_torch.distributed.compression import quantize_int8_rows
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from test_torch_prefill_tc import kstep_scores, pad_cols

torch.set_num_threads(1)

BF16_TOL = dict(rtol=2e-2, atol=2e-2)      # chip_smoke.py's TOL[bf16]
FP32_SUMS = 1e-5                           # fp32 sums in another order
P_ROUNDING = 2.0 ** -9                     # the outputs' budget
BF16_ROUNDOFF = 2.0 ** -8                  # unit roundoff of bf16
LOG2E = math.log2(math.e)
K1_STEP_KEYS = 64                          # flash_attention.cu's k1tc::STEP
SPLIT_KEY_GROUPS = 4                       # paged_prefill.cu's tc::KGROUPS


def rand(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32))


def online_softmax(s, v, key_tiles, v_scale=None):
    """The kernels' fp32 online softmax over log2-domain scores ``s``
    (..., rows, keys) with -1e30 at masked keys, walking ``key_tiles``
    (slices of the key axis) in order; P (times ``v_scale`` (..., 1,
    keys), the value scales of int8 codes ``v``, if given) rounded to
    bf16 for P.V.  Returns the unnormalised (m, l, acc), m in the log2
    domain."""
    m = torch.full(s.shape[:-1], ref.NEG_INF)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(*s.shape[:-1], v.shape[-1])
    for keys in key_tiles:
        st = s[..., keys]
        mx = torch.maximum(m, st.amax(-1))
        # a row that has seen no key yet subtracts 0, so its masked keys
        # weigh exp2(-1e30) = 0
        m_use = torch.where(mx == ref.NEG_INF, 0.0, mx)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(st - m_use[..., None])
        l = l * alpha + p.sum(-1)
        if v_scale is not None:
            p = p * v_scale[..., keys]
        acc = (acc * alpha[..., None]
               + p.to(torch.bfloat16).float() @ v[..., keys, :])
        m = mx
    return m, l, acc


def merge_groups(states):
    """The key groups' (m, l, acc) merged by a max-shift, log2 domain."""
    m_star = torch.stack([m for m, _, _ in states]).amax(0)
    l = sum(l * torch.exp2(m - m_star) for m, l, _ in states)
    acc = sum(acc * torch.exp2(m - m_star)[..., None]
              for m, _, acc in states)
    return m_star, l, acc


def normalise(l, acc):
    return acc / torch.where(l == 0, 1.0, l)[..., None]


# --------------------------------------------------------------------------
# K1: dense self-attention, and cross attention with a key length of its
# own
# --------------------------------------------------------------------------


def k1_emulate(q, k, v, causal=True, window=None, block_q=64, block_k=64,
               width=None, step=K1_STEP_KEYS):
    """The bf16 K1's arithmetic and tiling in plain torch at the tile
    ``block_q`` x ``block_k``; output like q.  A block's query rows only
    choose which steps are skipped (nothing), and a ``block_k``-key copy
    is walked in ``step``-key steps, up to the keys' own length
    (which differs from the rows' in cross attention).  ``width`` runs it
    as the padded instance of that width does (test_torch_prefill_tc's
    ``tc_emulate``; a wide one's steps are 32 keys)."""
    b, h, s_len, d = q.shape
    sk = k.shape[2]
    g = h // k.shape[1]
    kk = torch.repeat_interleave(k.float(), g, dim=1)
    vv = torch.repeat_interleave(v.float(), g, dim=1)
    if width is None:
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk)
    else:
        q, kk, vv = (pad_cols(x, width) for x in (q, kk, vv))
        s = kstep_scores("bhqd,bhkd->bhqk", q.float(), kk)
    s = s * np.float32(d ** -0.5 * LOG2E)
    qi = torch.arange(s_len)[:, None]
    kj = torch.arange(sk)[None, :]
    mask = torch.ones(s_len, sk, dtype=torch.bool)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    s = torch.where(mask, s, ref.NEG_INF)
    assert block_q % 16 == 0 and block_k % step == 0
    steps = [slice(t0 + j, t0 + j + step)
             for t0 in range(0, sk, block_k)
             for j in range(0, block_k, step)
             if t0 + j < sk]     # a step past Sk is skipped
    _, l, acc = online_softmax(s, vv, steps)
    return normalise(l, acc)[..., :d].to(q.dtype)


# (label, H, Hkv, D, S, causal, window): yi-6b's prefill and phase 3's
# edge cases of chip_smoke.py, deepseek-7b's G = 1 and phi4-mini's G = 3
K1_CASES = [
    ("yi-6b S=512", 32, 4, 128, 512, True, None),
    ("yi-6b S=300", 32, 4, 128, 300, True, None),
    ("yi-6b window 64", 32, 4, 128, 512, True, 64),
    ("yi-6b non-causal", 32, 4, 128, 512, False, None),
    ("G=1", 32, 32, 128, 512, True, None),
    ("G=3", 24, 8, 128, 300, True, None),
    ("G=8 D=64 non-causal window 32", 32, 4, 64, 200, False, 32),
    ("h2o-danube D=80 S=300 window 128", 32, 8, 80, 300, True, 128),
    ("zamba2 D=112 S=300 window 128", 32, 32, 112, 300, True, 128),
]


@pytest.mark.parametrize("case", K1_CASES, ids=[c[0] for c in K1_CASES])
def test_k1_emulation_within_bf16_tolerance_of_plain(case):
    _, h, hkv, d, s_len, causal, window = case
    q = rand((1, h, s_len, d), 31).to(torch.bfloat16)
    k = rand((1, hkv, s_len, d), 32).to(torch.bfloat16)
    v = rand((1, hkv, s_len, d), 33).to(torch.bfloat16)
    kw = dict(causal=causal, window=window)
    got = k1_emulate(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **BF16_TOL)
    # before the output's bf16 rounding: the derived bound of P's rounding
    got32 = k1_emulate(q.float(), k, v, **kw)
    want32 = ref.attention_ref(q.float(), k.float(), v.float(), **kw)
    v_max = float(v.float().abs().max())
    np.testing.assert_allclose(got32.numpy(), want32.numpy(), rtol=0,
                               atol=P_ROUNDING * v_max + FP32_SUMS)


@pytest.mark.parametrize("h,hkv", [(8, 8), (6, 2), (8, 1)])
@pytest.mark.parametrize("s_len,causal,window", [
    (128, True, None), (100, True, None), (192, True, 16), (100, False, None),
    (77, False, 24)])
def test_k1_emulation_against_jax_kernel_in_interpret_mode(h, hkv, s_len,
                                                          causal, window):
    """G 1, 3 and 8 in float32 with bf16-valued q, k, v: causal, a ragged
    S that no tile divides, a window with and without the causal mask."""
    q = rand((2, h, s_len, 32), 34).to(torch.bfloat16).float()
    k = rand((2, hkv, s_len, 32), 35).to(torch.bfloat16).float()
    v = rand((2, hkv, s_len, 32), 36).to(torch.bfloat16).float()
    got = k1_emulate(q, k, v, causal=causal, window=window).numpy()
    want = np.asarray(jax_attention(q.numpy(), k.numpy(), v.numpy(),
                                    causal=causal, window=window,
                                    block_q=64, block_k=64, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=P_ROUNDING
                               * float(v.abs().max()) + FP32_SUMS)


@pytest.mark.parametrize("sq,sk,hkv,d", [(1, 300, 6, 64), (4, 300, 6, 64),
                                         (224, 300, 6, 64), (9, 70, 2, 16)])
def test_k1_emulation_cross_length_within_bf16_of_plain(sq, sk, hkv, d):
    """Cross attention (whisper's decoder rows over its encoder's keys, not
    causal): the kernel's arithmetic over Sk keys in its 64-key steps, the
    last one ragged, within the bf16 tolerance of ``ref.attention_ref``
    and within P's rounding bound before the output's rounding."""
    q = rand((2, 6, sq, d), 37).to(torch.bfloat16)
    k = rand((2, hkv, sk, d), 38).to(torch.bfloat16)
    v = rand((2, hkv, sk, d), 39).to(torch.bfloat16)
    got = k1_emulate(q, k, v, causal=False)
    want = ref.attention_ref(q, k, v, causal=False)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **BF16_TOL)
    got32 = k1_emulate(q.float(), k, v, causal=False)
    want32 = ref.attention_ref(q.float(), k.float(), v.float(), causal=False)
    np.testing.assert_allclose(got32.numpy(), want32.numpy(), rtol=0,
                               atol=P_ROUNDING * float(v.float().abs().max())
                               + FP32_SUMS)


K1_TILES = [(bq, bk) for bq in (64, 128) for bk in (64, 128)]


@pytest.mark.parametrize("tile", K1_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", [c for c in K1_CASES
                                  if c[3] in (80, 112, 128)],
                         ids=lambda c: c[0])
def test_k1_every_tile_against_plain_and_jax_kernel(case, tile):
    """Each D = 128, 80 and 112 instance (block_q 64 or 128 by block_k 64
    or 128): the
    emulation within the bf16 tolerance of ``ref.attention_ref``, equal
    bit for bit to the default tile's, and within 2^-9 max |v| + 1e-5 of
    the JAX ``flash_attention`` in interpret mode at the same block_q and
    block_k (float32 holding bf16 values; the JAX kernel pads S to the
    tile, the card's masks it)."""
    _, h, hkv, d, s_len, causal, window = case
    block_q, block_k = tile
    q = rand((1, h, s_len, d), 51).to(torch.bfloat16)
    k = rand((1, hkv, s_len, d), 52).to(torch.bfloat16)
    v = rand((1, hkv, s_len, d), 53).to(torch.bfloat16)
    kw = dict(causal=causal, window=window)
    got = k1_emulate(q, k, v, **kw, block_q=block_q, block_k=block_k)
    np.testing.assert_allclose(
        got.float().numpy(), ref.attention_ref(q, k, v, **kw).float().numpy(),
        **BF16_TOL)
    assert torch.equal(got, k1_emulate(q, k, v, **kw))
    got32 = k1_emulate(q.float(), k, v, **kw, block_q=block_q,
                       block_k=block_k)
    want = np.asarray(jax_attention(q.float().numpy(), k.float().numpy(),
                                    v.float().numpy(), **kw, block_q=block_q,
                                    block_k=block_k, interpret=True))
    np.testing.assert_allclose(got32.numpy(), want, rtol=0,
                               atol=P_ROUNDING * float(v.float().abs().max())
                               + FP32_SUMS)


@pytest.mark.parametrize("dtype,d,tile,ok", [
    (torch.bfloat16, 128, (None, None), (64, 64)),
    (torch.bfloat16, 128, (128, 128), (128, 128)),
    (torch.bfloat16, 128, (64, 128), (64, 128)),
    (torch.bfloat16, 128, (32, 64), None),
    (torch.bfloat16, 128, (64, 256), None),
    (torch.bfloat16, 64, (None, None), (64, 64)),
    (torch.bfloat16, 64, (128, 64), None),
    (torch.float32, 128, (None, None), (64, 32)),
    (torch.float32, 128, (64, 64), None)])
def test_k1_tile_without_an_instance_raises_before_the_launch(dtype, d, tile,
                                                             ok):
    """``attention_tile``: the default tile for ``None`` (bf16 64 x 64, the
    float32 SIMT template's 64 x 32), the instances at D 128, and
    ``ValueError`` naming them otherwise.  ``flash_attention`` checks the
    tile first, so CPU tensors raise the same error before anything else;
    with an instance they raise for the device."""
    q = torch.zeros(1, 8, 16, d, dtype=dtype)
    k = torch.zeros(1, 2, 16, d, dtype=dtype)
    bq, bk = tile
    if ok is None:
        with pytest.raises(ValueError, match="no instance.*has"):
            fa.attention_tile("k", q, bq, bk)
        with pytest.raises(ValueError, match="no instance"):
            fa.flash_attention(q, k, k, block_q=bq, block_k=bk)
    else:
        assert fa.attention_tile("k", q, bq, bk) == ok
        with pytest.raises(ValueError, match="CUDA tensors"):
            fa.flash_attention(q, k, k, block_q=bq, block_k=bk)
    assert fa.flash_attention.by_tile.get(ok, 0) == 0


# --------------------------------------------------------------------------
# K5b: the split partials mode of the paged prefill kernel
# --------------------------------------------------------------------------


def gathered_scales(scale, table, g):
    """Per-row scales (P, Hkv, psz) of int8 pools gathered through the
    table and repeated for the G query heads: (B, H, 1, keys)."""
    rows = ref.gather_pages(scale[..., None], table)[..., 0]
    return torch.repeat_interleave(rows, g, 1)[:, :, None, :]


def split_emulate(q, k_pool, v_pool, table, start, kv_len, ns, k_scale=None,
                  v_scale=None, tile_rows=pa.TC_TILE_ROWS,
                  keys=pa.TC_TILE_KEYS):
    """The partials mode's partition, arithmetic and tiling in plain
    torch at a tile of ``tile_rows`` query rows (block_q x G) and ``keys``
    keys, each key tile split among ``SPLIT_KEY_GROUPS`` key groups (2 from
    48 rows, paged_prefill.cu's ``Tile``): fp32 (m, l, acc) of every
    split, (B, H, ns, C) and (.., D), m in natural-log units, exactly
    (-1e30, 0, 0) where a row saw no key.  With ``k_scale`` and
    ``v_scale`` the pools hold int8 codes (K6d)."""
    b, h, c, d = q.shape
    g = h // k_pool.shape[1]
    rows = tile_rows // g
    n_groups = 2 if tile_rows >= 48 else SPLIT_KEY_GROUPS
    k = torch.repeat_interleave(ref.gather_pages(k_pool, table).float(), g, 1)
    v = torch.repeat_interleave(ref.gather_pages(v_pool, table).float(), g, 1)
    sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k)
    if k_scale is not None:     # the key scale on S's column, in fp32
        s = s * gathered_scales(k_scale, table, g)
    vs = None if v_scale is None else gathered_scales(v_scale, table, g)
    s = s * np.float32(d ** -0.5 * LOG2E)
    start, kv_len = start.long(), kv_len.long()
    i = torch.arange(c)
    qi = start[:, None] + i                                       # (B, C)
    kj = torch.arange(sk)
    visible = (kj <= qi[..., None]) & (kj < kv_len[:, None, None])
    # the query tile's live key tiles, from its last row's position
    last = start[:, None] + (i // rows + 1) * rows - 1
    t_live = torch.minimum(-(-kv_len.clamp(0, sk) // keys)[:, None],
                           last // keys + 1)
    t_live = torch.where(last < 0, 0, t_live)
    per = -(-t_live // ns)
    kn = keys // n_groups
    parts = []
    for split in range(ns):
        lo = torch.minimum(split * per, t_live) * keys
        hi = torch.minimum(t_live, split * per + per) * keys
        mask = visible & (kj >= lo[..., None]) & (kj < hi[..., None])
        ss = torch.where(mask[:, None], s, ref.NEG_INF)
        groups = [online_softmax(ss, v, [slice(t0, t0 + kn) for t0 in
                                         range(group * kn, sk, keys)], vs)
                  for group in range(n_groups)]
        m, l, acc = merge_groups(groups)
        parts.append((torch.where(m == ref.NEG_INF, ref.NEG_INF, m / LOG2E),
                      l, acc))
    return tuple(torch.stack(p, dim=2) for p in zip(*parts))


def shuffled_table(b, nblk, kv_len, psz, seed):
    """Distinct shuffled pages per lane (page 0 is the null page), entries
    past ceil(kv_len / psz) on page 0."""
    pages = np.random.default_rng(seed).permutation(
        np.arange(1, b * nblk + 1)).reshape(b, nblk).astype(np.int32)
    for i, n in enumerate(kv_len):
        pages[i, -(-int(n) // psz):] = 0
    return torch.from_numpy(pages)


def chunk_case(h, hkv, d, psz, nblk, starts, valid, c, seed):
    """q and bf16 pools, the table, start and kv_len of chunks of c rows
    at ``starts`` with ``valid`` rows committed (0 and 0: an idle lane)."""
    b = len(starts)
    kv_len = [s + n for s, n in zip(starts, valid)]
    q = rand((b, h, c, d), seed).to(torch.bfloat16)
    kp = rand((b * nblk + 1, hkv, psz, d), seed + 1).to(torch.bfloat16)
    vp = rand((b * nblk + 1, hkv, psz, d), seed + 2).to(torch.bfloat16)
    table = shuffled_table(b, nblk, kv_len, psz, seed + 3)
    return (q, kp, vp, table, torch.tensor(starts, dtype=torch.int32),
            torch.tensor(kv_len, dtype=torch.int32))


# chip_smoke.py's SPLIT_CASES: the verify shapes of yi-6b (G = 8) and
# deepseek-7b (G = 1), four lanes with chunks of 5 and an idle lane, and
# the phase-8 chunk of 128 at 384
SPLIT_CASES = {
    "yi-6b verify": (32, 4, 128, 16, 64, [839, 720, 190, 544, 0],
                     [5, 5, 5, 5, 0], 5),
    "deepseek-7b verify": (32, 32, 128, 16, 64, [839, 720, 190, 544, 0],
                           [5, 5, 5, 5, 0], 5),
    "yi-6b chunk at 384": (32, 4, 128, 16, 32, [384], [128], 128),
}


@pytest.mark.parametrize("ns", [2, 3, 8])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_emulation_partials_match_plain_at_the_kernel_tiles(case, ns):
    """Partials against ``paged_prefill_split_ref`` cut at the kernel's
    tiles: the same empty splits, exactly (-1e30, 0, 0); m and l within
    1e-5; acc within 2^-8 sum_j p_j |v_j|, and acc / l within the bf16
    tolerance; merged by K5c's rule, the output within 2e-2 of the
    one-pass plain version and the idle lane exactly 0."""
    h, hkv, d, psz, nblk, starts, valid, c = SPLIT_CASES[case]
    q, kp, vp, table, start, kv_len = chunk_case(h, hkv, d, psz, nblk,
                                                 starts, valid, c, 41)
    tiles = dict(block_q=pa.TC_TILE_ROWS // (h // hkv),
                 block_k=pa.TC_TILE_KEYS)
    gm, gl, gacc = split_emulate(q, kp, vp, table, start, kv_len, ns)
    _, (m, l, acc) = ref.paged_prefill_split_ref(
        q, kp, vp, table, start, kv_len, ns, **tiles)
    # sum_j p_j |v_j| of every split: the plain version over |v|
    _, (_, _, acc_abs) = ref.paged_prefill_split_ref(
        q, kp, vp.float().abs(), table, start, kv_len, ns, **tiles)
    empty = m == ref.NEG_INF
    assert torch.equal(gm == ref.NEG_INF, empty)
    assert torch.all(gl[empty] == 0) and torch.all(gacc[empty] == 0)
    np.testing.assert_allclose(gm.numpy(), m.numpy(), rtol=1e-5,
                               atol=FP32_SUMS)
    np.testing.assert_allclose(gl.numpy(), l.numpy(), rtol=1e-5,
                               atol=FP32_SUMS)
    bound = BF16_ROUNDOFF * acc_abs + FP32_SUMS * (1 + acc.abs())
    assert bool(((gacc - acc).abs() <= bound).all())
    seen = torch.where(l == 0, 1.0, l)[..., None]
    np.testing.assert_allclose((gacc / seen).numpy(), (acc / seen).numpy(),
                               **BF16_TOL)
    _, l_star, acc_star = ref.combine_split_states(gm, gl, gacc)
    out = ref.finalize_split_states(l_star, acc_star).to(q.dtype)
    want = ref.paged_prefill_ref(q, kp, vp, table, start, kv_len)
    for lane, n in enumerate(valid):
        if n == 0:
            assert torch.all(out[lane] == 0)
            continue
        np.testing.assert_allclose(out[lane, :, :n].float().numpy(),
                                   want[lane, :, :n].float().numpy(),
                                   **BF16_TOL)


@pytest.mark.parametrize("ns", [2, 3])
@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 1), (8, 8)])
def test_split_emulation_against_jax_kernel_in_interpret_mode(h, hkv, ns):
    """Merged partials against the JAX split kernel's output in float32
    with bf16-valued q and pools: three lanes, chunks of 8 at a mid-page
    start, at 0, and a ragged chunk; pages of 8, so the kernel's 128-key
    tile spans the table while the JAX kernel walks 8-key page tiles."""
    c, d, psz, nblk = 8, 16, 8, 20
    starts, valid = [70, 0, 140], [8, 8, 5]
    q, kp, vp, table, start, kv_len = chunk_case(h, hkv, d, psz, nblk,
                                                 starts, valid, c, 43)
    q, kp, vp = q.float(), kp.float(), vp.float()
    gm, gl, gacc = split_emulate(q, kp, vp, table, start, kv_len, ns)
    _, l_star, acc_star = ref.combine_split_states(gm, gl, gacc)
    got = ref.finalize_split_states(l_star, acc_star).numpy()
    want = np.asarray(jax_paged_prefill(
        q.numpy(), kp.numpy(), vp.numpy(), jnp.asarray(table.numpy()),
        jnp.asarray(start.numpy()), jnp.asarray(kv_len.numpy()),
        num_splits=ns, interpret=True))
    atol = P_ROUNDING * float(vp.abs().max()) + FP32_SUMS
    for lane, n in enumerate(valid):       # rows past kv_len are padding
        np.testing.assert_allclose(got[lane, :, :n], want[lane, :, :n],
                                   rtol=0, atol=atol)


# --------------------------------------------------------------------------
# K6d: the same partials mode over int8 pools
# --------------------------------------------------------------------------


def quantized(kp, vp):
    """Per-row int8 codes and fp32 scales of bf16 pools, as the serve's
    write path quantizes them."""
    (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
    return k8, v8, ks, vs


@pytest.mark.parametrize("ns", [2, 3, 8])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_int8_split_emulation_partials_match_plain_at_the_kernel_tiles(case,
                                                                       ns):
    """K6d's partials against ``paged_prefill_split_ref`` over the same
    int8 pools, cut at the kernel's tiles: the same empty splits, exactly
    (-1e30, 0, 0); m and l within 1e-5; acc within 2^-8 sum_j p_j |v_j|
    with |v| dequantized; merged by K5c's rule, the output within 2e-2 of
    the one-pass plain version and the idle lane exactly 0."""
    h, hkv, d, psz, nblk, starts, valid, c = SPLIT_CASES[case]
    q, kp, vp, table, start, kv_len = chunk_case(h, hkv, d, psz, nblk,
                                                 starts, valid, c, 45)
    k8, v8, ks, vs = quantized(kp, vp)
    scales = dict(k_scale=ks, v_scale=vs)
    tiles = dict(block_q=pa.TC_TILE_ROWS // (h // hkv),
                 block_k=pa.TC_TILE_KEYS)
    gm, gl, gacc = split_emulate(q, k8, v8, table, start, kv_len, ns, **scales)
    _, (m, l, acc) = ref.paged_prefill_split_ref(
        q, k8, v8, table, start, kv_len, ns, **scales, **tiles)
    # sum_j p_j |v_j|: the plain version over |codes| times their scales
    _, (_, _, acc_abs) = ref.paged_prefill_split_ref(
        q, k8, v8.float().abs(), table, start, kv_len, ns, **scales, **tiles)
    empty = m == ref.NEG_INF
    assert torch.equal(gm == ref.NEG_INF, empty)
    assert torch.all(gl[empty] == 0) and torch.all(gacc[empty] == 0)
    np.testing.assert_allclose(gm.numpy(), m.numpy(), rtol=1e-5,
                               atol=FP32_SUMS)
    np.testing.assert_allclose(gl.numpy(), l.numpy(), rtol=1e-5,
                               atol=FP32_SUMS)
    bound = BF16_ROUNDOFF * acc_abs + FP32_SUMS * (1 + acc.abs())
    assert bool(((gacc - acc).abs() <= bound).all())
    _, l_star, acc_star = ref.combine_split_states(gm, gl, gacc)
    out = ref.finalize_split_states(l_star, acc_star).to(q.dtype)
    want = ref.paged_prefill_ref(q, k8, v8, table, start, kv_len, **scales)
    for lane, n in enumerate(valid):
        if n == 0:
            assert torch.all(out[lane] == 0)
            continue
        np.testing.assert_allclose(out[lane, :, :n].float().numpy(),
                                   want[lane, :, :n].float().numpy(),
                                   **BF16_TOL)


@pytest.mark.parametrize("ns", [2, 3])
@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 1), (8, 8)])
def test_int8_split_emulation_against_jax_kernel_in_interpret_mode(h, hkv,
                                                                   ns):
    """Merged K6d partials against the JAX int8 split kernel's output,
    ``flash_paged_prefill_quant(..., num_splits=ns, interpret=True)``, in
    float32 over the same codes and scales: three lanes, chunks of 8 at a
    mid-page start, at 0, and a ragged chunk, pages of 8.  The only
    difference is P's rounding: 2^-9 of the largest dequantized |v|, plus
    1e-5 for fp32 sums taken in another order."""
    c, d, psz, nblk = 8, 16, 8, 20
    starts, valid = [70, 0, 140], [8, 8, 5]
    q, kp, vp, table, start, kv_len = chunk_case(h, hkv, d, psz, nblk,
                                                 starts, valid, c, 47)
    k8, v8, ks, vs = quantized(kp, vp)
    q = q.float()
    gm, gl, gacc = split_emulate(q, k8, v8, table, start, kv_len, ns,
                                 k_scale=ks, v_scale=vs)
    _, l_star, acc_star = ref.combine_split_states(gm, gl, gacc)
    got = ref.finalize_split_states(l_star, acc_star).numpy()
    want = np.asarray(jax_paged_prefill_quant(
        q.numpy(), k8.numpy(), v8.numpy(), ks.numpy(), vs.numpy(),
        jnp.asarray(table.numpy()), jnp.asarray(start.numpy()),
        jnp.asarray(kv_len.numpy()), num_splits=ns, interpret=True))
    v_max = float((v8.float() * vs[..., None]).abs().max())
    atol = P_ROUNDING * v_max + FP32_SUMS
    for lane, n in enumerate(valid):       # rows past kv_len are padding
        np.testing.assert_allclose(got[lane, :, :n], want[lane, :, :n],
                                   rtol=0, atol=atol)


# --------------------------------------------------------------------------
# the tiles (the run-time AT's block_q x block_k): every D = 128 instance
# --------------------------------------------------------------------------


def tiles_at(g: int) -> list[tuple[int, int]]:
    """(query rows, keys) of the D = 128 instances that G ``g`` takes."""
    return [(g * bq, keys)
            for bq in pa.prefill_tiles(torch.bfloat16, 128, g)[0]
            for keys in pa.TC_BLOCK_KS]


@pytest.mark.parametrize("quant", [False, True], ids=["K5b", "K6d"])
@pytest.mark.parametrize("tile_rows,keys", tiles_at(8))
def test_every_split_tile_partials_match_plain_at_that_tile(tile_rows, keys,
                                                             quant):
    """The partials mode at each tile of the D = 128 instances, 3 splits,
    on the yi-6b verify shape (G 8: block_q = rows // 8): its partials
    against ``paged_prefill_split_ref`` cut at ``block_q`` and
    ``block_k``, the same empty splits exactly (-1e30, 0, 0), m and l
    within 1e-5, acc within 2^-8 sum_j p_j |v_j|; merged, within the bf16
    tolerance of the one-pass plain version, the idle lane exactly 0."""
    check_split_tile(SPLIT_CASES["yi-6b verify"], tile_rows, keys, quant, 49)


@pytest.mark.parametrize("quant", [False, True], ids=["K5b", "K6d"])
@pytest.mark.parametrize("tile_rows,keys", tiles_at(3))
def test_g3_split_tile_partials_match_plain_at_that_tile(tile_rows, keys,
                                                         quant):
    """The same at phi4-mini's heads (24 q / 8 kv, G 3) on its verify
    shape, at the 48-row tile (block_q 16, 3 slabs, 2 key groups)."""
    check_split_tile((24, 8, 128, 16, 64, [839, 720, 190, 544, 0],
                      [5, 5, 5, 5, 0], 5), tile_rows, keys, quant, 53)


def check_split_tile(shape, tile_rows, keys, quant, seed):
    h, hkv, d, psz, nblk, starts, valid, c = shape
    q, kp, vp, table, start, kv_len = chunk_case(h, hkv, d, psz, nblk,
                                                 starts, valid, c, seed)
    scales = {}
    if quant:
        kp, vp, ks, vs = quantized(kp, vp)
        scales = dict(k_scale=ks, v_scale=vs)
    tiles = dict(block_q=tile_rows // (h // hkv), block_k=keys)
    gm, gl, gacc = split_emulate(q, kp, vp, table, start, kv_len, 3,
                                 tile_rows=tile_rows, keys=keys, **scales)
    _, (m, l, acc) = ref.paged_prefill_split_ref(
        q, kp, vp, table, start, kv_len, 3, **scales, **tiles)
    _, (_, _, acc_abs) = ref.paged_prefill_split_ref(
        q, kp, vp.float().abs(), table, start, kv_len, 3, **scales, **tiles)
    empty = m == ref.NEG_INF
    assert torch.equal(gm == ref.NEG_INF, empty)
    assert torch.all(gl[empty] == 0) and torch.all(gacc[empty] == 0)
    np.testing.assert_allclose(gm.numpy(), m.numpy(), rtol=1e-5,
                               atol=FP32_SUMS)
    np.testing.assert_allclose(gl.numpy(), l.numpy(), rtol=1e-5,
                               atol=FP32_SUMS)
    bound = BF16_ROUNDOFF * acc_abs + FP32_SUMS * (1 + acc.abs())
    assert bool(((gacc - acc).abs() <= bound).all())
    _, l_star, acc_star = ref.combine_split_states(gm, gl, gacc)
    out = ref.finalize_split_states(l_star, acc_star).to(q.dtype)
    want = ref.paged_prefill_ref(q, kp, vp, table, start, kv_len, **scales)
    for lane, n in enumerate(valid):
        if n == 0:
            assert torch.all(out[lane] == 0)
            continue
        np.testing.assert_allclose(out[lane, :, :n].float().numpy(),
                                   want[lane, :, :n].float().numpy(),
                                   **BF16_TOL)

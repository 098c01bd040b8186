"""The error budget of the tensor-core paged prefill kernel (K4 and K6c
with a bf16 query, ``csrc/paged_prefill.cu``), on the CPU.

The kernel cannot run here, so a plain-torch emulation of its arithmetic
stands in for it: Q.K^T as bf16 products summed in fp32, the key scale of
an int8 pool applied to the column of S after the code product, and the
kernel's tiling of the online softmax in fp32 (exp2 of log2-scaled
scores): 128-key tiles, each split among 4 key groups of 32 keys (the
warps of a block), a running max and sum per group, the groups' states
merged at the end by a max-shift.  P (for int8 pools P times the value
scale) is rounded to bf16 before P.V, with the row sums taken from the
fp32 P.  Only the order of the fp32 sums inside one mma differs from the
card.  The emulation is held to

* the plain version ``ref.paged_prefill_ref`` at the phase-8 widths of
  ``chip_smoke.py`` (yi-6b: H 32, Hkv 4, D 128, a chunk of 128 at 384 in
  pages of 16) and at its verify shape (chunks of 5 over four lanes and an
  idle lane), over bf16 and int8 pools, within the card's bf16 tolerance
  2e-2 (rtol = atol); and, before the output's own bf16 rounding, within
  the bound the design derives: rounding p_j to bf16 moves it by at most
  2^-9 p_j, so an output, a convex combination of values, moves by at most
  2^-9 max |v|;
* the JAX package's Pallas kernels in interpret mode at a reduced shape in
  float32, with q and the bf16 pools rounded to bf16 first so that the
  only difference is P's rounding: the same 2^-9 max |v| bound, plus 1e-5
  for fp32 sums taken in another order.

Inputs come from numpy with a seed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_paged_prefill as jax_paged_prefill
from repro.kernels.flash_attention import \
    flash_paged_prefill_quant as jax_paged_prefill_quant
from repro_torch.distributed.compression import quantize_int8_rows
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

torch.set_num_threads(1)

BF16_TOL = dict(rtol=2e-2, atol=2e-2)      # chip_smoke.py's TOL[bf16]
P_ROUNDING = 2.0 ** -9                     # unit roundoff of bf16
LOG2E = math.log2(math.e)
BLOCK_N = 128                              # keys per K/V tile
KEY_GROUPS = 4                             # key groups per tile


def key_groups(rows: int) -> int:
    """The key groups of a tile of ``rows`` query rows, paged_prefill.cu's
    ``Tile``: 4 up to 32 rows, 2 from 48 (6 and 8 warps a block)."""
    return 2 if rows >= 48 else 4


def pad_cols(x, width):
    """x with zero columns appended up to ``width`` (a padded instance's
    shared-memory rows)."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def kstep_scores(eq, q, k):
    """Q.K^T as the mma's 16-deep steps over the head dim, summed in
    order in fp32: a step of zero columns (a padded instance's) adds
    exactly nothing.  A width above 256 is a wide instance's: each
    128-column slice's steps summed in order, then the slices' partial
    sums in slice order (``mma.cuh``'s ``sum_slices``)."""
    if q.shape[-1] > 256:
        return sum(kstep_scores(eq, q[..., i:i + 128], k[..., i:i + 128])
                   for i in range(0, q.shape[-1], 128))
    return sum(torch.einsum(eq, q[..., i:i + 16], k[..., i:i + 16])
               for i in range(0, q.shape[-1], 16))


def tc_emulate(q, k_pool, v_pool, table, start, kv_len, k_scale=None,
               v_scale=None, block_k=BLOCK_N, groups=KEY_GROUPS,
               width=None):
    """The tensor-core kernel's arithmetic and tiling in plain torch, at
    ``block_k`` keys a tile split among ``groups`` key groups; output like
    q (the one-pass kernel's query tile changes nothing else: a key tile
    a row does not see adds exactly nothing).  ``width`` runs it as the
    instance of that width does: q, K and V zero-padded to it, Q.K^T in
    16-deep steps (:func:`kstep_scores`), the columns past d dropped."""
    b, h, c, d = q.shape
    hkv = k_pool.shape[1]
    g = h // hkv
    k = ref.gather_pages(k_pool, table).float()     # bf16 values or codes
    v = ref.gather_pages(v_pool, table).float()
    if width is not None:
        q, k, v = pad_cols(q, width), pad_cols(k, width), pad_cols(v, width)
    sk = k.shape[2]
    ones = torch.ones(b, hkv, sk)
    ks = ones if k_scale is None else ref.gather_pages(
        k_scale[..., None], table)[..., 0]
    vs = ones if v_scale is None else ref.gather_pages(
        v_scale[..., None], table)[..., 0]
    kk = torch.repeat_interleave(k, g, dim=1)
    vv = torch.repeat_interleave(v, g, dim=1)
    ks = torch.repeat_interleave(ks, g, dim=1)[:, :, None, :]
    vs = torch.repeat_interleave(vs, g, dim=1)[:, :, None, :]
    if width is None:
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk)
    else:
        s = kstep_scores("bhqd,bhkd->bhqk", q.float(), kk)
    s = s * ks * np.float32(d ** -0.5 * LOG2E)
    qi = start[:, None] + torch.arange(c)
    kj = torch.arange(sk)
    mask = (kj <= qi[..., None]) & (kj < kv_len[:, None, None])
    s = torch.where(mask[:, None], s, ref.NEG_INF)
    kn = block_k // groups
    states = []
    for group in range(groups):         # keys group * kn .. + kn - 1 of a tile
        m = torch.full((b, h, c), ref.NEG_INF)
        l = torch.zeros(b, h, c)
        acc = torch.zeros(b, h, c, q.shape[-1])
        for t0 in range(group * kn, sk, block_k):
            st = s[..., t0:t0 + kn]
            mx = torch.maximum(m, st.amax(-1))
            # a row that has seen no key yet subtracts 0, so its masked
            # keys weigh exp2(-1e30) = 0
            m_use = torch.where(mx == ref.NEG_INF, 0.0, mx)
            alpha = torch.exp2(m - m_use)
            p = torch.exp2(st - m_use[..., None])
            l = l * alpha + p.sum(-1)
            pv = (p * vs[..., t0:t0 + kn]).to(torch.bfloat16).float()
            acc = acc * alpha[..., None] + pv @ vv[:, :, t0:t0 + kn]
            m = mx
        states.append((m, l, acc))
    m_star = torch.stack([m for m, _, _ in states]).amax(0)
    l = sum(l * torch.exp2(m - m_star) for m, l, _ in states)
    acc = sum(acc * torch.exp2(m - m_star)[..., None]
              for m, _, acc in states)
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out[..., :d].to(q.dtype)


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


def case_inputs(h, hkv, d, psz, nblk, starts, valid, c, seed, quant):
    """q and pools in bf16 (int8 pools quantized from them), the table,
    start and kv_len."""
    b = len(starts)
    kv_len = [s + v for s, v in zip(starts, valid)]
    q = rand((b, h, c, d), seed).to(torch.bfloat16)
    kp = rand((b * nblk + 1, hkv, psz, d), seed + 1).to(torch.bfloat16)
    vp = rand((b * nblk + 1, hkv, psz, d), seed + 2).to(torch.bfloat16)
    table = shuffled_table(b, nblk, kv_len, psz, seed + 3)
    start = torch.tensor(starts, dtype=torch.int32)
    lens = torch.tensor(kv_len, dtype=torch.int32)
    if quant:
        (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
        return q, (k8, v8, ks, vs), table, start, lens
    return q, (kp, vp, None, None), table, start, lens


# (H, Hkv, D, psz, nblk, starts, valid rows, C): chip_smoke.py's phase-8
# timing shape and its verify shape (SPLIT_CASES[0])
SHAPES = {
    "phase-8 chunk": (32, 4, 128, 16, 32, [384], [128], 128),
    "verify": (32, 4, 128, 16, 64, [839, 720, 190, 544, 0], [5, 5, 5, 5, 0],
               5),
}


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_emulated_kernel_within_bf16_tolerance_of_plain(shape, quant):
    h, hkv, d, psz, nblk, starts, valid, c = SHAPES[shape]
    q, (kp, vp, ks, vs), table, start, lens = case_inputs(
        h, hkv, d, psz, nblk, starts, valid, c, 17, quant)
    got = tc_emulate(q, kp, vp, table, start, lens, ks, vs)
    want = ref.paged_prefill_ref(q, kp, vp, table, start, lens, k_scale=ks,
                                 v_scale=vs)
    # before the output's bf16 rounding: the derived bound of P's rounding
    got32 = tc_emulate(q.float(), kp, vp, table, start, lens, ks, vs)
    want32 = ref.paged_prefill_ref(q.float(), kp, vp, table, start, lens,
                                   k_scale=ks, v_scale=vs)
    v_max = float(ref._dequantize_pools(kp, vp, ks, vs)[1].abs().max())
    for i, n in enumerate(valid):
        if lens[i] == 0:                      # the idle lane: exactly 0
            assert torch.all(got[i] == 0)
            continue
        np.testing.assert_allclose(got[i, :, :n].float().numpy(),
                                   want[i, :, :n].float().numpy(), **BF16_TOL)
        np.testing.assert_allclose(got32[i, :, :n].numpy(),
                                   want32[i, :, :n].numpy(), rtol=0,
                                   atol=P_ROUNDING * v_max + 1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 1)])
@pytest.mark.parametrize("case", ["first-chunk", "mid-page", "ragged"])
def test_emulated_kernel_against_jax_kernels_in_interpret_mode(case, h, hkv,
                                                               quant):
    """Two lanes, chunks of 8 (tests/test_torch_paged.py's cases) in
    float32; q and the bf16 pools hold bf16 values."""
    b, c, d, psz, nblk = 2, 8, 16, 8, 4
    starts = {"first-chunk": [0, 0], "mid-page": [12, 0],
              "ragged": [16, 0]}[case]
    valid = [5 if case == "ragged" else c, c]
    q, (kp, vp, ks, vs), table, start, lens = case_inputs(
        h, hkv, d, psz, nblk, starts, valid, c, 23, quant)
    q = q.float()
    if not quant:
        kp, vp = kp.float(), vp.float()
    got = tc_emulate(q, kp, vp, table, start, lens, ks, vs).numpy()
    args = [np.asarray(x) for x in (q, kp, vp)]
    if quant:
        args += [ks.numpy(), vs.numpy()]
        kernel = jax_paged_prefill_quant
    else:
        kernel = jax_paged_prefill
    want = np.asarray(kernel(*args, jnp.asarray(table.numpy()),
                             jnp.asarray(start.numpy()),
                             jnp.asarray(lens.numpy()), interpret=True))
    v_max = float(ref._dequantize_pools(kp, vp, ks, vs)[1].abs().max())
    for i, n in enumerate(valid):           # rows past kv_len are padding
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], rtol=0,
                                   atol=P_ROUNDING * v_max + 1e-5)


@pytest.mark.parametrize("h,hkv,d,ok", [
    (32, 4, 128, True), (32, 32, 128, True), (8, 2, 16, True),
    (32, 1, 64, True), (12, 4, 128, True), (12, 4, 64, False),
    (20, 4, 128, True), (28, 4, 128, False), (64, 1, 64, False),
    (32, 4, 24, False)])
def test_tensor_core_kernel_shape_check(h, hkv, d, ok):
    """Every shape is taken.  Where G = H / Hkv divides one of the row
    tiles at D with a power-of-two quotient (``ok``: at D 128 the 48-row
    tile takes G 3 and the 80-row tile G 5), the ladder names a tile by
    its positions, as before; the shapes that were refused run too: G 3
    and G 64 at D 64 (32-row tiles only) and G 7 on the flattened (position,
    head) rows (one tile, named by its 32 rows), and D 24 on
    the padded instance of width 64.  Each shape's plain prefill (what the
    wrapper runs on a CPU tensor) agrees with the JAX kernel in interpret
    mode within 1e-5."""
    pa.check_tc_shape("k", h, hkv, d)
    g = h // hkv
    rt = fa.route("flash_paged_prefill", torch.bfloat16, d)
    flat = pa.flattened(d, g)
    assert rt.padded == (d == 24) and flat == (not ok and d != 24)
    block_qs, _ = pa.prefill_tiles(torch.bfloat16, d, g)
    assert block_qs == ((32,) if flat else tuple(
        r // g for r in pa.tc_row_tiles(d) if r % g == 0
        and (r // g) & (r // g - 1) == 0))
    assert pa.default_block_q(d, g) in block_qs
    rows = pa.prefill_rows(d, g, pa.default_block_q(d, g))
    assert rows in pa.tc_row_tiles(d) and (flat or rows % g == 0)
    q, (kp, vp, _, _), table, start, lens = case_inputs(
        h, hkv, d, 8, 4, [12, 0], [5, 3], 5, 23 + h + d, False)
    q, kp, vp = q.float(), kp.float(), vp.float()
    got = ref.paged_prefill_ref(q, kp, vp, table, start, lens)
    want = np.asarray(jax_paged_prefill(
        *(np.asarray(x) for x in (q, kp, vp)), jnp.asarray(table.numpy()),
        jnp.asarray(start.numpy()), jnp.asarray(lens.numpy()), block_q=8,
        interpret=True))
    for i, n in enumerate((5, 3)):
        np.testing.assert_allclose(got[i, :, :n].numpy(), want[i, :, :n],
                                   rtol=1e-5, atol=1e-5)


# the tiles of the D = 128 instances that G 8 (and G 4) takes: (query
# rows, keys); the row tile is block_q x G, so at G 8 block_q is rows // 8
TILES = [(8 * bq, keys) for bq in pa.prefill_tiles(torch.bfloat16, 128, 8)[0]
         for keys in pa.TC_BLOCK_KS]
# G 3's: the 48-row tile, block_q 16
G3_TILES = [(3 * bq, keys)
            for bq in pa.prefill_tiles(torch.bfloat16, 128, 3)[0]
            for keys in pa.TC_BLOCK_KS]


@pytest.mark.parametrize("quant", [False, True], ids=["K4", "K6c"])
@pytest.mark.parametrize("rows,keys", TILES)
def test_every_prefill_tile_within_bound_of_plain(rows, keys, quant):
    """Each tile of the D = 128 instances at the verify shape (yi-6b
    heads, chunks of 5 over four lanes and an idle lane): within the bf16
    tolerance of the plain version and, before the output's rounding,
    within 2^-9 max |v| + 1e-5; the idle lane exactly 0."""
    h, hkv, d, psz, nblk, starts, valid, c = SHAPES["verify"]
    q, (kp, vp, ks, vs), table, start, lens = case_inputs(
        h, hkv, d, psz, nblk, starts, valid, c, 19, quant)
    tile = dict(block_k=keys, groups=key_groups(rows))
    got = tc_emulate(q, kp, vp, table, start, lens, ks, vs, **tile)
    got32 = tc_emulate(q.float(), kp, vp, table, start, lens, ks, vs, **tile)
    want32 = ref.paged_prefill_ref(q.float(), kp, vp, table, start, lens,
                                   k_scale=ks, v_scale=vs)
    v_max = float(ref._dequantize_pools(kp, vp, ks, vs)[1].abs().max())
    for i, n in enumerate(valid):
        if lens[i] == 0:
            assert torch.all(got[i] == 0)
            continue
        np.testing.assert_allclose(got[i, :, :n].float().numpy(),
                                   want32[i, :, :n].numpy(), **BF16_TOL)
        np.testing.assert_allclose(got32[i, :, :n].numpy(),
                                   want32[i, :, :n].numpy(), rtol=0,
                                   atol=P_ROUNDING * v_max + 1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["K4", "K6c"])
@pytest.mark.parametrize("rows,keys", TILES)
def test_prefill_tiles_against_jax_kernels_in_interpret_mode(rows, keys,
                                                             quant):
    """Every tile against the JAX ``flash_paged_prefill(_quant)`` at the
    matching ``block_q`` (rows // G) and ``block_k`` (which the TPU kernel
    takes as its sub-page tile, the whole page of 8 here), G 4, float32
    holding bf16 values, within 2^-9 max |v| + 1e-5."""
    b, c, d, psz, nblk, g = 2, 8, 16, 8, 6, 4
    q, (kp, vp, ks, vs), table, start, lens = case_inputs(
        g, 1, d, psz, nblk, [12, 0], [c, 5], c, 29, quant)
    q = q.float()
    if not quant:
        kp, vp = kp.float(), vp.float()
    got = tc_emulate(q, kp, vp, table, start, lens, ks, vs, block_k=keys,
                     groups=key_groups(rows)).numpy()
    args = [np.asarray(x) for x in (q, kp, vp)]
    if quant:
        args += [ks.numpy(), vs.numpy()]
    kernel = jax_paged_prefill_quant if quant else jax_paged_prefill
    want = np.asarray(kernel(*args, jnp.asarray(table.numpy()),
                             jnp.asarray(start.numpy()),
                             jnp.asarray(lens.numpy()), block_q=rows // g,
                             block_k=keys, interpret=True))
    v_max = float(ref._dequantize_pools(kp, vp, ks, vs)[1].abs().max())
    for i, n in enumerate((c, 5)):
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], rtol=0,
                                   atol=P_ROUNDING * v_max + 1e-5)


@pytest.mark.parametrize("dtype,d,g,block_q,block_k,ok", [
    (torch.bfloat16, 128, 8, None, None, (4, 128)),
    (torch.bfloat16, 128, 8, 2, 64, (2, 64)),
    (torch.bfloat16, 128, 8, 8, 128, (8, 128)),
    (torch.bfloat16, 128, 1, 64, 64, (64, 64)),
    (torch.bfloat16, 128, 8, 3, 128, None),
    (torch.bfloat16, 128, 8, 16, 128, None),
    (torch.bfloat16, 128, 8, 4, 32, None),
    (torch.bfloat16, 64, 8, 2, 128, None),
    (torch.bfloat16, 64, 8, 4, 64, None),
    (torch.bfloat16, 128, 8, 6, 128, None),
    (torch.bfloat16, 128, 3, None, None, (16, 128)),
    (torch.bfloat16, 128, 3, 16, 64, (16, 64)),
    (torch.bfloat16, 128, 3, 32, 128, None),
    (torch.bfloat16, 128, 1, None, None, (32, 128)),
    (torch.float32, 128, 8, None, None, (64, 32)),
    (torch.float32, 128, 8, 4, 128, None)])
def test_prefill_tile_without_instance_raises(dtype, d, g, block_q, block_k,
                                              ok):
    """A tile the kernel has no instance for raises ``ValueError`` naming
    the tiles it has (G 8 at the 48-row tile would be block_q 6, not a
    power of two); ``None`` is the default (bf16: 32 // G rows, G 3's 16
    of the 48-row tile, and 128 keys; float32: the SIMT template's 64 and
    32)."""
    q = torch.zeros(1, 4 * g, 5, d, dtype=dtype)
    if ok is not None:
        assert pa.prefill_tile("k", q, 4, block_q, block_k) == ok
    else:
        with pytest.raises(ValueError, match="has block_q in"):
            pa.prefill_tile("k", q, 4, block_q, block_k)


# phi4-mini's verify shape: 24 q / 8 kv heads (G 3), chunks of 5 over
# four lanes and an idle lane
G3_VERIFY = (24, 8, 128, 16, 64, [839, 720, 190, 544, 0], [5, 5, 5, 5, 0],
             5)


@pytest.mark.parametrize("quant", [False, True], ids=["K4", "K6c"])
@pytest.mark.parametrize("rows,keys", G3_TILES)
def test_g3_tiles_within_bound_of_plain(rows, keys, quant):
    """The 48-row tile (3 slabs, 2 key groups) at phi4-mini's heads on the
    verify shape and a 128-row chunk at 384: within the bf16 tolerance of
    the plain version and, before the output's rounding, within 2^-9
    max |v| + 1e-5; the idle lane exactly 0."""
    for c, starts, valid in ((5, G3_VERIFY[5], G3_VERIFY[6]),
                             (128, [384], [128])):
        h, hkv, d, psz, nblk = G3_VERIFY[:5]
        q, (kp, vp, ks, vs), table, start, lens = case_inputs(
            h, hkv, d, psz, nblk, starts, valid, c, 37, quant)
        tile = dict(block_k=keys, groups=key_groups(rows))
        got = tc_emulate(q, kp, vp, table, start, lens, ks, vs, **tile)
        got32 = tc_emulate(q.float(), kp, vp, table, start, lens, ks, vs,
                           **tile)
        want32 = ref.paged_prefill_ref(q.float(), kp, vp, table, start,
                                       lens, k_scale=ks, v_scale=vs)
        v_max = float(ref._dequantize_pools(kp, vp, ks, vs)[1].abs().max())
        for i, n in enumerate(valid):
            if lens[i] == 0:
                assert torch.all(got[i] == 0)
                continue
            np.testing.assert_allclose(got[i, :, :n].float().numpy(),
                                       want32[i, :, :n].numpy(), **BF16_TOL)
            np.testing.assert_allclose(got32[i, :, :n].numpy(),
                                       want32[i, :, :n].numpy(), rtol=0,
                                       atol=P_ROUNDING * v_max + 1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["K4", "K6c"])
@pytest.mark.parametrize("rows,keys", G3_TILES)
@pytest.mark.parametrize("case", ["mid-page", "ragged"])
def test_g3_tiles_against_jax_kernels_in_interpret_mode(case, rows, keys,
                                                        quant):
    """The 48-row tile at G 3 (6 q / 2 kv heads) against the JAX
    ``flash_paged_prefill(_quant)`` at block_q 16 and the tile's
    block_k, float32 holding bf16 values, within 2^-9 max |v| + 1e-5."""
    c, d, psz, nblk = 8, 16, 8, 6
    starts = {"mid-page": [12, 0], "ragged": [16, 0]}[case]
    valid = [5 if case == "ragged" else c, c]
    q, (kp, vp, ks, vs), table, start, lens = case_inputs(
        6, 2, d, psz, nblk, starts, valid, c, 41, quant)
    q = q.float()
    if not quant:
        kp, vp = kp.float(), vp.float()
    got = tc_emulate(q, kp, vp, table, start, lens, ks, vs, block_k=keys,
                     groups=key_groups(rows)).numpy()
    args = [np.asarray(x) for x in (q, kp, vp)]
    if quant:
        args += [ks.numpy(), vs.numpy()]
    kernel = jax_paged_prefill_quant if quant else jax_paged_prefill
    want = np.asarray(kernel(*args, jnp.asarray(table.numpy()),
                             jnp.asarray(start.numpy()),
                             jnp.asarray(lens.numpy()), block_q=rows // 3,
                             block_k=keys, interpret=True))
    v_max = float(ref._dequantize_pools(kp, vp, ks, vs)[1].abs().max())
    for i, n in enumerate(valid):
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], rtol=0,
                                   atol=P_ROUNDING * v_max + 1e-5)

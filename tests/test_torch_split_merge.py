"""K5c inside the bf16 split phase-1 kernels, on the CPU: the last-arrival
merge of ``csrc/common.cuh`` (``merge_splits_if_last``) that the merged
routes of ``kernels/paged_attention.py`` run in the epilogue of K5a and
K6b (``paged_decode.cu``'s partials mode) and of K5b and K6d
(``paged_prefill.cu``'s).

The kernels cannot run here, so a plain-torch emulation of the protocol
stands in.  The phase-1 partials come from the existing emulations of the
kernels' arithmetic (``split_tc_emulate`` of ``test_torch_decode_tc.py``
for decode, ``split_emulate`` of ``test_torch_attention_tc.py`` for
verify).  Then the split CTAs of every output tile (decode: a lane, kv head
and 16-row slab; verify: a lane, kv head and query tile of 32 // G chunk
rows) "arrive" in a seeded random order: each stores its rows' partials
into buffers that start as NaN, and adds one to its tile's counter; the one
that finds ns - 1 there merges the tile with the kernel's own index maps
(one "warp" a row for m*, the weights of 32 splits at a time and l* in
split order, then the columns in split order) and resets the counter.

The merge's steps are exact IEEE operations here as on the card: the max,
the float32 subtraction, the fused multiply-add (a float64 product, exact
for float32 inputs, and sum, rounded to float32), the float32 division;
the exponential is ``math.exp`` rounded to float32, one function for every
emulation, so emulations that take the same steps in the same order agree
bit for bit.  The tests hold

1. the output bit-equal across arrival orders;
2. bit-equal to a sequential emulation of standalone K5c (one row at a
   time, the splits in order, as ``split_combine_kernel`` takes them), and
   within float32 rounding (rtol = atol = 1e-5: 16 splits of products and
   sums at 2^-24 each, on values of order 1) of ``ref.combine_split_states``
   and ``ref.finalize_split_states``, whose ``torch.sum`` promises no order;
3. every counter back at 0;
4. within the bounds the existing merged tests use of the JAX package's
   ``flash_paged_decode(_quant)`` and ``flash_paged_prefill(_quant)`` with
   ``num_splits`` in interpret mode, for 2, 3, 8 and 16 splits, G 1, 2 and
   4, bf16 and int8 pools: decode within 2^-8 sum_j p_j |v_j| / l + 1e-5
   (P rounded to bf16), verify within 2^-9 max |v| + 1e-5; an empty lane
   exactly 0, and at 16 splits more splits than any lane's key tiles (empty
   splits).

Inputs come from numpy with a seed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_paged_decode as jax_paged_decode
from repro.kernels.flash_attention import \
    flash_paged_decode_quant as jax_paged_decode_quant
from repro.kernels.flash_attention import flash_paged_prefill as jax_paged_prefill
from repro.kernels.flash_attention import \
    flash_paged_prefill_quant as jax_paged_prefill_quant
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from test_torch_attention_tc import (FP32_SUMS, P_ROUNDING, chunk_case,
                                     quantized, split_emulate)
from test_torch_decode_tc import (FP32_TERM, P_BOUND, case_inputs,
                                  split_tc_emulate, weighted_abs_v)

torch.set_num_threads(1)

LANES = 32                       # a warp: lane s holds splits s, s + 32, ...
SLAB = pa.DECODE_SLAB_ROWS       # decode rows per CTA
REF_TOL = dict(rtol=1e-5, atol=1e-5)
ORDERS = (0, 1, 2)               # seeds of the arrival orders


def exp32(x: torch.Tensor) -> torch.Tensor:
    """e^x of float32 values, rounded to float32: one function for every
    emulation, element by element."""
    return torch.tensor([math.exp(v) for v in x.double().flatten().tolist()],
                        dtype=torch.float64).float().reshape(x.shape)


def fma32(total: torch.Tensor, x: torch.Tensor,
          alpha: torch.Tensor) -> torch.Tensor:
    """total + x * alpha with one rounding to float32 after an exact
    product (common.cuh's split_fma)."""
    return (x.double() * alpha.double() + total.double()).float()


def out32(a: torch.Tensor, l_star: torch.Tensor) -> torch.Tensor:
    """a / l*, an all-empty row (l* = 0) divided by 1 (split_out)."""
    return a / torch.where(l_star == 0, torch.ones_like(l_star), l_star)


# --------------------------------------------------------------------------
# the two emulations of K5c: standalone, and last-arrival in the epilogue
# --------------------------------------------------------------------------


def k5c_emulate(m, l, acc):
    """Standalone K5c (``split_combine_kernel``): partials m, l (BR, ns,
    rows) and acc (BR, ns, rows, D) -> (BR, rows, D), one (br, row) at a
    time, m* by a running max from -1e30, then the splits in order."""
    br_n, ns, rows, d = acc.shape
    out = torch.empty((br_n, rows, d))
    for br in range(br_n):
        for r in range(rows):
            m_star = torch.tensor(ref.NEG_INF)
            for s in range(ns):
                m_star = torch.maximum(m_star, m[br, s, r])
            l_star, a = torch.tensor(0.0), torch.zeros(d)
            for s in range(ns):
                alpha = exp32(m[br, s, r] - m_star)
                l_star = fma32(l_star, l[br, s, r], alpha)
                a = fma32(a, acc[br, s, r], alpha)
            out[br, r] = out32(a, l_star)
    return out


def merge_tile(pm, pl, pacc, ns, rows, sstride, prow, d):
    """The last CTA's merge of one tile over the flat partials, with the
    kernel's steps: one warp a row (lane s holding splits s, s + 32, ...,
    a butterfly max), then 32 splits at a time the lanes' weights and l*
    in split order, and each row's columns in split order."""
    base = torch.tensor([prow(r) for r in range(rows)])
    lanes = torch.full((rows, LANES), ref.NEG_INF)
    for s in range(ns):
        lanes[:, s % LANES] = torch.maximum(lanes[:, s % LANES],
                                            pm[base + s * sstride])
    off = LANES // 2
    while off:                       # __shfl_xor_sync butterfly
        lanes = torch.maximum(lanes, lanes[:, torch.arange(LANES) ^ off])
        off //= 2
    m_star = lanes[:, 0]
    l_star, a = torch.zeros(rows), torch.zeros((rows, d))
    for s0 in range(0, ns, LANES):
        n = min(LANES, ns - s0)
        idx = base[:, None] + (s0 + torch.arange(n))[None, :] * sstride
        alpha = exp32(pm[idx] - m_star[:, None])        # (rows, n)
        lv = pl[idx]
        for j in range(n):
            l_star = fma32(l_star, lv[:, j], alpha[:, j])
        for j in range(n):
            a = fma32(a, pacc[idx[:, j]], alpha[:, j, None])
    return out32(a, l_star[:, None])


def last_arrival(parts, tiles, out, order_seed):
    """Run the protocol over the emulated phase-1 partials ``parts`` (m,
    l, acc in the kernel's layout) into ``out`` (NaN where nothing was
    written): ``tiles`` lists (rows, sstride, prow, orow) per output tile,
    prow and orow flat indices of row r's split-0 state and its output
    row.  The (tile, split) arrivals come in a seeded random order; each
    stores its split's rows, then counts; the ns-th merges.  Returns the
    counters."""
    m, l, acc = parts
    ns, d = m.shape[-2], acc.shape[-1]
    src = m.flatten(), l.flatten(), acc.reshape(-1, d)
    pm, pl, pacc = (torch.full_like(t, float("nan")) for t in src)
    counters = torch.zeros(len(tiles), dtype=torch.int32)
    flat = out.view(-1, d)
    arrivals = [(t, s) for t in range(len(tiles)) for s in range(ns)]
    order = np.random.default_rng(order_seed).permutation(len(arrivals))
    for i in order:
        t, s = arrivals[i]
        rows, sstride, prow, orow = tiles[t]
        idx = torch.tensor([prow(r) + s * sstride for r in range(rows)])
        pm[idx], pl[idx], pacc[idx] = src[0][idx], src[1][idx], src[2][idx]
        prev = int(counters[t])
        counters[t] += 1
        if prev == ns - 1:           # the last of the tile's splits
            flat[torch.tensor([orow(r) for r in range(rows)])] = merge_tile(
                pm, pl, pacc, ns, rows, sstride, prow, d)
            counters[t] = 0
    return counters


def decode_tiles(b, h, hkv, ns):
    """paged_decode.cu's tiles: (lane, kv head, 16-row slab), its rows'
    partials at (bh * ns + s) * G + r0 + r, its output rows at b * H + hk
    * G + r0 + r."""
    g = h // hkv
    tiles = []
    for bh in range(b * hkv):
        for r0 in range(0, g, SLAB):
            tiles.append((min(SLAB, g - r0), g,
                          lambda r, bh=bh, r0=r0: bh * ns * g + r0 + r,
                          lambda r, bh=bh, r0=r0: bh * g + r0 + r))
    return tiles


def verify_tiles(b, h, hkv, c, ns, tile_rows=pa.TC_TILE_ROWS):
    """paged_prefill.cu's tiles: (lane, kv head, q tile of tile_rows // G
    chunk rows), folded row r being chunk row i0 + r // G of head hk * G
    + r % G; partials at ((b * H + head) * ns + s) * C + qi, output rows
    at (b * H + head) * C + qi; the rows of the chunk only."""
    g = h // hkv
    rq = tile_rows // g
    tiles = []
    for bb in range(b):
        for hk in range(hkv):
            head0 = bb * h + hk * g
            for i0 in range(0, c, rq):
                tiles.append((
                    min(tile_rows, (c - i0) * g), c,
                    lambda r, h0=head0, i0=i0: ((h0 + r % g) * ns * c
                                                + i0 + r // g),
                    lambda r, h0=head0, i0=i0: (h0 + r % g) * c + i0 + r // g))
    return tiles


def merged_outputs(parts, tiles, shape):
    """The protocol's output for every arrival order (each checked for
    counters back at 0 and every row written)."""
    outs = []
    for seed in ORDERS:
        out = torch.full(shape, float("nan"))
        counters = last_arrival(parts, tiles, out, seed)
        assert torch.all(counters == 0)
        assert not bool(torch.isnan(out).any())
        outs.append(out)
    return outs


def check_against_k5c_and_ref(outs, parts):
    """Bit-equal across orders and to standalone K5c; within float32
    rounding of the reference combine."""
    m, l, acc = parts
    flat = (m.reshape(-1, *m.shape[-2:]), l.reshape(-1, *l.shape[-2:]),
            acc.reshape(-1, *acc.shape[-3:]))
    k5c = k5c_emulate(*flat).reshape(outs[0].shape)
    for out in outs:
        assert torch.equal(out, outs[0])
        assert torch.equal(out, k5c)
    _, l_star, acc_star = ref.combine_split_states(*parts)
    want = ref.finalize_split_states(l_star, acc_star)
    np.testing.assert_allclose(outs[0].numpy(),
                               want.reshape(outs[0].shape).numpy(), **REF_TOL)


# --------------------------------------------------------------------------
# decode: K5a and K6b with K5c in the epilogue
# --------------------------------------------------------------------------

DECODE = dict(d=16, psz=8, nblk=20, kv_len=[0, 11, 45, 150])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 2)],
                         ids=["G1", "G2", "G4"])
@pytest.mark.parametrize("ns", [2, 3, 8, 16])
def test_merged_decode_protocol(ns, h, hkv, quant):
    """The last-arrival merge of the emulated K5a (K6b) partials: the same
    output for every arrival order, bit-equal to standalone K5c, within
    float32 rounding of the reference combine, counters back at 0; within
    the one-pass bound of the JAX ``flash_paged_decode(_quant)`` at the
    same ``num_splits`` (interpret mode); the empty lane exactly 0.  A lane
    of 150 keys has 3 of the kernel's 64-key tiles, so 8 and 16 splits
    leave splits empty."""
    d, psz, nblk, kv_len = (DECODE[k] for k in ("d", "psz", "nblk", "kv_len"))
    q, (kp, vp, ks, vs), table, lens = case_inputs(h, hkv, d, psz, nblk,
                                                   kv_len, 97, quant)
    q = q.float()
    if not quant:
        kp, vp = kp.float(), vp.float()
    parts = split_tc_emulate(q, kp, vp, table, lens, ns, ks, vs)
    assert bool((parts[0] == ref.NEG_INF).any())      # an empty split
    b = len(kv_len)
    outs = merged_outputs(parts, decode_tiles(b, h, hkv, ns),
                          (b, hkv, h // hkv, d))
    check_against_k5c_and_ref(outs, parts)
    got = outs[0].reshape(q.shape)
    assert torch.all(got[0] == 0)                     # kv_len 0
    args = (q, kp, vp) + ((ks, vs) if quant else ()) + (table, lens)
    jax_fn = jax_paged_decode_quant if quant else jax_paged_decode
    want = np.asarray(jax_fn(*(jnp.asarray(x.numpy()) for x in args),
                             num_splits=ns, interpret=True))
    bound = P_BOUND * weighted_abs_v(q, kp, vp, table, lens, ks, vs)
    bound = (bound + FP32_TERM).numpy()
    assert np.all(np.abs(got[1:].numpy() - want[1:]) <= bound[1:])


def test_decode_tiles_cover_every_output_row_once():
    """G 40 takes three 16-row slabs (the last of 8 rows): the tiles'
    output rows are every (lane, head) once, and their split-0 partial
    rows every (lane, kv head, row) once."""
    b, h, hkv, ns = 2, 80, 2, 3
    tiles = decode_tiles(b, h, hkv, ns)
    assert len(tiles) == b * hkv * 3
    out_rows = sorted(t[3](r) for t in tiles for r in range(t[0]))
    assert out_rows == list(range(b * h))
    g = h // hkv
    first = sorted(t[2](r) for t in tiles for r in range(t[0]))
    assert first == [bh * ns * g + r for bh in range(b * hkv)
                     for r in range(g)]


# --------------------------------------------------------------------------
# verify: K5b and K6d with K5c in the epilogue
# --------------------------------------------------------------------------

# three lanes with chunks of 8 (at a mid-page start, at 0, ragged) and an
# idle lane; pages of 8
VERIFY = dict(c=8, d=16, psz=8, nblk=20, starts=[70, 0, 140, 0],
              valid=[8, 8, 5, 0])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 2)],
                         ids=["G1", "G2", "G4"])
@pytest.mark.parametrize("ns", [2, 3, 8, 16])
def test_merged_verify_protocol(ns, h, hkv, quant):
    """The last-arrival merge of the emulated K5b (K6d) partials over the
    kernel's q tiles (32 // G chunk rows, so G 1 is one tile of the chunk
    and the tile's rows past C are never written): the same output for
    every arrival order, bit-equal to standalone K5c, within float32
    rounding of the reference combine, counters back at 0; within 2^-9
    max |v| + 1e-5 of the JAX ``flash_paged_prefill(_quant)`` at the same
    ``num_splits`` (interpret mode) on the committed rows; the idle lane
    exactly 0."""
    c, d, psz, nblk, starts, valid = (
        VERIFY[k] for k in ("c", "d", "psz", "nblk", "starts", "valid"))
    q, kp, vp, table, start, kv_len = chunk_case(h, hkv, d, psz, nblk,
                                                 starts, valid, c, 101)
    q = q.float()
    scales = {}
    if quant:
        kp, vp, ks, vs = quantized(kp, vp)
        scales = dict(k_scale=ks, v_scale=vs)
        v_max = float((vp.float() * vs[..., None]).abs().max())
    else:
        kp, vp = kp.float(), vp.float()
        v_max = float(vp.abs().max())
    parts = split_emulate(q, kp, vp, table, start, kv_len, ns, **scales)
    assert bool((parts[0] == ref.NEG_INF).any())      # an empty split
    b = len(starts)
    outs = merged_outputs(parts, verify_tiles(b, h, hkv, c, ns), q.shape)
    check_against_k5c_and_ref(outs, parts)
    got = outs[0]
    assert torch.all(got[valid.index(0)] == 0)        # the idle lane
    args = (q, kp, vp) + ((ks, vs) if quant else ()) + (table, start, kv_len)
    jax_fn = jax_paged_prefill_quant if quant else jax_paged_prefill
    want = np.asarray(jax_fn(*(jnp.asarray(x.numpy()) for x in args),
                             num_splits=ns, interpret=True))
    atol = P_ROUNDING * v_max + FP32_SUMS
    for lane, n in enumerate(valid):       # rows past kv_len are padding
        np.testing.assert_allclose(got[lane, :, :n].numpy(),
                                   want[lane, :, :n], rtol=0, atol=atol)


def test_a_merge_before_the_last_arrival_would_read_unstored_partials():
    """The protocol's guard: merging when the first split of a tile
    arrives reads partials no split has stored yet (NaN here), so only
    the ns-th arrival may merge."""
    d, psz, nblk, kv_len = (DECODE[k] for k in ("d", "psz", "nblk", "kv_len"))
    q, (kp, vp, _, _), table, lens = case_inputs(4, 2, d, psz, nblk, kv_len,
                                                 97, False)
    ns = 3
    parts = split_tc_emulate(q.float(), kp.float(), vp.float(), table, lens,
                             ns)
    rows, sstride, prow, _ = decode_tiles(len(kv_len), 4, 2, ns)[2]
    m, l, acc = parts[0].flatten(), parts[1].flatten(), parts[2].reshape(-1, d)
    stored = [torch.full_like(t, float("nan")) for t in (m, l, acc)]
    idx = torch.tensor([prow(r) for r in range(rows)])   # split 0 only
    for dst, src in zip(stored, (m, l, acc)):
        dst[idx] = src[idx]
    early = merge_tile(*stored, ns, rows, sstride, prow, d)
    assert bool(torch.isnan(early).all())
    full = merge_tile(m, l, acc, ns, rows, sstride, prow, d)
    assert bool(torch.isfinite(full).all())


# --------------------------------------------------------------------------
# every tile of the D = 128 instances (the run-time AT's tiles)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
def test_merged_decode_protocol_at_every_key_tile(block_k):
    """The last-arrival merge of the emulated K5a partials cut at each key
    tile (3 splits, G 4): bit-equal across arrival orders and to
    standalone K5c, counters back at 0, within the one-pass bound of the
    JAX ``flash_paged_decode`` at the same ``block_k`` and splits."""
    d, psz, nblk, kv_len = (DECODE[k] for k in ("d", "psz", "nblk", "kv_len"))
    q, (kp, vp, _, _), table, lens = case_inputs(8, 2, d, psz, nblk, kv_len,
                                                 113, False)
    q, kp, vp = q.float(), kp.float(), vp.float()
    parts = split_tc_emulate(q, kp, vp, table, lens, 3, block_k=block_k)
    outs = merged_outputs(parts, decode_tiles(len(kv_len), 8, 2, 3),
                          (len(kv_len), 2, 4, d))
    check_against_k5c_and_ref(outs, parts)
    got = outs[0].reshape(q.shape)
    want = np.asarray(jax_paged_decode(
        *(jnp.asarray(x.numpy()) for x in (q, kp, vp, table, lens)),
        block_k=block_k, num_splits=3, interpret=True))
    bound = (P_BOUND * weighted_abs_v(q, kp, vp, table, lens, None, None)
             + FP32_TERM).numpy()
    assert torch.all(got[0] == 0)
    assert np.all(np.abs(got[1:].numpy() - want[1:]) <= bound[1:])


@pytest.mark.parametrize("tile_rows,keys", [
    (4 * bq, keys) for bq in pa.prefill_tiles(torch.bfloat16, 128, 4)[0]
    for keys in pa.TC_BLOCK_KS])
def test_merged_verify_protocol_at_every_tile(tile_rows, keys):
    """The last-arrival merge of the emulated K5b partials over the q
    tiles of each tile of the D = 128 instances that G 4 takes (3 splits,
    block_q = rows // 4, the arrival counters one per q tile of that many
    rows):
    bit-equal across orders and to standalone K5c, counters back at 0,
    within 2^-9 max |v| + 1e-5 of the JAX ``flash_paged_prefill`` at the
    matching block_q and block_k and splits."""
    c, d, psz, nblk, starts, valid = (
        VERIFY[k] for k in ("c", "d", "psz", "nblk", "starts", "valid"))
    q, kp, vp, table, start, kv_len = chunk_case(8, 2, d, psz, nblk, starts,
                                                 valid, c, 117)
    q, kp, vp = q.float(), kp.float(), vp.float()
    parts = split_emulate(q, kp, vp, table, start, kv_len, 3,
                          tile_rows=tile_rows, keys=keys)
    b = len(starts)
    outs = merged_outputs(parts, verify_tiles(b, 8, 2, c, 3, tile_rows),
                          q.shape)
    check_against_k5c_and_ref(outs, parts)
    want = np.asarray(jax_paged_prefill(
        *(jnp.asarray(x.numpy()) for x in (q, kp, vp, table, start, kv_len)),
        block_q=tile_rows // 4, block_k=keys, num_splits=3, interpret=True))
    atol = P_ROUNDING * float(vp.abs().max()) + FP32_SUMS
    for lane, n in enumerate(valid):
        np.testing.assert_allclose(outs[0][lane, :, :n].numpy(),
                                   want[lane, :, :n], rtol=0, atol=atol)

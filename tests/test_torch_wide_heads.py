"""Head dims above 256 (257 to 512) in the port, against the JAX package
on the CPU.

The card's attention kernels (K1-K6d, ``csrc/*.cu``) take a head dim above
256 on the wide rungs ``fa.WIDE_HEAD_DIMS`` (384 and 512): a 16-row mma
slab is served by one warp per 128 columns, each holding its slice's Q
fragments and O accumulator; the slices' partial Q.K^T meet in shared
memory and are summed in slice order, so every warp of the slab runs the
same online softmax and adds P.V into its own columns (``csrc/common.cuh``).
One tile each: K1 32 rows by 32 keys, the decode kernel 32 keys (2 key
groups), the prefill kernel 32 rows by 32 keys (1 key group); the float32
SIMT templates 32 query rows in 8 warps.  Above 512 every route raises
``ValueError`` naming the limit.  Here, where the kernels cannot run:

* the tables: routes, tiles, shared memory and the cluster rule at the
  wide rungs, the run-time ladders and the limit;
* the port's plain versions against the JAX kernels in interpret mode at
  d 264, 300, 384 and 512, G 7, float32 and bfloat16, bf16 and int8
  pools, one pass and 2 splits: float32 within 2e-5, bfloat16 within 2e-2
  (rtol = atol) of the JAX kernel on the same bf16 values;
* the emulations of the wide kernels' arithmetic (the slices' partial
  sums in slice order, P rounded to bf16, the wide tiles) against plain
  (bfloat16 within 2e-2) and against the JAX kernels in float32 on bf16
  values, within the bound of P's rounding (2^-9 of max |v|) plus 1e-5 of
  fp32 sums: K1, the decode kernel at every cluster size, its dense mode
  and its partials merged as K5c does, the prefill kernel at G 7 (the
  flattened rows) one pass and split;
* the engine: yi-6b's reduced config at d_head 320 (the rung 384 on the
  card) through the port's engine and the JAX engine, greedy tokens equal
  for dense lanes, the paged pool, int8 pages at 2 splits and
  speculative decoding; one train step's loss and every gradient equal to
  the JAX package's (float32, the tolerances of test_torch_train_parity).

Inputs come from numpy with seeds.
"""
import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch.serve import tile_ladders
from repro_torch.models import build_model
from repro_torch.tuning.install import flash_blocks_cost
from test_torch_attention_tc import (FP32_SUMS, LOG2E, P_ROUNDING, k1_emulate,
                                     online_softmax)
from test_torch_decode_tc import emulate_strips
from test_torch_head_dims import (BF16, H, HKV, PSZ, close,
                                  engine_tokens_match_jax, paged_inputs,
                                  values)
from test_torch_prefill_tc import kstep_scores, pad_cols, tc_emulate
from test_torch_train_parity import (GRAD_RTOL, LOSS_RTOL, batches, flat,
                                     grad_atol, to_numpy, torch_batch)

jfa = importlib.import_module("repro.kernels.flash_attention")
torch.set_num_threads(1)

F32 = torch.float32
BF16_TOL = dict(rtol=2e-2, atol=2e-2)         # chip_smoke.py's TOL[bf16]
DIMS = (264, 300, 384, 512)
KERNEL_NAMES = ("flash_attention", "flash_decode", "flash_paged_decode",
                "flash_paged_prefill")
H100_SMEM_PER_BLOCK = 232_448


def rung(d: int) -> int:
    return fa.padded_width(d)


def jnp_(x):
    return jax.numpy.asarray(np.asarray(x))


# --------------------------------------------------------------------------
# the tables
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d", [257, 264, 300, 384, 385, 512])
def test_wide_head_dims_route_to_the_wide_rungs_with_their_one_tile(d):
    """Every kernel and query type takes the wide instance of the smallest
    rung at or above d, from the wide library, at its one tile; every tile
    the tables publish passes the wrappers' tile checks."""
    width = 384 if d <= 384 else 512
    for name in KERNEL_NAMES:
        for dtype in (F32, BF16):
            rt = fa.route(name, dtype, d)
            assert rt == (width, True) and rt.wide and rt.library == "_wide"
            assert rt.dp == width
    q = torch.zeros(1, H, 1, d, dtype=BF16)
    for dtype in (F32, BF16):
        assert fa.attention_tiles(dtype, d) == (fa.WIDE_TILE,)
        assert fa.attention_tile("flash_attention", q.to(dtype), None,
                                 None) == fa.WIDE_TILE
    assert pa.decode_block_ks(BF16, d) == pa.decode_block_ks(
        BF16, d, dense=True) == (fa.WIDE_BLOCK_K,)
    assert pa.decode_tile("flash_paged_decode", q, None) == fa.WIDE_BLOCK_K
    assert pa.prefill_tiles(BF16, d, 8) == ((4,), (32,))
    assert pa.prefill_tiles(BF16, d, 7) == ((32,), (32,))   # flattened
    assert pa.prefill_tiles(F32, d, 7) == ((32,), (32,))
    assert pa.prefill_tile("flash_paged_prefill", q, HKV, None, None) == (
        32, 32)
    assert pa.prefill_route("flash_paged_prefill", BF16, d, 7) == (width,
                                                                   True)


def test_wide_shared_memory_cluster_rule_and_the_limit():
    """``decode_smem_bytes`` reckons the wide ``dec::Smem`` (2 stages, a
    copy of the scales a slice, the slices' partial scores in two
    buffers): every wide instance fits a block and the cluster rule counts
    one CTA an SM; K1's and the SIMT templates' formulas at the wide tile;
    above 512 every route raises naming the limit, whose reason is the
    float32 template's 32-row tile at the next rung, 640."""
    want = {(384, False): 125_184, (384, True): 127_744,
            (512, False): 166_144, (512, True): 169_216}
    for (w, quant), n in want.items():
        assert pa.decode_smem_bytes(w, 32, quant, 0) == n < H100_SMEM_PER_BLOCK
        assert pa.DECODE_CTAS[(w, 32, quant)] == 1
        assert pa.cluster_size(4, 4, 132, w, 32, quant) == 8
        assert pa.cluster_size(64, 8, 132, w, 32, quant) == 1
    assert fa.smem_bytes(32, 32, 512) == 182_784
    assert fa.smem_bytes(32, 32, 384) == 137_728
    assert fa.simt_smem_bytes(512) == 200_832 < H100_SMEM_PER_BLOCK
    assert fa.simt_smem_bytes(640) == 249_984 > H100_SMEM_PER_BLOCK
    for d in (513, 640):
        for name in KERNEL_NAMES:
            with pytest.raises(ValueError, match="1..512.*249,984"):
                fa.route(name, BF16, d)
        assert pa.prefill_tiles(BF16, d, 8) == ((), ())


@pytest.mark.parametrize("d", [320, 512])
def test_run_time_ladders_and_flash_blocks_at_wide_head_dims(d):
    """``tile_ladders`` at yi-6b's widths with d_head ``d`` lists the wide
    instances' one tile (keys 32, block_q 4 at G 8), which the wrappers
    take; ``FlashBlocks`` costs only the wide tile as finite."""
    cfg = dataclasses.replace(get_arch("yi-6b"), d_head=d)

    class _Model:
        pass
    model = _Model()
    model.cfg = cfg
    ladders = tile_ladders(model, 16)
    assert ladders["dense_block_k"] == ladders["block_k"] == (32,)
    assert ladders["prefill_block_k"] == ladders["kv_block_k"] == (32,)
    assert ladders["block_q"] == (4,)
    q = torch.zeros(1, cfg.n_heads, 1, d, dtype=BF16)
    assert pa.prefill_tile("flash_paged_prefill", q, cfg.n_kv_heads, 4,
                           32) == (4, 32)
    assert flash_blocks_cost(32, 32, seq=2048, d_head=d,
                             smem_limit=H100_SMEM_PER_BLOCK) < float("inf")
    for tile in ((64, 64), (128, 128)):
        assert flash_blocks_cost(*tile, seq=2048, d_head=d,
                                 smem_limit=H100_SMEM_PER_BLOCK) == float(
                                     "inf")


@pytest.mark.parametrize("d,width", [(128, 384), (256, 512)])
def test_forced_wide_rung_answers_for_every_table(d, width):
    """Inside ``fa._forced_width`` of a wide rung every route and tile
    table answers for the wide instance (the card's check against the head
    dim's own)."""
    with fa._forced_width(width):
        assert fa.route("flash_paged_decode", BF16, d) == (width, True)
        assert fa.attention_tiles(BF16, d) == (fa.WIDE_TILE,)
        assert pa.decode_block_ks(BF16, d) == (32,)
        assert pa.prefill_tiles(BF16, d, 8) == ((4,), (32,))
    assert not fa.route("flash_paged_decode", BF16, d).wide


# --------------------------------------------------------------------------
# the port's plain versions against the JAX kernels (interpret mode)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d", DIMS)
def test_k1_and_k2_plain_against_jax_kernels(d):
    """K1: causal self-attention of 20 rows; K2: one token over dense
    caches of 24 slots, lanes of 24 and 9 keys; G 7, float32 and
    bfloat16."""
    q, k, v = (values((1, n, 20, d), d + j)
               for j, n in enumerate((H, HKV, HKV)))
    want = jfa.flash_attention(*(np.asarray(x) for x in (q, k, v)),
                               causal=True, block_q=16, block_k=16,
                               interpret=True)
    for dtype in (F32, BF16):
        close(ops.attention(q.to(dtype), k.to(dtype), v.to(dtype),
                            causal=True), want, dtype)
    q, k, v = (values((2, n, s, d), 3 * d + j)
               for j, (n, s) in enumerate(((H, 1), (HKV, 24), (HKV, 24))))
    lens = torch.tensor([24, 9], dtype=torch.int32)
    want = jfa.flash_decode(*(np.asarray(x) for x in (q, k, v)),
                            jnp_(lens), block_k=8, interpret=True)
    for dtype in (F32, BF16):
        close(ops.decode_attention(q.to(dtype), k.to(dtype), v.to(dtype),
                                   lens), want, dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d", DIMS)
def test_paged_plain_against_jax_kernels(d, quant):
    """K3 (K6a) and, at 2 splits, K5a's (K6b's) partials at the wide
    decode tile merged by K5c, against the JAX ``flash_paged_decode
    (_quant)``: lanes of 29 and 7 keys; K4 (K6c) and at 2 splits K5b's
    (K6d's) partials at the wide tile (32 flattened rows by 32 keys;
    float32 32 by 32) against ``flash_paged_prefill(_quant)``: a chunk of
    5 at 12 and one of 3 at 0; G 7, shuffled pages of 8."""
    q, (kp, vp), (k8, v8, ks, vs), table = paged_inputs(d, 1, 300 + d)
    lens = torch.tensor([29, 7], dtype=torch.int32)
    pools = (k8, v8, ks, vs) if quant else (kp, vp)
    decode = jfa.flash_paged_decode_quant if quant else jfa.flash_paged_decode
    for ns in (1, 2):
        want = decode(np.asarray(q), *(np.asarray(x) for x in pools),
                      jnp_(table), jnp_(lens), num_splits=ns, interpret=True)
        for dtype in (F32, BF16):
            p = (ops.PagedPools(k8, v8, ks, vs) if quant else
                 ops.PagedPools(kp.to(dtype), vp.to(dtype)))
            qq = q.to(dtype)
            if ns == 1:
                got = ops.paged_decode(qq, p, table, lens)
            else:
                got, _ = ref.paged_decode_split_tiles_ref(
                    qq, p.k, p.v, table, lens, ns, k_scale=p.k_scale,
                    v_scale=p.v_scale,
                    block_k=pa.decode_tile("flash_paged_decode", qq, None))
            close(got, want, dtype)
    q, (kp, vp), (k8, v8, ks, vs), table = paged_inputs(d, 5, 500 + d)
    pools = (k8, v8, ks, vs) if quant else (kp, vp)
    start = torch.tensor([12, 0], dtype=torch.int32)
    lens = torch.tensor([17, 3], dtype=torch.int32)
    prefill = (jfa.flash_paged_prefill_quant if quant
               else jfa.flash_paged_prefill)
    g = H // HKV
    tiles = {BF16: dict(rows=pa.prefill_rows(d, g, pa.default_block_q(d, g)),
                        block_k=pa.default_block_k(BF16, d)),
             F32: dict(zip(("block_q", "block_k"), pa.simt_prefill_tile(d)))}
    assert tiles[BF16] == dict(rows=32, block_k=32)
    for ns in (1, 2):
        want = prefill(np.asarray(q), *(np.asarray(x) for x in pools),
                       jnp_(table), jnp_(start), jnp_(lens), block_q=8,
                       num_splits=ns, interpret=True)
        for dtype in (F32, BF16):
            p = (ops.PagedPools(k8, v8, ks, vs) if quant else
                 ops.PagedPools(kp.to(dtype), vp.to(dtype)))
            qq = q.to(dtype)
            if ns == 1:
                got = ops.paged_prefill(qq, p, table, start, lens)
            else:
                got, _ = ref.paged_prefill_split_ref(
                    qq, p.k, p.v, table, start, lens, ns, k_scale=p.k_scale,
                    v_scale=p.v_scale, **tiles[dtype])
            close(got, want, dtype, rows=(5, 3))


# --------------------------------------------------------------------------
# the wide kernels' arithmetic, emulated
# --------------------------------------------------------------------------


def p_bound(v) -> float:
    """The float32 emulation's budget against a fp32 kernel: P's rounding
    to bf16 (2^-9 of max |v| on an output) plus fp32 sums."""
    return P_ROUNDING * float(v.float().abs().max()) + FP32_SUMS


@pytest.mark.parametrize("d", DIMS)
def test_k1_wide_emulation_against_plain_and_jax(d):
    """K1 at the wide tile (32 rows, 32-key steps) on the rung's slices:
    within bf16's tolerance of plain, and in float32 (bf16-valued inputs)
    within P's rounding of the JAX kernel; causal, G 4, 70 rows (a ragged
    last tile)."""
    q = values((1, 8, 70, d), d).to(BF16)
    k, v = values((1, 2, 70, d), d + 1).to(BF16), values((1, 2, 70, d),
                                                         d + 2).to(BF16)
    kw = dict(block_q=fa.WIDE_TILE[0], block_k=fa.WIDE_TILE[1],
              width=rung(d), step=fa.WIDE_TILE[1])
    got = k1_emulate(q, k, v, **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               ref.attention_ref(q, k, v).float().numpy(),
                               **BF16_TOL)
    got32 = k1_emulate(q.float(), k, v, **kw).numpy()
    want = np.asarray(jfa.flash_attention(
        *(x.float().numpy() for x in (q, k, v)), causal=True, block_q=16,
        block_k=16, interpret=True))
    np.testing.assert_allclose(got32, want, rtol=0, atol=p_bound(v))


def test_slices_sum_in_slice_order():
    """At a wide width the emulated Q.K^T is the slices' 16-deep partial
    sums added in slice order: equal to itself slice by slice, and within
    fp32 rounding of one sum over the whole row."""
    q, k = values((1, 2, 5, 512), 1), values((1, 2, 9, 512), 2)
    eq = "bhqd,bhkd->bhqk"
    parts = [kstep_scores(eq, q[..., i:i + 128], k[..., i:i + 128])
             for i in range(0, 512, 128)]
    assert torch.equal(kstep_scores(eq, q, k),
                       ((parts[0] + parts[1]) + parts[2]) + parts[3])
    np.testing.assert_allclose(kstep_scores(eq, q, k).numpy(),
                               torch.einsum(eq, q, k).numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("quant", [False, True], ids=["K3", "K6a"])
@pytest.mark.parametrize("d", DIMS)
def test_decode_wide_emulation_every_cluster_and_split(d, quant):
    """The decode kernel's wide instance (32-key tiles, 2 key groups, the
    slices' sums): one pass at every cluster size, its dense mode (K2) and
    its partials at 2 and 3 splits merged as K5c does, against plain
    (bf16) and the JAX kernels (float32, P's bound)."""
    q, (kp, vp), (k8, v8, ks, vs), table = paged_inputs(d, 1, 700 + d)
    lens = torch.tensor([29, 7], dtype=torch.int32)
    kpool, vpool = (k8, v8) if quant else (kp.to(BF16), vp.to(BF16))
    scales = (ks, vs) if quant else (None, None)
    gk, gv = ref.gather_pages(kpool, table), ref.gather_pages(vpool, table)
    gs = [None if s is None else ref.gather_pages(s[..., None], table)[..., 0]
          for s in scales]
    w, bk = rung(d), fa.WIDE_BLOCK_K
    plain = ref.paged_decode_ref(q.to(BF16), kpool, vpool, table, lens,
                                 k_scale=scales[0], v_scale=scales[1])
    for c in pa.CLUSTER_SIZES:
        got = emulate_strips(q.to(BF16), gk, gv, *gs, lens, c, block_k=bk,
                             width=w)
        np.testing.assert_allclose(got.float().numpy(),
                                   plain.float().numpy(), **BF16_TOL)
    if not quant:
        dense = emulate_strips(q.to(BF16), gk, gv, None, None, lens, 2,
                               block_k=bk, width=w)
        np.testing.assert_allclose(
            dense.float().numpy(),
            ref.decode_ref(q.to(BF16), gk, gv, lens).float().numpy(),
            **BF16_TOL)
    jargs = [np.asarray(q), *(np.asarray(x) for x in (
        (k8, v8, ks, vs) if quant else (kpool.float(), vpool.float())))]
    jdecode = jfa.flash_paged_decode_quant if quant else jfa.flash_paged_decode
    v_scale = 1.0 if vs is None or not quant else float(vs.max())
    for ns in (1, 2, 3):
        if ns == 1:
            got = emulate_strips(q, gk, gv, *gs, lens, 4, block_k=bk,
                                 width=w)[:, :, 0]
        else:
            m, l, acc = emulate_strips(q, gk, gv, *gs, lens, ns,
                                       partials=True, block_k=bk, width=w)
            _, l_star, acc_star = ref.combine_split_states(m, l, acc)
            got = ref.finalize_split_states(l_star, acc_star).reshape(
                q.shape[0], H, d)
        want = np.asarray(jdecode(*jargs, jnp_(table), jnp_(lens),
                                  num_splits=ns, interpret=True))[:, :, 0]
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=p_bound(gv) * v_scale)


def prefill_split_emulate(q, k_pool, v_pool, table, start, kv_len, ns,
                          k_scale=None, v_scale=None, rows=32, keys=32,
                          width=None):
    """The prefill kernel's wide partials mode in plain torch: the slices'
    scores (``kstep_scores`` at ``width``), the flattened rows' partition
    (a tile of ``rows`` (position, head) rows walks the key tiles its last
    row sees, split s a contiguous share, ``ref.paged_prefill_split_ref``'s
    at ``rows``), one key group walking ``keys``-key steps, P rounded to
    bf16; returns the K5c-merged output, float32."""
    b, h, c, d = q.shape
    hkv = k_pool.shape[1]
    g = h // hkv
    k = ref.gather_pages(k_pool, table).float()
    v = ref.gather_pages(v_pool, table).float()
    sk = k.shape[2]
    ones = torch.ones(b, hkv, sk)
    ksc = ones if k_scale is None else ref.gather_pages(
        k_scale[..., None], table)[..., 0]
    vsc = ones if v_scale is None else ref.gather_pages(
        v_scale[..., None], table)[..., 0]
    qq = pad_cols(q.float(), width)
    kk = pad_cols(torch.repeat_interleave(k, g, 1), width)
    vv = pad_cols(torch.repeat_interleave(v, g, 1), width)
    s = kstep_scores("bhqd,bhkd->bhqk", qq, kk)
    s = s * torch.repeat_interleave(ksc, g, 1)[:, :, None] * np.float32(
        d ** -0.5 * LOG2E)
    vs = torch.repeat_interleave(vsc, g, 1)[:, :, None, :]
    i = torch.arange(c)
    f = i[None, :] * g + (torch.arange(h) % g)[:, None]          # (H, C)
    last = start[:, None, None] + ((f // rows + 1) * rows - 1) // g
    lens = kv_len.clamp(0, sk)[:, None, None]
    t_live = torch.where(last < 0, 0, torch.minimum(-(-lens // keys),
                                                    last // keys + 1))
    per = -(-t_live // ns)
    kj = torch.arange(sk)
    visible = (kj <= (start[:, None] + i)[:, None, :, None]) & (
        kj < lens[..., None])
    steps = [slice(t0, t0 + keys) for t0 in range(0, sk, keys)]
    parts = []
    for split in range(ns):
        lo = torch.minimum(split * per, t_live)[..., None] * keys
        hi = torch.minimum(t_live, split * per + per)[..., None] * keys
        mask = visible & (kj >= lo) & (kj < hi)
        m, l, acc = online_softmax(torch.where(mask, s, ref.NEG_INF), vv,
                                   steps, vs)
        parts.append((torch.where(m == ref.NEG_INF, ref.NEG_INF, m / LOG2E),
                      l, acc[..., :d]))
    m, l, acc = (torch.stack(p, dim=2) for p in zip(*parts))
    _, l_star, acc_star = ref.combine_split_states(m, l, acc)
    return ref.finalize_split_states(l_star, acc_star)


@pytest.mark.parametrize("quant", [False, True], ids=["K4", "K6c"])
@pytest.mark.parametrize("d", DIMS)
def test_prefill_wide_emulation_g7_one_pass_and_split(d, quant):
    """The prefill kernel's wide instance at G 7 (the flattened rows): one
    pass (``tc_emulate`` at 32 keys, one key group, the slices' sums)
    within bf16's tolerance of plain, and the partials at 2 splits merged
    as K5c does equal to one pass within fp32 rounding; both in float32
    within P's bound of the JAX kernels at 1 and 2 splits."""
    q, (kp, vp), (k8, v8, ks, vs), table = paged_inputs(d, 5, 900 + d)
    start = torch.tensor([12, 0], dtype=torch.int32)
    lens = torch.tensor([17, 3], dtype=torch.int32)
    kpool, vpool = (k8, v8) if quant else (kp.to(BF16), vp.to(BF16))
    scales = (ks, vs) if quant else (None, None)
    kw = dict(block_k=32, groups=1, width=rung(d))
    own = tc_emulate(q.to(BF16), kpool, vpool, table, start, lens, *scales,
                     **kw)
    want = ref.paged_prefill_ref(q.to(BF16), kpool, vpool, table, start,
                                 lens, k_scale=scales[0], v_scale=scales[1])
    close(own, want.float(), BF16, rows=(5, 3))
    jargs = [np.asarray(q), *(np.asarray(x) for x in (
        (k8, v8, ks, vs) if quant else (kpool.float(), vpool.float())))]
    jprefill = (jfa.flash_paged_prefill_quant if quant
                else jfa.flash_paged_prefill)
    atol = p_bound(ref.gather_pages(vpool, table)) * (
        float(vs.max()) if quant else 1.0)
    one = tc_emulate(q, kpool, vpool, table, start, lens, *scales, **kw)
    for ns in (1, 2):
        got = (one if ns == 1 else prefill_split_emulate(
            q, kpool, vpool, table, start, lens, ns, *scales,
            width=rung(d)))
        jwant = np.asarray(jprefill(*jargs, jnp_(table), jnp_(start),
                                    jnp_(lens), block_q=8, num_splits=ns,
                                    interpret=True))
        for lane, n in enumerate((5, 3)):
            np.testing.assert_allclose(got[lane, :, :n].numpy(),
                                       jwant[lane, :, :n], rtol=0, atol=atol)


# --------------------------------------------------------------------------
# the engine and a train step at d_head 320
# --------------------------------------------------------------------------


def small(cfg):
    """yi-6b's reduced config (4 q / 2 kv heads) at d_head 320."""
    return dataclasses.replace(cfg.reduced(), d_head=320)


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(small(JAX_ARCHS["yi-6b"]))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(small(get_arch("yi-6b")))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    jdraft, draft = jmodel.draft_model(), model.draft_model()
    return dict(jmodel=jmodel, jparams=jparams, model=model, params=params,
                jdraft=jdraft, jdparams=jmodel.slice_draft_params(jparams,
                                                                  jdraft),
                draft=draft, dparams=model.slice_draft_params(params, draft))


@pytest.mark.parametrize("mode", ["dense", "paged chunked", "int8 pages",
                                  "speculative"])
def test_engine_greedy_tokens_at_d320_identical_to_jax(pair, mode):
    """yi-6b reduced at d_head 320 (the card's wide instances of width 384
    for every kernel): the port's engine against the JAX engine."""
    assert fa.route("flash_paged_decode", BF16, 320) == (384, True)
    engine_tokens_match_jax(pair, mode)


def test_train_step_loss_and_gradients_at_d320_match_jax(pair):
    """One train step's loss and every gradient leaf at d_head 320 in
    float32 against ``jax.value_and_grad`` of the JAX ``train_loss`` on the
    same weights and numpy batch (test_torch_train_parity's tolerances)."""
    cfg = pair["model"].cfg
    batch = batches(cfg, 1)[0]
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    want_loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.train_loss(p, b)))(jparams, batch)
    want = flat(params_from_jax(to_numpy(jgrads), cfg, "cpu",
                                dtype=torch.float32))
    params = params_from_jax(to_numpy(jparams), cfg, "cpu",
                             dtype=torch.float32)
    leaves = flat(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = pair["model"].train_loss(params, torch_batch(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    assert set(leaves) == set(want)
    atol = grad_atol(want)
    for key, g in zip(leaves, grads):
        w = want[key].numpy()
        got = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(got, w, rtol=GRAD_RTOL, atol=atol[key],
                                   err_msg=key)

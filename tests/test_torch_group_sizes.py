"""Every GQA group size the Pallas prefill kernels take, in the port,
against the JAX package on the CPU.

The card's bf16 prefill and verify kernel (K4, K5b, K6c, K6d:
``csrc/paged_prefill.cu``) stacks the G query heads of a kv head into its
row tiles.  A tile holds BM consecutive rows of the kv head's C x G
(position, head) rows, row f being chunk row f // G of head f % G: where G
divides BM that is BM // G positions of all G heads (the fold it had, the
ladder calling the tile by ``block_q``), and where it does not (G 7, G 3
and 5 at D 160, G above 80) a tile spans no whole number of positions
(the ladder calling it by its rows).  Here, where the kernel cannot run:

* the flattened rows: at G 8 (32 rows), G 3 (48), G 5 (80) and G 1 the
  kernel's tiles (their rows, positions and the last position each tile
  walks to) and the plain split partition (``ref.paged_prefill_split_ref``
  at ``rows``) are today's, bit for bit; at G 7 the partition's merged
  output is within 1e-5 of the plain one-pass version and of the JAX
  kernel, and the tensor-core emulation (bf16 P) within 2^-8 (bf16's
  unit roundoff) max |v| + 1e-5 of both;
* the port's plain versions against the JAX kernels in interpret mode at
  G 3, 5, 6, 7, 9 and 12 by D 64, 128 and 160: K3, K5a, K6a, K6b (decode)
  and K4, K5b, K6c, K6d (prefill), float32 within 2e-5 and bfloat16 within
  2e-2 of the JAX kernel on the same bf16 values;
* the tables: every G from 1 to 128 has a prefill tile at every head dim
  up to 256, whose default the tile check takes; the run-time AT's ladders
  at Qwen2-7B's G 7 and at G 3 on D 160 list only tiles with an instance;
* the engine: yi-6b's reduced config with 7 query heads over 1 kv head
  (G 7) through the port's engine and the JAX engine: greedy tokens equal
  for dense lanes, the paged pool, int8 pages and speculative decoding.

Inputs come from numpy with seeds.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.distributed.compression import quantize_int8_rows
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch.serve import tile_ladders
from repro_torch.models import build_model
from test_torch_head_dims import MODES, close, engine_tokens_match_jax, values
from test_torch_prefill_tc import tc_emulate

jfa = importlib.import_module("repro.kernels.flash_attention")
torch.set_num_threads(1)

BF16 = torch.bfloat16
#: bf16's unit roundoff: rounding P (over int8 pools P times the value
#: scale) to bf16 moves each term by at most this share, so an output, a
#: convex combination of values, by at most this share of max |v|
P_BOUND = 2.0 ** -8
PSZ, NBLK = 8, 4
GROUPS = (3, 5, 6, 7, 9, 12)
GROUP_DIMS = (64, 128, 160)


def kernel_tiles(c: int, g: int, bm: int) -> list[tuple[list, int]]:
    """``paged_prefill.cu``'s query tiles of one kv head's chunk of ``c``
    positions at ``g`` heads and ``bm`` rows: for each tile the (chunk row,
    head) of its rows below C x G, and the offset from ``start`` of the
    last position it walks to (its last row's, rows past the chunk
    included)."""
    tiles = []
    for f0 in range(0, c * g, bm):
        rows = [(f // g, f % g) for f in range(f0, f0 + bm) if f // g < c]
        tiles.append((rows, (f0 + bm - 1) // g))
    return tiles


def folded_tiles(c: int, g: int, block_q: int) -> list[tuple[list, int]]:
    """The fold the kernel had where G divides its rows: tile t holds
    chunk rows t * block_q .. + block_q - 1 of all g heads, row r being
    chunk row t * block_q + r // g of head r % g."""
    tiles = []
    for i0 in range(0, c, block_q):
        rows = [(i0 + r // g, r % g) for r in range(block_q * g)
                if i0 + r // g < c]
        tiles.append((rows, i0 + block_q - 1))
    return tiles


@pytest.mark.parametrize("g,bm", [(8, 32), (3, 48), (5, 80), (1, 32),
                                  (4, 16), (2, 64)])
def test_flattened_rows_are_the_fold_where_g_divides_the_tile(g, bm):
    """Where G divides BM the flattened tiles are the fold's, row for row,
    with the same last position, so the launches (ceil(C * G / BM) tiles
    = ceil(C / block_q)) and the split partition are today's."""
    for c in (1, 5, 37, 128):
        got = kernel_tiles(c, g, bm)
        assert got == folded_tiles(c, g, bm // g)
        assert len(got) == -(-c // (bm // g))


def split_case(h, hkv, d, c, starts, valid, seed, quant=False):
    """q (B, H, c, d) and pools of bf16 values (int8 codes and scales
    quantized from them), a shuffled table, start and kv_len."""
    b = len(starts)
    q = values((b, h, c, d), seed)
    kp, vp = (values((b * NBLK + 1, hkv, PSZ, d), seed + i) for i in (1, 2))
    perm = np.random.default_rng(seed + 3).permutation(b * NBLK) + 1
    table = torch.from_numpy(perm.reshape(b, NBLK).astype(np.int32))
    start = torch.tensor(starts, dtype=torch.int32)
    lens = torch.tensor([s + v for s, v in zip(starts, valid)],
                        dtype=torch.int32)
    if quant:
        (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
        return q, (k8, v8, ks, vs), table, start, lens
    return q, (kp, vp, None, None), table, start, lens


@pytest.mark.parametrize("g,bm", [(8, 32), (3, 48), (5, 80)])
def test_flattened_partition_is_todays_bit_for_bit(g, bm):
    """The plain split prefill at the flattened tiles of ``bm`` rows gives
    the partials and output of ``block_q = bm // g``'s partition, bit for
    bit (4 splits of 8-key tiles, chunks of 9 at 20 and of 6 at 0)."""
    q, (kp, vp, _, _), table, start, lens = split_case(
        2 * g, 2, 16, 9, [20, 0], [9, 6], 40 + g)
    kw = dict(block_k=8)
    flat = ref.paged_prefill_split_ref(q, kp, vp, table, start, lens, 4,
                                       rows=bm, **kw)
    fold = ref.paged_prefill_split_ref(q, kp, vp, table, start, lens, 4,
                                       block_q=bm // g, **kw)
    assert torch.equal(flat[0], fold[0])
    assert all(torch.equal(a, b) for a, b in zip(flat[1], fold[1]))


@pytest.mark.parametrize("quant", [False, True], ids=["K5b", "K6d"])
@pytest.mark.parametrize("ns", [1, 2, 4])
def test_g7_flattened_split_against_plain_and_jax(ns, quant):
    """G 7 (28 q / 4 kv heads, Qwen2-7B's): the split partition at the
    flattened 32-row tile (a tile spans 4 4/7 positions) merged by K5c,
    within 1e-5 of the plain one-pass prefill and of the JAX
    ``flash_paged_prefill(_quant)`` at ``ns`` splits in interpret mode."""
    q, pools, table, start, lens = split_case(28, 4, 32, 7, [20, 0],
                                              [7, 5], 70, quant)
    k, v, ks, vs = pools
    got, (m, _, _) = ref.paged_prefill_split_ref(
        q, k, v, table, start, lens, ns, k_scale=ks, v_scale=vs,
        block_k=8, rows=32)
    assert m.shape == (2, 28, ns, 7)
    plain = ref.paged_prefill_ref(q, k, v, table, start, lens, k_scale=ks,
                                  v_scale=vs)
    kernel = (jfa.flash_paged_prefill_quant if quant
              else jfa.flash_paged_prefill)
    args = [np.asarray(x) for x in (q, k, v)] + (
        [np.asarray(ks), np.asarray(vs)] if quant else [])
    want = kernel(*args, jnp.asarray(table.numpy()),
                  jnp.asarray(start.numpy()), jnp.asarray(lens.numpy()),
                  block_q=8, num_splits=ns, interpret=True)
    for i, n in enumerate((7, 5)):
        np.testing.assert_allclose(got[i, :, :n].numpy(),
                                   plain[i, :, :n].numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[i, :, :n].numpy(),
                                   np.asarray(want)[i, :, :n], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["K4", "K6c"])
def test_g7_emulated_kernel_within_bound_of_plain_and_jax(quant):
    """The tensor-core kernel's emulation (bf16 products, P rounded to bf16
    before P.V, 128-key tiles of 4 key groups) at G 7 on float32 holding
    bf16 values: within 2^-8 max |v| + 1e-5 of the plain version and of
    the JAX kernel in interpret mode (the one-pass kernel's row tile
    changes nothing else: a key tile a row does not see adds nothing)."""
    q, pools, table, start, lens = split_case(28, 4, 32, 7, [20, 0], [7, 5],
                                              71, quant)
    k, v, ks, vs = pools
    got = tc_emulate(q, k, v, table, start, lens, ks, vs).numpy()
    plain = ref.paged_prefill_ref(q, k, v, table, start, lens, k_scale=ks,
                                  v_scale=vs).numpy()
    kernel = (jfa.flash_paged_prefill_quant if quant
              else jfa.flash_paged_prefill)
    args = [np.asarray(x) for x in (q, k, v)] + (
        [np.asarray(ks), np.asarray(vs)] if quant else [])
    want = np.asarray(kernel(*args, jnp.asarray(table.numpy()),
                             jnp.asarray(start.numpy()),
                             jnp.asarray(lens.numpy()), block_q=8,
                             interpret=True))
    v_max = float(ref._dequantize_pools(k, v, ks, vs)[1].abs().max())
    for i, n in enumerate((7, 5)):
        for other in (plain, want):
            np.testing.assert_allclose(got[i, :, :n], other[i, :, :n],
                                       rtol=0, atol=P_BOUND * v_max + 1e-5)


# --------------------------------------------------------------------------
# the port's plain versions against the JAX kernels (interpret mode)
# --------------------------------------------------------------------------


def group_heads(g: int) -> tuple[int, int]:
    """(H, Hkv) of a case at group size ``g``: 2 kv heads."""
    return 2 * g, 2


@pytest.mark.parametrize("d", GROUP_DIMS)
@pytest.mark.parametrize("g", GROUPS)
def test_paged_decode_plain_against_jax_at_group_size(g, d):
    """K3 and K6a in one pass, K5a's and K6b's partials at the kernels'
    key tiles merged by K5c at 3 splits, against the JAX kernels: lanes of
    29 and 7 keys, 2 kv heads."""
    h, hkv = group_heads(g)
    q, (kp, vp, _, _), table, _, lens = split_case(h, hkv, d, 1, [28, 6],
                                                   [1, 1], 100 * g + d)
    (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
    for quant in (False, True):
        kernel = (jfa.flash_paged_decode_quant if quant
                  else jfa.flash_paged_decode)
        pools = (k8, v8, ks, vs) if quant else (kp, vp)
        for ns in (1, 3):
            want = kernel(*(np.asarray(x) for x in (q, *pools)),
                          jnp.asarray(table.numpy()),
                          jnp.asarray(lens.numpy()), num_splits=ns,
                          interpret=True)
            for dtype in (torch.float32, BF16):
                qq = q.to(dtype)
                p = (ops.PagedPools(*pools) if quant else
                     ops.PagedPools(kp.to(dtype), vp.to(dtype)))
                if ns == 1:
                    got = ops.paged_decode(qq, p, table, lens)
                else:
                    got, _ = ref.paged_decode_split_tiles_ref(
                        qq, p.k, p.v, table, lens, ns, k_scale=p.k_scale,
                        v_scale=p.v_scale,
                        block_k=pa.decode_tile("k", qq, None))
                close(got, want, dtype)


@pytest.mark.parametrize("d", GROUP_DIMS)
@pytest.mark.parametrize("g", GROUPS)
def test_paged_prefill_plain_against_jax_at_group_size(g, d):
    """K4 and K6c in one pass, K5b's and K6d's partials at the kernels'
    default tiles (bf16: the row tile the ladder defaults to at (G, D),
    flattened where G divides none) merged by K5c at 2 splits, against the
    JAX kernels: chunks of 5 at 12 and of 3 at 0, 2 kv heads."""
    h, hkv = group_heads(g)
    q, (kp, vp, _, _), table, start, lens = split_case(
        h, hkv, d, 5, [12, 0], [5, 3], 200 * g + d)
    (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
    tiles = {BF16: dict(rows=pa.prefill_rows(d, g, pa.default_block_q(d, g)),
                        block_k=pa.default_block_k(BF16, d)),
             torch.float32: dict(zip(("block_q", "block_k"),
                                     pa.SIMT_PREFILL_TILE))}
    for quant in (False, True):
        kernel = (jfa.flash_paged_prefill_quant if quant
                  else jfa.flash_paged_prefill)
        pools = (k8, v8, ks, vs) if quant else (kp, vp)
        for ns in (1, 2):
            want = kernel(*(np.asarray(x) for x in (q, *pools)),
                          jnp.asarray(table.numpy()),
                          jnp.asarray(start.numpy()),
                          jnp.asarray(lens.numpy()), block_q=8,
                          num_splits=ns, interpret=True)
            for dtype in (torch.float32, BF16):
                qq = q.to(dtype)
                p = (ops.PagedPools(*pools) if quant else
                     ops.PagedPools(kp.to(dtype), vp.to(dtype)))
                if ns == 1:
                    got = ops.paged_prefill(qq, p, table, start, lens)
                else:
                    got, _ = ref.paged_prefill_split_ref(
                        qq, p.k, p.v, table, start, lens, ns,
                        k_scale=p.k_scale, v_scale=p.v_scale,
                        **tiles[dtype])
                close(got, want, dtype, rows=(5, 3))


# --------------------------------------------------------------------------
# the tables
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [range(1, 65), range(65, 129),
                                  range(129, 193), range(193, 257)],
                         ids=["1-64", "65-128", "129-192", "193-256"])
def test_every_group_size_has_a_prefill_tile_at_every_head_dim(dims):
    """G 1 .. 128 at every head dim: a bf16 tile whose default the tile
    check takes, its rows an instance's row tile (G x block_q where G
    divides it, else the rows themselves)."""
    for d in dims:
        rows = pa.tc_row_tiles(d)
        for g in range(1, 129):
            block_qs, block_ks = pa.prefill_tiles(BF16, d, g)
            assert block_qs and block_ks, (d, g)
            q = torch.zeros(1, g, 1, d, dtype=BF16)
            bq, bk = pa.prefill_tile("k", q, 1, None, None)
            assert bq in block_qs and bk in block_ks
            assert all(pa.prefill_rows(d, g, b) in rows for b in block_qs)
            pa.check_tc_shape("k", g, 1, d)


class _Model:
    def __init__(self, cfg):
        self.cfg = cfg


@pytest.mark.parametrize("h,hkv,d,block_qs,block_ks", [
    (28, 4, 128, (32,), (128,)), (24, 8, 160, (32,), (128,)),
    (32, 4, 128, (2, 4, 8), pa.TC_BLOCK_KS)])
def test_run_time_ladders_at_other_group_sizes(h, hkv, d, block_qs,
                                               block_ks):
    """``tile_ladders`` on yi-6b's widths with Qwen2-7B's 28 q / 4 kv heads
    (G 7) and with 24 / 8 at D 160 (G 3): the flattened instances' one
    tile, 32 rows by 128 keys, named by its rows; yi-6b's own G 8 as it
    was.  Every tile it lists has an instance."""
    cfg = dataclasses.replace(get_arch("yi-6b"), n_heads=h, n_kv_heads=hkv,
                              d_head=d)
    ladders = tile_ladders(_Model(cfg), 16)
    assert ladders["block_q"] == block_qs
    assert ladders["prefill_block_k"] == block_ks
    q = torch.zeros(1, h, 1, d, dtype=BF16)
    for bq in ladders["block_q"]:
        for bk in ladders["prefill_block_k"]:
            assert pa.prefill_tile("k", q, hkv, bq, bk) == (bq, bk)
    assert pa.flattened(d, h // hkv) == (h // hkv != 8)


# --------------------------------------------------------------------------
# the engine at G 7
# --------------------------------------------------------------------------


def small(cfg):
    """yi-6b's reduced config with 7 q heads over 1 kv head (G 7)."""
    return dataclasses.replace(cfg.reduced(), n_heads=7, n_kv_heads=1)


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


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_greedy_tokens_at_g7_identical_to_jax(pair, mode):
    """yi-6b reduced with 7 q heads over 1 kv head (the card's flattened
    prefill rows, on the padded instance of width 64): the port's engine
    against the JAX engine."""
    assert pa.flattened(16, 7) and pa.prefill_route(
        "flash_paged_prefill", BF16, 16, 7) == (64, True)
    engine_tokens_match_jax(pair, mode)

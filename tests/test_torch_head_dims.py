"""Every head dim the Pallas attention kernels take, in the port, against
the JAX package on the CPU.

The card's attention kernels (K1-K6d, ``csrc/*.cu``) have instances of
their own at a few head dims (``fa.head_dims``) and padded instances at the
widths of ``fa.PADDED_HEAD_DIMS``: a head dim d with no instance of its own
runs on the smallest width DP >= d, its columns past d zero in shared
memory and never stored (``fa.route``).  Up to 512 every d has a route
(above 256 on the wide rungs, ``tests/test_torch_wide_heads.py``); 513 and
above raise ``ValueError`` naming the limit.  Here, where the kernels
cannot run:

* the tables: every d from 1 to 512 has a route and tiles for every
  kernel and query type, the tiles of a padded instance are its defaults,
  and d 513 raises;
* the port's plain versions (what its wrappers run on a CPU tensor, and
  the phase-1 partials of the split routes cut at the kernels' tiles)
  against the JAX kernels in interpret mode at d 8, 24, 36, 80, 96, 100,
  112, 160 and 256, G 7 (7 q heads over 1 kv head), float32 and bfloat16,
  bf16 and int8 pools, one pass and split: float32 within 2e-5, bfloat16
  within its tolerance 2e-2 (rtol = atol) of the JAX kernel on the same
  values (the inputs are bf16 values, so the only difference is the
  output's rounding);
* the emulations of the tensor-core kernels' arithmetic (K1, K2/K3, K4;
  ``tests/test_torch_*_tc.py``) at a padded width DP > d: bit-equal to the
  unpadded emulation, since the zero columns add exact zeros to Q.K^T in
  the mma's 16-deep steps and P.V's extra columns are dropped;
* the engine: yi-6b's reduced config at d_head 24 (no instance of its own:
  the padded one of width 64 on the card) through the port's engine and
  the JAX engine: greedy tokens equal for dense lanes, the paged pool,
  int8 pages and speculative decoding.

Inputs come from numpy with seeds.
"""
import contextlib
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.distributed.compression import quantize_int8_rows
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch.serve import tile_ladders
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine
from test_torch_attention_tc import k1_emulate
from test_torch_decode_tc import decode_tc_emulate, dense_tc_emulate
from test_torch_prefill_tc import tc_emulate

# the module: ``repro.kernels`` re-exports its functions under the same
# names
jfa = importlib.import_module("repro.kernels.flash_attention")
torch.set_num_threads(1)

BF16 = torch.bfloat16
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)         # chip_smoke.py's TOL[bf16]
DIMS = (8, 24, 36, 80, 96, 100, 112, 160, 256)
H, HKV = 7, 1                                  # G 7
PSZ, NBLK = 8, 4
KERNEL_NAMES = ("flash_attention", "flash_decode", "flash_paged_decode",
                "flash_paged_prefill")


def values(shape, seed):
    """Seeded normal values that bf16 holds exactly, as float32."""
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).to(BF16).float()


def close(got: torch.Tensor, want, dtype, rows=None) -> None:
    """``got`` (the port, in ``dtype``) against ``want`` (the JAX kernel
    in float32) at the tolerance of ``dtype``; ``rows`` (per lane) keeps
    each lane's valid chunk rows."""
    got = got.float().numpy()
    want = np.asarray(want)
    tol = BF16_TOL if dtype == BF16 else F32_TOL
    if rows is None:
        np.testing.assert_allclose(got, want, **tol)
        return
    for i, n in enumerate(rows):
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], **tol)


def paged_inputs(d, c, seed):
    """q (2, H, c, d), pools of 9 pages, a shuffled table, int8 codes and
    scales quantized from the pools."""
    q = values((2, H, c, d), seed)
    kp, vp = values((9, HKV, PSZ, d), seed + 1), values((9, HKV, PSZ, d),
                                                         seed + 2)
    perm = np.random.default_rng(seed + 3).permutation(8) + 1
    table = torch.from_numpy(perm.reshape(2, NBLK).astype(np.int32))
    (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
    return q, (kp, vp), (k8, v8, ks, vs), table


# --------------------------------------------------------------------------
# the tables
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_every_head_dim_to_512_has_a_route_and_tiles(name, dtype):
    """d 1 .. 512: the head dim's own instance where the kernel has one,
    else the padded instance of the smallest width at or above it, whose
    tiles are the defaults alone; every tile the tables publish has an
    instance (the tile checks take it)."""
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        rt = fa.route(name, dtype, d)
        own = d in fa.head_dims(name, dtype)
        assert rt == (d, False) if own else rt == (
            min(w for w in fa.PADDED_HEAD_DIMS if w >= d), True)
        q = torch.zeros(1, H, 1, d, dtype=dtype)
        if name == "flash_attention":
            tiles = fa.attention_tiles(dtype, d)
            assert len(tiles) == 1 or not rt.padded
            for tile in tiles:
                assert fa.attention_tile(name, q, *tile) == tile
        elif name == "flash_paged_prefill":
            block_qs, block_ks = pa.prefill_tiles(dtype, d, H // HKV)
            assert block_qs and block_ks
            for bq in block_qs:
                for bk in block_ks:
                    assert pa.prefill_tile(name, q, HKV, bq, bk) == (bq, bk)
        else:
            ks = pa.decode_block_ks(dtype, d, dense=name == "flash_decode")
            assert ks and (len(ks) == 1 or not rt.padded)
            for bk in ks:
                assert pa.decode_tile(name, q, bk) == bk


@pytest.mark.parametrize("d", [513, 544, 640])
def test_head_dims_above_512_raise_naming_the_limit(d):
    """Above the wide rungs (512) there is no instance: the tables and the
    checks raise ``ValueError`` naming the limit and its reason (the
    float32 templates' shared memory at the next rung, 640)."""
    for name in KERNEL_NAMES:
        with pytest.raises(ValueError, match="1..512.*shared memory"):
            fa.route(name, BF16, d)
    with pytest.raises(ValueError, match="1..512"):
        pa.check_tc_shape("flash_paged_prefill", 8, 1, d)
    assert pa.prefill_tiles(BF16, d, 8) == ((), ())
    # the reason: the float32 templates' 32-row tile at the next rung
    assert fa.simt_smem_bytes(640) == 249_984 > 227 * 1024


@pytest.mark.parametrize("width", [None, 64, 96, 128, 192, 256])
def test_forced_width_takes_only_a_rung_at_or_above_d(width):
    """The private ``fa._forced_width`` (the card's bit-equality check)
    names a padded instance, a rung at or above d, which every route and
    tile table in its block answers for; outside it the head dim's own."""
    forced = (contextlib.nullcontext() if width is None
              else fa._forced_width(width))
    with forced:
        rt = fa.route("flash_paged_decode", BF16, 64)
        rows = pa.tc_row_tiles(64)
        g3 = pa.prefill_route("flash_paged_prefill", BF16, 64, 3)
    assert rt == ((64, False) if width is None else (width, True))
    assert rows == (pa.TC_TILE_ROWS,)
    assert g3 == (width or 64, True)
    assert fa.route("flash_paged_decode", BF16, 64) == (64, False)
    for bad in (80, 32, 300):
        with pytest.raises(ValueError, match="padded instance"):
            with fa._forced_width(bad):
                pass
    with fa._forced_width(64), pytest.raises(ValueError,
                                             match="padded instance"):
        fa.route("flash_paged_decode", BF16, 96)


class _Model:
    def __init__(self, cfg):
        self.cfg = cfg


@pytest.mark.parametrize("d", [96, 100, 256])
def test_run_time_ladders_publish_only_instanced_tiles(d):
    """``tile_ladders`` at yi-6b's widths with d_head ``d`` (no instance
    of its own: the padded ones): every tile it lists has an instance
    (the wrappers' tile checks take it), the decode and prefill key tiles
    are the padded instances' defaults."""
    cfg = dataclasses.replace(get_arch("yi-6b"), d_head=d)
    ladders = tile_ladders(_Model(cfg), 16)
    g = cfg.n_heads // cfg.n_kv_heads
    q = torch.zeros(1, cfg.n_heads, 1, d, dtype=BF16)
    assert ladders["dense_block_k"] == ladders["block_k"] == (64,)
    assert ladders["prefill_block_k"] == (pa.padded_block_k(
        fa.route("flash_paged_prefill", BF16, d).width),)
    for bk in ladders["block_k"]:
        pa.decode_tile("flash_paged_decode", q, bk)
        pa.decode_tile("flash_decode", q, bk)
    for bq in ladders["block_q"]:
        for bk in ladders["prefill_block_k"]:
            assert pa.prefill_tile("flash_paged_prefill", q, cfg.n_kv_heads,
                                   bq, bk) == (bq, bk)
    assert ladders["block_q"] == (32 // g,)


# --------------------------------------------------------------------------
# the port's plain versions against the JAX kernels (interpret mode)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("d", DIMS)
def test_k1_plain_against_jax_kernel(d):
    """K1: causal self-attention of 20 rows at G 7, float32 and
    bfloat16."""
    q, k, v = values((1, H, 20, d), d), values((1, HKV, 20, d), d + 1), \
        values((1, HKV, 20, d), d + 2)
    want = jfa.flash_attention(*(np.asarray(x) for x in (q, k, v)),
                               causal=True, block_q=16, block_k=16,
                               interpret=True)
    for dtype in (torch.float32, BF16):
        got = ops.attention(q.to(dtype), k.to(dtype), v.to(dtype),
                            causal=True)
        close(got, want, dtype)


@pytest.mark.parametrize("d", DIMS)
def test_k2_plain_against_jax_kernel(d):
    """K2: one token over dense caches of 24 slots, lanes of 24 and 9
    keys, G 7."""
    q, k, v = values((2, H, 1, d), d), values((2, HKV, 24, d), d + 1), \
        values((2, HKV, 24, d), d + 2)
    lens = torch.tensor([24, 9], dtype=torch.int32)
    want = jfa.flash_decode(*(np.asarray(x) for x in (q, k, v)),
                            jnp.asarray(lens.numpy()), block_k=8,
                            interpret=True)
    for dtype in (torch.float32, BF16):
        got = ops.decode_attention(q.to(dtype), k.to(dtype), v.to(dtype),
                                   lens)
        close(got, want, dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d", DIMS)
def test_paged_decode_plain_against_jax_kernels(d, quant):
    """K3 (K6a over int8 pools) and, at 3 splits, K5a's (K6b's) partials
    at the kernels' key tiles (the bf16 kernel's 64, the SIMT template's
    32) merged by K5c, against the JAX
    ``flash_paged_decode(_quant)`` at 1 and 3 splits: lanes of 29 and 7
    keys in shuffled pages of 8, G 7."""
    q, (kp, vp), (k8, v8, ks, vs), table = paged_inputs(d, 1, 300 + d)
    lens = torch.tensor([29, 7], dtype=torch.int32)
    args = [np.asarray(q), *(np.asarray(x) for x in (
        (k8, v8, ks, vs) if quant else (kp, vp)))]
    kernel = jfa.flash_paged_decode_quant if quant else jfa.flash_paged_decode
    pools = (ops.PagedPools(k8, v8, ks, vs) if quant
             else ops.PagedPools(kp, vp))
    for ns in (1, 3):
        want = kernel(*args, jnp.asarray(table.numpy()),
                      jnp.asarray(lens.numpy()), num_splits=ns,
                      interpret=True)
        for dtype in (torch.float32, BF16):
            qq = q.to(dtype)
            fp = ops.PagedPools(kp.to(dtype), vp.to(dtype))
            p = pools if quant else fp
            if ns == 1:
                got = ops.paged_decode(qq, p, table, lens)
            else:
                got, _ = ref.paged_decode_split_tiles_ref(
                    qq, p.k, p.v, table, lens, ns, k_scale=p.k_scale,
                    v_scale=p.v_scale,
                    block_k=pa.decode_tile("flash_paged_decode", qq, None))
            close(got, want, dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d", DIMS)
def test_paged_prefill_plain_against_jax_kernels(d, quant):
    """K4 (K6c over int8 pools) and, at 2 splits, K5b's (K6d's) partials
    at the kernels' default tiles (bf16: the flattened 32 rows at G 7 by
    the instance's keys; float32: the SIMT template's 64 by 32) merged by
    K5c, against the JAX ``flash_paged_prefill(_quant)`` at 1 and 2
    splits: a chunk of 5 at 12 and one of 3 at 0, G 7."""
    q, (kp, vp), (k8, v8, ks, vs), table = paged_inputs(d, 5, 500 + d)
    start = torch.tensor([12, 0], dtype=torch.int32)
    lens = torch.tensor([17, 3], dtype=torch.int32)
    args = [np.asarray(q), *(np.asarray(x) for x in (
        (k8, v8, ks, vs) if quant else (kp, vp)))]
    kernel = (jfa.flash_paged_prefill_quant if quant
              else jfa.flash_paged_prefill)
    g = H // HKV
    tiles = {BF16: dict(rows=pa.prefill_rows(d, g, pa.default_block_q(d, g)),
                        block_k=pa.default_block_k(BF16, d)),
             torch.float32: dict(zip(("block_q", "block_k"),
                                     pa.SIMT_PREFILL_TILE))}
    for ns in (1, 2):
        want = kernel(*args, jnp.asarray(table.numpy()),
                      jnp.asarray(start.numpy()), jnp.asarray(lens.numpy()),
                      block_q=8, num_splits=ns, interpret=True)
        for dtype in (torch.float32, BF16):
            qq = q.to(dtype)
            p = (ops.PagedPools(k8, v8, ks, vs) if quant
                 else ops.PagedPools(kp.to(dtype), vp.to(dtype)))
            if ns == 1:
                got = ops.paged_prefill(qq, p, table, start, lens)
            else:
                got, _ = ref.paged_prefill_split_ref(
                    qq, p.k, p.v, table, start, lens, ns, k_scale=p.k_scale,
                    v_scale=p.v_scale, **tiles[dtype])
            close(got, want, dtype, rows=(5, 3))


# --------------------------------------------------------------------------
# the tensor-core kernels' emulations on a padded instance
# --------------------------------------------------------------------------

# (d, the padded width): d with an instance of its own forced onto a wider
# rung, as chip_smoke.py's phase 39 (d) does on the card, and d without one
PADDED = [(80, 96), (112, 128), (64, 96), (128, 160), (96, 128), (160, 256)]


@pytest.mark.parametrize("d,width", PADDED)
def test_k1_emulation_on_a_padded_instance_is_bit_equal(d, width):
    """K1's emulation with q, K and V zero-padded to ``width`` gives the
    same bits as at ``d``: Q.K^T's extra 16-deep steps add exact zeros."""
    q = values((1, 8, 70, d), d).to(BF16)
    k, v = values((1, 2, 70, d), d + 1).to(BF16), values((1, 2, 70, d),
                                                         d + 2).to(BF16)
    own = k1_emulate(q, k, v, width=d)
    assert torch.equal(k1_emulate(q, k, v, width=width), own)
    np.testing.assert_allclose(
        own.float().numpy(), ref.attention_ref(q, k, v).float().numpy(),
        **BF16_TOL)


@pytest.mark.parametrize("d,width", PADDED)
def test_decode_emulation_on_a_padded_instance_is_bit_equal(d, width):
    """The decode kernel's emulation (K3 over paged pools at 2 CTAs a
    cluster, K2 over dense strips) padded to ``width``: bit-equal."""
    q, (kp, vp), _, table = paged_inputs(d, 1, 700 + d)
    q, kp, vp = q.to(BF16), kp.to(BF16), vp.to(BF16)
    lens = torch.tensor([29, 7], dtype=torch.int32)
    own = decode_tc_emulate(q, kp, vp, table, lens, cluster=2, width=d)
    assert torch.equal(decode_tc_emulate(q, kp, vp, table, lens, cluster=2,
                                         width=width), own)
    strips = ref.gather_pages(kp, table)
    assert torch.equal(dense_tc_emulate(q, strips, strips, lens, width=width),
                       dense_tc_emulate(q, strips, strips, lens, width=d))
    np.testing.assert_allclose(
        own.float().numpy(),
        ref.paged_decode_ref(q, kp, vp, table, lens).float().numpy(),
        **BF16_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["K4", "K6c"])
@pytest.mark.parametrize("d,width", PADDED)
def test_prefill_emulation_on_a_padded_instance_is_bit_equal(d, width,
                                                             quant):
    """The prefill kernel's emulation over bf16 or int8 pools padded to
    ``width``: bit-equal (int8 codes are zero-padded like the bf16
    rows)."""
    q, (kp, vp), (k8, v8, ks, vs), table = paged_inputs(d, 5, 900 + d)
    start = torch.tensor([12, 0], dtype=torch.int32)
    lens = torch.tensor([17, 3], dtype=torch.int32)
    pools = (k8, v8, ks, vs) if quant else (kp.to(BF16), vp.to(BF16), None,
                                            None)
    q = q.to(BF16)
    kv, scales = pools[:2], pools[2:]
    own = tc_emulate(q, *kv, table, start, lens, *scales, width=d)
    assert torch.equal(tc_emulate(q, *kv, table, start, lens, *scales,
                                  width=width), own)
    want = ref.paged_prefill_ref(q, *pools[:2], table, start, lens,
                                 k_scale=pools[2], v_scale=pools[3])
    close(own, want.float(), BF16, rows=(5, 3))


# --------------------------------------------------------------------------
# the engine at d_head 24
# --------------------------------------------------------------------------


def small(cfg):
    """yi-6b's reduced config (4 q / 2 kv heads) at d_head 24."""
    return dataclasses.replace(cfg.reduced(), d_head=24)


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


def _requests(n=3, plen=11, max_new=6):
    return [(i, [1 + i] + [(3 * i + j) % 90 + 2 for j in range(plen - 1)],
             max_new) for i in range(n)]


# engine keyword arguments of each mode, shared by both packages; the
# port's own extras (num_splits) in the second dict
MODES = {
    "dense": (dict(n_lanes=2, max_len=48), {}),
    "paged chunked": (dict(n_lanes=2, max_len=48, cache="paged",
                           page_size=8, prefill_chunk=4), {}),
    "int8 pages": (dict(n_lanes=2, max_len=48, cache="paged", page_size=8,
                        prefill_chunk=8, kv_dtype="int8"),
                   dict(num_splits=2)),
    "speculative": (dict(n_lanes=2, max_len=48, cache="paged", page_size=8,
                         prefill_chunk=8, spec_k=2), dict(num_splits=2)),
}


def engine_tokens_match_jax(pair, mode) -> None:
    """Greedy tokens of the port's engine equal the JAX engine's in
    ``mode`` (of :data:`MODES`), with the same steps and draft stats."""
    shared, extra = MODES[mode]
    port, jax_ = dict(shared, **extra), dict(shared)
    if "spec_k" in shared:
        port.update(draft_model=pair["draft"], draft_params=pair["dparams"])
        jax_.update(draft_model=pair["jdraft"],
                    draft_params=pair["jdparams"])
    eng = ServingEngine(pair["model"], pair["params"], **port)
    jeng = JaxEngine(pair["jmodel"], pair["jparams"], **jax_)
    reqs = _requests()
    for rid, prompt, max_new in reqs:
        eng.submit(Request(rid=rid, prompt=list(prompt),
                           max_new_tokens=max_new))
        jeng.submit(JaxRequest(rid=rid, prompt=list(prompt),
                               max_new_tokens=max_new))
    got = {r.rid: r.out_tokens for r in eng.run(max_steps=400)}
    want = {r.rid: r.out_tokens for r in jeng.run(max_steps=400)}
    assert got == want
    assert all(len(got[rid]) == max_new for rid, _, max_new in reqs)
    assert eng.steps == jeng.steps
    if "spec_k" in shared:
        assert eng.spec_stats() == jeng.spec_stats()
        assert eng.spec_ticks > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_greedy_tokens_at_d24_identical_to_jax(pair, mode):
    """yi-6b reduced at d_head 24 (the card's padded instances of width
    64 for every kernel): the port's engine against the JAX engine."""
    assert fa.route("flash_paged_decode", BF16, 24) == (64, True)
    engine_tokens_match_jax(pair, mode)

"""pixtral-12b in the port against the JAX package on the CPU.

pixtral-12b is mistral-nemo's decoder (an ``attn_mlp`` stack, 32 query
heads over 8 kv heads at d_model 5120: D 160, G 4) behind a vision stub:
1024 precomputed patch embeddings, projected by ``frontend_proj`` and put
in front of the text.  Its reduced config has D 16 and G 2, so a second
small config at pixtral's geometry (2 layers, d_model 640, 4 q / 1 kv
heads: D 160, G 4, 8 patches) is built on both sides by the same
``dataclasses.replace``.  At each:

* the config copy equals the JAX package's, field by field, and so does
  the analytic parameter count;
* the bridge carries ``frontend_proj`` across;
* ``forward`` and ``prefill`` with ``frontend_embeds``, and decode steps
  after such a prefill, equal the JAX model's at 1e-4 (float32);
* greedy tokens equal the JAX ``ServingEngine``'s, which serves the arch
  text-only, on dense lanes and on the paged pool: chunked prefill, int8
  pages (with split-KV on the port's side) and speculative decoding.

The card's kernels at D 160 cannot run here, so the emulations of their
arithmetic and tiling (``test_torch_attention_tc``, ``test_torch_decode_tc``
and ``test_torch_prefill_tc``) stand in for them at pixtral's G 4: K1 at
its four tiles, K2, K3 and K6a at both key tiles and every cluster size,
K5a and K6b merged, K4 and K6c at every tile of the D-160 ladder, K5b and
K6d's partials, each against the plain version and the JAX Pallas kernel
in interpret mode, with the bounds those files derive.  The D-160 tile
tables, the run-time AT's ladders and the cluster rule are checked
without a launch.

Inputs are made with numpy from seeds and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attention_tc import (BF16_ROUNDOFF, FP32_SUMS, chunk_case,
                                     k1_emulate, quantized, split_emulate)
from test_torch_decode_tc import (FP32_TERM, P_BOUND, decode_tc_emulate,
                                  dense_tc_emulate, split_tc_emulate,
                                  weighted_abs_v)
from test_torch_decode_tc import case_inputs as decode_inputs
from test_torch_prefill_tc import P_ROUNDING, key_groups, tc_emulate
from test_torch_prefill_tc import case_inputs as prefill_inputs

from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels.flash_attention import flash_attention as jax_attention
from repro.kernels.flash_attention import flash_decode as jax_flash_decode
from repro.kernels.flash_attention import flash_paged_decode as jax_paged_decode
from repro.kernels.flash_attention import \
    flash_paged_decode_quant as jax_paged_decode_quant
from repro.kernels.flash_attention import \
    flash_paged_prefill as jax_paged_prefill
from repro.kernels.flash_attention import \
    flash_paged_prefill_quant as jax_paged_prefill_quant
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.registry import NOT_PORTED
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.launch.serve import ServeConfig, serve_config, tile_ladders
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine

torch.set_num_threads(1)

ARCH = "pixtral-12b"
TOL = dict(rtol=1e-4, atol=1e-4)
BF16 = torch.bfloat16
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab_size", "rope_theta", "window", "compute_dtype",
          "cache_dtype", "tie_embeddings", "qkv_bias", "family", "frontend",
          "frontend_seq", "norm", "act", "use_rope")
#: pixtral's geometry at a small width: D 160, G 4
D160 = dict(d_model=640, n_heads=4, n_kv_heads=1, d_head=160)


def small(cfg, name: str):
    """The reduced config (D 16, G 2) or its D-160 variant (4 q / 1 kv
    heads of 160)."""
    cfg = cfg.reduced()
    return cfg if name == "D16" else dataclasses.replace(cfg, **D160)


@pytest.mark.parametrize("size", ["full", "D16", "D160"])
def test_config_copy_matches_jax(size):
    want, got = JAX_ARCHS[ARCH], ARCHS[ARCH]
    if size != "full":
        want, got = small(want, size), small(got, size)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.head_dim == want.head_dim
    assert got.padded_vocab == want.padded_vocab
    assert got.param_count() == want.param_count()
    assert got.layer_kinds() == want.layer_kinds() == ["attn_mlp"] * \
        got.n_layers
    assert (got.head_dim, got.n_heads // got.n_kv_heads, got.frontend_seq) \
        == {"full": (160, 4, 1024), "D16": (16, 2, 8),
            "D160": (160, 4, 8)}[size]


def test_pixtral_is_registered_and_nothing_waits():
    assert get_arch(ARCH) is ARCHS[ARCH]
    assert NOT_PORTED == {}
    assert set(ARCHS) == set(JAX_ARCHS)
    full = get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size, full.frontend) == (
        40, 5120, 32, 8, 160, 14336, 131072, "vision")
    # 12.77 B parameters in the analytic count (as the JAX package's, which
    # leaves out frontend_proj's 26 M): 25.5 GB of bf16 weights
    assert 12.7e9 < full.param_count() < 12.8e9
    assert build_model(full).supports_paged_cache


def test_init_params_holds_the_patch_projection():
    """The port's own random weights of a vision arch carry ``frontend_proj``
    (d x d); a decoder arch without a frontend has none."""
    cfg = small(get_arch(ARCH), "D160")
    params = build_model(cfg).init(0, "cpu")
    assert params["frontend_proj"].shape == (cfg.d_model, cfg.d_model)
    assert "frontend_proj" not in build_model(
        get_arch("yi-6b").reduced()).init(0, "cpu")


@pytest.fixture(scope="module", params=["D16", "D160"])
def pair(request):
    """(jax model, jax params, port model, port params, drafts) at one of
    the two small configs."""
    jmodel = jax_build_model(small(JAX_ARCHS[ARCH], request.param))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(small(get_arch(ARCH), request.param))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    jdraft, draft = jmodel.draft_model(), model.draft_model()
    return dict(jmodel=jmodel, jparams=jparams, model=model, params=params,
                jdraft=jdraft, jdparams=jmodel.slice_draft_params(jparams,
                                                                  jdraft),
                draft=draft, dparams=model.slice_draft_params(params, draft))


def test_bridge_carries_the_patch_projection(pair):
    params, jparams = pair["params"], pair["jparams"]
    d = pair["model"].cfg.d_model
    assert params["frontend_proj"].shape == (d, d)
    np.testing.assert_array_equal(params["frontend_proj"].numpy(),
                                  np.asarray(jparams["frontend_proj"]))


def _patches(cfg, b: int, seed: int) -> np.ndarray:
    """``frontend_seq`` seeded patch embeddings per lane, (B, F, d)."""
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)


TOKENS = np.array([[3, 17, 42, 9, 250, 64, 7], [5, 1, 88, 13, 2, 200, 31]],
                  np.int32)


def test_forward_with_frontend_embeds_matches_jax(pair):
    """The hidden states of F patches and S tokens, (B, F + S, d)."""
    cfg = pair["model"].cfg
    fe = _patches(cfg, 2, 11)
    jh, _ = pair["jmodel"].forward(pair["jparams"], TOKENS, fe)
    h, aux = pair["model"].forward(pair["params"],
                                   torch.from_numpy(TOKENS).long(),
                                   frontend_embeds=torch.from_numpy(fe))
    assert h.shape == (2, cfg.frontend_seq + TOKENS.shape[1], cfg.d_model)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("vision", [True, False], ids=["patches", "text"])
def test_prefill_and_decode_logits_match_jax(pair, vision):
    """A prefill with the patches in front of the prompt (the caches hold
    F + S positions), or of the prompt alone, then 3 greedy decode steps
    that continue at position F + S (or S)."""
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    model, params = pair["model"], pair["params"]
    fe = _patches(model.cfg, 2, 12) if vision else None
    jlogits, jcaches = jmodel.prefill(jparams, TOKENS, fe, 32)
    logits, caches = model.prefill(
        params, torch.from_numpy(TOKENS).long(), 32,
        frontend_embeds=None if fe is None else torch.from_numpy(fe))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(caches["kv"][0].numpy(),
                               np.asarray(jcaches["kv"][0]), **TOL)
    s = TOKENS.shape[1] + (model.cfg.frontend_seq if vision else 0)
    assert caches["kv"][0].shape[3] == 32
    tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)[:, None]
    for step in range(3):
        pos = np.full((2,), s + step, np.int32)
        jlogits, jcaches = jmodel.decode_step(jparams, jcaches, tok, pos)
        logits, caches = model.decode_step(params, caches,
                                           torch.from_numpy(tok).long(),
                                           torch.from_numpy(pos).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        tok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)[:, None]


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


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_greedy_tokens_identical_to_jax(pair, mode):
    """Text-only serving, as the JAX engine serves the arch (a request
    carries no patches)."""
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


def test_serve_config_runs_pixtral_on_cpu():
    out = serve_config(ServeConfig(arch=ARCH, device="cpu", n_requests=2,
                                   n_lanes=2, max_new=3, prompt_len=6,
                                   cache="paged", page_size=8,
                                   prefill_chunk=4))
    assert out["finished"] == 2
    assert all(len(t) == 3 for t in out["outputs"].values())


# --------------------------------------------------------------------------
# the card's kernels at D 160, on the CPU (no launch): tables and ladders
# --------------------------------------------------------------------------


def test_d160_routes_and_tiles():
    """K1 (both query types), the bf16 K2 and the bf16 paged kernels have
    instances of their own at D 160; the float32 K2 and the paged kernels'
    float32 templates, which were refused, run on the padded instances of
    width 160 (5 columns a decode lane).  K1 has D 128's four tiles, the
    decode kernels key tiles 32 and 64, the prefill kernels rows 16, 32
    and 64 (block_q 4, 8 and 16 at G 4) by keys 64 and 128; G 3 and 5,
    whose 48- and 80-row tiles exist at D 128 only, take the flattened
    instances, whose one tile (32 rows by 128 keys) the ladder names by
    its rows."""
    assert 160 in fa.DENSE_HEAD_DIMS and 160 in fa.TILED_HEAD_DIMS
    assert 160 in fa.PAGED_HEAD_DIMS and 160 not in fa.HEAD_DIMS
    assert fa.head_dims("flash_attention", torch.float32) == \
        fa.DENSE_HEAD_DIMS
    assert 160 in fa.head_dims("flash_paged_decode", BF16)
    for name in ("flash_decode", "flash_paged_decode"):
        assert 160 not in fa.head_dims(name, torch.float32)
        assert fa.route(name, torch.float32, 160) == (160, True)
    assert fa.attention_tiles(BF16, 160) == fa.attention_tiles(BF16, 128)
    assert fa.smem_bytes(64, 64, 160) == 107_520
    assert fa.smem_bytes(128, 128, 160) == 215_040
    assert pa.decode_block_ks(BF16, 160) == pa.DECODE_BLOCK_KS == (32, 64)
    assert pa.prefill_tiles(BF16, 160, 4) == ((4, 8, 16), pa.TC_BLOCK_KS)
    assert pa.prefill_tiles(BF16, 160, 1) == ((16, 32, 64), pa.TC_BLOCK_KS)
    assert pa.prefill_tiles(torch.float32, 160, 4) == ((64,), (32,))
    assert pa.default_block_q(160, 4) == 8
    pa.check_tc_shape("k", 32, 8, 160)
    for h in (24, 40):
        pa.check_tc_shape("k", h, 8, 160)
        assert pa.flattened(160, h // 8)
        assert pa.prefill_tiles(BF16, 160, h // 8) == ((32,), (128,))
        assert pa.default_block_q(160, h // 8) == 32
    q = torch.zeros(1, 32, 5, 160, dtype=BF16)
    assert pa.prefill_tile("k", q, 8, None, None) == (8, 128)
    for bq in (4, 8, 16):
        for bk in (64, 128):
            assert pa.prefill_tile("k", q, 8, bq, bk) == (bq, bk)
    with pytest.raises(ValueError, match="has block_q in"):
        pa.prefill_tile("k", q, 8, 12, 128)
    with pytest.raises(ValueError, match="has block_q in"):
        pa.prefill_tile("k", q, 8, 8, 32)
    q1 = torch.zeros(1, 32, 1, 160, dtype=BF16)
    assert pa.decode_tile("k", q1, 32) == 32 and pa.decode_tile(
        "k", q1, None) == 64


def test_decode_shared_memory_and_ctas_per_sm_at_d160():
    """``decode_smem_bytes`` reckons ``dec::Smem``: 108,800 B at D 128 and
    64 keys (two CTAs an SM), 134,400 at D 160 (one: 64 keys of bf16 rows
    of 336 bytes in a ring of 3), 117,504 over int8 pools (one), 69,888 at
    32 keys (three, of which the rule counts two).  The padded instances
    of widths 192 and 256 hold one CTA an SM too, the others two."""
    assert pa.decode_smem_bytes(128, 64, False, 0) == 108_800
    assert pa.decode_smem_bytes(128, 64, True, 0) == 96_000
    assert pa.decode_smem_bytes(160, 64, False, 0) == 134_400
    assert pa.decode_smem_bytes(160, 64, True, 0) == 117_504
    assert pa.decode_smem_bytes(160, 32, False, 0) == 69_888
    assert pa.DECODE_CTAS[(160, 64, False)] == 1
    assert pa.DECODE_CTAS[(160, 64, True)] == 1
    assert pa.DECODE_CTAS[(160, 32, False)] == 2
    assert pa.DECODE_CTAS[(160, 32, True)] == 2
    for (d, bk, _), n in pa.DECODE_CTAS.items():
        assert n == (1 if d > 160 or (d, bk) == (160, 64) else 2)


class _Model:
    def __init__(self, cfg):
        self.cfg = cfg


def test_run_time_ladders_at_d160():
    """The run-time AT's ladders for pixtral at published widths (bf16,
    D 160, G 4): ``DecodeBucket``'s key tiles 32 and 64 (dense and paged),
    ``PrefillBucket``'s block_q 4, 8 and 16 by keys 64 and 128."""
    ladders = tile_ladders(_Model(get_arch(ARCH)), 16)
    assert ladders["dense_block_k"] == (32, 64)
    assert ladders["block_k"] == (32, 64)
    assert ladders["block_q"] == (4, 8, 16)
    assert ladders["prefill_block_k"] == pa.TC_BLOCK_KS


# --------------------------------------------------------------------------
# the card's kernels at D 160, emulated, against plain and the JAX kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tile", fa.attention_tiles(BF16, 160),
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_k1_d160_every_tile_against_plain_and_jax_kernel(tile):
    """K1 at D 160 and G 4 (8 q / 2 kv heads), causal over 130 rows (a
    ragged last tile): within the bf16 tolerance of the plain version,
    and in float32 with bf16-valued inputs within 2^-9 max |v| + 1e-5 of
    the JAX kernel at the same block_q and block_k (interpret mode)."""
    s = 130
    q, k, v = (torch.from_numpy(np.random.default_rng(60 + i)
                                .standard_normal((1, n, s, 160))
                                .astype(np.float32)).to(BF16)
               for i, n in enumerate((8, 2, 2)))
    got = k1_emulate(q, k, v, block_q=tile[0], block_k=tile[1])
    np.testing.assert_allclose(got.float().numpy(),
                               ref.attention_ref(q, k, v).float().numpy(),
                               **BF16_TOL)
    q, k, v = q.float(), k.float(), v.float()
    got = k1_emulate(q, k, v, block_q=tile[0], block_k=tile[1]).numpy()
    want = np.asarray(jax_attention(q.numpy(), k.numpy(), v.numpy(),
                                    causal=True, block_q=tile[0],
                                    block_k=tile[1], interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=P_ROUNDING
                               * float(v.abs().max()) + FP32_SUMS)


@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
def test_k2_d160_against_plain_and_jax_flash_decode(block_k):
    """K2 (the dense mode) at D 160 and G 4 over strips of 150 keys (not a
    multiple of either tile): an empty lane exactly 0, one shorter than a
    tile, one full; every cluster size within 2^-8 sum_j p_j |v_j| / l +
    1e-5 of the JAX ``flash_decode`` (interpret mode)."""
    s, kv_len = 150, [0, 37, 150]
    q, (kp, vp, _, _), table, lens = decode_inputs(8, 2, 160, s, 1, kv_len,
                                                   62, False)
    k = ref.gather_pages(kp, table).float()
    v = ref.gather_pages(vp, table).float()
    q = q.float()
    want = np.asarray(jax_flash_decode(q.numpy(), k.numpy(), v.numpy(),
                                       jnp.asarray(lens.numpy()),
                                       interpret=True))
    bound = (P_BOUND * ref.decode_ref(q, k, v.abs(), lens)
             + FP32_TERM).numpy()
    for cluster in pa.CLUSTER_SIZES:
        got = dense_tc_emulate(q, k, v, lens, cluster, block_k=block_k)
        got = got.numpy()
        assert np.all(got[0] == 0)
        assert np.all(np.abs(got[1:] - want[1:]) <= bound[1:])


@pytest.mark.parametrize("quant", [False, True], ids=["K3", "K6a"])
@pytest.mark.parametrize("block_k", pa.DECODE_BLOCK_KS)
def test_k3_k6a_d160_against_plain_and_jax_kernels(block_k, quant):
    """K3 / K6a at D 160 and G 4 (8 q / 2 kv heads), pages of 16, lanes of
    0, 11, 45 and 150 keys (entries past kv_len on the null page): every
    cluster size within the bf16 tolerance of the plain version and, in
    float32 with bf16-valued q and pools, within 2^-8 sum_j p_j |v_j| / l
    + 1e-5 of the JAX ``flash_paged_decode(_quant)`` (interpret mode)."""
    kv_len = [0, 11, 45, 150]
    q, (kp, vp, ks, vs), table, lens = decode_inputs(8, 2, 160, 16, 10,
                                                     kv_len, 64, quant)
    plain = ref.paged_decode_ref(q, kp, vp, table, lens, k_scale=ks,
                                 v_scale=vs)
    q32 = q.float()
    if not quant:
        kp, vp = kp.float(), vp.float()
    args = (q32, kp, vp) + ((ks, vs) if quant else ()) + (table, lens)
    kernel = jax_paged_decode_quant if quant else jax_paged_decode
    want = np.asarray(kernel(*(jnp.asarray(x.numpy()) for x in args),
                             interpret=True))
    bound = (P_BOUND * weighted_abs_v(q32, kp, vp, table, lens, ks, vs)
             + FP32_TERM).numpy()
    for cluster in pa.CLUSTER_SIZES:
        got = decode_tc_emulate(q, kp, vp, table, lens, ks, vs, cluster,
                                block_k=block_k)
        assert torch.all(got[0] == 0)
        np.testing.assert_allclose(got[1:].float().numpy(),
                                   plain[1:].float().numpy(), **BF16_TOL)
        got32 = decode_tc_emulate(q32, kp, vp, table, lens, ks, vs, cluster,
                                  block_k=block_k).numpy()
        assert np.all(np.abs(got32[1:] - want[1:]) <= bound[1:])


@pytest.mark.parametrize("quant", [False, True], ids=["K5a", "K6b"])
@pytest.mark.parametrize("ns", [2, 3, 8])
def test_k5a_k6b_d160_merged_against_jax_split_kernels(ns, quant):
    """K5a / K6b's partials at D 160 and G 4 (the default 64-key tile),
    merged as K5c merges them: within the one-pass bound of the JAX
    ``flash_paged_decode(_quant)(num_splits=ns)`` (interpret mode) and of
    the plain version; the empty lane exactly 0."""
    kv_len = [0, 11, 45, 150]
    q, (kp, vp, ks, vs), table, lens = decode_inputs(8, 2, 160, 16, 10,
                                                     kv_len, 66, quant)
    q = q.float()
    if not quant:
        kp, vp = kp.float(), vp.float()
    _, l, acc = ref.combine_split_states(
        *split_tc_emulate(q, kp, vp, table, lens, ns, ks, vs))
    got = ref.finalize_split_states(l, acc).reshape(q.shape)
    args = (q, kp, vp) + ((ks, vs) if quant else ()) + (table, lens)
    kernel = jax_paged_decode_quant if quant else jax_paged_decode
    want = np.asarray(kernel(*(jnp.asarray(x.numpy()) for x in args),
                             num_splits=ns, interpret=True))
    plain = ref.paged_decode_ref(q, kp, vp, table, lens, k_scale=ks,
                                 v_scale=vs)
    bound = P_BOUND * weighted_abs_v(q, kp, vp, table, lens, ks, vs) \
        + FP32_TERM
    assert torch.all(got[0] == 0)
    assert torch.all((got[1:] - plain[1:]).abs() <= bound[1:])
    assert np.all(np.abs(got[1:].numpy() - want[1:]) <= bound[1:].numpy())


#: the tiles of the D-160 ladder at G 4: (query rows, keys)
D160_TILES = [(4 * bq, bk) for bq in pa.prefill_tiles(BF16, 160, 4)[0]
              for bk in pa.TC_BLOCK_KS]


@pytest.mark.parametrize("quant", [False, True], ids=["K4", "K6c"])
@pytest.mark.parametrize("rows,keys", D160_TILES)
def test_k4_k6c_d160_every_tile_against_plain_and_jax_kernels(rows, keys,
                                                              quant):
    """K4 / K6c at every tile of the D-160 ladder at G 4 (block_q = rows /
    4): two lanes, a chunk of 8 starting mid-page and a ragged one at 0,
    pages of 8; within the bf16 tolerance of the plain version, and in
    float32 with bf16-valued inputs within 2^-9 max |v| + 1e-5 of the JAX
    ``flash_paged_prefill(_quant)`` at the same block_q and block_k
    (interpret mode)."""
    c, valid = 8, [8, 5]
    q, (kp, vp, ks, vs), table, start, lens = prefill_inputs(
        4, 1, 160, 8, 6, [12, 0], valid, c, 68, quant)
    groups = key_groups(rows)
    got = tc_emulate(q, kp, vp, table, start, lens, ks, vs, block_k=keys,
                     groups=groups)
    plain = ref.paged_prefill_ref(q, kp, vp, table, start, lens, k_scale=ks,
                                  v_scale=vs)
    q = q.float()
    if not quant:
        kp, vp = kp.float(), vp.float()
    got32 = tc_emulate(q, kp, vp, table, start, lens, ks, vs, block_k=keys,
                       groups=groups).numpy()
    args = [np.asarray(x) for x in (q, kp, vp)]
    if quant:
        args += [ks.numpy(), vs.numpy()]
    kernel = jax_paged_prefill_quant if quant else jax_paged_prefill
    want = np.asarray(kernel(*args, jnp.asarray(table.numpy()),
                             jnp.asarray(start.numpy()),
                             jnp.asarray(lens.numpy()), block_q=rows // 4,
                             block_k=keys, interpret=True))
    v_max = float(ref._dequantize_pools(kp, vp, ks, vs)[1].abs().max())
    for i, n in enumerate(valid):         # rows past kv_len are padding
        np.testing.assert_allclose(got[i, :, :n].float().numpy(),
                                   plain[i, :, :n].float().numpy(),
                                   **BF16_TOL)
        np.testing.assert_allclose(got32[i, :, :n], want[i, :, :n], rtol=0,
                                   atol=P_ROUNDING * v_max + 1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["K5b", "K6d"])
@pytest.mark.parametrize("rows,keys", D160_TILES)
def test_k5b_k6d_d160_every_tile_against_plain_and_jax_kernels(rows, keys,
                                                               quant):
    """K5b / K6d's partials at every tile of the D-160 ladder, 3 splits, on
    a verify of 5 rows over four lanes and an idle one (pixtral's G 4 at 8
    q / 2 kv heads): against ``paged_prefill_split_ref`` cut at the same
    tile (m and l within 1e-5, acc within 2^-8 sum_j p_j |v_j|, the same
    empty splits); merged as K5c merges them, against the JAX
    ``flash_paged_prefill(_quant)(num_splits=3)`` (interpret mode) within
    2^-9 max |v| + 1e-5, the idle lane exactly 0."""
    h, hkv, ns = 8, 2, 3
    starts, valid, c = [190, 47, 100, 9, 0], [5, 5, 5, 5, 0], 5
    q, kp, vp, table, start, kv_len = chunk_case(h, hkv, 160, 16, 16,
                                                 starts, valid, c, 70)
    scales = {}
    if quant:
        kp, vp, ks, vs = quantized(kp, vp)
        scales = dict(k_scale=ks, v_scale=vs)
    tiles = dict(block_q=rows // (h // hkv), block_k=keys)
    q = q.float()
    if not quant:
        kp, vp = kp.float(), vp.float()
    gm, gl, gacc = split_emulate(q, kp, vp, table, start, kv_len, ns,
                                 tile_rows=rows, keys=keys, **scales)
    _, (m, l, acc) = ref.paged_prefill_split_ref(
        q, kp, vp, table, start, kv_len, ns, **scales, **tiles)
    _, (_, _, acc_abs) = ref.paged_prefill_split_ref(
        q, kp, vp.float().abs(), table, start, kv_len, ns, **scales, **tiles)
    empty = m == ref.NEG_INF
    assert torch.equal(gm == ref.NEG_INF, empty)
    np.testing.assert_allclose(gm.numpy(), m.numpy(), rtol=1e-5,
                               atol=FP32_SUMS)
    np.testing.assert_allclose(gl.numpy(), l.numpy(), rtol=1e-5,
                               atol=FP32_SUMS)
    bound = BF16_ROUNDOFF * acc_abs + FP32_SUMS * (1 + acc.abs())
    assert bool(((gacc - acc).abs() <= bound).all())
    _, l_star, acc_star = ref.combine_split_states(gm, gl, gacc)
    got = ref.finalize_split_states(l_star, acc_star).numpy()
    args = [np.asarray(x) for x in (q, kp, vp)]
    if quant:
        args += [ks.numpy(), vs.numpy()]
    kernel = jax_paged_prefill_quant if quant else jax_paged_prefill
    want = np.asarray(kernel(*args, jnp.asarray(table.numpy()),
                             jnp.asarray(start.numpy()),
                             jnp.asarray(kv_len.numpy()), num_splits=ns,
                             interpret=True))
    v_max = float(ref._dequantize_pools(kp, vp, scales.get("k_scale"),
                                        scales.get("v_scale"))[1]
                  .abs().max())
    assert np.all(got[4] == 0)
    for lane, n in enumerate(valid[:4]):
        np.testing.assert_allclose(got[lane, :, :n], want[lane, :, :n],
                                   rtol=0, atol=P_ROUNDING * v_max + 1e-5)

"""h2o-danube-1.8b and the sliding-window ring buffer in the port against
the JAX package on the CPU.

h2o-danube is a plain ``attn_mlp`` stack with a 4096-key sliding window,
32 query heads over 8 kv heads and head dim 80 (G 4).  The JAX package
serves it from dense lanes only: a lane's KV cache is a ring buffer of
``min(max_len, window)`` slots, decode writes slot ``pos % W`` and reads
``min(pos + 1, W)`` keys, and prefill lays the prompt's last W keys out
as the ring does (``kv_out``: rolled by ``(S - W) % W`` when S > W,
padded when S < W).  Its reduced config has window 32 at D 16; a second
small config at D 80 (8 query heads over 2, G 4) is built on both sides
by the same ``dataclasses.replace``.  At each, with prompts shorter than,
equal to and longer than the window and decodes that cross it:

* the config copy equals the JAX package's, field by field;
* the prefill caches hold the ring layout bit for bit: every slot holds,
  exactly, the port's own key of the position the JAX package's cache
  puts there (the positions read off each package's layer-0 keys, which
  no attention has touched), and the two packages' values agree at 1e-5;
* prefill and decode logits equal the JAX model's at 1e-4;
* greedy tokens equal the JAX ``ServingEngine``'s on dense lanes;
* the paged pool refuses the arch with a ``ValueError`` naming "paged",
  in both packages.

The card's kernels take D 80 on the routes that serve it, K1 and K2 (the
cluster kernel's dense mode), and no paged kernel does: the tile tables
say so, and the run-time AT's ladders follow them.

Inputs are made with numpy from seeds and handed to both packages.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.kvcache import PagedKVCache as JaxPagedKVCache
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.registry import NOT_PORTED
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch.serve import ServeConfig, serve_config, tile_ladders
from repro_torch.models import build_model
from repro_torch.models import transformer
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.kvcache import PagedKVCache

torch.set_num_threads(1)

ARCH = "h2o-danube-1.8b"
TOL = dict(rtol=1e-4, atol=1e-4)
BF16 = torch.bfloat16
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab_size", "rope_theta", "window", "compute_dtype",
          "cache_dtype", "tie_embeddings", "qkv_bias", "family")
WINDOW = 32                     # reduced()'s window, both small configs
# prompts shorter than, equal to and longer than the window
PROMPTS = (20, WINDOW, 45)


def small(cfg, name: str):
    """The reduced config (D 16, G 2) or its D-80 variant (8 q / 2 kv
    heads: G 4, as the published config)."""
    cfg = cfg.reduced()
    return cfg if name == "D16" else dataclasses.replace(
        cfg, n_heads=8, n_kv_heads=2, d_head=80)


@pytest.mark.parametrize("size", ["full", "D16", "D80"])
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
    assert (got.head_dim, got.n_heads // got.n_kv_heads, got.window) == {
        "full": (80, 4, 4096), "D16": (16, 2, WINDOW),
        "D80": (80, 4, WINDOW)}[size]


def test_h2o_danube_is_registered_and_three_families_still_wait():
    assert get_arch(ARCH) is ARCHS[ARCH]
    # whisper-tiny, zamba2-7b and pixtral-12b are ported since: none waits,
    # and the audio stub outside the encoder-decoder family still raises
    assert NOT_PORTED == {}
    for name in ("whisper-tiny", "zamba2-7b", "pixtral-12b"):
        assert get_arch(name) is ARCHS[name]
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        build_model(dataclasses.replace(get_arch(ARCH).reduced(),
                                        frontend="audio", frontend_seq=4))
    full = get_arch(ARCH)
    # 1.83 B parameters, served whole: 3.7 GB of bf16 weights
    assert 1.82e9 < full.param_count() < 1.84e9


@pytest.fixture(scope="module", params=["D16", "D80"])
def pair(request):
    """(jax model, jax params, port model, port params) at one of the two
    small configs."""
    jmodel = jax_build_model(small(JAX_ARCHS[ARCH], request.param))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(small(get_arch(ARCH), request.param))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    return dict(jmodel=jmodel, jparams=jparams, model=model, params=params)


def _prompt(s_len: int) -> np.ndarray:
    return ((np.arange(s_len) * 7 + 3) % 250).astype(np.int32)[None]


def _slot_positions(ring: np.ndarray, keys: np.ndarray) -> list[int]:
    """The position each slot of a layer's ring (Hkv, W, Dh) holds: the
    one whose key (of ``keys`` (Hkv, S, Dh)) it equals exactly, -1 for an
    all-zero slot; raises on a slot that is neither."""
    out = []
    for t in range(ring.shape[1]):
        hits = [p for p in range(keys.shape[1])
                if np.array_equal(ring[:, t], keys[:, p])]
        if hits:
            out.append(hits[-1])
        else:
            assert not ring[:, t].any(), f"slot {t} holds no key"
            out.append(-1)
    return out


@pytest.mark.parametrize("s_len", PROMPTS)
def test_prefill_caches_hold_the_ring_layout_bit_for_bit(pair, s_len):
    """Layer 0's keys depend on no attention, so a run without the window
    gives each package every position's key; the ring's slots must hold
    the same positions in both packages (the last W at ``pos % W``, zeros
    past a short prompt), each bit-equal to that package's own key, and
    the packages' caches must agree."""
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    model, params = pair["model"], pair["params"]
    tokens, max_len = _prompt(s_len), 64
    _, jcaches = jmodel.prefill(jparams, tokens, None, max_len)
    _, caches = model.prefill(params, torch.from_numpy(tokens).long(),
                              max_len)
    nowin = jax_build_model(dataclasses.replace(jmodel.cfg, window=None))
    _, jall = nowin.prefill(jparams, tokens, None, max_len)
    _, pall = transformer.prefill(
        params, torch.from_numpy(tokens).long(),
        dataclasses.replace(model.cfg, window=None), max_len)
    held = range(max(0, s_len - WINDOW), s_len)     # the last W positions
    want = [next((p for p in held if p % WINDOW == t), -1)
            for t in range(WINDOW)]
    for side, (jk, jv) in enumerate((jcaches["kv"], caches["kv"])):
        full = (jall if side == 0 else pall)["kv"]
        for ring, keys in ((jk, full[0]), (jv, full[1])):
            ring = np.asarray(ring)[0, 0]             # layer 0, lane 0
            assert ring.shape[1] == WINDOW
            keys = np.asarray(keys)[0, 0, :, :s_len]
            assert _slot_positions(ring, keys) == want
    for j, p in zip(jcaches["kv"], caches["kv"]):
        assert p.shape == j.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("s_len", PROMPTS)
def test_prefill_and_decode_across_the_window_match_jax(pair, s_len):
    """Prefill, then 14 decode steps: the 20-token prompt's decodes cross
    W (the ring's first wrap in decode), the others wrap further."""
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    model, params = pair["model"], pair["params"]
    tokens = _prompt(s_len)
    jlogits, jcaches = jmodel.prefill(jparams, tokens, None, 64)
    logits, caches = model.prefill(params, torch.from_numpy(tokens).long(),
                                   64)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    tok = int(np.argmax(np.asarray(jlogits)[0]))
    for step in range(14):
        pos = np.array([s_len + step], np.int32)
        jlogits, jcaches = jmodel.decode_step(
            jparams, jcaches, np.array([[tok]], np.int32), pos)
        logits, caches = model.decode_step(
            params, caches, torch.tensor([[tok]]),
            torch.from_numpy(pos).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        tok = int(np.argmax(np.asarray(jlogits)[0]))
    for j, p in zip(jcaches["kv"], caches["kv"]):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


def test_engine_greedy_tokens_identical_to_jax(pair):
    """Dense lanes, one request per prompt length, 16 new tokens each: the
    20-token prompt crosses W in decode, the 45-token one is rolled at
    prefill; 2 lanes, so the third request waits for one."""
    eng = ServingEngine(pair["model"], pair["params"], n_lanes=2, max_len=80)
    jeng = JaxEngine(pair["jmodel"], pair["jparams"], n_lanes=2, max_len=80)
    for rid, s_len in enumerate(PROMPTS):
        prompt = [int(t) for t in _prompt(s_len)[0]]
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=16))
        jeng.submit(JaxRequest(rid=rid, prompt=list(prompt),
                               max_new_tokens=16))
    got = {r.rid: r.out_tokens for r in eng.run(max_steps=400)}
    want = {r.rid: r.out_tokens for r in jeng.run(max_steps=400)}
    assert got == want
    assert all(len(t) == 16 for t in got.values())
    assert eng.steps == jeng.steps
    assert eng.kv.caches["kv"][0].shape[3] == WINDOW


def test_paged_cache_raises_in_both_packages(pair):
    with pytest.raises(ValueError, match="paged"):
        JaxPagedKVCache(pair["jmodel"], n_lanes=1, max_len=32, n_pages=5,
                        page_size=8)
    with pytest.raises(ValueError, match="paged"):
        PagedKVCache(pair["model"], n_lanes=1, max_len=32, n_pages=5,
                     page_size=8, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        pair["model"].init_paged_caches(5, 8, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(pair["model"], pair["params"], n_lanes=1, max_len=32,
                      cache="paged", page_size=8)
    assert not pair["model"].supports_paged_cache


@pytest.mark.parametrize("flag", [dict(cache="paged", prefill_chunk=8),
                                  dict(cache="paged", draft=True)])
def test_serve_refuses_the_paged_pool_naming_the_ring(flag):
    with pytest.raises(ValueError, match="ring buffer"):
        serve_config(ServeConfig(arch=ARCH, device="cpu", n_requests=1,
                                 n_lanes=1, max_new=2, prompt_len=4,
                                 page_size=8, **flag))


def test_serve_config_runs_danube_on_cpu_past_the_window():
    out = serve_config(ServeConfig(arch=ARCH, device="cpu", n_requests=2,
                                   n_lanes=2, max_new=8, prompt_len=40,
                                   max_len=64))
    assert out["finished"] == 2
    assert all(len(t) == 8 for t in out["outputs"].values())


@pytest.mark.parametrize("max_len,width", [(100, WINDOW), (16, 16)])
def test_dense_caches_are_window_wide(max_len, width):
    model = build_model(small(get_arch(ARCH), "D80"))
    k, v = model.init_caches(3, max_len, device="cpu")["kv"]
    assert k.shape == v.shape == (2, 3, 2, width, 80)


# --------------------------------------------------------------------------
# the card's kernels at D 80, on the CPU (no launch)
# --------------------------------------------------------------------------


def test_d80_routes_and_tiles():
    """K1 (both query types) and the bf16 K2 have instances of their own at
    D 80; K1's bf16 tiles are D 128's four, K2's key tiles 32 and 64.  The
    float32 K2 and the paged kernels, which were refused at D 80, run on
    the padded instances of width 96, each with its default tile alone (a
    float32 lane of the decode template then owns 3 of its columns)."""
    assert fa.head_dims("flash_attention", BF16) == fa.DENSE_HEAD_DIMS
    assert fa.head_dims("flash_attention", torch.float32) == \
        fa.DENSE_HEAD_DIMS
    assert fa.head_dims("flash_decode", BF16) == fa.DENSE_HEAD_DIMS
    assert 80 in fa.DENSE_HEAD_DIMS
    assert fa.route("flash_attention", BF16, 80) == (80, False)
    for name, dtype in (("flash_decode", torch.float32),
                        ("flash_paged_decode", BF16),
                        ("flash_paged_prefill", torch.float32)):
        assert 80 not in fa.head_dims(name, dtype)
        assert fa.route(name, dtype, 80) == (96, True)
    assert fa.attention_tiles(BF16, 80) == fa.attention_tiles(BF16, 128) \
        == ((64, 64), (64, 128), (128, 64), (128, 128))
    assert fa.attention_tiles(torch.float32, 80) == (fa.SIMT_TILE,)
    assert pa.decode_block_ks(BF16, 80, dense=True) == pa.DECODE_BLOCK_KS \
        == (32, 64)
    assert pa.decode_block_ks(BF16, 80) == (pa.DECODE_TILE_KEYS,)
    assert pa.prefill_tiles(BF16, 80, 4) == ((8,), (pa.TC_TILE_KEYS,))
    assert pa.prefill_tiles(torch.float32, 80, 4) == ((64,), (32,))
    pa.check_tc_shape("flash_paged_prefill", 32, 8, 80)
    q = torch.zeros(1, 32, 1, 80, dtype=BF16)
    assert pa.decode_tile("flash_decode", q, 32) == 32
    for tile in fa.attention_tiles(BF16, 80):
        assert fa.attention_tile("flash_attention", q, *tile) == tile
    with pytest.raises(ValueError, match="block_k=128"):
        pa.decode_tile("flash_decode", q, 128)
    with pytest.raises(ValueError, match="block_k=32"):
        pa.decode_tile("flash_paged_decode", q, 32)


class _Model:
    def __init__(self, cfg):
        self.cfg = cfg


def test_run_time_ladders_at_d80():
    """The run-time AT's ladders for h2o-danube at published widths (bf16,
    D 80): ``DecodeBucket``'s dense key tiles 32 and 64 (K2), and the
    padded instances' defaults for the paged kernels."""
    ladders = tile_ladders(_Model(get_arch(ARCH)), 16)
    assert ladders["dense_block_k"] == (32, 64)
    # the paged kernels, which the arch never reaches, would run on the
    # padded instances (width 96), each with its default tile alone
    assert ladders["block_q"] == (8,) and ladders["prefill_block_k"] == (
        pa.TC_TILE_KEYS,)
    assert ladders["block_k"] == (pa.DECODE_TILE_KEYS,)

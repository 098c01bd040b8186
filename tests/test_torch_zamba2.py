"""zamba2-7b's Mamba-2 stack and its shared attention block in the port
against the JAX package on the CPU.

zamba2 is 81 Mamba-2 (SSD) layers with one shared transformer block
(windowed causal attention at D 112, G 1, and a gated SiLU MLP) applied
after every 6th layer with the same weights each time, each application
keeping its own KV ring of ``min(max_len, window)`` slots.  Mamba-2 is
plain PyTorch on both routes (jnp in the JAX package); the shared block
runs K1 and K2 on the card.  Checked here:

* the config copy equals the JAX package's, field for field;
* ``ssd_chunked`` (chunk sizes that do and do not divide L, a chunk
  longer than L, the zero-``dt`` padded tail) and its final state,
  ``apply_mamba2`` (with the state), ``step_mamba2`` (float32 state, as
  the lanes hold it, and bf16 weights) equal the JAX functions;
* at ``reduced()`` (D 16, G 2, window 32) and a D-112 variant (d_model
  224, 2 heads: G 1) built the same way on both sides, with 5 layers and
  a period of 2 (two applications): the shared block's application
  indices; ``forward``; prefill logits, the SSM states and ``shared_kv``
  equal to the JAX package's compacted caches, the ring rolled at
  prefill (prompts longer than the window); decode steps that wrap the
  ring; prefill-then-decode equal to ``forward`` over S + 1 tokens;
* the dense-lane engine's greedy tokens equal the JAX ``ServingEngine``'s
  with the rings wrapped (also at ``reduced()`` itself: 2 layers, one
  application), and the paged pool is refused in both packages and by
  ``serve``;
* the card's tables take D 112 on K1 (four tiles) and K2's dense mode
  (both key tiles), and no paged kernel does.

Inputs are made with numpy from seeds and handed to both packages.
Tolerances: 1e-4 float32 for logits, states and caches (both sides sum
float32 products in other orders); 2e-2 for bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.kvcache import PagedKVCache as JaxPagedKVCache
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch.serve import ServeConfig, serve_config, tile_ladders
from repro_torch.models import build_model, ssm, transformer
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.kvcache import PagedKVCache

torch.set_num_threads(1)

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
BF16 = torch.bfloat16
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
WINDOW = 32
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab_size", "ssm_version", "ssm_state", "ssm_head_dim",
          "ssm_chunk", "d_inner", "ssm_d_inner", "ssm_n_heads",
          "attn_period", "window", "rope_theta", "compute_dtype",
          "cache_dtype", "tie_embeddings", "family")


def small(cfg, name: str):
    """The reduced config (D 16, G 2) or its D-112 variant (2 q / 2 kv
    heads: G 1, as the published config), both at 5 layers with a period
    of 2, so the shared block runs twice and its second application
    follows layer 3."""
    cfg = dataclasses.replace(cfg.reduced(), n_layers=5)
    return cfg if name == "D16" else dataclasses.replace(
        cfg, d_model=224, n_heads=2, n_kv_heads=2, d_head=112)


@pytest.mark.parametrize("size", ["full", "D16", "D112"])
def test_config_copy_matches_jax(size):
    want, got = JAX_ARCHS[ARCH], ARCHS[ARCH]
    if size != "full":
        want, got = small(want, size), small(got, size)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.head_dim == want.head_dim
    assert got.padded_vocab == want.padded_vocab
    assert got.param_count() == want.param_count()
    assert got.layer_kinds() == want.layer_kinds() == ["mamba2"] * \
        got.n_layers
    assert got.n_shared_attn_applications() == \
        want.n_shared_attn_applications()
    assert (got.head_dim, got.n_heads // got.n_kv_heads, got.window,
            got.n_shared_attn_applications()) == {
        "full": (112, 1, 4096, 13), "D16": (16, 2, WINDOW, 2),
        "D112": (112, 1, WINDOW, 2)}[size]


def test_zamba2_is_registered_at_its_size():
    full = get_arch(ARCH)
    assert get_arch(ARCH) is ARCHS[ARCH]
    # 6.75 B parameters: 13.5 GB of bf16 weights, whole on one card
    assert 6.74e9 < full.param_count() < 6.76e9
    assert full.ssm_n_heads == 112 and full.ssm_d_inner == 7168


# --------------------------------------------------------------------------
# the Mamba-2 block
# --------------------------------------------------------------------------


def ssd_inputs(bsz, length, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, length, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, length, h)))).astype(
        np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    b = rng.standard_normal((bsz, length, n)).astype(np.float32)
    c = rng.standard_normal((bsz, length, n)).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    return x, dt, a, b, c, d


@pytest.mark.parametrize("length,chunk", [(16, 8), (13, 4), (9, 8), (5, 8),
                                          (1, 4)])
def test_ssd_chunked_and_final_state_match_jax(length, chunk):
    """Chunks that divide L and that do not (the padded tail's zero dt
    keeps the final state exact), and a chunk longer than L."""
    args = ssd_inputs(2, length, 3, 4, 5, length * 10 + chunk)
    want, jh = jax_ssm.ssd_chunked(*args, chunk, return_final_state=True)
    got, th = ssm.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk,
                              return_final_state=True)
    assert got.shape == (2, length, 3, 4) and th.shape == (2, 3, 5, 4)
    assert th.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    only = ssm.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk)
    assert torch.equal(only, got)


def test_ssd_final_state_equals_the_stepped_recurrence():
    """The chunked algorithm's final state is the one-step recurrence's
    (h = exp(dt a) h + dt b x^T) after every step, padded tail or not."""
    x, dt, a, b, c, d = (torch.from_numpy(v)
                         for v in ssd_inputs(1, 11, 2, 3, 4, 7))
    _, hf = ssm.ssd_chunked(x, dt, a, b, c, d, 4, return_final_state=True)
    h = torch.zeros(1, 2, 4, 3)
    for t in range(11):
        h = torch.exp(dt[:, t] * a)[..., None, None] * h + torch.einsum(
            "bn,bhp,bh->bhnp", b[:, t], x[:, t], dt[:, t])
    torch.testing.assert_close(hf, h, **TOL)


M2 = dict(d_model=32, d_inner=48, d_state=6, n_heads=4, head_dim=12,
          chunk=4)


@pytest.fixture(scope="module")
def block():
    """A JAX ``init_mamba2`` block with its zero and one leaves made
    random, and the same weights as torch tensors."""
    jcfg = jax_ssm.Mamba2Config(**M2)
    jp = jax_ssm.init_mamba2(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(11)
    jp = {k: (np.array(v) if k in ("in_proj", "out_proj", "conv_w", "a_log")
              else (rng.standard_normal(v.shape) * 0.3 + 0.5).astype(
                  np.float32)) for k, v in jp.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    return jcfg, jp, ssm.Mamba2Config(**M2), tp


@pytest.mark.parametrize("length", [9, 12])
def test_apply_mamba2_with_state_matches_jax(block, length):
    jcfg, jp, cfg, tp = block
    x = np.random.default_rng(4).standard_normal((2, length, 32)).astype(
        np.float32)
    want, jst = jax_ssm.apply_mamba2(jp, x, jcfg, return_state=True)
    got, st = ssm.apply_mamba2(tp, torch.from_numpy(x), cfg,
                               return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("conv", "h"):
        assert tuple(st[key].shape) == jst[key].shape
        np.testing.assert_allclose(st[key].numpy(), np.asarray(jst[key]),
                                   **TOL)
    assert torch.equal(ssm.apply_mamba2(tp, torch.from_numpy(x), cfg), got)


def test_step_mamba2_matches_jax_and_continues_apply(block):
    """Steps from the zero state, and a step continuing ``apply_mamba2``'s
    state, equal the JAX step; the step after a prefill of L tokens equals
    the whole sequence's last output."""
    jcfg, jp, cfg, tp = block
    rng = np.random.default_rng(5)
    jstate = jax_ssm.init_mamba2_state(2, jcfg)
    tstate = ssm.init_mamba2_state(2, cfg)
    assert tstate["conv"].dtype == torch.float32
    for _ in range(3):
        x = rng.standard_normal((2, 1, 32)).astype(np.float32)
        jy, jstate = jax_ssm.step_mamba2(jp, x, jstate, jcfg)
        ty, tstate = ssm.step_mamba2(tp, torch.from_numpy(x), tstate, cfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for key in ("conv", "h"):
        np.testing.assert_allclose(tstate[key].numpy(),
                                   np.asarray(jstate[key]), **TOL)
    seq = rng.standard_normal((2, 7, 32)).astype(np.float32)
    whole = ssm.apply_mamba2(tp, torch.from_numpy(seq), cfg)
    _, st = ssm.apply_mamba2(tp, torch.from_numpy(seq[:, :6]), cfg,
                             return_state=True)
    y, _ = ssm.step_mamba2(tp, torch.from_numpy(seq[:, 6:]), st, cfg)
    np.testing.assert_allclose(y[:, 0].numpy(), whole[:, 6].numpy(), **TOL)


def test_step_mamba2_promotes_like_jax_with_bf16_weights(block):
    """bf16 weights and activations against the float32 conv state the
    serving lanes hold: float32 state in both packages, a bf16 output."""
    jcfg, jp, cfg, tp = block
    jp16 = jax.tree.map(lambda v: jnp.asarray(v, jnp.bfloat16), jp)
    tp16 = {k: v.to(BF16) for k, v in tp.items()}
    rng = np.random.default_rng(6)
    jstate = jax_ssm.init_mamba2_state(2, jcfg)
    tstate = ssm.init_mamba2_state(2, cfg)
    for _ in range(2):
        x = rng.standard_normal((2, 1, 32)).astype(np.float32)
        jy, jstate = jax_ssm.step_mamba2(jp16, jnp.asarray(x, jnp.bfloat16),
                                         jstate, jcfg)
        ty, tstate = ssm.step_mamba2(tp16, torch.from_numpy(x).to(BF16),
                                     tstate, cfg)
        assert ty.dtype == BF16 and jy.dtype == jnp.bfloat16
        np.testing.assert_allclose(ty.float().numpy(),
                                   np.asarray(jy.astype(jnp.float32)),
                                   **BF16_TOL)
    assert tstate["conv"].dtype == torch.float32
    assert jstate["conv"].dtype == jnp.float32
    np.testing.assert_allclose(tstate["h"].numpy(), np.asarray(jstate["h"]),
                               **BF16_TOL)


# --------------------------------------------------------------------------
# the hybrid model
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["D16", "D112"])
def pair(request):
    """(jax model, jax params, port model, port params) at one of the two
    small configs."""
    jmodel = jax_build_model(small(JAX_ARCHS[ARCH], request.param))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(small(get_arch(ARCH), request.param))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    return dict(jmodel=jmodel, jparams=jparams, model=model, params=params)


def _prompt(b: int, s_len: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 250, (b, s_len)).astype(
        np.int32)


def test_shared_block_application_indices(pair):
    """After layers 1 and 3 of 5 (period 2), into slots 0 and 1, as the
    JAX package's selector compacts them; the JAX step's ``app_idx``."""
    cfg = pair["model"].cfg
    applies = [i for i in range(cfg.n_layers) if transformer._applies(cfg, i)]
    assert applies == [1, 3]
    assert [transformer._app_index(cfg, i) for i in applies] == [0, 1]
    is_app = np.array([(i + 1) % cfg.attn_period == 0
                       for i in range(cfg.n_layers)], np.int32)
    assert list(np.cumsum(is_app)[applies] - 1) == [0, 1]
    assert cfg.n_shared_attn_applications() == len(applies)
    full = get_arch(ARCH)
    assert [transformer._app_index(full, i) for i in range(full.n_layers)
            if transformer._applies(full, i)] == list(range(13))
    params = pair["params"]
    assert set(params["shared_attn"]) == {"attn", "mlp", "norm1_w",
                                          "norm2_w"}
    assert params["shared_attn"]["attn"]["wq"].dim() == 2    # not stacked


def test_forward_matches_jax(pair):
    tokens = _prompt(2, 20, 1)
    want, _ = pair["jmodel"].forward(pair["jparams"], tokens)
    got, aux = pair["model"].forward(pair["params"],
                                     torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("s_len", [20, WINDOW, 45])
def test_prefill_states_and_shared_kv_match_jax(pair, s_len):
    """Prompts shorter than, equal to and longer than the window (the
    ring rolled at prefill): logits, every layer's state, and the shared
    block's rings equal JAX's caches, compacted there by a 0/1 selector
    and collected here as the block runs."""
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    model, params = pair["model"], pair["params"]
    tokens = _prompt(2, s_len, 2)
    jlogits, jcaches = jmodel.prefill(jparams, tokens, None, 64)
    logits, caches = model.prefill(params, torch.from_numpy(tokens).long(),
                                   64)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert list(caches) == ["ssm", "shared_kv"]
    for key in ("conv", "h"):
        np.testing.assert_allclose(caches["ssm"][key].numpy(),
                                   np.asarray(jcaches["ssm"][key]), **TOL)
    for got, want in zip(caches["shared_kv"], jcaches["shared_kv"],
                         strict=True):
        assert tuple(got.shape) == want.shape == (
            2, 2, model.cfg.n_kv_heads, WINDOW, model.cfg.head_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if s_len < WINDOW:
        assert not caches["shared_kv"][0][:, :, :, s_len:].any()


@pytest.mark.parametrize("s_len", [20, 45])
def test_decode_across_the_window_matches_jax(pair, s_len):
    """Prefill, then 16 decode steps: the 20-token prompt's decodes wrap
    the ring (its first wrap in decode), the 45-token one's wrap further."""
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    model, params = pair["model"], pair["params"]
    tokens = _prompt(1, s_len, 3)
    jlogits, jcaches = jmodel.prefill(jparams, tokens, None, 80)
    logits, caches = model.prefill(params, torch.from_numpy(tokens).long(),
                                   80)
    tok = int(np.argmax(np.asarray(jlogits)[0]))
    for step in range(16):
        pos = np.array([s_len + step], np.int32)
        jlogits, jcaches = jmodel.decode_step(
            jparams, jcaches, np.array([[tok]], np.int32), pos)
        logits, caches = model.decode_step(
            params, caches, torch.tensor([[tok]]),
            torch.from_numpy(pos).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        tok = int(np.argmax(np.asarray(jlogits)[0]))
    for got, want in zip(caches["shared_kv"], jcaches["shared_kv"],
                         strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("conv", "h"):
        np.testing.assert_allclose(caches["ssm"][key].numpy(),
                                   np.asarray(jcaches["ssm"][key]), **TOL)


@pytest.mark.parametrize("s_len", [10, 40])
def test_prefill_then_decode_equals_forward(pair, s_len):
    """Prefill of S tokens and one decode step give the logits ``forward``
    gives at the last of S + 1 tokens (40: the window already rolled)."""
    model, params = pair["model"], pair["params"]
    tokens = torch.from_numpy(_prompt(1, s_len + 1, 4)).long()
    _, caches = model.prefill(params, tokens[:, :s_len], 64)
    logits, _ = model.decode_step(params, caches, tokens[:, s_len:],
                                  torch.tensor([s_len]))
    hidden, _ = model.forward(params, tokens)
    want = model.head_logits(params, hidden[:, -1])
    torch.testing.assert_close(logits, want, **TOL)


def test_init_caches_hold_float32_state_and_window_wide_rings(pair):
    model, jmodel = pair["model"], pair["jmodel"]
    for max_len, width in ((100, WINDOW), (16, 16)):
        caches = model.init_caches(3, max_len, device="cpu")
        jcaches = jmodel.init_caches(3, max_len)
        assert list(caches) == ["ssm", "shared_kv"]
        for key in ("conv", "h"):
            assert caches["ssm"][key].dtype == torch.float32
            assert tuple(caches["ssm"][key].shape) == \
                jcaches["ssm"][key].shape
        for got, want in zip(caches["shared_kv"], jcaches["shared_kv"],
                             strict=True):
            assert tuple(got.shape) == want.shape == (
                2, 3, model.cfg.n_kv_heads, width, model.cfg.head_dim)


def test_engine_greedy_tokens_identical_to_jax(pair):
    """Dense lanes, a request a prompt length, 14 new tokens each: the
    20-token prompt wraps its rings in decode, the 45-token one is rolled
    at prefill; 2 lanes, so the third request waits for one."""
    eng = ServingEngine(pair["model"], pair["params"], n_lanes=2, max_len=80)
    jeng = JaxEngine(pair["jmodel"], pair["jparams"], n_lanes=2, max_len=80)
    for rid, s_len in enumerate((20, 45, 26)):
        prompt = [int(t) for t in _prompt(1, s_len, 20 + rid)[0]]
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=14))
        jeng.submit(JaxRequest(rid=rid, prompt=list(prompt),
                               max_new_tokens=14))
    got = {r.rid: r.out_tokens for r in eng.run(max_steps=300)}
    want = {r.rid: r.out_tokens for r in jeng.run(max_steps=300)}
    assert got == want
    assert all(len(t) == 14 for t in got.values())
    assert eng.steps == jeng.steps
    assert eng.kv.caches["shared_kv"][0].shape[3] == WINDOW


def test_engine_greedy_tokens_identical_to_jax_at_reduced():
    """The same at ``reduced()`` itself (2 layers, one application of the
    shared block): prompts past the window and decodes across it."""
    jmodel = jax_build_model(JAX_ARCHS[ARCH].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(1))
    model = build_model(get_arch(ARCH).reduced())
    assert model.cfg.n_shared_attn_applications() == 1
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    eng = ServingEngine(model, params, n_lanes=2, max_len=80)
    jeng = JaxEngine(jmodel, jparams, n_lanes=2, max_len=80)
    for rid, s_len in enumerate((40, 24)):
        prompt = [int(t) for t in _prompt(1, s_len, 30 + rid)[0]]
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=16))
        jeng.submit(JaxRequest(rid=rid, prompt=list(prompt),
                               max_new_tokens=16))
    got = {r.rid: r.out_tokens for r in eng.run(max_steps=200)}
    want = {r.rid: r.out_tokens for r in jeng.run(max_steps=200)}
    assert got == want and all(len(t) == 16 for t in got.values())


def test_paged_cache_raises_in_both_packages(pair):
    with pytest.raises(ValueError, match="paged"):
        JaxPagedKVCache(pair["jmodel"], n_lanes=1, max_len=32, n_pages=5,
                        page_size=8)
    with pytest.raises(ValueError, match="paged"):
        PagedKVCache(pair["model"], n_lanes=1, max_len=32, n_pages=5,
                     page_size=8, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(pair["model"], pair["params"], n_lanes=1, max_len=32,
                      cache="paged", page_size=8)
    assert not pair["model"].supports_paged_cache


@pytest.mark.parametrize("flag", [dict(cache="paged", prefill_chunk=8),
                                  dict(cache="paged", draft=True)])
def test_serve_refuses_the_paged_pool_naming_both_states(flag):
    with pytest.raises(ValueError, match="SSM state and its sliding window"):
        serve_config(ServeConfig(arch=ARCH, device="cpu", n_requests=1,
                                 n_lanes=1, max_new=2, prompt_len=4,
                                 page_size=8, **flag))


def test_serve_config_runs_zamba2_on_cpu_past_the_window():
    out = serve_config(ServeConfig(arch=ARCH, device="cpu", n_requests=2,
                                   n_lanes=2, max_new=6, prompt_len=40,
                                   max_len=64))
    assert out["finished"] == 2
    assert all(len(t) == 6 for t in out["outputs"].values())


# --------------------------------------------------------------------------
# the card's kernels at D 112, on the CPU (no launch)
# --------------------------------------------------------------------------


def test_d112_routes_and_tiles():
    """K1 (both query types) and the bf16 K2 have instances of their own at
    D 112; K1's bf16 tiles are D 128's four, K2's key tiles 32 and 64.  The
    float32 K2 and the paged kernels, which were refused at D 112, run on
    the padded instances of width 128, each with its default tile alone."""
    assert 112 in fa.DENSE_HEAD_DIMS and 112 in fa.TILED_HEAD_DIMS
    assert 112 not in fa.HEAD_DIMS
    assert fa.head_dims("flash_attention", torch.float32) == \
        fa.DENSE_HEAD_DIMS
    for name, dtype in (("flash_decode", torch.float32),
                        ("flash_paged_decode", BF16)):
        assert 112 not in fa.head_dims(name, dtype)
        assert fa.route(name, dtype, 112) == (128, True)
    assert fa.attention_tiles(BF16, 112) == fa.attention_tiles(BF16, 128) \
        == ((64, 64), (64, 128), (128, 64), (128, 128))
    assert fa.smem_bytes(128, 128, 112) == 153_600
    assert pa.decode_block_ks(BF16, 112, dense=True) == \
        pa.DECODE_BLOCK_KS == (32, 64)
    assert pa.decode_block_ks(BF16, 112) == (pa.DECODE_TILE_KEYS,)
    assert pa.prefill_tiles(BF16, 112, 1) == ((32,), (pa.TC_TILE_KEYS,))
    pa.check_tc_shape("flash_paged_prefill", 32, 32, 112)
    q = torch.zeros(1, 32, 1, 112, dtype=BF16)
    assert pa.decode_tile("flash_decode", q, 32) == 32
    for tile in fa.attention_tiles(BF16, 112):
        assert fa.attention_tile("flash_attention", q, *tile) == tile


class _Model:
    def __init__(self, cfg):
        self.cfg = cfg


def test_run_time_ladders_at_d112():
    """The run-time AT's ladders for zamba2 at published widths (bf16, D
    112): ``DecodeBucket``'s dense key tiles 32 and 64 (K2), and the
    padded instances' defaults for the paged kernels."""
    ladders = tile_ladders(_Model(get_arch(ARCH)), 16)
    assert ladders["dense_block_k"] == (32, 64)
    # the paged kernels, which the arch never reaches, would run on the
    # padded instances (width 128), each with its default tile alone
    assert ladders["block_q"] == (32,) and ladders["prefill_block_k"] == (
        pa.TC_TILE_KEYS,)

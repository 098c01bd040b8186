"""whisper-tiny's encoder-decoder in the port against the JAX package on
the CPU.

whisper-tiny is 4 + 4 layers of LayerNorm, GELU (tanh) MLPs and no RoPE:
the encoder's bidirectional self-attention over the (stubbed) audio
frames, the decoder's causal self-attention (with ``qkv_bias``) and its
cross attention over the encoder states, which projects WITHOUT the
``bq``/``bk``/``bv`` biases ``init_attention`` makes.  Its reduced config
(D 16, G 2) and a D-64, G-1 variant (d_model 128, 2 heads, whisper's
head dim) are built on both sides by the same ``dataclasses.replace``;
at each:

* the config copy equals the JAX package's, field for field;
* ``layer_norm``, the tanh GELU and ``sinusoidal_positions`` equal the
  JAX layers;
* ``cross_kv``, ``cross_full`` and ``cross_decode`` with nonzero biases
  loaded on both sides equal the JAX functions, ignore the biases, while
  the decoder's self-attention adds them;
* ``encode``, the prefill logits and both caches (self K/V padded to
  ``max_len``, cross K/V of every layer), and 8 greedy decode steps
  equal the JAX model's (logits at 1e-4, tokens identical), with the
  params' biases and LayerNorm weights made nonzero on both sides;
* ``ops.attention(causal=False)`` with Sq != Sk equals the JAX
  ``attention_ref``; a causal or windowed Sq != Sk call raises;
* the serving engine refuses the arch, naming the frames, and the paged
  pool is refused as in the JAX package.

Inputs are made with numpy from seeds and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.registry import NOT_PORTED
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServeConfig, serve_config
from repro_torch.models import attention as attn
from repro_torch.models import build_model, encdec, layers
from repro_torch.serving import ServingEngine

torch.set_num_threads(1)

ARCH = "whisper-tiny"
TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = ("n_layers", "n_encoder_layers", "d_model", "n_heads", "n_kv_heads",
          "d_ff", "vocab_size", "norm", "act", "use_rope", "qkv_bias",
          "tie_embeddings", "frontend", "frontend_seq", "compute_dtype",
          "cache_dtype", "family")


def small(cfg, name: str):
    """The reduced config (D 16, G 2) or its D-64 variant (2 q / 2 kv
    heads: G 1, as the published config)."""
    cfg = cfg.reduced()
    return cfg if name == "D16" else dataclasses.replace(
        cfg, d_model=128, n_heads=2, n_kv_heads=2, d_head=64)


@pytest.mark.parametrize("size", ["full", "D16", "D64"])
def test_config_copy_matches_jax(size):
    want, got = JAX_ARCHS[ARCH], ARCHS[ARCH]
    if size != "full":
        want, got = small(want, size), small(got, size)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.head_dim == want.head_dim
    assert got.padded_vocab == want.padded_vocab
    assert got.param_count() == want.param_count()
    assert got.is_encoder_decoder and want.is_encoder_decoder
    assert (got.head_dim, got.n_heads // got.n_kv_heads, got.frontend_seq) \
        == {"full": (64, 1, 1500), "D16": (16, 2, 8),
            "D64": (64, 1, 8)}[size]


def test_whisper_is_registered_and_pixtral_still_waits():
    """pixtral-12b waited for item 8b.6, which ported it: nothing waits,
    and the audio stub outside the encoder-decoder family still raises."""
    assert get_arch(ARCH) is ARCHS[ARCH]
    assert NOT_PORTED == {}
    assert get_arch("pixtral-12b") is ARCHS["pixtral-12b"]
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        build_model(dataclasses.replace(get_arch("yi-6b").reduced(),
                                        frontend="audio", frontend_seq=4))
    full = get_arch(ARCH)
    assert full.padded_vocab == 51968
    # 41.2 M parameters (the analytic count, as the JAX package's)
    assert 41.1e6 < full.param_count() < 41.3e6


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    want = jax_layers.layer_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                                 jnp.asarray(b, dtype))
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = layers.layer_norm(*(torch.from_numpy(a).to(tdt)
                              for a in (x, w, b)))
    assert got.dtype == tdt
    tol = TOL if dtype is np.float32 else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_gelu_is_the_tanh_form_as_in_jax():
    x = np.linspace(-6, 6, 401, dtype=np.float32)
    p = {"w_up": np.eye(401, dtype=np.float32)[:, :401],
         "w_down": np.eye(401, dtype=np.float32)}
    want = jax_layers.apply_mlp(p, x[None], act="gelu")
    got = layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x[None]), act="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the erf form differs by more than the tolerance: the choice is seen
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((erf - got[0]).abs().max()) > 1e-4


@pytest.mark.parametrize("seq,dim", [(8, 16), (1500, 384), (7, 64)])
def test_sinusoidal_positions_match_jax(seq, dim):
    want = jax_layers.sinusoidal_positions(seq, dim)
    got = layers.sinusoidal_positions(seq, dim)
    assert got.dtype == torch.float32 and got.shape == (seq, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# cross attention, with biases that the cross path must ignore
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["D16", "D64"])
def attn_pair(request):
    cfg = small(get_arch(ARCH), request.param)
    acfg = encdec._acfg(cfg, False)
    jacfg = jax_encdec._acfg(small(JAX_ARCHS[ARCH], request.param), False)
    jp = jax_attn.init_cross_attention(jax.random.PRNGKey(2), jacfg)
    rng = np.random.default_rng(3)
    jp = {k: (rng.standard_normal(v.shape).astype(np.float32)
              if k.startswith("b") else np.array(v)) for k, v in jp.items()}
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    return cfg, acfg, jacfg, jp, tp


def test_cross_kv_full_and_decode_match_jax_and_skip_the_biases(attn_pair):
    cfg, acfg, jacfg, jp, tp = attn_pair
    assert all(np.abs(jp[b]).max() > 0.1 for b in ("bq", "bk", "bv"))
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    x1 = x[:, :1]
    jk, jv = jax_attn.cross_kv(jp, enc, jacfg)
    k, v = attn.cross_kv(tp, torch.from_numpy(enc), acfg)
    assert k.shape == (2, cfg.n_kv_heads, 11, cfg.head_dim)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    want = jax_attn.cross_full(jp, x, jk, jv, jacfg)
    got = attn.cross_full(tp, torch.from_numpy(x), k, v, acfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want1 = jax_attn.cross_decode(jp, x1, jk, jv, jacfg)
    got1 = attn.cross_decode(tp, torch.from_numpy(x1), k, v, acfg)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **TOL)
    # the cross path ignores the biases: zeroing them changes nothing
    nob = {n: (torch.zeros_like(t) if n.startswith("b") else t)
           for n, t in tp.items()}
    k0, v0 = attn.cross_kv(nob, torch.from_numpy(enc), acfg)
    assert torch.equal(k0, k) and torch.equal(v0, v)
    assert torch.equal(attn.cross_full(nob, torch.from_numpy(x), k, v, acfg),
                       got)
    # ...while the decoder's self-attention adds them, in both packages
    sa, jsa = acfg._replace(causal=True), jacfg._replace(causal=True)
    self_b = attn.full(tp, torch.from_numpy(x), sa)
    np.testing.assert_allclose(self_b.numpy(),
                               np.asarray(jax_attn.full(jp, x, jsa)), **TOL)
    assert float((self_b - attn.full(nob, torch.from_numpy(x), sa))
                 .abs().max()) > 1e-3


@pytest.mark.parametrize("sq,sk,hkv", [(1, 23, 2), (4, 23, 4), (9, 5, 1),
                                       (30, 7, 2)])
def test_ops_attention_cross_length_matches_jax_attention_ref(sq, sk, hkv):
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, hkv, sk, 16)).astype(np.float32)
    v = rng.standard_normal((2, hkv, sk, 16)).astype(np.float32)
    want = jax_ref.attention_ref(q, k, v, causal=False)
    got = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=False, window=4),
                                dict(causal=True, window=4)])
def test_causal_or_windowed_cross_length_raises(kw):
    q = torch.zeros(1, 2, 4, 16)
    k = torch.zeros(1, 2, 9, 16)
    with pytest.raises(ValueError, match="cross attention"):
        ops.attention(q, k, k, **kw)
    with pytest.raises(ValueError, match="cross attention"):
        fa.check_lengths(4, 9, kw["causal"], kw.get("window"))
    fa.check_lengths(9, 9, True, 4)          # self-attention: any mask


def test_k1_wrapper_on_cpu_tensors_raises():
    q = torch.zeros(1, 2, 4, 64)
    k = torch.zeros(1, 2, 1500, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, k, k, causal=False)
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, k, k, causal=False, use_kernel=True)


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------


def _perturb(tree, rng):
    """Every bias and LayerNorm weight of a numpy param tree made nonzero
    (random), the rest kept: the init's zeros and ones would hide a bias
    or an LN bias that one package drops."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        node = np.asarray(node)
        if name in ("bq", "bk", "bv", "w", "b"):
            return (rng.standard_normal(node.shape) * 0.3
                    + (1.0 if name == "w" else 0.0)).astype(node.dtype)
        return node
    return walk(tree)


@pytest.fixture(scope="module", params=["D16", "D64"])
def pair(request):
    """(jax model, jax params, port model, port params) at one of the two
    small configs, biases and LayerNorm weights perturbed."""
    jmodel = jax_build_model(small(JAX_ARCHS[ARCH], request.param))
    jparams = _perturb(jax.tree.map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(0))),
                       np.random.default_rng(5))
    model = build_model(small(get_arch(ARCH), request.param))
    params = params_from_jax(jparams, model.cfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, jparams)
    return dict(jmodel=jmodel, jparams=jparams, model=model, params=params)


def _frames(cfg, b: int, se: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, se, cfg.d_model)).astype(np.float32)


def _prompt(b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 250, (b, s)).astype(
        np.int32)


def test_bridge_carries_the_encdec_tree(pair):
    params = pair["params"]
    jflat = jax.tree_util.tree_flatten_with_path(pair["jparams"])[0]
    assert set(params) == {"frontend_proj", "enc_layers", "enc_ln", "embed",
                           "pos_embed", "dec_layers", "dec_ln"}
    for path, leaf in jflat:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert params["enc_layers"]["attn"]["wq"].shape[0] == \
        pair["model"].cfg.n_encoder_layers
    assert params["dec_layers"]["cross_attn"]["bq"].shape[0] == \
        pair["model"].cfg.n_layers
    # random init: the same tree of shapes as the JAX package's
    mine = build_model(pair["model"].cfg).init(0, "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda a: tuple(a.shape), pair["jparams"])


@pytest.mark.parametrize("se", [None, 20])
def test_encode_matches_jax(pair, se):
    cfg = pair["model"].cfg
    frames = _frames(cfg, 2, se or cfg.frontend_seq, 6)
    want = jax_encdec.encode(pair["jparams"], frames, pair["jmodel"].cfg)
    got = encdec.encode(pair["params"], torch.from_numpy(frames), cfg)
    assert got.shape == (2, frames.shape[1], cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s_len,se", [(5, None), (12, 20)])
def test_prefill_logits_and_caches_match_jax(pair, s_len, se):
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    model, params = pair["model"], pair["params"]
    frames = _frames(model.cfg, 2, se or model.cfg.frontend_seq, 7)
    tokens = _prompt(2, s_len, 8)
    jlogits, jcaches = jmodel.prefill(jparams, tokens, frames, 24)
    logits, caches = model.prefill(params, torch.from_numpy(tokens).long(),
                                   24, frontend_embeds=torch.from_numpy(
                                       frames))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert list(caches) == ["kv", "cross_kv"]
    for key in ("kv", "cross_kv"):
        for got, want in zip(caches[key], jcaches[key], strict=True):
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not caches["kv"][0][:, :, :, s_len:].any()


def test_greedy_decode_tokens_identical_to_jax(pair):
    """Prefill of a 4-token start-of-transcript prompt, then 8 greedy
    decode steps: the tokens are identical, the logits within 1e-4."""
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    model, params = pair["model"], pair["params"]
    frames = _frames(model.cfg, 2, model.cfg.frontend_seq, 9)
    tokens = _prompt(2, 4, 10)
    jlogits, jcaches = jmodel.prefill(jparams, tokens, frames, 16)
    logits, caches = model.prefill(params, torch.from_numpy(tokens).long(),
                                   16, frontend_embeds=torch.from_numpy(
                                       frames))
    jtoks, toks = [], []
    for step in range(8):
        jt = np.asarray(jlogits).argmax(-1).astype(np.int32)
        t = logits.argmax(-1)
        jtoks.append(jt.tolist())
        toks.append(t.tolist())
        pos = np.full((2,), 4 + step, np.int32)
        jlogits, jcaches = jmodel.decode_step(jparams, jcaches, jt[:, None],
                                              pos)
        logits, caches = model.decode_step(params, caches, t[:, None],
                                           torch.from_numpy(pos).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
    assert toks == jtoks
    for got, want in zip(caches["kv"], jcaches["kv"], strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_caches_and_the_position_table_wrap(pair):
    """``init_caches`` gives the JAX package's shapes and dtypes (the cross
    cache at ``frontend_seq`` frames), and a decode position past the
    table's 8192 rows reads row ``pos % 8192``, as the JAX step does."""
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    model, params = pair["model"], pair["params"]
    jcaches = jmodel.init_caches(3, 8)
    caches = model.init_caches(3, 8, device="cpu")
    for got, want in zip(caches["kv"] + caches["cross_kv"],
                         jcaches["kv"] + jcaches["cross_kv"], strict=True):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        assert not got.any()
    pos = torch.tensor([[3], [8192 + 3], [2 * 8192 + 5]])
    got = encdec._embed(params, torch.full((3, 1), 7), pos, model.cfg)
    pe, emb = (np.asarray(jparams[k]) for k in ("pos_embed", "embed"))
    want = emb[7] + pe[pos.numpy() % pe.shape[0]]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[0], got[1])


# --------------------------------------------------------------------------
# what the port does not run for this arch
# --------------------------------------------------------------------------


def test_engine_refuses_the_encoder_decoder(pair):
    with pytest.raises(ValueError, match="frames"):
        ServingEngine(pair["model"], pair["params"], n_lanes=1, max_len=16)
    with pytest.raises(ValueError, match="frames"):
        serve_config(ServeConfig(arch=ARCH, device="cpu", n_requests=1,
                                 n_lanes=1, max_new=2, prompt_len=4))


def test_paged_pool_and_decoder_only_paths_refused(pair):
    model = pair["model"]
    assert not model.supports_paged_cache
    assert not pair["jmodel"].supports_paged_cache
    with pytest.raises(ValueError, match="decoder-only"):
        model.init_paged_caches(4, 8, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        pair["jmodel"].init_paged_caches(4, 8)
    with pytest.raises(ValueError, match="decoder-only"):
        model.forward(pair["params"], torch.zeros(1, 3, dtype=torch.long))
    with pytest.raises(ValueError, match="frontend_embeds"):
        model.prefill(pair["params"], torch.zeros(1, 3, dtype=torch.long))


def test_decoder_archs_refuse_frames_and_the_vision_stub():
    """A decoder arch without a frontend has no ``frontend_proj``, so
    frames raise ``ValueError`` (the JAX package fails there on the
    missing key); a decoder with the vision stub builds and holds one."""
    yi = build_model(get_arch("yi-6b").reduced())
    params = yi.init(0, "cpu")
    with pytest.raises(ValueError, match="no frontend"):
        yi.prefill(params, torch.zeros(1, 3, dtype=torch.long),
                   frontend_embeds=torch.zeros(1, 2, 64))
    vlm = dataclasses.replace(get_arch("yi-6b").reduced(), family="vlm",
                              frontend="vision", frontend_seq=4)
    assert build_model(vlm).init(0, "cpu")["frontend_proj"].shape == (64, 64)
    # layer norm and GELU belong to the encoder-decoder family alone
    for kw in (dict(norm="ln"), dict(act="gelu"), dict(frontend="audio")):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            build_model(dataclasses.replace(get_arch("yi-6b").reduced(),
                                            **kw))

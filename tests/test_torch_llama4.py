"""llama4-scout-17b-a16e in the port against the JAX package on the CPU.

llama4-scout is an ``attn_moe`` stack: 16 experts, top-1 routing and one
shared expert, 40 query heads over 8 kv heads (G 5, D 128).  Its reduced
config has 4 over 2 (G 2, D 16) and 4 experts; a second small config at
G 5 (10 query heads over 2) is built on both sides by the same
``dataclasses.replace``.  At each:

* the config copy equals the JAX package's, field by field, with the
  same parameter counts (107.8 B at published widths; the 12-layer cut
  that one card serves holds 57.0 GB of bf16 weights);
* ``models/moe.py`` at top-1 with a shared expert against the JAX
  ``apply_moe``: the combine weight top-1 gives (1 for a kept pair), the
  tie order of the stable sort at k 1 (the lower expert index, as
  ``jax.lax.top_k``), and the capacity at the published ``moe_group_size``
  512 and capacity factor 1.25, where a 600-token call drops pairs;
* prefill and decode logits equal the JAX model's at 1e-4;
* greedy tokens equal the JAX ``ServingEngine``'s on dense lanes and on
  the paged pool: chunked prefill, int8 pages (split-KV on the port's
  side, which the plain route ignores) and speculative decoding with the
  self-speculative draft.

The card's tensor-core prefill kernel (K4, K5b, K6c, K6d) takes G 5
through its 80-row tile: the tile rules at G 5 and the run-time AT's
ladders, which follow them, and ``ops``' guard that keeps a tile
published for another group size (yi-6b's 32-row block_q 4 at G 8 would
be a 20-row tile at G 5) off a G-5 launch.

Inputs are made with numpy from seeds and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.at as at
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.registry import NOT_PORTED
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch.serve import ServeConfig, serve_config, tile_ladders
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.serving import Request, ServingEngine
from test_torch_phi4 import plain_prefill_matches_jax

torch.set_num_threads(1)

ARCH = "llama4-scout-17b-a16e"
KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = torch.bfloat16
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab_size", "rope_theta", "window", "compute_dtype",
          "cache_dtype", "tie_embeddings", "qkv_bias", "family", "n_experts",
          "top_k", "n_shared_experts", "capacity_factor", "moe_group_size")


def small(cfg, name: str):
    """The reduced config (G 2) or its G-5 variant (10 q / 2 kv heads)."""
    cfg = cfg.reduced()
    return cfg if name == "G2" else dataclasses.replace(cfg, n_heads=10,
                                                        n_kv_heads=2)


@pytest.mark.parametrize("size", ["full", "G2", "G5"])
def test_config_copy_matches_jax(size):
    want, got = JAX_ARCHS[ARCH], ARCHS[ARCH]
    if size != "full":
        want, got = small(want, size), small(got, size)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.head_dim == want.head_dim
    assert got.padded_vocab == want.padded_vocab
    assert got.layer_kinds() == want.layer_kinds() == ["attn_moe"] * \
        got.n_layers
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    g = got.n_heads // got.n_kv_heads
    assert g == {"full": 5, "G2": 2, "G5": 5}[size]


def test_llama4_is_registered_and_its_cut_fits_one_card():
    assert get_arch(ARCH) is ARCHS[ARCH]
    assert ARCH not in NOT_PORTED
    full = get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.n_experts, full.top_k,
            full.n_shared_experts, full.d_ff, full.vocab_size) == (
        48, 5120, 40, 8, 128, 16, 1, 1, 8192, 202048)
    # 107.8 B parameters, 215.5 GB of bf16: more than one 80 GB card
    assert 107.7e9 < full.param_count() < 107.9e9
    # the depth cut chip_smoke.py serves: 12 of 48 layers, 57.0 GB
    cut = dataclasses.replace(full, n_layers=12)
    assert 56.95e9 < 2 * cut.param_count() < 57.05e9
    assert cut.param_count() == dataclasses.replace(
        JAX_ARCHS[ARCH], n_layers=12).param_count()


# --------------------------------------------------------------------------
# the MoE at top-1 with a shared expert, against the JAX apply_moe
# --------------------------------------------------------------------------


def mk(e=16, k=1, cf=1.25, shared=1, group=512, d=16, ff=8):
    """(JAX config, JAX params, port config, port params): the JAX
    ``init_moe`` weights, bridged; llama4's routing by default."""
    jcfg = jmoe.MoEConfig(d_model=d, d_ff=ff, n_experts=e, top_k=k,
                          n_shared_experts=shared, capacity_factor=cf,
                          group_size=group)
    jp = jmoe.init_moe(KEY, jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, jp, moe.MoEConfig(*jcfg), tp


def normal(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 600, 16), (4, 1, 16), (4, 5, 16)])
def test_top1_moe_matches_jax_at_published_routing(shape):
    """llama4's routing (16 experts, top-1, one shared, groups of 512,
    capacity factor 1.25) on a 600-token call (a group of 512, capacity
    40, and a ragged tail of 88), a decode tick of 4 lanes and a verify of
    4 x 5: out and aux equal the JAX layer's at 1e-5; the 600-token call
    drops pairs, the small ones never."""
    jcfg, jp, cfg, p = mk()
    x = normal(shape, seed=shape[1])
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    with moe.trace_routing() as calls:
        out, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MOE_TOL)
    keep = calls[0]["keep"]
    assert calls[0]["top_i"].shape == keep.shape == (shape[0] * shape[1], 1)
    assert (int((~keep).sum()) > 0) == (shape[1] == 600)


def test_top1_combine_weight_is_one():
    """At k 1 the renormalised gate is p / p = 1: a kept token's routed
    output is its expert's output itself (the shared expert off), and a
    dropped one's is zero, as the JAX combine tensor gives."""
    jcfg, jp, cfg, p = mk(cf=0.25, shared=0, group=64)
    x = normal((1, 64, 16), seed=9)
    jout, _ = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    with moe.trace_routing() as calls:
        out, _ = moe.apply_moe(p, torch.from_numpy(x), cfg)
    top_i, keep = calls[0]["top_i"][:, 0], calls[0]["keep"][:, 0]
    assert (~keep).sum() > 0 and keep.sum() > 0
    xt = torch.from_numpy(x[0])
    for tok in range(64):
        e = int(top_i[tok])
        h = torch.nn.functional.silu(xt[tok] @ p["w_gate"][e]) \
            * (xt[tok] @ p["w_up"][e])
        want = h @ p["w_down"][e] if keep[tok] else torch.zeros(16)
        torch.testing.assert_close(out[0, tok], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MOE_TOL)


def test_top1_ties_go_to_the_lower_index():
    """A stable descending sort at k 1 picks the lowest of tied experts,
    as ``jax.lax.top_k`` does, and the router's ties route so in both
    layers: a router with two equal columns sends every token to the
    lower of them."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25] * 4, [0.4, 0.1, 0.4, 0.1],
                      [0.0, 0.0, 0.5, 0.5]], np.float32)
    vals, idx = moe._top_k(torch.from_numpy(probs), 1)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert idx[:, 0].tolist() == [1, 0, 0, 2]
    jcfg, jp, cfg, p = mk(e=4, group=16)
    router = np.zeros((16, 4), np.float32)
    router[:, 1] = router[:, 3] = 2.0       # experts 1 and 3 always tie
    x = np.abs(normal((1, 16, 16), seed=10))
    jp, p = dict(jp, router=jnp.asarray(router)), dict(
        p, router=torch.from_numpy(router))
    jout, _ = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    with moe.trace_routing() as calls:
        out, _ = moe.apply_moe(p, torch.from_numpy(x), cfg)
    assert set(calls[0]["top_i"][:, 0].tolist()) == {1}
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MOE_TOL)


def test_capacity_at_published_routing():
    full = get_arch(ARCH)
    mcfg = moe.MoEConfig(full.d_model, full.d_ff, full.n_experts,
                         full.top_k, full.n_shared_experts,
                         full.capacity_factor, full.moe_group_size)
    jcfg = jmoe.MoEConfig(*mcfg)
    assert (mcfg.group_size, mcfg.capacity_factor) == (512, 1.25)
    # decode (4 lanes) and verify (4 x 5) never drop; a 128-token chunk has
    # 10 slots an expert against a mean load of 8, a 512-token group 40
    for g, c in ((4, 4), (20, 4), (128, 10), (512, 40)):
        assert moe.capacity(mcfg, g) == jmoe.capacity(jcfg, g) == c


# --------------------------------------------------------------------------
# the model and the engines at the two small configs
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["G2", "G5"])
def pair(request):
    """Both packages' model, weights and self-speculative draft at one of
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


def test_prefill_and_decode_logits_match_jax(pair):
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    model, params = pair["model"], pair["params"]
    tokens = np.array([[3, 17, 42, 9, 250, 64, 7, 11, 90, 23, 5]], np.int32)
    jlogits, jcaches = jmodel.prefill(jparams, tokens, None, 16)
    logits, caches = model.prefill(params, torch.from_numpy(tokens).long(),
                                   16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    tok = int(np.argmax(np.asarray(jlogits)[0]))
    for step in range(3):
        pos = np.array([tokens.shape[1] + step], np.int32)
        jlogits, jcaches = jmodel.decode_step(
            jparams, jcaches, np.array([[tok]], np.int32), pos)
        logits, caches = model.decode_step(
            params, caches, torch.tensor([[tok]]),
            torch.from_numpy(pos).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        tok = int(np.argmax(np.asarray(jlogits)[0]))


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


def test_serve_config_runs_llama4_on_cpu():
    out = serve_config(ServeConfig(arch=ARCH, device="cpu", n_requests=2,
                                   n_lanes=2, max_new=3, prompt_len=6,
                                   cache="paged", page_size=8,
                                   prefill_chunk=4))
    assert out["finished"] == 2
    assert all(len(t) == 3 for t in out["outputs"].values())


# --------------------------------------------------------------------------
# the card's prefill tiles at llama4's G 5, on the CPU (no launch)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("g,block_qs,default", [
    (5, (16,), 16), (10, (8,), 8), (40, (2,), 2), (3, (16,), 16),
    (8, (2, 4, 8), 4), (1, (16, 32, 64), 32)])
def test_prefill_tiles_and_default_by_group_size(g, block_qs, default):
    """G 5 (and 10, 40) get the 80-row tile, block_q 80 / G, also their
    untuned default; G 1, 3 and 8 keep their ladders (block_q a power of
    two: 80 rows would be block_q 80, 26.7 and 10)."""
    assert pa.prefill_tiles(BF16, 128, g) == (block_qs, pa.TC_BLOCK_KS)
    assert pa.default_block_q(128, g) == default
    q = torch.zeros(1, 8 * g, 5, 128, dtype=BF16)
    assert pa.prefill_tile("k", q, 8, None, None) == (default, 128)
    pa.check_tc_shape("k", 8 * g, 8, 128)


@pytest.mark.parametrize("h,hkv,d", [(40, 8, 64), (56, 8, 128),
                                     (20, 4, 32)])
def test_g5_at_other_head_dims_and_g7_raise(h, hkv, d):
    """The 80-row tile is a D 128 instance: G 5 at D 64 or 32 has no row
    tile of whole positions, and G 7 divides no tile; both were refused
    and now run on the flattened (position, head) rows, their tiles named
    by their rows (32 by default), the plain prefill at the shape within
    1e-5 of the JAX kernel in interpret mode."""
    g = h // hkv
    pa.check_tc_shape("k", h, hkv, d)
    assert pa.flattened(d, g) and pa.default_block_q(d, g) == 32
    q = torch.zeros(1, h, 5, d, dtype=BF16)
    assert pa.prefill_tile("k", q, hkv, None, None) == (32, 128)
    plain_prefill_matches_jax(h, hkv, d, seed=h + d)


class _Model:
    def __init__(self, cfg):
        self.cfg = cfg


def test_run_time_ladders_follow_the_prefill_tiles_at_g5():
    """``PrefillBucket``'s and ``SpecBucket``'s ladders at llama4's
    published widths (bf16, D 128, G 5): the 80-row tile's block_q 16 by
    keys 64 and 128, so the tuner publishes no tile without an instance."""
    ladders = tile_ladders(_Model(get_arch(ARCH)), 16)
    assert ladders["block_q"] == (16,)
    assert ladders["prefill_block_k"] == pa.TC_BLOCK_KS
    assert ladders["dense_block_k"] == pa.DECODE_BLOCK_KS


@pytest.fixture
def published():
    at.clear_published()
    yield
    at.clear_published()


NAMES = ("block_q", "block_k", "num_splits", "scale")


@pytest.mark.parametrize("key", ["flash_paged_prefill", "flash_paged_verify"])
def test_a_tile_published_for_g8_never_reaches_a_g5_launch(published, key):
    """``at.tuned`` is shape-blind: yi-6b's tuned prefill tile (block_q 4,
    32 rows at G 8) stays published while llama4 (G 5) launches.  ``ops``
    hands the kernel a published tile only where it has an instance at
    the launch's shape, so the G-5 launch runs its default (16, 128) and
    the G-8 one the published tile; an explicit tile is handed on as it
    is (and raises in the wrapper if it has no instance)."""
    at.publish(key, block_q=4, block_k=64, num_splits=8)
    fits = {g: ops._prefill_fits(key, torch.zeros(1, 8 * g, 5, 128,
                                                  dtype=BF16), 8)
            for g in (5, 8)}
    assert ops._tuned(key, NAMES, fits[8]) == dict(block_q=4, block_k=64,
                                                   num_splits=8)
    assert ops._tuned(key, NAMES, fits[5]) == dict(num_splits=8)
    assert ops._tuned(key, NAMES, fits[5], block_q=4) == dict(block_q=4,
                                                             num_splits=8)
    at.publish(key, block_q=16)
    assert ops._tuned(key, NAMES, fits[5]) == dict(block_q=16, block_k=64,
                                                   num_splits=8)
    with pytest.raises(ValueError, match="no instance"):
        pa.prefill_tile(key, torch.zeros(1, 40, 5, 128, dtype=BF16), 8, 4,
                        None)


@pytest.mark.parametrize("published,g,want", [
    (dict(block_k=64), 5, dict(block_k=64)),
    (dict(block_k=32), 5, {}),
    (dict(block_q=8), 8, dict(block_q=8)),
    (dict(block_q=8), 5, {})])
def test_a_partly_published_prefill_tile_is_checked_with_the_default(
        published, g, want):
    """A region may publish one of the two values (phase 27's tuned serve
    publishes whole tiles, a user may publish one): the other is the
    default's, and the pair is checked at the launch's shape."""
    at.clear_published()
    try:
        at.publish("flash_paged_prefill", **published)
        q = torch.zeros(1, 8 * g, 5, 128, dtype=BF16)
        assert ops._tuned("flash_paged_prefill", NAMES,
                          ops._prefill_fits("flash_paged_prefill", q,
                                            8)) == want
    finally:
        at.clear_published()


def test_a_published_k1_tile_is_checked_at_the_head_dim(published):
    """K1's published tile is handed on at D 128 and 80 (every tile) and
    not at D 64, which has 64 x 64 only; a published block_k alone is
    checked with the default block_q."""
    names = ("block_q", "block_k", "scale")
    at.publish("flash_attention", block_q=128, block_k=128)
    for d, want in ((128, dict(block_q=128, block_k=128)),
                    (80, dict(block_q=128, block_k=128)), (64, {})):
        q = torch.zeros(1, 8, 4, d, dtype=BF16)
        assert ops._tuned("flash_attention", names,
                          ops._attention_fits(q)) == want
    at.clear_published()
    at.publish("flash_attention", block_k=128)
    q = torch.zeros(1, 8, 4, 80, dtype=BF16)
    assert ops._tuned("flash_attention", names,
                      ops._attention_fits(q)) == dict(block_k=128)


def test_a_decode_tile_without_an_instance_is_not_handed_on(published):
    """The decode kernels' key tiles: 32 has an instance at D 128 and 80,
    not at D 64, where a published 32 gives way to the default."""
    at.publish("flash_decode", block_k=32)
    names = ("block_k", "scale")
    for d, want in ((128, {"block_k": 32}), (80, {"block_k": 32}),
                    (64, {})):
        q = torch.zeros(1, 8, 1, d, dtype=BF16)
        assert ops._tuned("flash_decode", names,
                          ops._decode_fits("flash_decode", q)) == want

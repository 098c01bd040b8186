"""phi4-mini-3.8b in the port against the JAX package on the CPU.

phi4-mini is a plain ``attn_mlp`` stack with tied embeddings and 24
query heads over 8 kv heads (G 3, D 128).  Its reduced config has 4 over
2 (G 2, D 16), so a second small config with 6 query heads over 2 (G 3)
is built on both sides by the same ``dataclasses.replace``.  At each:

* the config copy equals the JAX package's, field by field;
* the bridge carries the tied embedding across (there is no ``lm_head``
  leaf), and prefill and decode logits equal the JAX model's at 1e-4;
* greedy tokens equal the JAX ``ServingEngine``'s on dense lanes and on
  the paged pool: chunked prefill, int8 pages (with split-KV on the port's
  side, which the plain route ignores, as the JAX ops do on the CPU) and
  speculative decoding with the self-speculative draft.

The card's tensor-core prefill kernel (K4, K5b, K6c, K6d) takes G 3
through its 48-row tile: the tile rules (``prefill_tiles``,
``check_tc_shape``, the untuned default) at G 1, 2, 3, 4 and 8, and the
run-time AT's ladders (``launch.serve.tile_ladders``), which follow them.

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
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.registry import NOT_PORTED
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch.serve import ServeConfig, serve_config, tile_ladders
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine

torch.set_num_threads(1)

ARCH = "phi4-mini-3.8b"
TOL = dict(rtol=1e-4, atol=1e-4)
BF16 = torch.bfloat16
FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab_size", "rope_theta", "window", "compute_dtype",
          "cache_dtype", "tie_embeddings", "qkv_bias", "family")


def small(cfg, name: str):
    """The reduced config (G 2) or its G-3 variant (6 q / 2 kv heads)."""
    cfg = cfg.reduced()
    return cfg if name == "G2" else dataclasses.replace(cfg, n_heads=6,
                                                        n_kv_heads=2)


@pytest.mark.parametrize("size", ["full", "G2", "G3"])
def test_config_copy_matches_jax(size):
    want, got = JAX_ARCHS[ARCH], ARCHS[ARCH]
    if size != "full":
        want, got = small(want, size), small(got, size)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.head_dim == want.head_dim
    assert got.padded_vocab == want.padded_vocab
    assert got.layer_kinds() == want.layer_kinds() == ["attn_mlp"] * \
        got.n_layers
    g = got.n_heads // got.n_kv_heads
    assert g == {"full": 3, "G2": 2, "G3": 3}[size]


def test_phi4_is_registered_and_no_longer_waits():
    assert get_arch(ARCH) is ARCHS[ARCH]
    assert ARCH not in NOT_PORTED
    full = get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size) == (
        32, 3072, 24, 8, 128, 8192, 200064)
    assert full.tie_embeddings


@pytest.fixture(scope="module", params=["G2", "G3"])
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


def test_bridge_carries_the_tied_embedding(pair):
    params, jparams = pair["params"], pair["jparams"]
    assert "lm_head" not in params and "lm_head" not in jparams
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  np.asarray(jparams["embed"]))


def test_prefill_and_decode_logits_match_jax(pair):
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    model, params = pair["model"], pair["params"]
    tokens = np.array([[3, 17, 42, 9, 250, 64, 7]], np.int32)
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


def test_serve_config_runs_phi4_on_cpu():
    out = serve_config(ServeConfig(arch=ARCH, device="cpu", n_requests=2,
                                   n_lanes=2, max_new=3, prompt_len=6,
                                   cache="paged", page_size=8,
                                   prefill_chunk=4))
    assert out["finished"] == 2
    assert all(len(t) == 3 for t in out["outputs"].values())


# --------------------------------------------------------------------------
# the card's prefill tiles at phi4's G 3, on the CPU (no launch)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("g,block_qs,default", [
    (1, (16, 32, 64), 32), (2, (8, 16, 32), 16), (3, (16,), 16),
    (4, (4, 8, 16), 8), (8, (2, 4, 8), 4)])
def test_prefill_tiles_and_default_by_group_size(g, block_qs, default):
    """G 3 gets the 48-row tile (block_q 16), which is also its untuned
    default; G 1, 2, 4 and 8 keep their ladders (block_q a power of two:
    48 rows would be block_q 48, 24, 12 and 6) and the 32-row default."""
    assert pa.prefill_tiles(BF16, 128, g) == (block_qs, pa.TC_BLOCK_KS)
    assert pa.default_block_q(128, g) == default
    q = torch.zeros(1, 4 * g, 5, 128, dtype=BF16)
    assert pa.prefill_tile("k", q, 4, None, None) == (default, 128)
    pa.check_tc_shape("k", 4 * g, 4, 128)


@pytest.mark.parametrize("h,hkv,d", [(24, 8, 64), (56, 8, 128),
                                     (12, 4, 32)])
def test_group_sizes_without_a_row_tile_raise(h, hkv, d):
    """G 3 at head dims other than 128 (32-row tiles only) and G 7 (which
    divides no row tile; llama4-scout's G 5 has the 80-row tile since
    it was ported) have no row tile of whole positions, and were refused;
    they now run on the flattened (position, head) rows: the ladder names
    their one tile by its rows, 32, and the plain prefill at the
    shape agrees with the JAX kernel in interpret mode within 1e-5."""
    g = h // hkv
    pa.check_tc_shape("k", h, hkv, d)
    assert pa.flattened(d, g)
    assert pa.default_block_q(d, g) == pa.TC_TILE_ROWS
    assert pa.prefill_tiles(BF16, d, g)[0] == (pa.TC_TILE_ROWS,)
    assert pa.prefill_rows(d, g, pa.default_block_q(d, g)) == 32
    plain_prefill_matches_jax(h, hkv, d)


def plain_prefill_matches_jax(h, hkv, d, seed=0):
    """The port's plain prefill (what its wrappers run on a CPU tensor) at
    (H, Hkv, D) against the JAX ``flash_paged_prefill`` in interpret mode:
    two lanes, chunks of 5 at 12 and of 3 at 0, pages of 8."""
    from repro.kernels.flash_attention import flash_paged_prefill
    from repro_torch.kernels import ref
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, h, 5, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((9, hkv, 8, d)).astype(np.float32)
              for _ in range(2))
    table = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    start, lens = np.array([12, 0], np.int32), np.array([17, 3], np.int32)
    got = ref.paged_prefill_ref(*(torch.from_numpy(x) for x in (
        q, kp, vp, table, start, lens))).numpy()
    want = np.asarray(flash_paged_prefill(q, kp, vp, table, start, lens,
                                          block_q=8, interpret=True))
    for i, n in enumerate((5, 3)):
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n],
                                   rtol=1e-5, atol=1e-5)


class _Model:
    def __init__(self, cfg):
        self.cfg = cfg


@pytest.mark.parametrize("arch,block_q", [("phi4-mini-3.8b", (16,)),
                                          ("yi-6b", (2, 4, 8)),
                                          ("deepseek-7b", (16, 32, 64))])
def test_run_time_ladders_follow_the_prefill_tiles(arch, block_q):
    """``PrefillBucket``'s and ``SpecBucket``'s ladders are
    ``tile_ladders``': at phi4's published widths (bf16, D 128, G 3) the
    48-row tile's block_q 16 by keys 64 and 128."""
    ladders = tile_ladders(_Model(get_arch(arch)), 16)
    assert ladders["block_q"] == block_q
    assert ladders["prefill_block_k"] == pa.TC_BLOCK_KS

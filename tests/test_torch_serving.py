"""The PyTorch port against the JAX package on the CPU, at the reduced
configs (float32 compute and cache).

Same weights on both sides: the JAX model's ``init`` is converted to
numpy and loaded through ``repro_torch.bridge.params_from_jax``.  Logits
are compared at rtol/atol 1e-4 (both sides sum float32 products, in
different orders); greedy tokens through the two serving engines must be
identical.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import sampling as jax_sampling
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.serve import ServeConfig, serve_config
from repro_torch.models import build_model
from repro_torch.models import layers
from repro_torch.serving import Request, ServingEngine, sampling

torch.set_num_threads(1)

ARCH_IDS = ["yi-6b", "deepseek-7b"]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=ARCH_IDS)
def pair(request):
    """(jax model, jax params, port model, port params) for one arch."""
    jcfg = JAX_ARCHS[request.param].reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_arch(request.param).reduced())
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def jax_steps(pair):
    """The JAX engine's jitted decode and prefill steps, shared by every
    JAX engine of one arch so each compiles once per shape."""
    jmodel = pair[0]
    return dict(decode_fn=jax.jit(jmodel.decode_step),
                prefill_fn=jax.jit(jmodel.prefill, static_argnums=(3,)))


def _prompts():
    """Four prompts of two lengths (few JAX prefill traces)."""
    return [[1 + i] + [(7 * i + 3 * j) % 200 + 2
                       for j in range(5 + 3 * (i % 2))] for i in range(4)]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# --------------------------------------------------------------------------
# configs and bridge
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_jax(arch, reduced):
    want, got = JAX_ARCHS[arch], ARCHS[arch]
    if reduced:
        want, got = want.reduced(), got.reduced()
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "rope_theta", "window", "compute_dtype",
                  "cache_dtype", "tie_embeddings", "qkv_bias"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.head_dim == want.head_dim
    assert got.padded_vocab == want.padded_vocab
    assert got.layer_kinds() == want.layer_kinds()


def test_get_arch_names_the_roadmap_item_for_unported_archs():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_arch("falcon-mamba-7b")
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_bridge_keeps_layout_and_casts_to_compute_dtype(pair):
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    layers_p = params["layers"]
    assert layers_p["attn"]["wq"].shape == (
        cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert layers_p["mlp"]["w_down"].shape == (cfg.n_layers, cfg.d_ff,
                                               cfg.d_model)
    assert params["lm_head"].shape == (cfg.d_model, cfg.padded_vocab)
    np.testing.assert_array_equal(
        params["layers"]["attn"]["wk"].numpy(),
        np.asarray(jparams["layers"]["attn"]["wk"]))
    assert all(t.dtype == torch.float32 for t in _leaves(params))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jax_layers.rms_norm(x, w)), **TOL)


@pytest.mark.parametrize("positions_shape", ["seq", "batch"])
def test_apply_rope_split_half_matches_jax(positions_shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 6, 16)).astype(np.float32)
    pos = (np.arange(6, dtype=np.int32) if positions_shape == "seq"
           else np.array([[5], [40]], np.int32).repeat(6, 1))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            5e6).numpy()
    want = np.asarray(jax_layers.apply_rope(x, pos, 5e6))
    np.testing.assert_allclose(got, want, **TOL)


def test_apply_mlp_matches_jax():
    rng = np.random.default_rng(2)
    p = {k: rng.uniform(-0.1, 0.1, size=s).astype(np.float32)
         for k, s in (("w_up", (64, 128)), ("w_gate", (64, 128)),
                      ("w_down", (128, 64)))}
    x = rng.normal(size=(3, 64)).astype(np.float32)
    got = layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_layers.apply_mlp(p, x)),
                               **TOL)


def test_init_draws_the_jax_distributions():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, 256, 512)
    bound = 1.0 / 16.0
    assert w.shape == (256, 512)
    assert float(w.abs().max()) <= bound
    assert abs(float(w.std()) - bound / np.sqrt(3.0)) < 2e-3
    e = layers.embed_init(gen, 512, 256)
    assert abs(float(e.std()) - 0.02) < 1e-3 and abs(float(e.mean())) < 1e-3


# --------------------------------------------------------------------------
# model: prefill + decode logits
# --------------------------------------------------------------------------


def test_prefill_and_decode_logits_match_jax(pair):
    jmodel, jparams, model, params = pair
    tokens = np.array([[3, 17, 42, 9, 250, 64, 7]], np.int32)
    max_len = 16
    jlogits, jcaches = jmodel.prefill(jparams, tokens, None, max_len)
    logits, caches = model.prefill(params, torch.from_numpy(tokens).long(),
                                   max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(caches["kv"][0].numpy(),
                               np.asarray(jcaches["kv"][0]), **TOL)
    tok = int(np.argmax(np.asarray(jlogits)[0]))
    for step in range(3):
        pos = np.array([tokens.shape[1] + step], np.int32)
        jlogits, jcaches = jmodel.decode_step(
            jparams, jcaches, np.array([[tok]], np.int32), pos)
        logits, caches = model.decode_step(
            params, caches, torch.tensor([[tok]]), torch.from_numpy(pos).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        tok = int(np.argmax(np.asarray(jlogits)[0]))


def test_batched_decode_with_idle_lane_matches_jax(pair):
    """Two lanes at different positions, one of them idle at pos 0 as the
    engine leaves it: the in-place cache write lands per lane."""
    jmodel, jparams, model, params = pair
    jc = jmodel.init_caches(2, 12)
    tc = model.init_caches(2, 12, device="cpu")
    token = np.array([[5], [77]], np.int32)
    for pos in ([0, 3], [1, 4], [0, 5]):
        pos = np.array(pos, np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, token, pos)
        tl, tc = model.decode_step(params, tc, torch.from_numpy(token).long(),
                                   torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["kv"][1].numpy(), np.asarray(jc["kv"][1]),
                               **TOL)


# --------------------------------------------------------------------------
# serving engine: greedy tokens identical to the JAX engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("timeslice", [None, 2])
def test_engine_greedy_tokens_identical_to_jax(pair, jax_steps, timeslice):
    jmodel, jparams, model, params = pair
    jeng = JaxEngine(jmodel, jparams, n_lanes=2, max_len=64,
                     timeslice=timeslice, **jax_steps)
    eng = ServingEngine(model, params, n_lanes=2, max_len=64,
                        timeslice=timeslice)
    for i, prompt in enumerate(_prompts()):
        jeng.submit(JaxRequest(rid=i, prompt=prompt, max_new_tokens=6))
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=6))
    want = {r.rid: r.out_tokens for r in jeng.run(max_steps=100)}
    got = {r.rid: r.out_tokens for r in eng.run(max_steps=100)}
    assert got == want
    assert all(len(t) == 6 for t in got.values())
    assert eng.steps == jeng.steps
    assert eng.scheduler.preemptions == jeng.scheduler.preemptions
    if timeslice is not None:
        assert eng.scheduler.preemptions > 0


def test_swap_out_in_round_trips_a_lane(pair):
    _, _, model, params = pair
    eng = ServingEngine(model, params, n_lanes=2, max_len=32)
    eng.submit(Request(rid=0, prompt=[4, 5, 6], max_new_tokens=4))
    eng.step()
    before = [t.clone() for t in eng.kv.caches["kv"]]
    handle = eng.kv.swap_out(0)
    for t in eng.kv.caches["kv"]:
        t[:, 0].zero_()
    eng.kv.swap_in(0, handle)
    for a, b in zip(before, eng.kv.caches["kv"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 7])
def test_sampling_matches_jax_sampler(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(3, 50)).astype(np.float32)
    sps = [sampling.SamplingParams(temperature=0.8, top_k=10, top_p=0.9,
                                   seed=seed + i) for i in range(3)]
    jsps = [jax_sampling.SamplingParams(temperature=0.8, top_k=10, top_p=0.9,
                                        seed=seed + i) for i in range(3)]
    assert sampling.sample_batch(logits, sps, [0, 4, 9]) == \
        jax_sampling.sample_batch(logits, jsps, [0, 4, 9])


def test_engine_rejects_the_paths_of_later_slices(pair):
    _, _, model, params = pair
    for kw in ({"spec_k": 2}, {"prefix_cache": True},
               {"autotuner": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(model, params, n_lanes=2, max_len=32, **kw)
    # chunked prefill, int8 pages and split-KV are paged-pool features,
    # as in JAX
    for kw in ({"prefill_chunk": 8}, {"kv_dtype": "int8"},
               {"num_splits": 2}):
        with pytest.raises(ValueError, match="paged"):
            ServingEngine(model, params, n_lanes=2, max_len=32, **kw)


# --------------------------------------------------------------------------
# the serve entry point
# --------------------------------------------------------------------------


def test_serve_config_on_cpu_finishes_and_reports():
    out = serve_config(ServeConfig(n_requests=5, n_lanes=2, max_new=4,
                                   timeslice=2, device="cpu"))
    assert out["finished"] == out["requests"] == 5
    assert out["device"] == "cpu"
    assert all(len(t) == 4 for t in out["outputs"].values())
    assert out["generated_tokens"] == 20
    assert out["preemptions"] > 0
    assert out["cache"]["kind"] == "dense"
    for key in ("tokens_per_s", "p50_ttft_s", "p99_ttft_s", "p50_itl_s",
                "p99_itl_s", "wall_s", "decode_steps", "p50_queue_wait_s",
                "mean_ttft_s", "kv_dtype", "config"):
        assert key in out
    assert out["config"]["device"] == "cpu"


def test_profile_decode_runs_the_engine_on_cpu():
    from repro_torch.launch.profile_decode import profile_decode
    out = profile_decode(n_lanes=2, max_len=32, prompt_len=8, steps=2,
                         device="cpu")
    assert out["host_ms_per_tick"] > 0
    assert out["device_ms_per_tick"] == 0.0      # no card, no device time


def test_profile_decode_traces_the_paged_tick_on_cpu():
    from repro_torch.launch.profile_decode import profile_decode
    out = profile_decode(n_lanes=2, max_len=32, prompt_len=12, steps=2,
                         device="cpu", cache="paged", prefill_chunk=4)
    assert out["host_ms_per_tick"] > 0
    assert out["device_ms_per_tick"] == 0.0


def test_serve_config_paged_chunked_on_cpu_reports_the_pool():
    out = serve_config(ServeConfig(n_requests=4, n_lanes=2, max_new=4,
                                   cache="paged", page_size=8,
                                   prefill_chunk=4, device="cpu"))
    assert out["finished"] == 4
    assert all(len(t) == 4 for t in out["outputs"].values())
    assert out["prefill_chunks"] >= 4
    assert out["cache"]["kind"] == "paged"
    assert out["cache"]["n_pages"] == 2 * 12 + 1     # ceil(96 / 8) per lane
    assert out["cache"]["used_pages"] == 0           # all released


def test_tick_split_dispatch_then_emit_equals_step(pair):
    """``step`` is ``schedule`` + ``dispatch`` + ``emit``; a dispatched
    tick's logits stay on the device until ``emit`` (``block`` waits on
    the tick's event, a no-op on the CPU)."""
    _, _, model, params = pair
    outs = []
    for manual in (False, True):
        eng = ServingEngine(model, params, n_lanes=2, max_len=32)
        for i, prompt in enumerate(_prompts()[:3]):
            eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=4))
        while eng.scheduler.has_queued or eng.active:
            if manual:
                eng.schedule()
                work = eng.dispatch()
                if work is not None:
                    assert work.logits.shape == (2, model.cfg.padded_vocab)
                    assert work.event is None
                    work.block()
                eng.emit(work)
            else:
                eng.step()
        outs.append({r.rid: r.out_tokens for r in eng.finished})
    assert outs[0] == outs[1]

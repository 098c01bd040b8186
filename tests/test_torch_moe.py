"""The MoE layer and moonshot-v1-16b-a3b in the port against the JAX
package on the CPU.

* ``models/moe.py``: every case of ``tests/test_moe.py`` (output shape,
  the ragged tail, dropping at tight capacity, drop-free capacity, the
  shared expert rescuing dropped rows, the aux loss under a forced
  imbalance, the capacity formula), plus k 6 over 64 experts with drops,
  where the port's one-pass queue positions meet the reference's six
  passes.  The JAX ``init_moe`` weights are bridged to the port, and out
  and aux must agree at 1e-5, the rows the reference drops exactly zero
  on both sides.  Ties in top-k go to the lower expert index, as
  ``jax.lax.top_k``; a replayed call takes the recorded call's routing.
* moonshot's config copy equals the JAX package's field by field, at
  full size and reduced, with the same parameter counts.
* The bridge carries every MoE leaf with the JAX layout, and the
  self-speculative draft's MoE leaves are views of the target's.
* At ``reduced()`` (capacity factor 4.0, drop-free) and at capacity
  factor 0.5 (which drops): prefill and decode logits within 1e-4 of the
  JAX model's, and greedy tokens equal to the JAX ``ServingEngine``'s on
  dense lanes, the paged pool in chunks, int8 pages with splits and
  speculative decoding.  At 0.5 the port's serve must drop pairs, and
  its tokens must differ from those at 4.0.

Inputs are made with numpy from seeds and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.registry import NOT_PORTED
from repro_torch.launch.profile_decode import profile_decode
from repro_torch.launch.serve import ServeConfig, serve_config
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.serving import Request, ServingEngine

torch.set_num_threads(1)

ARCH = "moonshot-v1-16b-a3b"
KEY = jax.random.PRNGKey(0)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# the layer: test_moe.py's cases, both packages on the same weights
# --------------------------------------------------------------------------


def mk(e=4, k=2, cf=1.25, shared=0, group=16, d=32, ff=64):
    """(JAX config, JAX params, port config, port params) as test_moe.py's
    ``mk``: the JAX ``init_moe`` weights, bridged."""
    jcfg = jmoe.MoEConfig(d_model=d, d_ff=ff, n_experts=e, top_k=k,
                          n_shared_experts=shared, capacity_factor=cf,
                          group_size=group)
    jp = jmoe.init_moe(KEY, jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, jp, moe.MoEConfig(*jcfg), tp


def both(jcfg, jp, cfg, p, x: np.ndarray):
    """Both packages on ``x``: (JAX out, JAX aux, port out, port aux,
    the port's routing record)."""
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    with moe.trace_routing() as calls:
        out, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    assert len(calls) == 1
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MOE_TOL)
    return np.asarray(jout), float(jaux), out.numpy(), float(aux), calls[0]


def normal(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def zero_rows(out: np.ndarray) -> np.ndarray:
    return np.linalg.norm(out[0], axis=-1) < 1e-7


# (label, mk keywords, input shape, input scale)
CASES = {
    "output shape": (dict(), (2, 24, 32), 1.0),
    "ragged tail": (dict(cf=4.0), (1, 26, 32), 0.5),
    "tight capacity": (dict(cf=0.25, k=1), (1, 64, 32), 1.0),
    "drop-free": (dict(cf=4.0), (1, 32, 32), 1.0),
    "shared expert": (dict(cf=0.25, k=1, shared=1), (1, 64, 32), 1.0),
    "k6 e64": (dict(e=64, k=6, cf=1.25, shared=2, group=48, d=16, ff=8),
               (2, 50, 16), 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_layer_matches_jax(case):
    kw, shape, scale = CASES[case]
    jcfg, jp, cfg, p = mk(**kw)
    x = normal(shape, seed=len(case), scale=scale)
    jout, _, out, _, route = both(jcfg, jp, cfg, p, x)
    assert out.shape == x.shape and np.isfinite(out).all()
    dropped = int((~route["keep"]).sum())
    if case == "ragged tail":
        # tokens past the last full group get expert outputs, the same as
        # those tokens routed alone (drop-free capacity)
        assert np.abs(out[0, 16:]).max() > 1e-4
        alone, _ = moe.apply_moe(p, torch.from_numpy(x[:, 16:]), cfg)
        np.testing.assert_allclose(out[:, 16:], alone.numpy(), rtol=1e-4,
                                   atol=1e-5)
    if case == "tight capacity":
        # k 1: each dropped pair is a token with no expert, a zero row
        assert dropped > 0 and zero_rows(out).sum() == dropped
        np.testing.assert_array_equal(zero_rows(out), zero_rows(jout))
    if case == "shared expert":
        assert dropped > 0 and zero_rows(out).sum() == 0
    if case == "drop-free":
        assert dropped == 0 and zero_rows(out).sum() == 0
    if case == "k6 e64":
        # 100 tokens in groups of 48 (a ragged tail of 4): capacity 11
        # against a mean load of 4.5 a group, so only the hot experts drop
        assert route["top_i"].shape == (100, 6) and 0 < dropped < 600


def test_shared_expert_rescues_dropped_rows():
    x = normal((1, 64, 32), seed=3)
    outs = {}
    for shared in (0, 1):
        jcfg, jp, cfg, p = mk(cf=0.25, k=1, shared=shared)
        outs[shared] = both(jcfg, jp, cfg, p, x)[2]
    assert zero_rows(outs[0]).sum() > 0 and zero_rows(outs[1]).sum() == 0


def test_aux_loss_penalises_imbalance_like_jax():
    jcfg, jp, cfg, p = mk(e=4, k=1, cf=4.0)
    router = np.zeros((32, 4), np.float32)
    router[:, 0] = 5.0      # logit 5 sum(x) on expert 0, 0 on the others
    x = normal((1, 64, 32), seed=4)
    _, _, _, aux_bal, _ = both(jcfg, jp, cfg, p, x)
    _, _, _, aux_bad, route = both(
        jcfg, dict(jp, router=jnp.asarray(router)), cfg,
        dict(p, router=torch.from_numpy(router)), x)
    assert aux_bad > aux_bal
    # a token with sum(x) < 0 ties experts 1-3 and takes the lowest
    assert set(route["top_i"][:, 0].tolist()) == {0, 1}


def test_capacity_formula():
    cfg = moe.MoEConfig(32, 64, n_experts=8, top_k=2, capacity_factor=1.0,
                        group_size=128)
    assert moe.capacity(cfg, 128) == 32 == jmoe.capacity(cfg, 128)
    assert moe.capacity(cfg, 4) == 4 == jmoe.capacity(cfg, 4)
    full = get_arch(ARCH)
    mcfg = moe.MoEConfig(full.d_model, full.d_ff, full.n_experts,
                         full.top_k, capacity_factor=full.capacity_factor)
    # decode (4 lanes) never drops; verify (4 x 5) and a 512-token group
    # can: capacity 4 against 30 choices, 60 against a mean load of 48
    assert [moe.capacity(mcfg, g) for g in (4, 20, 128, 512)] == \
        [4, 4, 15, 60]


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_one_pass_positions_meet_six_passes(cf):
    """k 6 over 64 experts: the dropped pairs are the reference's, found
    by its six choice passes over a running count."""
    jcfg, jp, cfg, p = mk(e=64, k=6, cf=cf, group=64, d=16, ff=8)
    x = normal((3, 40, 16), seed=5)
    _, _, _, _, route = both(jcfg, jp, cfg, p, x)
    top_i, keep = route["top_i"].numpy(), route["keep"].numpy()
    want = np.zeros_like(keep)
    c = moe.capacity(cfg, 64)
    for g0 in range(0, 120, 64):              # groups of 64, a ragged tail
        running = np.zeros(64, int)
        for choice in range(6):
            for tok in range(g0, min(g0 + 64, 120)):
                e = top_i[tok, choice]
                want[tok, choice] = running[e] < c
                running[e] += 1
    np.testing.assert_array_equal(keep, want)
    assert (~keep).sum() > 0


def test_replay_routes_as_recorded():
    """``replay_routing`` gives a call the recorded call's experts (and so
    its drops) whatever its own router says; replaying a call's own
    record changes nothing."""
    jcfg, jp, cfg, p = mk(e=8, k=2, cf=0.5, group=16, d=32, ff=16)
    x = torch.from_numpy(normal((1, 40, 32), seed=6))
    y = torch.from_numpy(normal((1, 40, 32), seed=7))
    with moe.trace_routing() as rec:
        out_x, _ = moe.apply_moe(p, x, cfg)
        moe.apply_moe(p, y, cfg)
    with moe.replay_routing(rec[:1] * 2), moe.trace_routing() as got:
        again, _ = moe.apply_moe(p, x, cfg)
        moe.apply_moe(p, y, cfg)
    torch.testing.assert_close(again, out_x, rtol=0, atol=0)
    assert (rec[0]["top_i"] != rec[1]["top_i"]).any()
    for call in got:
        assert torch.equal(call["top_i"], rec[0]["top_i"])
        assert torch.equal(call["keep"], rec[0]["keep"])


def test_top_k_ties_go_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25] * 4,
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    vals, idx = moe._top_k(torch.from_numpy(probs), 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert idx.tolist() == [[1, 2, 3], [0, 1, 2], [0, 2, 1]]


def test_init_moe_distributions_and_layout():
    cfg = moe.MoEConfig(64, 32, n_experts=8, top_k=2, n_shared_experts=2)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, lead=(3,), dtype=torch.bfloat16)
    jp = jmoe.init_moe(KEY, jmoe.MoEConfig(*cfg))
    shapes = jax.tree.map(lambda a: (3,) + a.shape, jp)
    assert jax.tree.map(lambda t: tuple(t.shape), p) == shapes
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(p))
    assert float(p["router"].abs().max()) <= 64 ** -0.5
    assert float(p["shared"]["w_down"].abs().max()) <= 64 ** -0.5
    for name, fan_in in (("w_gate", 64), ("w_up", 64), ("w_down", 32)):
        std = float(p[name].float().std())
        assert abs(std - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, name


# --------------------------------------------------------------------------
# moonshot-v1-16b-a3b: config, bridge, logits, engines
# --------------------------------------------------------------------------

FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab_size", "rope_theta", "window", "compute_dtype",
          "cache_dtype", "tie_embeddings", "qkv_bias", "family", "n_experts",
          "top_k", "n_shared_experts", "capacity_factor", "moe_group_size")


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_copy_matches_jax(size):
    want, got = JAX_ARCHS[ARCH], ARCHS[ARCH]
    if size == "reduced":
        want, got = want.reduced(), got.reduced()
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.head_dim == want.head_dim
    assert got.padded_vocab == want.padded_vocab
    assert got.layer_kinds() == want.layer_kinds() == ["attn_moe"] * \
        got.n_layers
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_moonshot_is_registered_and_llama4_still_waits():
    full = get_arch(ARCH)
    assert ARCH not in NOT_PORTED
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.n_experts, full.top_k,
            full.n_shared_experts, full.d_ff, full.vocab_size) == (
        48, 2048, 16, 16, 128, 64, 6, 2, 1408, 163840)
    # 28.89 B parameters: 57.8 GB of bf16 weights, on one 80 GB card
    assert 28.8e9 < full.param_count() < 29.0e9
    # llama4-scout, the encoder-decoder and the vision stub are ported:
    # nothing waits, and the audio stub outside the encoder-decoder family
    # still raises
    assert NOT_PORTED == {}
    assert get_arch("pixtral-12b").frontend == "vision"
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        build_model(dataclasses.replace(get_arch("yi-6b").reduced(),
                                        frontend="audio", frontend_seq=4))
    for name in ("yi-6b", "phi4-mini-3.8b", "falcon-mamba-7b"):
        assert get_arch(name).param_count() == \
            JAX_ARCHS[name].param_count()


def tight(cfg):
    """The reduced config at capacity factor 0.5, which drops pairs."""
    return dataclasses.replace(cfg, capacity_factor=0.5)


@pytest.fixture(scope="module", params=["cf4", "cf0.5"])
def pair(request):
    """Both packages' model, weights and self-speculative draft at the
    reduced config or its tight-capacity variant."""
    shape = (lambda c: c.reduced()) if request.param == "cf4" else \
        (lambda c: tight(c.reduced()))
    jmodel = jax_build_model(shape(JAX_ARCHS[ARCH]))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(shape(get_arch(ARCH)))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    jdraft, draft = jmodel.draft_model(), model.draft_model()
    return dict(name=request.param, jmodel=jmodel, jparams=jparams,
                model=model, params=params, jdraft=jdraft,
                jdparams=jmodel.slice_draft_params(jparams, jdraft),
                draft=draft, dparams=model.slice_draft_params(params, draft))


def test_bridge_carries_every_moe_leaf(pair):
    params, jparams, cfg = pair["params"], pair["jparams"], pair["model"].cfg
    layers, jlayers = params["layers"], jparams["layers"]
    assert "mlp" not in layers and set(layers["moe"]) == \
        {"router", "w_gate", "w_up", "w_down", "shared"}
    l, e, d, f = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    want = {"router": (l, d, e), "w_gate": (l, e, d, f),
            "w_up": (l, e, d, f), "w_down": (l, e, f, d),
            "shared": {"w_gate": (l, d, f), "w_up": (l, d, f),
                       "w_down": (l, f, d)}}
    assert jax.tree.map(lambda t: tuple(t.shape), layers["moe"]) == want
    for path, leaf in jax.tree_util.tree_leaves_with_path(jlayers["moe"]):
        got = layers["moe"]
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))


def test_draft_moe_leaves_are_views(pair):
    params, dparams = pair["params"], pair["dparams"]
    n = pair["draft"].cfg.n_layers
    assert n < pair["model"].cfg.n_layers
    for full, head in zip(jax.tree.leaves(params["layers"]["moe"]),
                          jax.tree.leaves(dparams["layers"]["moe"])):
        assert head.shape == (n,) + full.shape[1:]
        assert head.data_ptr() == full.data_ptr() and head._base is full


def test_forward_hidden_and_aux_match_jax(pair):
    tokens = np.array([[3, 17, 42, 9, 250, 64, 7, 1, 88, 19, 5, 200, 31,
                        77, 2, 14, 60, 9, 3]], np.int32)   # a ragged group
    jhidden, jaux = pair["jmodel"].forward(pair["jparams"], tokens)
    hidden, aux = pair["model"].forward(pair["params"],
                                        torch.from_numpy(tokens).long())
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MOE_TOL)
    assert float(aux) > 0


def test_prefill_and_decode_logits_match_jax(pair):
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    model, params = pair["model"], pair["params"]
    tokens = np.array([[3, 17, 42, 9, 250, 64, 7, 11, 90, 23, 5]], np.int32)
    jlogits, jcaches = jmodel.prefill(jparams, tokens, None, 16)
    with moe.trace_routing() as calls:
        logits, caches = model.prefill(params,
                                       torch.from_numpy(tokens).long(), 16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    dropped = sum(int((~c["keep"]).sum()) for c in calls)
    assert (dropped > 0) == (pair["name"] == "cf0.5")
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
# port's own extras (num_splits) in the second dict.  Chunks of 8 and
# verifies of 2 lanes x 3 are groups where capacity 4 can drop at 0.5.
MODES = {
    "dense": (dict(n_lanes=2, max_len=48), {}),
    "paged chunked": (dict(n_lanes=2, max_len=48, cache="paged",
                           page_size=8, prefill_chunk=8), {}),
    "int8 pages": (dict(n_lanes=2, max_len=48, cache="paged", page_size=8,
                        prefill_chunk=8, kv_dtype="int8"),
                   dict(num_splits=2)),
    "speculative": (dict(n_lanes=2, max_len=48, cache="paged", page_size=8,
                         prefill_chunk=8, spec_k=2), dict(num_splits=2)),
}


def _port_serve(model, params, kw: dict, reqs):
    eng = ServingEngine(model, params, **kw)
    for rid, prompt, max_new in reqs:
        eng.submit(Request(rid=rid, prompt=list(prompt),
                           max_new_tokens=max_new))
    finished = eng.run(max_steps=400)
    return eng, {r.rid: r.out_tokens for r in finished}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_greedy_tokens_identical_to_jax(pair, mode):
    shared, extra = MODES[mode]
    port, jax_ = dict(shared, **extra), dict(shared)
    if "spec_k" in shared:
        port.update(draft_model=pair["draft"], draft_params=pair["dparams"])
        jax_.update(draft_model=pair["jdraft"],
                    draft_params=pair["jdparams"])
    reqs = _requests()
    with moe.trace_routing() as calls:
        eng, got = _port_serve(pair["model"], pair["params"], port, reqs)
    jeng = JaxEngine(pair["jmodel"], pair["jparams"], **jax_)
    for rid, prompt, max_new in reqs:
        jeng.submit(JaxRequest(rid=rid, prompt=list(prompt),
                               max_new_tokens=max_new))
    want = {r.rid: r.out_tokens for r in jeng.run(max_steps=400)}
    assert got == want
    assert all(len(got[rid]) == max_new for rid, _, max_new in reqs)
    assert eng.steps == jeng.steps
    if "spec_k" in shared:
        assert eng.spec_stats() == jeng.spec_stats()
        assert eng.spec_ticks > 0
    dropped = sum(int((~c["keep"]).sum()) for c in calls)
    if pair["name"] == "cf4":
        assert dropped == 0
        return
    # the tight config drops pairs, and that changes the tokens: the same
    # weights at capacity factor 4.0 give others
    assert dropped > 0
    loose = build_model(get_arch(ARCH).reduced())
    if "spec_k" in shared:
        draft = loose.draft_model()
        port.update(draft_model=draft,
                    draft_params=loose.slice_draft_params(pair["params"],
                                                          draft))
    _, free = _port_serve(loose, pair["params"], port, reqs)
    assert free != got


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_serve_config_runs_moonshot_on_cpu(cache):
    paged = dict(cache="paged", page_size=8, prefill_chunk=4) \
        if cache == "paged" else {}
    out = serve_config(ServeConfig(arch=ARCH, device="cpu", n_requests=2,
                                   n_lanes=2, max_new=3, prompt_len=6,
                                   **paged))
    assert out["finished"] == 2
    assert all(len(t) == 3 for t in out["outputs"].values())


def test_profile_decode_takes_the_arch_on_cpu():
    out = profile_decode(ARCH, n_lanes=2, max_len=32, prompt_len=8, steps=2,
                         device="cpu", cache="paged", prefill_chunk=4)
    assert out["host_ms_per_tick"] > 0 and out["tokens_per_tick"] == 2

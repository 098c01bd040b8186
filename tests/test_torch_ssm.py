"""The port's Mamba-1 path (falcon-mamba-7b) against the JAX package on
the CPU: the plain selective scan (K9's plain version) against the JAX
Pallas kernel in interpret mode and its plain scan, the causal conv, the
Mamba-1 block and its decode step, the reduced falcon-mamba model
(``forward``, prefill, decode), the dense serving engine on SSM state,
and the ``SsmChunk`` install region.

The same inputs, drawn from a seed with numpy, go to both packages.
Tolerances: float32 2e-4 for the scan (as the JAX package's own kernel
test) and the Mamba-1 block, 1e-4 for the model's logits (as
``test_torch_serving.py``; both sides sum float32 products in different
orders); bf16 inputs 2e-2, one bf16 rounding of outputs formed from
float32 sums.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.at as at
from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels import ref as jax_ref
from repro.kernels.ssm_scan import selective_scan as jax_selective_scan
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as k9
from repro_torch.launch.serve import ServeConfig, serve_config
from repro_torch.models import build_model, layers, ssm
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.kvcache import DenseKVCache, lane_set
from repro_torch.tuning import (register_kernel_regions, run_install_tuning,
                                ssm_chunk_cost)

torch.set_num_threads(1)

ARCH = "falcon-mamba-7b"
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
TOL = dict(rtol=1e-4, atol=1e-4)
H100_SMEM_PER_BLOCK = 232_448    # cudaDevAttrMaxSharedMemoryPerBlockOptin


@pytest.fixture(autouse=True)
def _isolate_published():
    at.clear_published()
    yield
    at.clear_published()


def scan_inputs(bsz, length, di, n, seed):
    """x, dt (positive), a (negative), b, c, d as float32 numpy, drawn as
    the JAX package's kernel test draws them."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x, dt = draw(bsz, length, di), np.log1p(np.exp(draw(bsz, length, di)))
    a = -np.exp(draw(di, n))
    return x, dt.astype(np.float32), a, draw(bsz, length, n), \
        draw(bsz, length, n), draw(di)


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


# --------------------------------------------------------------------------
# K9's plain version
# --------------------------------------------------------------------------


@pytest.mark.parametrize("final_state", [False, True])
@pytest.mark.parametrize("l,chunk", [(96, 32), (90, 32), (64, 64), (33, 16)])
def test_plain_scan_matches_jax_kernel_and_plain_scan(l, chunk, final_state):
    x, dt, a, b, c, d = scan_inputs(2, l, 16, 8, seed=l + chunk)
    want_y = np.asarray(jax_selective_scan(x, dt, a, b, c, d, chunk=chunk,
                                           interpret=True))
    jy, jh = jax_ref.selective_scan_ref(x, dt, a, b, c, d,
                                        return_final_state=True)
    out = ops.ssm_scan(*_torch(x, dt, a, b, c, d), chunk=chunk,
                       return_final_state=final_state)
    y = out[0] if final_state else out
    assert y.dtype == torch.float32 and y.shape == (2, l, 16)
    np.testing.assert_allclose(y.numpy(), want_y, **SCAN_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    if final_state:
        h = out[1]
        assert h.dtype == torch.float32 and h.shape == (2, 16, 8)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)


@pytest.mark.parametrize("final_state", [False, True])
def test_plain_scan_bf16_inputs_match_jax(final_state):
    x, dt, a, b, c, d = scan_inputs(2, 40, 32, 16, seed=5)
    jx, jdt, jb, jc, jd = (jnp.asarray(v, jnp.bfloat16)
                           for v in (x, dt, b, c, d))
    jy, jh = jax_ref.selective_scan_ref(jx, jdt, a, jb, jc, jd,
                                        return_final_state=True)
    tx, tdt, tb, tc, td = _torch(x, dt, b, c, d, dtype=torch.bfloat16)
    out = ref.selective_scan_ref(tx, tdt, torch.from_numpy(a), tb, tc, td,
                                 return_final_state=final_state)
    y = out[0] if final_state else out
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), **BF16_TOL)
    if final_state:
        assert out[1].dtype == torch.float32
        np.testing.assert_allclose(out[1].numpy(), np.asarray(jh),
                                   **BF16_TOL)


def test_ssm_scan_use_kernel_on_cpu_raises():
    x, dt, a, b, c, d = _torch(*scan_inputs(1, 4, 8, 4, seed=0))
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        ops.ssm_scan(x, dt, a, b, c, d, use_kernel=True)


def test_kernel_smem_formula_and_wrapper_checks():
    # falcon-mamba's d_state 16: 16 channels a block, lane-major float rows
    # of 32 lanes x 16 steps at a lane stride of 20 floats (644 with the
    # row's pad) for x, dt, B and C, and the raw bf16 tile of 512 steps;
    # every SsmChunk candidate within an H100's per-block limit
    assert k9.smem_bytes(16, 512) == (4 * (2 * 16 + 2 * 16) * 644
                                      + 2 * 2 * 512 * 16 + 2 * 2 * 512 * 16)
    assert all(k9.smem_bytes(16, ch) <= H100_SMEM_PER_BLOCK
               for ch in (32, 64, 128, 256, 512))
    x, dt, a, b, c, d = _torch(*scan_inputs(1, 4, 8, 4, seed=0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        k9.selective_scan(x, dt, a, b, c, d)


# --------------------------------------------------------------------------
# the Mamba-1 block
# --------------------------------------------------------------------------


@pytest.mark.parametrize("length,k", [(7, 4), (2, 4), (5, 2)])
def test_causal_conv1d_matches_jax(length, k):
    rng = np.random.default_rng(length * 10 + k)
    x = rng.standard_normal((2, length, 12)).astype(np.float32)
    w = rng.standard_normal((k, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    got = layers.causal_conv1d(*_torch(x, w, bias)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_layers.causal_conv1d(x, w, bias)), **SCAN_TOL)
    # output t sees inputs up to t only, taps in order (no flip)
    want0 = x[:, 0] * w[k - 1] + bias
    np.testing.assert_allclose(got[:, 0], want0, rtol=1e-6, atol=1e-6)


MCFG = dict(d_model=32, d_inner=64, d_state=8)


@pytest.fixture(scope="module")
def block():
    """A JAX ``init_mamba1`` block and the same weights as torch tensors."""
    jcfg = jax_ssm.Mamba1Config(**MCFG)
    jp = jax_ssm.init_mamba1(jax.random.PRNGKey(3), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, jp, ssm.Mamba1Config(**MCFG), tp


@pytest.mark.parametrize("return_state", [False, True])
def test_apply_mamba1_matches_jax(block, return_state):
    jcfg, jp, cfg, tp = block
    x = np.random.default_rng(4).standard_normal((2, 9, 32)).astype(
        np.float32)
    want = jax_ssm.apply_mamba1(jp, x, jcfg, return_state=return_state)
    got = ssm.apply_mamba1(tp, torch.from_numpy(x), cfg,
                           return_state=return_state)
    if not return_state:
        want, got = (want, None), (got, None)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **SCAN_TOL)
    if return_state:
        for key in ("conv", "h"):
            assert got[1][key].shape == want[1][key].shape
            np.testing.assert_allclose(got[1][key].numpy(),
                                       np.asarray(want[1][key]), **SCAN_TOL)


def test_step_mamba1_matches_jax(block):
    jcfg, jp, cfg, tp = block
    rng = np.random.default_rng(5)
    jstate = jax_ssm.init_mamba1_state(2, jcfg)
    tstate = ssm.init_mamba1_state(2, cfg)
    for _ in range(3):
        x = rng.standard_normal((2, 1, 32)).astype(np.float32)
        jy, jstate = jax_ssm.step_mamba1(jp, x, jstate, jcfg)
        ty, tstate = ssm.step_mamba1(tp, torch.from_numpy(x), tstate, cfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    for key in ("conv", "h"):
        np.testing.assert_allclose(tstate[key].numpy(),
                                   np.asarray(jstate[key]), **SCAN_TOL)


def test_step_mamba1_promotes_like_jax_with_bf16_weights(block):
    """bf16 weights and activations against the float32 conv state the
    serving lanes hold: the conv output and the products it feeds are
    float32 in both packages, the block's output bf16."""
    jcfg, jp, cfg, tp = block
    jp16 = jax.tree.map(lambda v: v.astype(jnp.bfloat16), jp)
    tp16 = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    rng = np.random.default_rng(6)
    jstate = jax_ssm.init_mamba1_state(2, jcfg)
    tstate = ssm.init_mamba1_state(2, cfg)
    for _ in range(2):
        x = rng.standard_normal((2, 1, 32)).astype(np.float32)
        jy, jstate = jax_ssm.step_mamba1(jp16, jnp.asarray(x, jnp.bfloat16),
                                         jstate, jcfg)
        ty, tstate = ssm.step_mamba1(
            tp16, torch.from_numpy(x).to(torch.bfloat16), tstate, cfg)
        assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
        np.testing.assert_allclose(ty.float().numpy(),
                                   np.asarray(jy.astype(jnp.float32)),
                                   **BF16_TOL)
    assert tstate["conv"].dtype == torch.float32
    assert jstate["conv"].dtype == jnp.float32
    np.testing.assert_allclose(tstate["h"].numpy(), np.asarray(jstate["h"]),
                               **BF16_TOL)


# --------------------------------------------------------------------------
# the reduced falcon-mamba model
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params), reduced config."""
    jmodel = jax_build_model(JAX_ARCHS[ARCH].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_arch(ARCH).reduced())
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    return jmodel, jparams, model, params


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _shapes(v, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tuple(tree.shape)}


def test_init_params_leaves_equal_jax(pair):
    _, jparams, model, _ = pair
    ours = model.init(0, "cpu")
    assert _shapes(ours) == _shapes(jparams)
    a_log = ours["layers"]["ssm"]["a_log"]
    np.testing.assert_allclose(
        a_log.numpy(), np.asarray(jparams["layers"]["ssm"]["a_log"]),
        rtol=1e-6, atol=1e-6)


TOKENS = np.array([[3, 17, 42, 9, 250, 64, 7, 11, 5],
                   [8, 1, 99, 200, 13, 13, 2, 40, 77]], np.int32)


def test_forward_hidden_matches_jax(pair):
    jmodel, jparams, model, params = pair
    jh, jaux = jmodel.forward(jparams, TOKENS)
    th, taux = model.forward(params, torch.from_numpy(TOKENS).long())
    assert th.shape == jh.shape
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert float(taux) == float(jaux) == 0.0


def test_prefill_and_decode_match_jax(pair):
    jmodel, jparams, model, params = pair
    jlogits, jc = jmodel.prefill(jparams, TOKENS, None, 16)
    logits, caches = model.prefill(params, torch.from_numpy(TOKENS).long(),
                                   16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for key in ("conv", "h"):
        np.testing.assert_allclose(caches["ssm"][key].numpy(),
                                   np.asarray(jc["ssm"][key]), **TOL)
    tok = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)
    for step in range(4):
        pos = np.full((2,), TOKENS.shape[1] + step, np.int32)
        jlogits, jc = jmodel.decode_step(jparams, jc, tok, pos)
        logits, caches = model.decode_step(
            params, caches, torch.from_numpy(tok).long(),
            torch.from_numpy(pos).long())
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        tok = np.asarray(jlogits).argmax(-1)[:, None].astype(np.int32)
    for key in ("conv", "h"):
        np.testing.assert_allclose(caches["ssm"][key].numpy(),
                                   np.asarray(jc["ssm"][key]), **TOL)


def test_decode_consistency_with_forward(pair):
    """Teacher forcing: prefill then one decode step reproduces
    ``forward``'s logits at the last position (the port's own check of
    its cache handoff, as the JAX package's ``test_archs``)."""
    _, _, model, params = pair
    toks = torch.from_numpy(TOKENS).long()
    full = model.head_logits(params, model.forward(params, toks)[0][:, -1])
    logits, caches = model.prefill(params, toks, toks.shape[1] + 4)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), **TOL)
    nxt = torch.tensor([[21], [4]])
    logits, _ = model.decode_step(params, caches, nxt,
                                  torch.full((2,), toks.shape[1]))
    hidden, _ = model.forward(params, torch.cat([toks, nxt], dim=1))
    np.testing.assert_allclose(
        logits.numpy(), model.head_logits(params, hidden[:, -1]).numpy(),
        **TOL)


def test_init_caches_hold_float32_state(pair):
    _, _, model, _ = pair
    cfg = model.cfg
    caches = model.init_caches(3, 99, device="cpu")
    assert set(caches) == {"ssm"}
    assert caches["ssm"]["conv"].shape == (cfg.n_layers, 3, 3,
                                           cfg.ssm_d_inner)
    assert caches["ssm"]["h"].shape == (cfg.n_layers, 3, cfg.ssm_d_inner,
                                        cfg.ssm_state)
    assert all(t.dtype == torch.float32 for t in caches["ssm"].values())
    assert not model.supports_paged_cache


# --------------------------------------------------------------------------
# serving: dense lanes of SSM state
# --------------------------------------------------------------------------


def _prompts():
    return [[1 + i] + [(7 * i + 3 * j) % 200 + 2
                       for j in range(5 + 3 * (i % 2))] for i in range(4)]


@pytest.mark.parametrize("timeslice", [None, 2])
def test_engine_greedy_tokens_identical_to_jax(pair, timeslice):
    jmodel, jparams, model, params = pair
    jeng = JaxEngine(jmodel, jparams, n_lanes=2, max_len=64,
                     timeslice=timeslice, decode_fn=jax.jit(
                         jmodel.decode_step),
                     prefill_fn=jax.jit(jmodel.prefill, static_argnums=(3,)))
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


def test_dense_lanes_admit_and_swap_ssm_state(pair):
    _, _, model, params = pair
    kv = DenseKVCache(model, 3, 32, "cpu")
    _, pre = model.prefill(params, torch.tensor([[4, 5, 6, 7]]))
    assert pre["ssm"]["conv"].shape[1] == 1
    kv.admit(1, pre, 4)
    for key in ("conv", "h"):
        assert torch.equal(kv.caches["ssm"][key][:, 1],
                           pre["ssm"][key][:, 0])
        assert not kv.caches["ssm"][key][:, (0, 2)].any()
    before = {k: t.clone() for k, t in kv.caches["ssm"].items()}
    handle = kv.swap_out(1)
    assert len(handle) == 2
    for t in kv.caches["ssm"].values():
        t[:, 1] = 9.0
    kv.swap_in(1, handle)
    for key, t in kv.caches["ssm"].items():
        assert torch.equal(t, before[key])
    cfg = model.cfg
    n = cfg.n_layers * 3 * cfg.ssm_d_inner * (3 + cfg.ssm_state)
    assert kv.pool_bytes() == 4 * n


def test_lane_set_crops_and_pads_the_sequence_axis():
    full = torch.ones((2, 3, 4, 6))
    one = torch.arange(2 * 1 * 4 * 3, dtype=torch.float32).reshape(2, 1, 4, 3)
    lane_set(full, one, 2)
    assert torch.equal(full[:, 2, :, :3], one[:, 0])
    assert not full[:, 2, :, 3:].any()
    assert bool((full[:, :2] == 1).all())
    longer = torch.ones((2, 1, 4, 9)).to(torch.bfloat16)
    lane_set(full, longer, 0)
    assert bool((full[:, 0] == 1).all())


@pytest.mark.parametrize("kw", [dict(cache="paged"), dict(draft=True),
                                dict(prefix_cache=True)])
def test_serve_rejects_paged_pool_features_for_ssm(kw):
    with pytest.raises(ValueError, match="paged KV pool"):
        serve_config(ServeConfig(arch=ARCH, device="cpu", **kw))


def test_serve_cli_config_on_cpu_finishes_every_request():
    out = serve_config(ServeConfig(arch=ARCH, device="cpu", n_requests=5,
                                   n_lanes=2, max_new=4, timeslice=2))
    assert out["finished"] == 5
    assert all(len(t) == 4 for t in out["outputs"].values())
    assert out["cache"]["kind"] == "dense"


# --------------------------------------------------------------------------
# the SsmChunk install region
# --------------------------------------------------------------------------


def test_ssm_chunk_cost_is_finite_within_the_limit_and_inf_over_it():
    shape = dict(seq=512, d_inner=8192, d_state=16)
    costs = {ch: ssm_chunk_cost(ch, smem_limit=H100_SMEM_PER_BLOCK, **shape)
             for ch in (32, 64, 128, 256, 512)}
    assert all(math.isfinite(c) and c > 0 for c in costs.values())
    assert costs[32] > costs[64] > costs[128]
    assert ssm_chunk_cost(1024, seq=2048, d_inner=8192, d_state=16,
                          smem_limit=H100_SMEM_PER_BLOCK) == math.inf
    limit = k9.smem_bytes(16, 100)
    for ch in (32, 64, 128, 256, 512):
        over = k9.smem_bytes(16, ch) > limit
        assert math.isinf(ssm_chunk_cost(ch, smem_limit=limit,
                                         **shape)) == over
    # a chunk is cut to the sequence before it is costed
    assert math.isfinite(ssm_chunk_cost(4096, seq=64, d_inner=8192,
                                        d_state=16, smem_limit=limit))


def test_wall_clock_ssm_chunk_tuning_on_cpu_publishes_chunk(tmp_path):
    shape = dict(m=48, n=80, k=64, seq=24, d_inner=32, d_state=8,
                 smem_limit=H100_SMEM_PER_BLOCK)
    session = at.AutoTuner(str(tmp_path))
    register_kernel_regions(session, **shape)
    tuned = run_install_tuning(session, wall_clock=True, device="cpu")
    region = session.ctx.registry.get("SsmChunk")
    assert region.metadata["executor"] == "cuda-event"
    assert tuned["SsmChunk"]["chunk"] in (32, 64, 128, 256, 512)
    assert at.tuned("ssm_scan") == tuned["SsmChunk"]
    # MatmulBlocks: 3 axes x 3 values; FlashBlocks: 2 axes x 2 values;
    # SsmChunk: the d-spline's 8 samples
    assert session.executor_calls == 9 + 4 + 8
    again = at.AutoTuner(str(tmp_path))
    register_kernel_regions(again, **shape)
    assert run_install_tuning(again, wall_clock=True, device="cpu") == tuned
    assert again.executor_calls == 0


def test_tuned_chunk_reaches_the_scan_entry_point():
    """The published chunk is what ops.ssm_scan hands the kernel; on the
    CPU the plain scan ignores it, so the result is unchanged."""
    x, dt, a, b, c, d = _torch(*scan_inputs(1, 20, 8, 4, seed=9))
    want = ops.ssm_scan(x, dt, a, b, c, d)
    at.publish("ssm_scan", chunk=128)
    assert at.tuned("ssm_scan") == {"chunk": 128}
    assert torch.equal(ops.ssm_scan(x, dt, a, b, c, d), want)

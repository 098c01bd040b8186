"""The port's long-sequence plain attention (``ref.chunked_attention``,
taken by ``ops.attention`` above ``CHUNKED_THRESHOLD``) and its step
builders (``launch/steps.py``: ``step_for_shape``, the prefill and decode
steps) against the JAX package's on the CPU.

* chunked attention (float32, B 1, 4 q / 2 kv heads of 16, S 2304: 3
  query and 3 key chunks of 1024, the last half padding, or 5 of 512)
  against the JAX ``ref.chunked_attention`` and the port's
  ``attention_ref``, causal, non-causal and with a window of 300:
  rtol = atol = 1e-5; its gradient (each key step under
  ``torch.utils.checkpoint``) against autograd through ``attention_ref``
  at 1e-5;
* the prefill and decode steps on reduced yi-6b against the JAX steps at
  the serving parity tolerance (rtol = atol = 1e-4), at a short prompt
  and at 2304 tokens (both packages' chunked route);
* one train step at S 2304 (reduced yi-6b, B 1) against the JAX step
  under ``jax.jit``: the loss at rtol 1e-5 and the gradient norm at rtol
  1e-4, the train-parity tolerances, through ``FlashAttentionFn`` and
  through the chunked plain route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.at as jat
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import ShapeConfig as JaxShapeConfig
from repro.kernels import ref as jref
from repro.launch.steps import step_for_shape as jax_step_for_shape
from repro.models import LayoutPlan as JaxLayoutPlan
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
import repro_torch.at as at
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.data import DataConfig, batch_for_step
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.launch.steps import StepBundle, step_for_shape
from repro_torch.models import LayoutPlan, build_model
from repro_torch.optim import adamw

torch.set_num_threads(1)

B, H, HKV, S, D = 1, 4, 2, 2304, 16
TOL = dict(rtol=1e-5, atol=1e-5)
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
MASKS = {"causal": dict(causal=True), "full": dict(causal=False),
         "window": dict(causal=True, window=300)}


@pytest.fixture(autouse=True)
def _isolate_published():
    for pkg in (jat, at):
        pkg.clear_published()
    yield
    for pkg in (jat, at):
        pkg.clear_published()


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((B, H, S, D), (B, HKV, S, D), (B, HKV, S, D)))


def _torch(arrays, grad: bool = False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


# --------------------------------------------------------------------------
# ref.chunked_attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("block", [1024, 512])
def test_chunked_attention_matches_jax_and_attention_ref(qkv, block, mask):
    kw = MASKS[mask]
    want = np.asarray(jref.chunked_attention(
        *map(jnp.asarray, qkv), block_q=block, block_k=block, **kw))
    got = ref.chunked_attention(*_torch(qkv), block_q=block, block_k=block,
                                **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), ref.attention_ref(*_torch(qkv), **kw).numpy(), **TOL)


@pytest.mark.parametrize("mask", list(MASKS))
def test_chunked_attention_gradient_matches_attention_ref(qkv, mask,
                                                          monkeypatch):
    kw = MASKS[mask]
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, H, S, D), dtype=np.float32))
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", lambda *a,
                        **kwa: (calls.append(1), real(*a, **kwa))[1])
    grads = {}
    for name in ("chunked", "no remat", "ref"):
        ins = _torch(qkv, grad=True)
        out = (ref.attention_ref(*ins, **kw) if name == "ref" else
               ref.chunked_attention(*ins, remat=name == "chunked", **kw))
        grads[name] = torch.autograd.grad(out, ins, dout)
    assert len(calls) == 3 * 3          # 3 q chunks x 3 key chunks
    for got, want, rem in zip(grads["chunked"], grads["ref"],
                              grads["no remat"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        torch.testing.assert_close(got, rem, rtol=1e-6, atol=1e-6)


def test_ops_attention_plain_route_chunks_above_the_threshold(monkeypatch):
    """``use_kernel=False`` (and a CPU tensor without a gradient) takes
    the chunked route above 2048 queries at the tile published under
    ``chunked_attention`` (or given), ``attention_ref`` at or below."""
    calls = []
    chunked, dense = ref.chunked_attention, ref.attention_ref
    monkeypatch.setattr(ref, "chunked_attention", lambda *a, **kw: (
        calls.append(("chunked", kw)), chunked(*a, **kw))[1])
    monkeypatch.setattr(ref, "attention_ref", lambda *a, **kw: (
        calls.append(("ref", kw)), dense(*a, **kw))[1])
    assert ops.CHUNKED_THRESHOLD == 2048
    rng = np.random.default_rng(2)

    def run(s, grad=False, **kw):
        calls.clear()
        q, k, v = _torch([rng.standard_normal(shape, dtype=np.float32)
                          for shape in ((1, 2, s, 8), (1, 1, s, 8),
                                        (1, 1, s, 8))], grad)
        out = ops.attention(q, k, v, use_kernel=False, **kw)
        assert out.shape == q.shape
        if grad:
            out.sum().backward()
            assert q.grad is not None
        return [c[0] for c in calls], calls[0][1]

    assert run(2048)[0] == ["ref"]
    assert run(2049)[0] == ["chunked"]
    assert run(2049, grad=True)[0] == ["chunked"]
    assert run(2049)[1] == dict(causal=True, window=None)
    at.publish("chunked_attention", block_q=512, block_k=256)
    assert run(2049)[1] == dict(causal=True, window=None, block_q=512,
                                block_k=256)
    assert run(2049, block_k=128)[1]["block_k"] == 128
    assert run(2049, window=64)[0] == ["chunked"]


# --------------------------------------------------------------------------
# launch/steps.py
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def yi():
    """(jax model, jax params, port model, port params), reduced yi-6b."""
    jmodel = jax_build_model(JAX_ARCHS["yi-6b"].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_arch("yi-6b").reduced())
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    return jmodel, jparams, model, params


def test_step_for_shape_dispatches_by_kind():
    model = build_model(get_arch("yi-6b").reduced())
    names = {kind: step_for_shape(model, ShapeConfig(kind, 16, 2, kind),
                                  LayoutPlan()).__name__
             for kind in ("train", "prefill", "decode")}
    assert names == {"train": "train_step", "prefill": "prefill_step",
                     "decode": "decode_step"}
    assert StepBundle(fn=len).donate == ()
    # param_shardings is taken (the layouts the gradients are pinned to:
    # {} pins each to its parameter's own); plain tensors pass untouched
    step = step_for_shape(model, ShapeConfig("t", 16, 2, "train"),
                          LayoutPlan(), param_shardings={})
    assert step.__name__ == "train_step"
    grads = [torch.ones(2), torch.zeros(3)]
    assert steps.pin_grads(grads, grads, {}) == grads
    assert steps.SHARDING_ITEM == "ROADMAP queue 1, item 10"


@pytest.mark.parametrize("seq", [40, S])
def test_prefill_and_decode_steps_match_jax(yi, seq):
    jmodel, jparams, model, params = yi
    tokens = np.random.default_rng(seq).integers(
        2, model.cfg.vocab_size, (2, seq)).astype(np.int32)
    jprefill = jax_step_for_shape(jmodel, JaxShapeConfig("p", seq, 2,
                                                         "prefill"),
                                  JaxLayoutPlan())
    prefill = step_for_shape(model, ShapeConfig("p", seq, 2, "prefill"),
                             LayoutPlan())
    jlogits, jcaches = jax.jit(jprefill)(jparams, {"tokens": tokens})
    logits, caches = prefill(params, {"tokens": torch.from_numpy(tokens)
                                      .long()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **SERVE_TOL)
    np.testing.assert_allclose(caches["kv"][0].numpy(),
                               np.asarray(jcaches["kv"][0]), **SERVE_TOL)

    # decode: two steps from caches with room past the prompt
    max_len = seq + 4
    _, jc = jmodel.prefill(jparams, tokens, None, max_len)
    _, tc = model.prefill(params, torch.from_numpy(tokens).long(), max_len)
    jdecode = jax.jit(jax_step_for_shape(
        jmodel, JaxShapeConfig("d", max_len, 2, "decode"), JaxLayoutPlan()))
    decode = step_for_shape(model, ShapeConfig("d", max_len, 2, "decode"),
                            LayoutPlan())
    tok = np.argmax(np.asarray(jlogits), axis=-1).astype(np.int32)[:, None]
    for i in range(2):
        pos = np.full((2,), seq + i, np.int32)
        jl, jc = jdecode(jparams, jc, tok, pos)
        tl, tc = decode(params, tc, torch.from_numpy(tok).long(),
                        torch.from_numpy(pos).long())
        assert tl.grad_fn is None
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SERVE_TOL)
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]


@pytest.fixture(scope="module")
def jax_long_step(yi):
    """The JAX train step's first-step metrics at S 2304, B 1 (its
    chunked route, each key step under ``jax.checkpoint``)."""
    jmodel, jparams, model, _ = yi
    cfg = model.cfg
    batch = {k: v.numpy() for k, v in batch_for_step(
        DataConfig(cfg.vocab_size, S, 1, seed=3), 0).items()}
    opt = jax_adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=1)
    jstep = jax.jit(jax_step_for_shape(
        jmodel, JaxShapeConfig("t", S, 1, "train"), JaxLayoutPlan("host"),
        opt))
    _, _, metrics = jstep(jparams, jax_adamw.init(jparams),
                          jax.tree.map(jnp.asarray, batch))
    return batch, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("use_kernel", [None, False])
def test_train_step_above_the_threshold_matches_jax(yi, jax_long_step,
                                                    use_kernel, monkeypatch):
    """``use_kernel=None``: ``FlashAttentionFn`` (the plain forward and
    the closed-form backward on the CPU); ``False``: the chunked plain
    route, differentiated through its checkpointed key steps."""
    jmodel, jparams, model, _ = yi
    batch, want = jax_long_step
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             "cpu", dtype=torch.float32)
    routes = []
    chunked = ref.chunked_attention
    monkeypatch.setattr(ref, "chunked_attention", lambda *a, **kw: (
        routes.append("chunked"), chunked(*a, **kw))[1])
    step = step_for_shape(
        model, ShapeConfig("t", S, 1, "train"), LayoutPlan("host"),
        adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=1),
        use_kernel=use_kernel)
    _, _, metrics = step(params, adamw.init(params),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    assert routes == ([] if use_kernel is None
                      else ["chunked"] * model.cfg.n_layers)
    np.testing.assert_allclose(float(metrics["loss"]), want["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               want["grad_norm"], rtol=GRAD_RTOL)

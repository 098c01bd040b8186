"""The train step over a mesh: ``step_for_shape(param_shardings=...)`` with
``DTensor`` parameters and batch, against the unsharded port step and the
JAX package's step (``jax.value_and_grad`` of the same loss).

For one arch a family at ``reduced()`` (dense yi-6b, MoE moonshot,
Mamba-1 falcon-mamba, encoder-decoder whisper, hybrid zamba2), with the
JAX model's weights carried across by ``repro_torch.bridge`` and one
numpy batch, on a 1x2 and a 2x2 world of spawned gloo ranks
(``run_world``; the rank function is ``torch_mesh_workers.sharded_grads``):
the loss within rtol 1e-5 and every gradient within 1e-5 of both, on
every rank, and every gradient (each microbatch's and their sums) in its
parameter's placements.

The decode step over a mesh (``build_decode_step`` with the weights,
caches and token placed by each decode plan's rules: ``tp``,
``decode_seq``, ``decode_resident``), one token after an 8-token
prefill, on the same worlds and on 1x4 (fewer KV heads than ``model``
ranks, a GQA group across two ranks): the logits and every cache within
1e-5 of the unsharded step's, on every rank.

In this process: with no plan, ``constrain`` and
``constrain_layer_params`` return their input itself.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.distributed import run_world
from repro_torch.models.sharding_ctx import (LayoutPlan, constrain,
                                             constrain_layer_params, use_plan)
from repro_torch.optim import adamw

import torch_mesh_workers as workers

ARCHS = ("yi-6b", "moonshot-v1-16b-a3b", "falcon-mamba-7b", "whisper-tiny",
         "zamba2-7b")
WORLDS = ("1x2", "2x2")
B, S = 4, 32


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frontend_embeds"] = rng.standard_normal(
            (B, 16, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def cases():
    """(arch, numpy JAX params, numpy batch, the JAX loss, the JAX
    gradients as the port's leaves)."""
    out = []
    for i, arch in enumerate(ARCHS):
        jcfg = JAX_ARCHS[arch].reduced()
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(i))
        batch = _batch(jcfg, i)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b, m=jmodel: m.train_loss(p, b)))(jparams, batch)
        cfg = get_arch(arch).reduced()
        want = [g.numpy() for g in adamw.leaves(params_from_jax(
            jax.tree.map(np.asarray, grads), cfg, "cpu",
            dtype=torch.float32))]
        out.append((arch, jax.tree.map(np.asarray, jparams), batch,
                    float(loss), want))
    return out


@pytest.fixture(scope="module")
def ranks(cases):
    """Every rank's results on each world."""
    args = [(arch, p, b) for arch, p, b, _, _ in cases]
    return {spec: run_world(workers.sharded_grads,
                            int(spec[0]) * int(spec[2]), args=(args, spec))
            for spec in WORLDS}


@pytest.fixture(scope="module")
def decode_1x4(cases):
    """Every rank's sharded decode results on a 1x4 world."""
    args = [(arch, p, b) for arch, p, b, _, _ in cases]
    return run_world(workers.sharded_decodes, 4, args=(args, "1x4"))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_unsharded_and_jax(arch, world, cases,
                                                      ranks):
    _, _, _, jax_loss, jax_grads = next(c for c in cases if c[0] == arch)
    for got in (r[arch] for r in ranks[world]):
        assert got["kept"], "a gradient left its parameter's placements"
        np.testing.assert_allclose(got["loss"], got["loss_unsharded"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["loss"], jax_loss, rtol=1e-5)
        assert len(got["grads"]) == len(jax_grads)
        for g, g0, gj in zip(got["grads"], got["grads_unsharded"],
                             jax_grads):
            np.testing.assert_allclose(g, g0, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(g, gj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("plan", workers.DECODE_PLANS)
@pytest.mark.parametrize("world", WORLDS + ("1x4",))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_step_matches_unsharded(arch, world, plan, ranks,
                                               decode_1x4):
    per_rank = (decode_1x4 if world == "1x4" else
                [r[arch]["decode"] for r in ranks[world]])
    for got in per_rank:
        got = got[arch] if world == "1x4" else got
        want_logits, want_caches = got["unsharded"]
        logits, caches = got[plan]
        np.testing.assert_allclose(logits, want_logits, rtol=1e-5, atol=1e-5)
        assert len(caches) == len(want_caches)
        for c, c0 in zip(caches, want_caches):
            np.testing.assert_allclose(c, c0, rtol=1e-5, atol=1e-5)


def test_constrain_without_a_plan_is_the_identity():
    x = torch.randn(2, 3, 4)
    lp = {"attn": {"wq": torch.randn(4, 4)}, "norm1_w": torch.ones(4)}
    assert constrain(x, "hidden") is x
    assert constrain_layer_params(lp) is lp
    # a plan over plain tensors changes nothing either
    with use_plan(LayoutPlan(specs={"hidden": ("data", None, None)})):
        assert constrain(x, "hidden") is x
        assert constrain_layer_params(lp) is lp

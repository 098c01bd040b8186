"""The port's train path against the JAX package's on the CPU, in float32,
one arch per family at its reduced config: yi-6b (dense), h2o-danube-1.8b
(sliding window), moonshot-v1-16b-a3b (MoE, its aux loss), falcon-mamba-7b
(Mamba-1: the scan's gradient), zamba2-7b (Mamba-2 and the shared block),
pixtral-12b (the vision prefix, which carries no loss) and whisper-tiny
(the encoder-decoder, its tied head).

The same weights (the JAX ``Model.init``, through the numpy bridge in
float32) and the same numpy batches go to both packages:

* the loss and every gradient leaf against ``jax.value_and_grad`` of the
  JAX ``Model.train_loss`` (its gradients bridged the same way).  The
  port's gradients go through ``ops.attention`` and ``ops.ssm_scan``'s
  ``torch.autograd.Function``s (the closed-form backwards, with the plain
  forwards on the CPU), the JAX package's through autodiff of its plain
  ops;
* three steps of ``build_train_step`` (AdamW, cosine schedule, clipping)
  against the JAX ``build_train_step`` under ``jax.jit``: the losses and
  every parameter after the steps.

Tolerances (float32 both sides, sums in other orders):

* loss: rtol 1e-5;
* gradients: rtol 1e-4 with an atol of 1e-5 of the leaf's scale (its
  largest |JAX gradient|), and never under 1e-7 of the largest gradient
  of all leaves (float32 rounding of the sums: a leaf whose gradient is
  zero in exact arithmetic, as the self-attention key bias's, whose
  shift leaves every softmax unchanged, comes out as ~1e-10 of noise);
* parameters after the steps: rtol 1e-5 with an atol of 1e-5 of the
  leaf's scale (its largest |JAX value|), plus what the gradient
  tolerance allows through Adam: Adam normalises each entry's gradient
  (``m / (sqrt(v) + eps)``), so a gradient known to a relative error r
  moves the entry by r lr, and a gradient within its atol of zero by up
  to 2 lr, its sign decided by rounding.  Each step adds lr x min(2,
  atol / |g|) for the entry's JAX gradient g at that step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import LayoutPlan as JaxLayoutPlan
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS
from repro_torch.data import DataConfig, batch_for_step
from repro_torch.launch.steps import build_train_step
from repro_torch.models import LayoutPlan, build_model
from repro_torch.optim import adamw

torch.set_num_threads(1)

FAMILIES = ["yi-6b", "h2o-danube-1.8b", "moonshot-v1-16b-a3b",
            "falcon-mamba-7b", "zamba2-7b", "pixtral-12b", "whisper-tiny"]
SEQ, BATCH, STEPS = 36, 2, 3     # 72 tokens: a ragged MoE group of 16,
#                                  a window of 32 passed, 36 = 4 x 8 + 4
#                                  steps of the SSD chunk
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL, GRAD_FLOOR = 1e-4, 1e-5, 1e-7
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-5
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def batches(cfg, n: int) -> list[dict]:
    """n numpy batches of the port's pipeline (the frontend's frames or
    patches included), handed to both packages."""
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH, seed=3,
                      frontend_seq=cfg.frontend_seq if cfg.frontend != "none"
                      or cfg.is_encoder_decoder else 0,
                      d_model=cfg.d_model)
    return [{k: v.numpy() for k, v in batch_for_step(dcfg, s).items()}
            for s in range(n)]


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=FAMILIES)
def case(request):
    arch = request.param
    jcfg, cfg = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return dict(arch=arch, cfg=cfg, jmodel=jmodel, jparams=jparams,
                model=build_model(cfg), data=batches(cfg, STEPS))


def port_params(case) -> dict:
    return params_from_jax(to_numpy(case["jparams"]), case["cfg"], "cpu",
                           dtype=torch.float32)


def grad_atol(grads: dict) -> dict:
    """Each leaf's gradient atol: 1e-5 of its scale, at least 1e-7 of the
    largest gradient of all leaves."""
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in grads.values())
    return {k: max(GRAD_ATOL * float(g.abs().max()), floor)
            for k, g in grads.items()}


def jax_value_and_grad(case, jparams, batch):
    model = case["jmodel"]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: model.train_loss(p, b)))(jparams, batch)
    return float(loss), flat(params_from_jax(to_numpy(grads), case["cfg"],
                                             "cpu", dtype=torch.float32))


def test_loss_and_every_gradient_match_jax(case):
    batch = case["data"][0]
    want_loss, want = jax_value_and_grad(case, case["jparams"], batch)
    params = port_params(case)
    leaves = flat(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = case["model"].train_loss(params, torch_batch(batch))
    assert loss.grad_fn is not None
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), want_loss,
                               rtol=LOSS_RTOL)
    assert set(leaves) == set(want)
    atol = grad_atol(want)
    for key, g in zip(leaves, grads):
        w = want[key].numpy()
        got = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(got, w, rtol=GRAD_RTOL, atol=atol[key],
                                   err_msg=key)


def test_three_adamw_steps_match_jax(case):
    jmodel, cfg = case["jmodel"], case["cfg"]
    jstep = jax.jit(jax_build_train_step(
        jmodel, JaxLayoutPlan(name="host"), jax_adamw.AdamWConfig(**OPT)))
    step = build_train_step(case["model"], LayoutPlan(name="host"),
                            adamw.AdamWConfig(**OPT))
    jparams = case["jparams"]
    jopt = jax_adamw.init(jparams)
    params = port_params(case)
    opt = adamw.init(params)
    moved = {k: np.zeros(v.shape) for k, v in flat(params).items()}
    for batch in case["data"]:
        _, jgrads = jax_value_and_grad(case, jparams, batch)
        atol = grad_atol(jgrads)
        for key, g in jgrads.items():
            moved[key] += OPT["lr"] * np.minimum(
                2.0, atol[key] / np.maximum(np.abs(g.numpy()), 1e-30))
        jparams, jopt, jmetrics = jstep(jparams, jopt,
                                        jax.tree.map(jnp.asarray, batch))
        params, opt, metrics = step(params, opt, torch_batch(batch))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(metrics["lr"]),
                                   float(jmetrics["lr"]), rtol=1e-6)
    assert int(opt.step) == int(jopt.step) == STEPS
    want = flat(params_from_jax(to_numpy(jparams), cfg, "cpu",
                                dtype=torch.float32))
    for key, p in flat(params).items():
        w, got = want[key].numpy(), p.detach().numpy()
        scale = float(np.abs(w).max())
        tol = PARAM_RTOL * np.abs(w) + PARAM_ATOL * scale + moved[key]
        bad = np.abs(got - w) > tol
        assert not bad.any(), (key, float(np.abs(got - w)[bad].max()))

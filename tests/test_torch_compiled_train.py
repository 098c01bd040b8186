"""The compiled train step (``launch/train.py`` over
``serving/compiled.py``'s ``CompiledStep``): the port's counterpart of the
JAX trainer's ``jax.jit(build_train_step(...))``.

On the CPU the trainer calls its step through; the bookkeeping runs
through the module's capture seam with a stand-in backend,
:class:`Replayer`, whose "capture" runs the step and puts back every
tensor the step updates in place (so, as a real capture, it changes
nothing) and whose "replay" runs the step on the captured inputs with
every counter held.  Checked: the batch dict, made anew every step, is a
per-tick input (a replay, no recapture), a moved parameter (a restored
checkpoint's) recaptures once, the autograd Functions' counters add at
every replay, a failed capture raises naming ``"train"``, the remat
policies save no RNG state, and, one arch a family (``FAMILIES`` of
``test_torch_train_parity.py``), 3 compiled steps equal 3 eager steps bit
for bit and the JAX package's 3 AdamW steps under ``jax.jit`` within
that file's tolerances.  The ``gpu`` cases need the card and skip here:
a graphed train step against the eager one, and the checkpoint restart
through the compiled step.  JAX is imported only in a fixture, so the
``gpu`` cases run where JAX is not installed::

    PYTHONPATH=src python -m pytest -q tests/test_torch_compiled_train.py
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_compiled_train.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, batch_for_step
from repro_torch.kernels import autograd as ag
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import build_train_step
from repro_torch.models import LayoutPlan, build_model
from repro_torch.models.sharding_ctx import use_plan
from repro_torch.models.transformer import remat_wrap
from repro_torch.optim import adamw
from repro_torch.serving import compiled
from repro_torch.serving.compiled import CompiledStep, CudaGraphs, compile_step

torch.set_num_threads(1)

#: ``test_torch_train_parity.py``'s, one arch a family
FAMILIES = ["yi-6b", "h2o-danube-1.8b", "moonshot-v1-16b-a3b",
            "falcon-mamba-7b", "zamba2-7b", "pixtral-12b", "whisper-tiny"]
KW = dict(device="cpu", log_every=100)


class Replayer(CudaGraphs):
    """The capture seam on the CPU for a step that updates its state in
    place: the warm-up runs the step; "capture" runs it once more and
    puts back every tensor of the warm-up's result (the parameters, the
    moments, the step count: what the step updates), so the capture
    changes nothing, as a real one executes nothing; "replay" runs it on
    the captured inputs with every counter held (the compiled step adds
    the capture's counts) and copies its fresh outputs (the metrics)
    into the captured ones."""

    def __init__(self, fail: bool = False):
        self.fail = fail
        self.state: list = []
        self.replayed = 0

    def takes(self, device):
        return True

    def stream(self, device):
        return None

    def warm_up(self, call, stream, device):
        out = call()
        self.state = [t for t in adamw.leaves(out)
                      if isinstance(t, torch.Tensor)]
        return out

    def capture(self, call, stream, device):
        if self.fail:
            raise ValueError("operation not permitted when stream is "
                             "capturing")
        saved = [t.detach().clone() for t in self.state]
        out = call()
        with torch.no_grad():
            for t, was in zip(self.state, saved):
                t.copy_(was)
        return (call, out), out

    def replay(self, graph):
        call, out = graph
        held = compiled._snapshot()
        new = call()
        compiled._restore(held)
        with torch.no_grad():
            for o, n in zip(adamw.leaves(out), adamw.leaves(new)):
                if isinstance(o, torch.Tensor) and o is not n:
                    o.copy_(n)
        self.replayed += 1


def setup(arch="yi-6b", seq=16, batch=2, steps=3, **plan_kw):
    """The reduced ``arch``'s model, weights (seed 0), AdamW state, train
    step and ``steps`` fresh batches (a new dict each, as the trainer
    makes)."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, "cpu", dtype=cfg.param_dtype)
    step = build_train_step(model, LayoutPlan(name="host", **plan_kw),
                            adamw.AdamWConfig(warmup_steps=1,
                                              total_steps=steps))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=1,
                      frontend_seq=cfg.frontend_seq if cfg.frontend != "none"
                      or cfg.is_encoder_decoder else 0,
                      d_model=cfg.d_model)
    batches = [batch_for_step(dcfg, s) for s in range(steps)]
    return params, adamw.init(params), step, batches


def run(step, params, opt, batches) -> list[tuple[float, float]]:
    out = []
    for batch in batches:
        params, opt, metrics = step(params, opt, dict(batch))
        out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    return out


def same_tree(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(adamw.leaves(a),
                                                  adamw.leaves(b)))


# --------------------------------------------------------------------------
# the trainer's step, compiled
# --------------------------------------------------------------------------


def test_the_trainer_reports_graphs_and_calls_through_on_the_cpu():
    out = train_mod.train(arch="yi-6b", steps=2, seq_len=8, batch=2, **KW)
    assert out["graphs"] == {"captures": 0, "replays": 0, "recaptures": 0,
                             "graphs": {}}


def test_the_trainer_replays_its_step_and_equals_the_eager_run(monkeypatch):
    """``train`` with the stand-in seam: one capture, a replay every later
    step (a new batch dict each: no recapture), the losses and every
    parameter and moment bit-equal to the run that calls through."""
    eager = train_mod.train(arch="yi-6b", steps=4, seq_len=16, batch=2, **KW)
    monkeypatch.setattr(compiled, "CudaGraphs", Replayer)
    graphed = train_mod.train(arch="yi-6b", steps=4, seq_len=16, batch=2,
                              **KW)
    assert graphed["graphs"] == {"captures": 1, "replays": 3,
                                 "recaptures": 0, "graphs": {"train": 1}}
    assert graphed["losses"] == eager["losses"]
    assert same_tree(graphed["params"], eager["params"])
    assert same_tree(graphed["opt_state"], eager["opt_state"])
    assert int(graphed["opt_state"].step) == 4


def test_a_resumed_run_captures_once_and_equals_the_straight_run(
        monkeypatch, tmp_path):
    monkeypatch.setattr(compiled, "CudaGraphs", Replayer)
    kw = dict(arch="h2o-danube-1.8b", steps=6, seq_len=16, batch=2, **KW)
    straight = train_mod.train(**kw)
    d = str(tmp_path / "ck")
    part1 = train_mod.train(ckpt_dir=d, ckpt_every=3, run_steps=3, **kw)
    part2 = train_mod.train(ckpt_dir=d, ckpt_every=100, **kw)
    assert part1["graphs"]["captures"] == part2["graphs"]["captures"] == 1
    assert part2["graphs"]["replays"] == 2
    assert part1["losses"] + part2["losses"] == straight["losses"]
    assert same_tree(part2["params"], straight["params"])


def test_a_dtensor_step_stays_eager(monkeypatch):
    """Over a mesh (``DTensor`` leaves) the trainer keeps the eager step:
    gloo stages every collective through the host."""
    seen = []
    monkeypatch.setattr(train_mod, "is_dtensor", lambda x: True)
    real = train_mod.build_train_step

    def spy(*a, **kw):
        fn = real(*a, **kw)

        def step(*args):
            seen.append(1)
            return fn(*args)
        return step
    monkeypatch.setattr(train_mod, "build_train_step", spy)
    monkeypatch.setattr(compiled, "CudaGraphs", Replayer)
    out = train_mod.train(arch="yi-6b", steps=2, seq_len=8, batch=2, **KW)
    assert out["graphs"]["captures"] == 0 and len(seen) == 2


# --------------------------------------------------------------------------
# per-tick batches, moved parameters, counters, a failed capture
# --------------------------------------------------------------------------


def test_a_new_batch_dict_every_step_replays():
    params, opt, step, batches = setup(steps=4)
    fn = compile_step(step, "train", Replayer(), per_tick=("batch",))
    run(fn, params, opt, batches)
    assert (fn.captures, fn.replays, fn.recaptures) == (1, 3, 0)
    (graph,) = fn.graphs.values()
    # the graph's own copies of the batch's tensors, the last one's values
    assert len(graph.inputs) == len(batches[-1])
    for buf, x in zip(graph.inputs, batches[-1].values()):
        assert torch.equal(buf, x) and buf is not x
    # by keyword (a key of its own), the batch is per-tick all the same
    fn(params, opt, batch=batches[0])
    fn(params, opt, batch=batches[1])
    assert (fn.captures, fn.replays, fn.recaptures) == (2, 4, 0)


def test_without_per_tick_a_new_batch_dict_recaptures():
    """The reason for ``per_tick``: a tensor inside a container is
    persistent, so a fresh batch dict moves it and recaptures."""
    params, opt, step, batches = setup(steps=3)
    fn = compile_step(step, "train", Replayer())
    run(fn, params, opt, batches)
    assert (fn.captures, fn.replays, fn.recaptures) == (3, 0, 2)


def test_a_moved_parameter_recaptures_once():
    params, opt, step, batches = setup(steps=4)
    fn = compile_step(step, "train", Replayer(), per_tick=("batch",))
    params, opt, _ = fn(params, opt, batches[0])
    params, opt, _ = fn(params, opt, batches[1])
    # a restore: new tensors of the same values
    params = adamw.tree_map(lambda p: p.detach().clone(), params)
    params, opt, _ = fn(params, opt, batches[2])
    params, opt, _ = fn(params, opt, batches[3])
    assert (fn.captures, fn.recaptures, fn.replays) == (2, 1, 2)
    assert len(fn.graphs) == 1


def test_the_functions_counters_add_at_every_replay():
    """A replay adds what the capture counted through the Functions, as
    it does for the kernels; the warm-up counts once, the capture not."""
    def counted(params, opt_state, batch):
        ag.FlashAttentionFn.launches += 2
        ag.SelectiveScanFn.launches += 1
        params["w"].add_(batch["x"])
        return params, opt_state, {"loss": params["w"].sum()}

    was = [f.launches for f in ag.FUNCTIONS]
    try:
        for f in ag.FUNCTIONS:
            f.launches = 0
        fn = compile_step(counted, "train", Replayer(), per_tick=("batch",))
        params = {"w": torch.zeros(3)}
        for n in range(1, 5):
            fn(params, {}, {"x": torch.ones(3)})
            assert (ag.FlashAttentionFn.launches,
                    ag.SelectiveScanFn.launches) == (2 * n, n)
        assert torch.equal(params["w"], torch.full((3,), 4.0))
        assert (fn.captures, fn.replays) == (1, 3)
    finally:
        for f, n in zip(ag.FUNCTIONS, was):
            f.launches = n


def test_a_failed_capture_raises_naming_the_train_step(monkeypatch):
    params, opt, step, batches = setup(steps=1)
    fn = compile_step(step, "train", Replayer(fail=True),
                      per_tick=("batch",))
    with pytest.raises(RuntimeError, match="step 'train'.*not permitted"):
        fn(params, opt, batches[0])
    assert fn.graphs == {} and fn.captures == 0

    monkeypatch.setattr(compiled, "CudaGraphs",
                        lambda: Replayer(fail=True))
    with pytest.raises(RuntimeError, match="step 'train'"):
        train_mod.train(arch="yi-6b", steps=2, seq_len=8, batch=2, **KW)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_the_remat_policies_save_no_rng_state(remat):
    """No layer draws a random number, so the recompute keeps no RNG
    state: reading the CUDA generator is not allowed under capture."""
    with use_plan(LayoutPlan(name="host", remat=remat)):
        wrapped = remat_wrap(lambda x: x)
    assert wrapped.keywords["preserve_rng_state"] is False
    assert wrapped.keywords["use_reentrant"] is False


@pytest.mark.parametrize("plan_kw", [dict(num_microbatches=2),
                                     dict(remat="full")],
                         ids=["2 microbatches", "remat full"])
def test_compiled_plans_equal_their_eager_steps(plan_kw):
    params, opt, step, batches = setup(batch=4, **plan_kw)
    want = run(step, params, opt, batches)
    params2, opt2, step2, _ = setup(batch=4, **plan_kw)
    fn = compile_step(step2, "train", Replayer(), per_tick=("batch",))
    assert run(fn, params2, opt2, batches) == want
    assert same_tree(params2, params) and same_tree(opt2, opt)
    assert (fn.captures, fn.replays) == (1, 2)


# --------------------------------------------------------------------------
# one arch a family: compiled = eager bit for bit, and = the JAX package
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """``test_torch_train_parity.py``'s case of the family (it imports
    JAX) and its JAX reference: 3 AdamW steps of the JAX train step under
    ``jax.jit``, their losses, parameters and the Adam allowance."""
    parity = pytest.importorskip("test_torch_train_parity")
    jax = parity.jax
    arch = request.param
    cfg = parity.ARCHS[arch].reduced()
    jmodel = parity.jax_build_model(parity.JAX_ARCHS[arch].reduced())
    case = dict(arch=arch, cfg=cfg, jmodel=jmodel,
                jparams=jmodel.init(jax.random.PRNGKey(0)),
                model=build_model(cfg), data=parity.batches(cfg, parity.STEPS))
    jstep = jax.jit(parity.jax_build_train_step(
        case["jmodel"], parity.JaxLayoutPlan(name="host"),
        parity.jax_adamw.AdamWConfig(**parity.OPT)))
    jparams = case["jparams"]
    jopt = parity.jax_adamw.init(jparams)
    moved = {k: np.zeros(v.shape)
             for k, v in parity.flat(parity.port_params(case)).items()}
    losses = []
    for batch in case["data"]:
        _, jgrads = parity.jax_value_and_grad(case, jparams, batch)
        atol = parity.grad_atol(jgrads)
        for key, g in jgrads.items():
            moved[key] += parity.OPT["lr"] * np.minimum(
                2.0, atol[key] / np.maximum(np.abs(g.numpy()), 1e-30))
        jparams, jopt, jm = jstep(jparams, jopt,
                                  jax.tree.map(jax.numpy.asarray, batch))
        losses.append(float(jm["loss"]))
    want = parity.flat(parity.params_from_jax(
        parity.to_numpy(jparams), case["cfg"], "cpu", dtype=torch.float32))
    return dict(parity=parity, case=case, losses=losses, want=want,
                moved=moved)


def test_three_compiled_steps_equal_eager_and_jax(family):
    parity, case = family["parity"], family["case"]
    runs = {}
    for mode in ("eager", "compiled"):
        step = build_train_step(case["model"], LayoutPlan(name="host"),
                                adamw.AdamWConfig(**parity.OPT))
        if mode == "compiled":
            step = compile_step(step, "train", Replayer(),
                                per_tick=("batch",))
        params = parity.port_params(case)
        opt = adamw.init(params)
        losses = []
        for batch in case["data"]:
            params, opt, metrics = step(params, opt,
                                        parity.torch_batch(batch))
            losses.append(float(metrics["loss"]))
        runs[mode] = (losses, params, opt, step)
    (le, pe, oe, _), (lc, pc, oc, fn) = runs["eager"], runs["compiled"]
    assert isinstance(fn, CompiledStep)
    assert (fn.captures, fn.replays, fn.recaptures) == (1, 2, 0)
    assert lc == le
    assert same_tree(pc, pe) and same_tree(oc, oe)
    np.testing.assert_allclose(lc, family["losses"], rtol=parity.LOSS_RTOL)
    assert int(oc.step) == parity.STEPS
    want, moved = family["want"], family["moved"]
    for key, p in parity.flat(pc).items():
        w, got = want[key].numpy(), p.detach().numpy()
        scale = float(np.abs(w).max())
        tol = (parity.PARAM_RTOL * np.abs(w) + parity.PARAM_ATOL * scale
               + moved[key])
        bad = np.abs(got - w) > tol
        assert not bad.any(), (key, float(np.abs(got - w)[bad].max()))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only there)")
    return torch.device("cuda")


def card_run(arch: str, graphed: bool, steps: int = 3, **plan_kw):
    """``steps`` train steps of the reduced ``arch`` on the card from the
    seed-0 weights: (losses, grad norms, params, the step)."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, "cuda", dtype=cfg.param_dtype)
    opt = adamw.init(params)
    step = build_train_step(model, LayoutPlan(name="host", **plan_kw),
                            adamw.AdamWConfig(warmup_steps=1,
                                              total_steps=steps))
    if graphed:
        step = compile_step(step, "train", per_tick=("batch",))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2,
                      seed=1,
                      frontend_seq=cfg.frontend_seq if cfg.frontend != "none"
                      or cfg.is_encoder_decoder else 0,
                      d_model=cfg.d_model)
    losses, norms = [], []
    for s in range(steps):
        batch = {k: v.cuda() for k, v in batch_for_step(dcfg, s).items()}
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, params, step


def max_diff(a: dict, b: dict) -> float:
    return max(float((x.detach() - y.detach()).abs().max())
               for x, y in zip(adamw.leaves(a), adamw.leaves(b)))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,plan_kw", [
    ("yi-6b", {}), ("yi-6b", dict(num_microbatches=2)),
    ("yi-6b", dict(remat="full")), ("falcon-mamba-7b", {}),
    ("moonshot-v1-16b-a3b", {}), ("whisper-tiny", {})])
def test_a_graphed_train_step_equals_the_eager_one(cuda_device, arch,
                                                   plan_kw):
    """One capture and replays after it; the losses and grad norms within
    1e-5 of the eager run's, the parameters no further from the eager
    run's than a second eager run's are (the backward's atomics), and
    the Functions' launches equal."""
    counts = {}
    for mode in ("eager", "eager again", "graphed"):
        for f in ag.FUNCTIONS:
            f.launches = 0
        counts[mode] = card_run(arch, mode == "graphed", **plan_kw)
        counts[mode] += ({f.__name__: f.launches for f in ag.FUNCTIONS},)
    le, ne, pe, _, fe = counts["eager"]
    lg, ng, pg, step, fg = counts["graphed"]
    assert (step.captures, step.replays, step.recaptures) == (1, 2, 0)
    np.testing.assert_allclose(lg, le, rtol=1e-5)
    np.testing.assert_allclose(ng, ne, rtol=1e-5)
    noise = max_diff(counts["eager again"][2], pe)
    assert max_diff(pg, pe) <= max(2 * noise, 1e-6)
    assert fg == fe and sum(fg.values()) > 0


@pytest.mark.gpu
def test_checkpoint_restart_exact_through_the_compiled_step(cuda_device,
                                                            tmp_path):
    """``test_torch_train_loop.py``'s restart on the card, where the step
    is compiled: one capture in each run, the resumed losses and
    parameters equal to the uninterrupted run's."""
    kw = dict(arch="h2o-danube-1.8b", steps=10, seq_len=24, batch=4,
              device="cuda", log_every=100)
    straight = train_mod.train(**kw)
    d = str(tmp_path / "ck")
    part1 = train_mod.train(ckpt_dir=d, ckpt_every=5, run_steps=5, **kw)
    part2 = train_mod.train(ckpt_dir=d, ckpt_every=100, **kw)
    assert straight["graphs"] == {"captures": 1, "replays": 9,
                                  "recaptures": 0, "graphs": {"train": 1}}
    assert part1["graphs"]["captures"] == part2["graphs"]["captures"] == 1
    np.testing.assert_allclose(part1["losses"] + part2["losses"],
                               straight["losses"], rtol=1e-5, atol=1e-5)
    for key in ("embed", "lm_head", "final_norm_w"):
        torch.testing.assert_close(part2["params"][key],
                                   straight["params"][key], rtol=0, atol=0)
    assert int(part2["opt_state"].step) == int(straight["opt_state"].step)

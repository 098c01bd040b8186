"""The port's training loop end to end on the CPU (``launch/train.py``),
as ``tests/test_train_loop.py`` checks the JAX package's: the loss
falls (on one repeated batch: see the test), microbatching equals the
full batch, the remat policies (none, dots, full) equal each other, and
a checkpoint restart reproduces the uninterrupted run exactly (the
deterministic (seed, step, shard) data and the checkpointed params and
AdamW state leave no hidden state).  Also the CLI: ``--device cpu``
trains and resumes, ``--autotune`` selects the layout plan before step 0
and a second launch reads it back, and the default device is the
card."""
import numpy as np
import pytest
import torch

import repro_torch.at as at
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, batch_for_step
from repro_torch.launch.steps import build_eval_loss, build_train_step
from repro_torch.launch.train import main, train
from repro_torch.models import LayoutPlan, build_model
from repro_torch.optim import adamw
from repro_torch.tuning import tune_layout

torch.set_num_threads(1)

KW = dict(device="cpu", log_every=100)


def test_loss_decreases():
    """The trainer's step (``build_train_step`` with ``train``'s
    schedule for 8 steps) on one batch, 8 times: the loss falls at every
    step, and the eval loss with it.  One batch, because across the
    synthetic stream's batches the next token is near uniform given the
    context at this size (the reduced vocab's ln 256 = 5.545): the JAX
    package's 8-step losses at this setting move by +-0.1 around 5.7
    either way, so a falling mean of fresh batches is noise."""
    cfg = get_arch("h2o-danube-1.8b").reduced()
    model = build_model(cfg)
    params = model.init(0, "cpu", dtype=cfg.param_dtype)
    opt = adamw.init(params)
    step = build_train_step(model, LayoutPlan(),
                            adamw.AdamWConfig(warmup_steps=2, total_steps=8))
    batch = batch_for_step(DataConfig(cfg.vocab_size, 32, 4), 0)
    evaluate = build_eval_loss(model, LayoutPlan())
    before = float(evaluate(params, batch))
    losses = []
    for _ in range(8):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert losses[0] == pytest.approx(before, rel=1e-6)
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert float(evaluate(params, batch)) < losses[-1]


def test_microbatching_matches_full_batch():
    """Gradient accumulation is numerically equivalent to the full batch
    (same data, same steps) to float32 tolerance."""
    a = train(arch="yi-6b", steps=4, seq_len=16, batch=8,
              num_microbatches=1, **KW)
    b = train(arch="yi-6b", steps=4, seq_len=16, batch=8,
              num_microbatches=4, **KW)
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("batch,nmb", [(5, 2), (1, 2)])
def test_microbatches_that_do_not_divide_the_batch_raise(batch, nmb):
    """Unequal microbatches would each get weight 1/n, so a batch that n
    does not divide is refused (the JAX step's reshape raises too), and
    no parameter moves."""
    cfg = get_arch("yi-6b").reduced()
    model = build_model(cfg)
    params = model.init(0, "cpu", dtype=cfg.param_dtype)
    before = [p.clone() for p in adamw.leaves(params)]
    step = build_train_step(model, LayoutPlan(num_microbatches=nmb),
                            adamw.AdamWConfig())
    data = batch_for_step(DataConfig(cfg.vocab_size, 8, batch), 0)
    with pytest.raises(ValueError, match="equal microbatches"):
        step(params, adamw.init(params), data)
    for p, was in zip(adamw.leaves(params), before):
        torch.testing.assert_close(p.detach(), was, rtol=0, atol=0)


@pytest.fixture(scope="module")
def no_remat():
    return {arch: train(arch=arch, steps=3, seq_len=16, batch=4,
                        remat="none", **KW)
            for arch in ("yi-6b", "falcon-mamba-7b")}


@pytest.mark.parametrize("arch", ["yi-6b", "falcon-mamba-7b"])
@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_remat_matches_no_remat(no_remat, arch, remat):
    """Each policy recomputes what it drops (K1's and K9's Functions
    included) and gives the same losses and weights."""
    a = no_remat[arch]
    b = train(arch=arch, steps=3, seq_len=16, batch=4, remat=remat, **KW)
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=2e-4,
                               atol=2e-4)
    for key, p in a["params"]["layers"].items():
        if isinstance(p, torch.Tensor):
            torch.testing.assert_close(b["params"]["layers"][key], p,
                                       rtol=1e-5, atol=1e-6)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat"):
        train(arch="yi-6b", steps=1, seq_len=8, batch=2, remat="some",
              **KW)


def test_checkpoint_restart_exact(tmp_path):
    """Kill-and-resume reproduces the uninterrupted run exactly."""
    straight = train(arch="h2o-danube-1.8b", steps=10, seq_len=24, batch=4,
                     **KW)
    d = str(tmp_path / "ck")
    part1 = train(arch="h2o-danube-1.8b", steps=10, seq_len=24, batch=4,
                  ckpt_dir=d, ckpt_every=5, run_steps=5, **KW)
    # "failure" here; restart resumes from step_000000004
    part2 = train(arch="h2o-danube-1.8b", steps=10, seq_len=24, batch=4,
                  ckpt_dir=d, ckpt_every=100, **KW)
    resumed = part1["losses"] + part2["losses"]
    np.testing.assert_allclose(resumed, straight["losses"], rtol=1e-5,
                               atol=1e-5)
    assert part2["steps"] == 5
    for key in ("embed", "lm_head", "final_norm_w"):
        torch.testing.assert_close(part2["params"][key],
                                   straight["params"][key], rtol=0, atol=0)
    assert int(part2["opt_state"].step) == int(straight["opt_state"].step)


def test_cli_trains_on_the_cpu_resumes_and_refuses_autotune(capsys,
                                                           tmp_path):
    """The name is kept from when ``--autotune`` raised; the test now
    checks that it selects: deepseek-7b's train_4k plan is ``tp`` (the
    JAX package's winner), recorded under ``--ckpt-dir`` and read back
    by a second launch and by a later session, which tunes nothing."""
    args = ["--device", "cpu", "--arch", "whisper-tiny", "--batch", "2",
            "--seq-len", "8", "--ckpt-dir", str(tmp_path / "w")]
    main(args + ["--steps", "2"])
    assert "[train] done: 2 steps" in capsys.readouterr().out
    main(args + ["--steps", "2"])       # nothing left to run
    assert "[train] done: 0 steps, final loss n/a" in capsys.readouterr().out
    main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 1" in out and "done: 1 steps" in out

    ck = tmp_path / "at"
    tune = ["--device", "cpu", "--autotune", "--ckpt-dir", str(ck),
            "--batch", "2", "--seq-len", "8"]
    main(tune + ["--steps", "2"])
    out = capsys.readouterr().out
    assert ("[train] static AT: layout plan for (deepseek-7b, train_4k) "
            "-> 'tp'") in out and "done: 2 steps" in out
    main(tune + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "-> 'tp'" in out and "resumed from step 1" in out
    assert len((ck / "OAT_Records.jsonl").read_text().splitlines()) == 1
    session = at.AutoTuner(str(ck))
    assert tune_layout(session, "deepseek-7b", "train_4k") == "tp"
    assert session.warm_hits == [("static", "Layout_deepseek_7b_train_4k")]


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="is_available"):
        train(steps=1, seq_len=8, batch=2)

"""End-to-end training driver with fault tolerance, the JAX package's
``launch/train.py`` on the port.

* deterministic data keyed by (seed, step, shard) -> exact resume;
* checkpoint/restart: async atomic checkpoints + retention; on start,
  auto-resume from the newest checkpoint;
* straggler watchdog + heartbeat monitor wired into the step loop (one
  host);
* weights held in the config's ``param_dtype`` (float32), cast to
  ``compute_dtype`` at use; on the card attention runs K1 and Mamba-1's
  scan K9, each through its ``torch.autograd.Function``;
* on the card the step is compiled (``serving/compiled.py``'s
  :class:`CompiledStep`, the JAX driver's ``jax.jit`` of the step): the
  first step runs eagerly and is then captured as one CUDA graph, which
  every later step replays with its batch copied in; the parameters and
  the AdamW state are updated in place by the replay.  A restored
  checkpoint's new tensors get one new capture.  The returned
  ``"graphs"`` counts the captures, replays and recaptures
  (:func:`~repro_torch.serving.compiled.graph_stats`).  A step over
  ``DTensor`` leaves stays eager (gloo stages every collective through
  the host, as the mesh engine's steps do);
* before-execute-time AT (``--autotune``): the layout plan of
  ``(--arch, --tune-shape)`` chosen by ``tuning/static.py`` before the
  first step (the paper's phase order: install -> static -> run), at the
  rates of the card the run is on (``core.cost.CHIPS``; the default row
  with ``--device cpu``), and recorded under ``--ckpt-dir`` (or the
  working directory), so a later launch of the same cell reads it.

``--layers`` cuts the depth (the width stays the published one), as
``chip_smoke.py`` does to fit a model's AdamW state on one card.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch deepseek-7b --steps 50 --reduced --ckpt-dir "$TMPDIR/ckpt"
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
        --full --layers 12 --steps 6 --batch 4 --seq-len 1024
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 2 --autotune --ckpt-dir "$TMPDIR/ckpt"
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import at, checkpoint
from ..configs import get_arch
from ..data import DataConfig, batch_for_step
from ..device import resolve
from ..distributed.fault_tolerance import HeartbeatMonitor, StragglerWatchdog
from ..models import LayoutPlan, build_model
from ..models.sharding_ctx import is_dtensor
from ..optim import adamw
from ..serving.compiled import compile_step, graph_stats
from ..tuning import tune_layout
from .steps import build_train_step


def train(arch: str = "deepseek-7b", steps: int = 20, reduced: bool = True,
          ckpt_dir: str | None = None, ckpt_every: int = 10,
          seq_len: int = 64, batch: int = 8, lr: float = 3e-4,
          remat: str = "none", num_microbatches: int = 1,
          log_every: int = 5, seed: int = 0,
          run_steps: int | None = None, autotune: bool = False,
          tune_shape: str = "train_4k", device: str = "cuda",
          layers: int | None = None) -> dict:
    """``steps`` fixes the schedule horizon; ``run_steps`` optionally stops
    this invocation early (simulated preemption for restart tests);
    ``layers`` cuts the depth.

    ``autotune=True`` runs before-execute-time AT through a
    ``repro_torch.at`` session before the first step: the layout plan for
    ``(arch, tune_shape)`` on the published config is selected on the
    roofline estimate at the rates of the card ``device`` names (the
    default row of ``core.cost.CHIPS`` on the CPU) and persisted in the
    session record store under ``ckpt_dir`` (or the working directory),
    so later launches of the same cell skip the selection.  Returns
    {"losses", "final_loss", "steps", "wall_s", "params", "opt_state",
    "tuned_plan"} as the JAX driver does, and "graphs": the compiled
    step's captures, replays and recaptures (all 0 on the CPU)."""
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dev = resolve(device)
    model = build_model(cfg)
    tuned_plan = None
    if autotune:
        session = at.AutoTuner(ckpt_dir or ".")
        chip = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else None
        tuned_plan = tune_layout(session, arch, tune_shape, chip=chip)
        print(f"[train] static AT: layout plan for ({arch}, {tune_shape}) "
              f"-> {tuned_plan!r}")
    plan = LayoutPlan(name="host", remat=remat,
                      num_microbatches=num_microbatches)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=max(2, steps // 10),
                                total_steps=steps)
    train_step = build_train_step(model, plan, opt_cfg)

    dcfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch,
        seed=seed,
        frontend_seq=cfg.frontend_seq if cfg.frontend != "none"
        or cfg.is_encoder_decoder else 0,
        d_model=cfg.d_model)

    start_step = 0
    params = model.init(seed, dev, dtype=cfg.param_dtype)
    opt_state = adamw.init(params)
    ckptr = checkpoint.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and checkpoint.latest_step(ckpt_dir) is not None:
        restored, meta = checkpoint.restore(
            ckpt_dir, {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        start_step = int(meta["step"]) + 1
        print(f"[train] resumed from step {meta['step']}")
    step_fn = (train_step if is_dtensor(adamw.leaves(params)[0]) else
               compile_step(train_step, "train", per_tick=("batch",)))

    hb = HeartbeatMonitor(n_hosts=1, timeout_s=600)
    watchdog = StragglerWatchdog(n_hosts=1)
    losses = []
    t_start = time.time()
    end_step = steps if run_steps is None else min(steps,
                                                   start_step + run_steps)
    for step in range(start_step, end_step):
        t0 = time.time()
        batch_data = {k: v.to(dev) for k, v in
                      batch_for_step(dcfg, step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch_data)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.time() - t0
        hb.beat(0)
        watchdog.observe(0, dt)
        if step % log_every == 0 or step == end_step - 1:
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt:5.2f}s")
        if ckptr and (step + 1) % ckpt_every == 0:
            ckptr.save(step, {"params": params, "opt": opt_state},
                       extra={"arch": cfg.name})
    if ckptr:
        ckptr.save(end_step - 1, {"params": params, "opt": opt_state},
                   extra={"arch": cfg.name})
        ckptr.wait()
    wall = time.time() - t_start
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "steps": end_step - start_step, "wall_s": wall,
            "params": params, "opt_state": opt_state,
            "tuned_plan": tuned_plan, "graphs": graph_stats([step_fn])}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=("none", "dots",
                                                          "full"))
    ap.add_argument("--autotune", action="store_true",
                    help="static-AT layout selection for (--arch, "
                    "--tune-shape) before step 0, recorded under "
                    "--ckpt-dir (or the working directory)")
    ap.add_argument("--tune-shape", default="train_4k")
    args = ap.parse_args(argv)
    out = train(arch=args.arch, steps=args.steps, reduced=args.reduced,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                seq_len=args.seq_len, batch=args.batch, lr=args.lr,
                remat=args.remat, num_microbatches=args.microbatches,
                autotune=args.autotune, tune_shape=args.tune_shape,
                device=args.device, layers=args.layers)
    final, graphs = out["final_loss"], out["graphs"]
    print(f"[train] done: {out['steps']} steps, final loss "
          f"{'n/a' if final is None else f'{final:.4f}'}, "
          f"{out['wall_s']:.1f}s; graphs: {graphs['captures']} captured, "
          f"{graphs['replays']} replayed, {graphs['recaptures']} "
          "recaptured")


if __name__ == "__main__":
    main()

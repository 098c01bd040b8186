"""Training: the port's trainer step as ``launch/train.py`` builds it
(``build_train_step`` under the cell's layout plan, wrapped in
``compile_step(..., per_tick=("batch",))``: the whole step one CUDA graph,
captured at the first step and replayed), on token batches made from the
seed, a new batch every step.

Set-up builds the one step object with its parameters and AdamW state and
drives it through the checked steps (the first runs eagerly and is
captured, the rest replay), reading each step's loss, step 1's gradient
from AdamW's first moment (``m = (1 - beta1) g`` after one step) and,
after the last checked step, how far each leaf moved.  The same object
runs the window: whole steps, each followed by the trainer's read of its
loss, for ``--seconds``, synchronised at both ends.  Once the window has
closed and the program's state is freed, the reference trains the same
weights on the same batches for the checked steps.
"""
from __future__ import annotations

import gc
import time

from benchcore import check
from benchcore.program import port_config
from benchcore.trace import Tracer
from benchcore.weights import (dims, get, leaf_specs, make_leaf,
                                make_weights, put, slices)
from traffic import generate


def _norms(tree: dict, sl: list, scale: float = 1.0,
           initial=None) -> dict:
    """{slice: norm} of ``tree``'s leaves (minus ``initial(path)``)."""
    out = {}
    for path in dict.fromkeys(p for _, p, _ in sl):
        t = get(tree, path).detach().float()
        if initial is not None:
            t = t - initial(path)
        for name, pth, i in sl:
            if pth == path:
                out[name] = float((t if i is None else t[i]).double().norm()
                                  ) * scale
        del t
    return out


def run(ctx) -> dict:
    import torch
    from repro_torch.models import LayoutPlan, build_model
    from repro_torch.optim import adamw
    from repro_torch.launch.steps import build_train_step
    from repro_torch.serving.compiled import compile_step

    conf, cell, mix = ctx.config, ctx.cell, ctx.traffic
    m = dims(conf)
    dtype = getattr(torch, conf["param_dtype"])
    specs = leaf_specs(conf)
    index = {s[0]: i for i, s in enumerate(specs)}

    def initial(path):
        return make_leaf(specs[index[path]], ctx.seed, index[path],
                         ctx.device, dtype).float()

    def batch(k: int) -> dict:
        return generate.train_batch(mix, ctx.seed, k, conf["vocab_size"],
                                    ctx.device)

    model = build_model(port_config(conf, ctx.port_overrides))
    params = make_weights(conf, ctx.seed, ctx.device, dtype)
    plan = LayoutPlan(name="host", remat=cell["remat"],
                      num_microbatches=cell["microbatches"])
    opt = cell["optimizer"]
    step_fn = compile_step(build_train_step(model, plan,
                                            adamw.AdamWConfig(**opt)),
                           "train", per_tick=("batch",))
    state = adamw.init(params)
    sl = slices(conf)
    n_checked = cell["check"]["steps"]
    losses, grad = [], None
    for k in range(1, n_checked + 1):
        params, state, metrics = step_fn(params, state, batch(k))
        losses.append(float(metrics["loss"]))
        if k == 1:
            grad = _norms(state.m, sl, 1.0 / (1.0 - opt["beta1"]))
    delta = _norms(params, sl, initial=initial)
    tracer = Tracer(ctx.cuda) if ctx.trace else None
    if tracer is not None:
        tracer.warm_up()
    ctx.sync()

    # the window: whole steps, the trainer's loop (a step, then its loss)
    t0 = time.monotonic()
    steps, k = 0, n_checked
    while True:
        k += 1
        params, state, metrics = step_fn(params, state, batch(k))
        float(metrics["loss"])
        steps += 1
        if time.monotonic() - t0 >= ctx.seconds:
            break
    ctx.sync()
    t1 = time.monotonic()
    rec = {"kind": "train", "dims": m, "setup_s": t0 - ctx.t_start,
           "window_s": t1 - t0, "steps": steps,
           "tokens": steps * mix["batch"] * mix["seq_len"],
           "batch": mix["batch"], "seq_len": mix["seq_len"],
           "attempted": steps, "failed": 0, "trace": None}
    if ctx.trace:
        rf = torch.profiler.record_function
        tracer.start()
        for _ in range(cell["trace_steps"]):
            k += 1
            with rf("train.batch"):
                b = batch(k)
            with rf("train.step"):
                params, state, metrics = step_fn(params, state, b)
            with rf("train.read_loss"):
                float(metrics["loss"])
        rec["trace"] = tracer.stop()
        rec["trace_steps"] = cell["trace_steps"]
    rec["memory_peak_bytes"] = ctx.memory_peak()
    del step_fn, state, params, metrics
    gc.collect()
    ctx.free()
    rec["readings"] = train_readings(ctx, m, losses, grad, delta, initial,
                                     batch, sl)
    return rec


def train_readings(ctx, m, losses, grad, delta, initial, batch, sl) -> dict:
    """The program's checked steps against the reference's on the same
    weights and batches (and, under ``ctx.control``, the control's against
    the reference's)."""
    import torch
    from reference.train import train_steps

    opt, n = ctx.cell["optimizer"], ctx.cell["check"]["steps"]
    specs = leaf_specs(ctx.config)

    def fresh():
        w = {}
        for i, s in enumerate(specs):
            put(w, s[0], make_leaf(s, ctx.seed, i, ctx.device,
                                   torch.float32))
        return w

    batches = [batch(k) for k in range(1, n + 1)]
    ref = train_steps(fresh(), m, opt, batches, sl, initial)
    keep = check.moving_leaves(ref["grad"])
    out = {"loss_gap": check.loss_gap(losses, ref["losses"]),
           "grad_gap": check.norm_gap(grad, ref["grad"])[0],
           "delta_gap": check.norm_gap(delta, ref["delta"], keep)[0],
           "leaves_left_out": len(ref["grad"]) - len(keep),
           "losses": losses, "ref_losses": ref["losses"]}
    out["grad_worst"] = check.norm_gap(grad, ref["grad"])[1]
    out["delta_worst"] = check.norm_gap(delta, ref["delta"], keep)[1]
    if ctx.control:
        gc.collect()
        ctx.free()
        ctl = train_steps(fresh(), m, opt, batches, sl, initial, "fp8")
        out["control_loss_gap"] = check.loss_gap(ctl["losses"], ref["losses"])
        out["control_grad_gap"] = check.norm_gap(ctl["grad"], ref["grad"])[0]
        out["control_delta_gap"] = check.norm_gap(ctl["delta"], ref["delta"],
                                                  keep)[0]
    return out

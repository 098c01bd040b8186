"""The reference training step: the decoder of :mod:`.llama` (each layer
recomputed in the backward, to fit beside nothing else on the card), the
mean next-token cross entropy, the global-norm clip and AdamW with a
linear warm-up and a cosine decay, written out plainly.

AdamW as the configuration states it: moments in float32, bias-corrected,
weight decay added to the Adam direction (``m_hat / (sqrt(v_hat) + eps) +
wd x p``), the step scaled by the scheduled rate.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .llama import (Products, layer, layer_weights, no_tf32, rms_norm,
                    ste_fp8)


def _leaves(tree: dict, prefix=()) -> list[tuple]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def loss_of(weights: dict, m: dict, batch: dict, precision: str
            ) -> torch.Tensor:
    mm = Products(precision)
    x = weights["embed"][batch["tokens"]]           # (B, S, d) float32

    def run_layer(x, i):
        lw = layer_weights(weights, i, mm, grad=True)
        return torch.stack([layer(xb, lw, m, mm) for xb in x])

    for i in range(m["L"]):
        x = checkpoint(run_layer, x, i, use_reentrant=False)
    h = rms_norm(x, weights["final_norm_w"], m["eps"])
    head = weights["lm_head"]
    if precision == "fp8":
        head = ste_fp8(head)
    logits = mm(h.reshape(-1, h.shape[-1]), head)
    return F.cross_entropy(logits, batch["labels"].reshape(-1))


def lr_at(step: int, opt: dict) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * t))
    r = opt["min_lr_ratio"]
    return opt["lr"] * warm * (r + (1 - r) * cos)


def train_steps(weights: dict, m: dict, opt: dict, batches: list[dict],
                slices: list[tuple], initial, precision: str = "f32"
                ) -> dict:
    """Run ``len(batches)`` steps on ``weights`` (float32 leaves, updated
    in place).  Returns {"losses": [...], "grad": {slice: norm of step 1's
    clipped gradient}, "grad_raw": {slice: that norm before the clip},
    "delta": {slice: norm of the change after the last step}}; ``slices``
    is (name, path, layer or None), ``initial(path)`` makes a leaf's
    starting value again."""
    no_tf32()
    leaves = _leaves(weights)
    ps = [p.requires_grad_(True) for _, p in leaves]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    b1, b2, eps, wd = opt["beta1"], opt["beta2"], opt["eps"], \
        opt["weight_decay"]
    by_path = {path: p for path, p in leaves}

    def norms(tensors: dict) -> dict:
        out = {}
        for name, path, i in slices:
            t = tensors[path]
            out[name] = float((t if i is None else t[i]).double().norm())
        return out

    losses, grad, grad_raw = [], None, None
    for step, batch in enumerate(batches, start=1):
        loss = loss_of(weights, m, batch, precision)
        gs = torch.autograd.grad(loss, ps)
        losses.append(float(loss.detach()))
        gn = torch.sqrt(sum((g.float() ** 2).sum() for g in gs))
        scale = torch.clamp(opt["clip_norm"] / torch.clamp(gn, min=1e-9),
                            max=1.0)
        if step == 1:
            grad_raw = norms({path: g for (path, _), g in zip(leaves, gs)})
        torch._foreach_mul_(list(gs), scale)
        if step == 1:
            grad = norms({path: g for (path, _), g in zip(leaves, gs)})
        lr = lr_at(step, opt)
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        with torch.no_grad():
            for p, g, mo, ve in zip(ps, gs, ms, vs):
                mo.mul_(b1).add_(g * (1 - b1))
                ve.mul_(b2).add_(g * g * (1 - b2))
                d = (mo / bc1) / ((ve / bc2).sqrt() + eps) + wd * p
                p.sub_(lr * d)
        del gs, loss
    delta = {}
    with torch.no_grad():
        for path in dict.fromkeys(path for _, path, _ in slices):
            d = by_path[path] - initial(path)
            for name, pth, i in slices:
                if pth == path:
                    delta[name] = float((d if i is None else d[i])
                                        .double().norm())
            del d
    return {"losses": losses, "grad": grad, "grad_raw": grad_raw,
            "delta": delta}

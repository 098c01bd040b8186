"""Step-function builders of the train path, the JAX package's
``launch/steps.py``: ``build_train_step`` composes loss -> gradients
(``torch.autograd.grad``) -> microbatch accumulation -> AdamW;
``build_eval_loss`` is the loss alone, without a graph.

``step_for_shape`` (and its ``StepBundle``), which picks a step by
``ShapeConfig``, comes with static AT (ROADMAP queue 1, item 9b), which
brings the shape schema; ``param_shardings`` comes with the multi-GPU
layout (item 10).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models import Model
from ..models.sharding_ctx import LayoutPlan, use_plan
from ..optim import adamw


def build_train_step(model: Model, plan: LayoutPlan,
                     opt_cfg: adamw.AdamWConfig,
                     use_kernel: bool | None = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Every leaf of ``params`` (all float, as in the JAX package) is
    trained: each is set to require grad and is updated in place by
    AdamW, and the same dicts come back.  With ``plan.num_microbatches``
    = n > 1 the batch is cut into n equal microbatches along its first
    axis (a batch that n does not divide raises ValueError, as the JAX
    step's reshape does); their gradients are summed into float32
    buffers (started by the first microbatch's, cast: 0 + g exactly) and
    divided by n, as the loss is.  ``metrics``: {"loss", "grad_norm", "lr"}, 0-d float32
    tensors on the params' device."""
    nmb = max(plan.num_microbatches, 1)

    def loss_and_grads(params: dict, batch: dict):
        ps = adamw.leaves(params)
        for p in ps:
            p.requires_grad_(True)
        with use_plan(plan):
            loss = model.train_loss(params, batch, use_kernel=use_kernel)
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(ps, gs)]

    def train_step(params: dict, opt_state: adamw.AdamWState, batch: dict):
        if nmb == 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            micro = [dict(zip(batch, mbs)) for mbs in
                     zip(*(_split(v, nmb) for v in batch.values()))]
            loss, grads = loss_and_grads(params, micro[0])
            grads = [g.float() for g in grads]
            for mb in micro[1:]:
                mb_loss, mb_grads = loss_and_grads(params, mb)
                loss = loss + mb_loss
                torch._foreach_add_(grads, mb_grads)
            loss = loss / nmb
            torch._foreach_div_(grads, nmb)
        _, opt_state, metrics = adamw.update(grads, opt_state, params,
                                             opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _split(x: torch.Tensor, n: int) -> tuple:
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split into "
                         f"{n} equal microbatches")
    return x.reshape(n, x.shape[0] // n, *x.shape[1:]).unbind(0)


def build_eval_loss(model: Model, plan: LayoutPlan,
                    use_kernel: bool | None = None) -> Callable:
    """(params, batch) -> loss, computed without a graph (the kernels run
    forward only)."""
    def eval_loss(params: dict, batch: dict):
        with torch.no_grad(), use_plan(plan):
            return model.train_loss(params, batch, use_kernel=use_kernel)

    return eval_loss

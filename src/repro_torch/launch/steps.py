"""Step-function builders, the JAX package's ``launch/steps.py``: the
functions the trainers and servers run.

``build_train_step`` composes loss -> gradients (``torch.autograd.grad``)
-> microbatch accumulation -> AdamW; ``build_eval_loss`` is the loss
alone, without a graph; ``build_prefill_step`` and ``build_decode_step``
are the serving entry points, run without a graph; ``step_for_shape``
picks one of them by a ``ShapeConfig``'s kind.  ``param_shardings``
(the gradient accumulator pinned to a sharded layout) comes with the
layout tooling (ROADMAP queue 1, item 10b) and raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ShapeConfig
from ..models import Model
from ..models.sharding_ctx import LayoutPlan, use_plan
from ..optim import adamw


#: the ROADMAP item that brings sharded layouts (its part b: the layout
#: tooling; part a, tensor-parallel serving, is ported)
SHARDING_ITEM = "ROADMAP queue 1, item 10"


@dataclass(frozen=True)
class StepBundle:
    """A step function and the argument positions whose buffers it may
    reuse (the JAX package's donation list, read by a dry run)."""

    fn: Callable
    donate: tuple = ()


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


def build_prefill_step(model: Model, plan: LayoutPlan,
                       use_kernel: bool | None = None) -> Callable:
    """(params, batch) -> (last-token logits, caches) of
    ``batch["tokens"]`` (and ``batch["frontend_embeds"]`` where the arch
    has a frontend), without a graph."""
    def prefill_step(params: dict, batch: dict):
        with torch.no_grad(), use_plan(plan):
            return model.prefill(params, batch["tokens"],
                                 use_kernel=use_kernel,
                                 frontend_embeds=batch.get("frontend_embeds"))

    return prefill_step


def build_decode_step(model: Model, plan: LayoutPlan,
                      use_kernel: bool | None = None) -> Callable:
    """(params, caches, token, pos) -> (logits, caches), one token a
    lane, without a graph."""
    def decode_step(params: dict, caches: dict, token: torch.Tensor,
                    pos: torch.Tensor):
        with torch.no_grad(), use_plan(plan):
            return model.decode_step(params, caches, token, pos,
                                     use_kernel=use_kernel)

    return decode_step


def step_for_shape(model: Model, shape: ShapeConfig, plan: LayoutPlan,
                   opt_cfg: adamw.AdamWConfig | None = None,
                   param_shardings=None,
                   use_kernel: bool | None = None) -> Callable:
    """The step a cell of ``shape.kind`` runs: train, prefill or decode."""
    if param_shardings is not None:
        raise NotImplementedError(
            "param_shardings (a sharded gradient accumulator) is not "
            f"ported yet: {SHARDING_ITEM}b, the layout tooling")
    if shape.kind == "train":
        return build_train_step(model, plan,
                                opt_cfg or adamw.AdamWConfig(),
                                use_kernel=use_kernel)
    if shape.kind == "prefill":
        return build_prefill_step(model, plan, use_kernel=use_kernel)
    return build_decode_step(model, plan, use_kernel=use_kernel)

"""Step-function builders, the JAX package's ``launch/steps.py``: the
functions the trainers and servers run.

``build_train_step`` composes loss -> gradients (``torch.autograd.grad``)
-> microbatch accumulation -> AdamW; ``build_eval_loss`` is the loss
alone, without a graph; ``build_prefill_step`` and ``build_decode_step``
are the serving entry points, run without a graph; ``step_for_shape``
picks one of them by a ``ShapeConfig``'s kind.

The steps take plain tensors or ``DTensor`` (parameters, batch and caches
laid out over a mesh by :mod:`repro_torch.distributed.sharding`; they run
under ``implicit_replication``, so the plain tensors a model makes, such
as positions and masks, count as replicated).  ``param_shardings`` (the
spec tree the parameters were placed by, the JAX step's ``NamedSharding``
tree) pins every gradient, each microbatch's and their float32 sums, to
its parameter's layout (``constrain_grads``): a partial sum over the
batch axes then lands on the parameter's shard.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ShapeConfig
from ..models import Model
from ..models.sharding_ctx import (LayoutPlan, is_dtensor, split_rows,
                                   use_plan)
from ..optim import adamw


#: the ROADMAP item that brought sharded layouts (tensor-parallel serving
#: and this module's ``param_shardings``)
SHARDING_ITEM = "ROADMAP queue 1, item 10"


def over_mesh(*trees):
    """The context a step runs in: ``implicit_replication`` where a leaf
    of ``trees`` is a ``DTensor``, else nothing."""
    if not any(is_dtensor(x) for t in trees for x in adamw.leaves(t)):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def pin_grads(grads: list, params: list, specs=None) -> list:
    """Each ``DTensor`` gradient redistributed to its parameter's layout:
    the placements of its spec in ``specs`` (the leaves of the spec tree,
    in the parameters' order), or the parameter's own placements."""
    from ..distributed.sharding import dtensor_placements, spec_leaves
    per = spec_leaves(specs) if specs else [None] * len(params)
    out = []
    for g, p, spec in zip(grads, params, per):
        if is_dtensor(g):
            dm = p.device_mesh
            pl = (tuple(p.placements) if spec is None else
                  dtensor_placements(spec, tuple(dm.mesh_dim_names)))
            if tuple(g.placements) != pl:
                g = g.redistribute(dm, pl)
        out.append(g)
    return out


def _whole(x):
    """A ``DTensor`` result as the whole tensor (a loss, a norm)."""
    return x.full_tensor() if is_dtensor(x) else x


@dataclass(frozen=True)
class StepBundle:
    """A step function and the argument positions whose buffers it may
    reuse (the JAX package's donation list, read by a dry run)."""

    fn: Callable
    donate: tuple = ()


def build_train_step(model: Model, plan: LayoutPlan,
                     opt_cfg: adamw.AdamWConfig,
                     use_kernel: bool | None = None,
                     param_shardings=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Every leaf of ``params`` (all float, as in the JAX package) is
    trained: each is set to require grad and is updated in place by
    AdamW, and the same dicts come back.  With ``plan.num_microbatches``
    = n > 1 the batch is cut into n equal microbatches along its first
    axis (a batch that n does not divide raises ValueError, as the JAX
    step's reshape does); their gradients are summed into float32
    buffers (started by the first microbatch's, cast: 0 + g exactly) and
    divided by n, as the loss is.  ``metrics``: {"loss", "grad_norm", "lr"}, 0-d float32
    tensors on the params' device (whole tensors over a mesh).  With
    ``param_shardings`` every gradient is pinned to its parameter's
    layout (:func:`pin_grads`)."""
    nmb = max(plan.num_microbatches, 1)

    def pin(grads: list, ps: list) -> list:
        if param_shardings is None:
            return grads
        return pin_grads(grads, ps, param_shardings)

    def loss_and_grads(params: dict, batch: dict):
        ps = adamw.leaves(params)
        for p in ps:
            p.requires_grad_(True)
        # the backward (and a remat policy's recompute) under the plan too
        with use_plan(plan):
            loss = model.train_loss(params, batch, use_kernel=use_kernel)
            gs = torch.autograd.grad(loss, ps, allow_unused=True)
        return loss.detach(), pin([torch.zeros_like(p) if g is None else g
                                   for p, g in zip(ps, gs)], ps)

    def train_step(params: dict, opt_state: adamw.AdamWState, batch: dict):
        with over_mesh(params, batch):
            if nmb == 1:
                loss, grads = loss_and_grads(params, batch)
            else:
                micro = [dict(zip(batch, mbs)) for mbs in
                         zip(*(_split(v, nmb) for v in batch.values()))]
                loss, grads = loss_and_grads(params, micro[0])
                grads = pin([g.float() for g in grads], adamw.leaves(params))
                for mb in micro[1:]:
                    mb_loss, mb_grads = loss_and_grads(params, mb)
                    loss = loss + mb_loss
                    torch._foreach_add_(grads, mb_grads)
                loss = loss / nmb
                torch._foreach_div_(grads, nmb)
            _, opt_state, metrics = adamw.update(grads, opt_state, params,
                                                 opt_cfg)
            metrics = {k: _whole(v) for k, v in metrics.items()}
            metrics["loss"] = _whole(loss)
        return params, opt_state, metrics

    return train_step


def _split(x: torch.Tensor, n: int) -> tuple:
    """``x``'s n microbatches along its first axis (a ``DTensor`` batch
    cut rank by rank: :func:`split_rows`)."""
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split into "
                         f"{n} equal microbatches")
    return split_rows(x, n)


def build_eval_loss(model: Model, plan: LayoutPlan,
                    use_kernel: bool | None = None) -> Callable:
    """(params, batch) -> loss, computed without a graph (the kernels run
    forward only)."""
    def eval_loss(params: dict, batch: dict):
        with torch.no_grad(), use_plan(plan), over_mesh(params, batch):
            return _whole(model.train_loss(params, batch,
                                           use_kernel=use_kernel))

    return eval_loss


def build_prefill_step(model: Model, plan: LayoutPlan,
                       use_kernel: bool | None = None) -> Callable:
    """(params, batch) -> (last-token logits, caches) of
    ``batch["tokens"]`` (and ``batch["frontend_embeds"]`` where the arch
    has a frontend), without a graph."""
    def prefill_step(params: dict, batch: dict):
        with torch.no_grad(), use_plan(plan), over_mesh(params, batch):
            return model.prefill(params, batch["tokens"],
                                 use_kernel=use_kernel,
                                 frontend_embeds=batch.get("frontend_embeds"))

    return prefill_step


def build_decode_step(model: Model, plan: LayoutPlan,
                      use_kernel: bool | None = None) -> Callable:
    """(params, caches, token, pos) -> (logits, caches), one token a
    lane, without a graph.  Over a mesh (``DTensor`` arguments) the
    products run on the weights' shards as the plan lays them out, and
    each rank writes and reads its shard of the caches (batch, then heads
    or sequence over ``model``: ``models.attention.decode``)."""
    def decode_step(params: dict, caches: dict, token: torch.Tensor,
                    pos: torch.Tensor):
        with torch.no_grad(), use_plan(plan), over_mesh(params, caches):
            return model.decode_step(params, caches, token, pos,
                                     use_kernel=use_kernel)

    return decode_step


def step_for_shape(model: Model, shape: ShapeConfig, plan: LayoutPlan,
                   opt_cfg: adamw.AdamWConfig | None = None,
                   param_shardings=None,
                   use_kernel: bool | None = None) -> Callable:
    """The step a cell of ``shape.kind`` runs: train, prefill or decode.
    ``param_shardings`` (the parameters' spec tree, or ``{}``: each
    parameter's own placements) pins the train step's gradients to the
    parameters' layouts."""
    if shape.kind == "train":
        return build_train_step(model, plan,
                                opt_cfg or adamw.AdamWConfig(),
                                use_kernel=use_kernel,
                                param_shardings=param_shardings)
    if shape.kind == "prefill":
        return build_prefill_step(model, plan, use_kernel=use_kernel)
    return build_decode_step(model, plan, use_kernel=use_kernel)

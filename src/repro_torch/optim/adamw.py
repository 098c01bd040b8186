"""AdamW + cosine schedule + global-norm clipping, the JAX package's
``optim/adamw.py`` as plain functions over a params dict.

The moments are float32 whatever the parameters' type; the step is an
int32 tensor, cast to float32 for the bias corrections; weight decay is
added to the Adam direction (``m_hat / (sqrt(v_hat) + eps) + wd * p``)
and ``p`` is updated in float32, then cast back to its own type.  That
is not ``torch.optim.AdamW``, which decays ``p`` before the step and
does not clip.

Unlike the JAX function, :func:`update` writes the new parameters and
moments IN PLACE (under ``torch.no_grad``) and returns the same tensors:
at yi-6b's width a functional copy of params and moments would need
another 31 GB.  The gradients handed in are consumed (scaled in place
when they are float32).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.sharding_ctx import from_local, is_dtensor


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    m: dict
    v: dict


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree) -> list:
    """The leaves of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def init(params: dict) -> AdamWState:
    """Zero moments in float32, laid out as their parameters (``DTensor``
    parameters give ``DTensor`` moments of the same placements), and a
    zero step: a replicated ``DTensor`` on the parameters' mesh where they
    are ``DTensor``."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    first = leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if is_dtensor(first):
        step = from_local(step, first, (), ())
    return AdamWState(step=step, m=zeros, v=tree_map(torch.clone, zeros))


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio x
    lr`` at ``total_steps`` (float32, on ``step``'s device)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum((x.float() ** 2).sum() for x in leaves(tree)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before).  Returns new tensors; :func:`update` scales in place."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def update(grads, state: AdamWState, params: dict, cfg: AdamWConfig):
    """One AdamW step.  ``grads``: a tree like ``params``, or the list of
    its leaves in order.  Returns (params, state, metrics): the same
    tensors, updated in place, and {"grad_norm", "lr"} (0-d float32)."""
    gs = [g.float() for g in leaves(grads)]
    gn = global_norm(gs)
    torch._foreach_mul_(gs, _clip_scale(gn, cfg.clip_norm))
    state.step.add_(1)
    lr = schedule(state.step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    step = state.step.float()
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    # leaf by leaf, so the temporaries are one leaf's, not the model's
    for p, g, m, v in zip(leaves(params), gs, leaves(state.m),
                          leaves(state.v)):
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.float()).mul_(lr)
        p.sub_(delta)            # in float32, then rounded to p's type
    return params, state, {"grad_norm": gn, "lr": lr}

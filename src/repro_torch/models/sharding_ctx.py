"""The layout plan a trainer installs: the single-device part of the JAX
package's ``models/sharding_ctx.py``.

:class:`LayoutPlan` carries the knobs the train step reads (``remat``,
``num_microbatches``, ``loss_chunks``, ``grad_compress``); model code
reads the installed plan through :func:`current_plan`.  On one device
there is nothing to shard: ``specs`` and ``layer_specs`` are kept for
the plan's shape but unused, and :func:`constrain` is the identity.  The
sharding rules are :mod:`repro_torch.distributed.sharding`; pinning a
layer's parameters to them (``constrain_layer_params``) is ROADMAP queue
1, item 10b.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field

import torch


@dataclass
class LayoutPlan:
    """Named activation layouts (unused on one device) and the train
    step's knobs."""

    name: str = "replicated"
    specs: dict = field(default_factory=dict)
    layer_specs: object = None
    remat: str = "none"            # none | dots | full
    num_microbatches: int = 1
    loss_chunks: int = 8           # the cross entropy's token chunks
    grad_compress: bool = False    # int8 gradient all-reduce (item 10b)

    def spec(self, role: str):
        return self.specs.get(role)


_ACTIVE: contextvars.ContextVar[LayoutPlan | None] = contextvars.ContextVar(
    "layout_plan", default=None)


def current_plan() -> LayoutPlan | None:
    return _ACTIVE.get()


@contextlib.contextmanager
def use_plan(plan: LayoutPlan | None):
    token = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(token)


def constrain(x: torch.Tensor, role: str) -> torch.Tensor:
    """The identity on one device (the JAX package pins ``x`` to the
    plan's layout for ``role``)."""
    return x

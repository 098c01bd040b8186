"""Load the JAX package's parameters into the port.

The caller converts the JAX pytree to numpy (``jax.tree.map(np.asarray,
params)``), so this module imports no JAX.  Both packages keep the same
nested-dict layout: weights are (in, out) and used as ``x @ W``, and the
layer leaves are stacked (L, ...).  So no leaf is transposed; this is the
one place a layout change would go.  Float leaves are cast to the
config's ``compute_dtype`` (the JAX model casts every leaf to it before
use, so the arithmetic is the same).
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig
from .device import resolve
from .models.transformer import check_supported, torch_dtype


def params_from_jax(tree: dict, cfg: ArchConfig,
                    device: str | torch.device = "cuda") -> dict:
    """The port's parameters from a numpy copy of the JAX pytree."""
    check_supported(cfg)
    dev = resolve(device)
    dtype = torch_dtype(cfg.compute_dtype)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = torch.from_numpy(np.array(node))     # a writable copy
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return convert(tree)

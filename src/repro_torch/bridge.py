"""Load the JAX package's parameters into the port.

The caller converts the JAX pytree to numpy (``jax.tree.map(np.asarray,
params)``), so this module imports no JAX.  Both packages keep the same
nested-dict layout: weights are (in, out) and used as ``x @ W``, and the
layer leaves are stacked (L, ...).  So no leaf is transposed; this is the
one place a layout change would go.  Float leaves are cast to the
config's ``compute_dtype`` (the JAX model casts every leaf to it before
use, so the arithmetic is the same), or to the ``dtype`` asked for (a
trainer holds them in ``param_dtype``, as the JAX package does).  That
holds for the Mamba-1 leaves too: the conv taps keep their (d_conv, Di)
layout, and ``a_log`` goes to ``compute_dtype`` like the rest, to be
upcast to float32 at use
(``-exp(a_log.float())``), where the JAX model upcasts it; and for the
Mamba-2 leaves and zamba2's unstacked ``shared_attn`` block.  The
encoder-decoder's tree (``frontend_proj``, the ``enc_layers`` and
``dec_layers`` stacks, the LayerNorms' ``w``/``b``, ``pos_embed``) is
carried the same way, and so is a vision decoder's ``frontend_proj``
(pixtral-12b's patch projection, (d, d)), by name.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig
from .device import resolve
from .models.transformer import check_supported, weights_dtype


def params_from_jax(tree: dict, cfg: ArchConfig,
                    device: str | torch.device = "cuda",
                    dtype: torch.dtype | str | None = None) -> dict:
    """The port's parameters from a numpy copy of the JAX pytree, float
    leaves in ``dtype`` (default ``compute_dtype``; a trainer passes
    ``param_dtype``)."""
    check_supported(cfg)
    dev = resolve(device)
    dtype = weights_dtype(cfg, dtype)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = torch.from_numpy(np.array(node))     # a writable copy
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return convert(tree)

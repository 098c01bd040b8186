"""Shared model layers: init helpers, RMS norm, RoPE, gated MLP.

Plain functions on tensors; parameters are nested dicts.  The arithmetic
follows the JAX package's layers: the norm and the rotary angles are
computed in float32 and cast back to the input's dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               lead: tuple[int, ...] = (), dtype=torch.float32,
               device="cpu") -> torch.Tensor:
    """Uniform(-1/sqrt(in), 1/sqrt(in)) weights of shape lead + (in, out),
    used as ``x @ W``."""
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.empty(lead + (in_dim, out_dim), dtype=dtype, device=device)
    return w.uniform_(-scale, scale, generator=gen)


def embed_init(gen: torch.Generator, vocab: int, dim: int, *,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Normal(0, 0.02) embedding table (vocab, dim)."""
    w = torch.empty((vocab, dim), dtype=dtype, device=device)
    return w.normal_(0.0, 0.02, generator=gen)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * weight.float()).to(dtype)


def rope_freqs(d_head: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Split-half rotary embedding.  x: (B, H, S, D) with positions (S,)
    or (B, S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)               # (D/2,)
    angles = positions[..., None].float() * freqs               # (..., S, D/2)
    if angles.dim() == 2:             # (S, D/2) -> (1, 1, S, D/2)
        angles = angles[None, None]
    else:                             # (B, S, D/2) -> (B, 1, S, D/2)
        angles = angles[:, None]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
             lead: tuple[int, ...] = (), dtype=torch.float32,
             device="cpu") -> dict:
    kw = dict(lead=lead, dtype=dtype, device=device)
    return {"w_up": dense_init(gen, d_model, d_ff, **kw),
            "w_down": dense_init(gen, d_ff, d_model, **kw),
            "w_gate": dense_init(gen, d_model, d_ff, **kw)}


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``."""
    up = x @ p["w_up"]
    gate = x @ p["w_gate"]
    return (F.silu(gate) * up) @ p["w_down"]

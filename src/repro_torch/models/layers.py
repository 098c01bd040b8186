"""Shared model layers: init helpers, RMS and layer norm, RoPE, sinusoidal
positions, the gated and ungated MLPs, causal conv, the chunked cross
entropy of the train path.

Plain functions on tensors; parameters are nested dicts.  The arithmetic
follows the JAX package's layers: the norms and the rotary angles are
computed in float32 and cast back to the input's dtype.  GELU is the tanh
approximation, ``jax.nn.gelu``'s default (``torch``'s default is the
exact erf form).
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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dtype)


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


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal embedding (S, D) in float32: the sin
    half, then the cos half."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angles = pos / (10000.0 ** (2 * idx / dim))
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, lead: tuple[int, ...] = (),
             dtype=torch.float32, device="cpu") -> dict:
    kw = dict(lead=lead, dtype=dtype, device=device)
    p = {"w_up": dense_init(gen, d_model, d_ff, **kw),
         "w_down": dense_init(gen, d_ff, d_model, **kw)}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, **kw)
    return p


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    return F.gelu(x, approximate="tanh") if act == "gelu" else F.silu(x)


def apply_mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """``(act(x @ w_gate) * (x @ w_up)) @ w_down`` when the MLP is gated
    (it has ``w_gate``), else ``act(x @ w_up) @ w_down``; ``act`` is
    ``"silu"`` or ``"gelu"``."""
    up = x @ p["w_up"]
    if "w_gate" in p:
        return (_act(x @ p["w_gate"], act) * up) @ p["w_down"]
    return _act(up, act) @ p["w_down"]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over the sequence.  x (B, L, C), w (K, C) as
    in the JAX package: ``K - 1`` zeros in front, then output ``t`` is
    ``sum_k w[k] * x[t - K + 1 + k]`` (a cross-correlation, as both
    frameworks' convolutions compute, so the taps are not flipped)."""
    k, c = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))          # (B, C, K-1+L)
    out = F.conv1d(xp, w.T.reshape(c, 1, k), groups=c)
    out = out.transpose(1, 2)
    if b is not None:
        out = out + b
    return out


def chunked_cross_entropy(hidden: torch.Tensor, w_vocab: torch.Tensor,
                          labels: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          n_chunks: int = 8,
                          z_weight: float = 0.0) -> torch.Tensor:
    """Mean cross entropy of ``hidden @ w_vocab`` against ``labels``,
    ``n_chunks`` token chunks at a time, so the whole (tokens, vocab)
    logits tensor is never made at once.  hidden (T, d), labels (T,),
    ``mask`` (T,) float (None: every token counts).  T is padded with
    masked rows to a multiple of ``n_chunks``; each chunk's logits are
    float32; ``z_weight`` adds ``z_weight * lse**2`` per token.

    As the JAX package's ``lax.scan`` keeps each chunk's residuals for
    the backward, autograd keeps each chunk's float32 logits here (no
    recomputation): T x vocab x 4 bytes in all, 1 GB for 4096 tokens of
    yi-6b's 64000."""
    t, _ = hidden.shape
    pad = (-t) % n_chunks
    if mask is None:
        mask = torch.ones((t,), dtype=torch.float32, device=hidden.device)
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tc = hidden.shape[0] // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        rows = slice(i * tc, (i + 1) * tc)
        logits = (hidden[rows] @ w_vocab).float()            # (tc, V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(1, labels[rows, None].long())[:, 0]
        m = mask[rows]
        nll = (lse - gold) * m
        z = (lse ** 2) * m * z_weight
        total = total + nll.sum() + z.sum()
    return total / torch.clamp(mask.sum(), min=1.0)

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

from .sharding_ctx import (batch_axes_of, batch_spec, constrain_to,
                           from_local, is_dtensor, local, split_dims,
                           split_rows)


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
    ``"silu"`` or ``"gelu"``.  Over a mesh the hidden width stays split
    over ``model`` (:func:`split_last`), forward and backward."""
    up = split_last(x @ p["w_up"])
    if "w_gate" in p:
        hidden = _act(split_last(x @ p["w_gate"]), act) * up
    else:
        hidden = _act(up, act)
    return split_last(hidden) @ p["w_down"]


def split_last(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` activation laid out with its batch over the batch
    axes and its last dimension (a column-parallel product's) over
    ``model``: pinned there, its gradient comes back there too, so the
    backward's products stay split (``DTensor`` would otherwise pick
    their layouts by its own costs).  A plain tensor as it is."""
    if not is_dtensor(t):
        return t
    return constrain_to(t, batch_spec(t, {t.dim() - 1: "model"}))


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


def head_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w``: hidden rows (T, d) through the LM head (d, V).  Over a
    mesh the product runs on each rank's shard as the head is laid out
    on ``model`` (its d split: partial logits, summed where they are
    used; its V split: this rank's vocab slice; neither: whole), so the
    backward's products are split alike whatever ``DTensor``'s own
    costs would pick."""
    if not is_dtensor(w):
        return h @ w
    from ..distributed.sharding import P
    names = tuple(w.device_mesh.mesh_dim_names)
    on_model = w.placements[names.index("model")] if "model" in names \
        else None
    split = next((d for d in (0, 1)
                  if on_model is not None and on_model.is_shard(d)), None)
    ax = batch_axes_of(h)
    hl = local(h, batch_spec(h, {1: "model"} if split == 0 else None),
               partial_over=("model",) if split == 1 else ())
    wl = local(w, P(*["model" if d == split else None for d in (0, 1)]),
               partial_over=ax)
    out = hl @ wl
    shape = (h.shape[0], w.shape[1])
    spec = batch_spec(h, {1: "model"} if split == 1 else None)
    return from_local(out, h, spec, shape,
                      partial_over=("model",) if split == 0 else ())


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each row's logit at its label.  Over a mesh (``DTensor`` logits,
    the vocab split over ``model``) each rank picks the labels in its own
    vocab slice and the rows are a partial sum over ``model``."""
    if not is_dtensor(logits):
        return logits.gather(1, labels[:, None].long())[:, 0]
    spec = batch_spec(logits, {1: "model"})
    lg = local(logits, spec)
    vl = lg.shape[1]
    first = (logits.device_mesh.get_local_rank("model") * vl
             if 1 in split_dims(logits, spec) else 0)
    lab = local(labels, batch_spec(labels)).long() - first
    mine = (lab >= 0) & (lab < vl)
    g = lg.gather(1, torch.where(mine, lab, 0)[:, None])[:, 0]
    g = torch.where(mine, g, 0.0)
    partial = ("model",) if 1 in split_dims(logits, spec) else ()
    return from_local(g, logits, batch_spec(labels), tuple(labels.shape),
                      partial_over=partial)


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
    if is_dtensor(hidden):      # over a mesh: chunks cut rank by rank
        parts = [split_rows(t, n_chunks) for t in (hidden, labels, mask)]
    for i in range(n_chunks):
        if is_dtensor(hidden):
            h, lab, m = (p[i] for p in parts)
        else:
            rows = slice(i * tc, (i + 1) * tc)
            h, lab, m = hidden[rows], labels[rows], mask[rows]
        logits = head_product(h, w_vocab).float()            # (tc, V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = _gold(logits, lab)
        nll = (lse - gold) * m
        z = (lse ** 2) * m * z_weight
        total = total + nll.sum() + z.sum()
    return total / torch.clamp(mask.sum(), min=1.0)

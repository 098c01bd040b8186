"""Plain PyTorch versions of the attention kernels.

Same semantics as the JAX package's oracles: float32 einsums, masked
scores set to ``-1e30`` (not ``-inf``), causal masks aligned at the end
(query ``i`` sits at absolute position ``i + Sk - Sq``), an optional
sliding window, an optional per-batch ``kv_len`` mask, and GQA by
repeating each kv head over its ``G = H // Hkv`` query heads.

A row that sees no key at all (``kv_len == 0``) gets a uniform softmax
over the ``-1e30`` scores here, i.e. the mean of ``v``; the kernels give
exactly 0 for such a row.  The engine never sends one.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None,
                  kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """GQA attention.  q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    kk = torch.repeat_interleave(k, g, dim=1).float()
    vv = torch.repeat_interleave(v, g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kj = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= (qi - kj) < window
    s = torch.where(mask[None, None], s, NEG_INF)
    if kv_len is not None:
        valid = kj[None, None] < kv_len.to(q.device)[:, None, None, None]
        s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: torch.Tensor | None = None,
               scale: float | None = None) -> torch.Tensor:
    """One-token decode (q: (B, H, 1, D)) against (B, Hkv, S, D) caches."""
    return attention_ref(q, k, v, causal=False, scale=scale, kv_len=kv_len)

"""GQA attention: the prefill path and the decode path with a dense KV cache.

* ``full(params, x, cfg)`` — prefill over a whole sequence (kernel K1 on
  CUDA, the plain version on CPU), causal with an optional sliding
  window; returns the attention output and optionally the K/V it made.
* ``decode(params, x, cache_k, cache_v, pos, cfg)`` — one new token per
  sequence against its cache (kernel K2 on CUDA).

Layouts follow the JAX package: projections are ``x @ W`` with W of shape
(in, out), heads are (B, H, S, D) after the projection.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops
from .layers import apply_rope, dense_init


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10000.0
    window: int | None = None
    causal: bool = True
    use_rope: bool = True
    qkv_bias: bool = False


def init_attention(gen: torch.Generator, cfg: AttnConfig, *,
                   lead: tuple[int, ...] = (), dtype=torch.float32,
                   device="cpu") -> dict:
    kw = dict(lead=lead, dtype=dtype, device=device)
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    p = {"wq": dense_init(gen, cfg.d_model, hq, **kw),
         "wk": dense_init(gen, cfg.d_model, hkv, **kw),
         "wv": dense_init(gen, cfg.d_model, hkv, **kw),
         "wo": dense_init(gen, hq, cfg.d_model, **kw)}
    if cfg.qkv_bias:
        for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros(lead + (n,), dtype=dtype, device=device)
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor):
    """q (B, H, S, D), k/v (B, Hkv, S, D); transposed views, not
    contiguous (ops makes them contiguous for the kernels)."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def full(p: dict, x: torch.Tensor, cfg: AttnConfig,
         positions: torch.Tensor | None = None, return_cache: bool = False,
         use_kernel: bool | None = None):
    """Whole-sequence attention.  x: (B, S, d)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = ops.attention(q, k, v, causal=cfg.causal, window=cfg.window,
                        use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
    out = out @ p["wo"]
    if return_cache:
        return out, (k, v)
    return out


def decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
           cache_v: torch.Tensor, pos: torch.Tensor, cfg: AttnConfig,
           use_kernel: bool | None = None):
    """One-token decode.  x: (B, 1, d); caches (B, Hkv, S, Dh); ``pos`` (B,)
    is the absolute position of the new token.  Returns (out, cache_k,
    cache_v).

    The new token's K/V is written into the caches IN PLACE at slot
    ``pos`` before the read (the JAX package returns updated copies), so
    the returned caches are the tensors passed in.  Sliding-window ring
    buffers are not ported (ROADMAP queue 1, item 8).
    """
    if cfg.window is not None:
        raise NotImplementedError(
            "sliding-window decode (the ring-buffer cache) is not ported "
            "yet: ROADMAP queue 1, item 8")
    b, one, _ = x.shape
    w = cache_k.shape[2]
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    bidx = torch.arange(b, device=x.device)
    cache_k[bidx, :, pos] = k[:, :, 0].to(cache_k.dtype)
    cache_v[bidx, :, pos] = v[:, :, 0].to(cache_v.dtype)
    kv_len = torch.clamp(pos + 1, max=w).to(torch.int32)
    out = ops.decode_attention(q, cache_k, cache_v, kv_len,
                               use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(b, one, cfg.n_heads * cfg.d_head)
    return out @ p["wo"], cache_k, cache_v


def init_cache(batch: int, cfg: AttnConfig, max_len: int,
               dtype=torch.bfloat16, device="cpu",
               lead: tuple[int, ...] = ()):
    """Zeroed K and V caches of shape lead + (batch, Hkv, max_len, Dh)."""
    if cfg.window is not None:
        raise NotImplementedError(
            "sliding-window ring-buffer caches are not ported yet: "
            "ROADMAP queue 1, item 8")
    shape = lead + (batch, cfg.n_kv_heads, max_len, cfg.d_head)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))

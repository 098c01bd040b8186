"""GQA attention: prefill, and decode against a dense or a paged KV cache.

* ``full(params, x, cfg)`` — prefill over a whole sequence (kernel K1 on
  CUDA, the plain version on CPU), causal with an optional sliding
  window; returns the attention output and optionally the K/V it made.
* ``decode(params, x, cache_k, cache_v, pos, cfg)`` — one new token per
  sequence against its cache (kernel K2 on CUDA).
* ``paged_decode`` / ``paged_prefill`` — one new token, or one prompt
  chunk, per sequence against page pools shared by every sequence
  (kernels K3 / K4 on CUDA, K5 with split-KV decode, K6 over int8
  pools).  Both write the new K/V into the pools in place before they
  read; int8 pools (``scales`` given) get it quantized per row, codes
  into the pools and fp32 scales beside them.

Layouts follow the JAX package: projections are ``x @ W`` with W of shape
(in, out), heads are (B, H, S, D) after the projection.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..distributed.compression import quantize_int8_rows
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


def paged_decode(p: dict, x: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, page_table: torch.Tensor,
                 pos: torch.Tensor, cfg: AttnConfig, scales=None,
                 num_splits: int | None = None,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """One-token decode against a paged KV cache.  x: (B, 1, d); pools
    (P, Hkv, psz, Dh); ``page_table`` (B, nblk) int; ``pos`` (B,) the new
    token's absolute position; ``scales`` the (k_scale, v_scale) float32
    (P, Hkv, psz) of int8 pools, None for fp pools; ``num_splits`` the
    split-KV degree of the attention (None or 1: one pass).

    The new token's K/V is written IN PLACE into page ``table[b, pos //
    psz]`` at slot ``pos % psz`` before the read, quantized per row into
    codes and scales for int8 pools (the allocator keeps pages
    lane-exclusive; idle and masked lanes all write the null page 0,
    whose content nobody reads unmasked).  Returns the output only: the
    pools passed in are the updated ones.  No sliding window: the paged
    pool serves only archs without one (``supports_paged_cache``)."""
    b, one, _ = x.shape
    psz = k_pool.shape[2]
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    phys = page_table.long().gather(1, (pos // psz)[:, None].long())[:, 0]
    slot = (pos % psz).long()
    pools = _write_rows(k_pool, v_pool, scales, phys, slot, k[:, :, 0],
                        v[:, :, 0])
    out = ops.paged_decode(q, pools, page_table, pos + 1,
                           num_splits=num_splits, use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(b, one, cfg.n_heads * cfg.d_head)
    return out @ p["wo"]


def _write_rows(k_pool: torch.Tensor, v_pool: torch.Tensor, scales,
                phys: torch.Tensor, slot: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> ops.PagedPools:
    """Write K/V rows (..., Hkv, Dh) into ``pool[phys, :, slot]`` in place,
    quantized per row for int8 pools (codes into the pools, scales into
    ``scales[i][phys, :, slot]``); returns the layer's pools bundle."""
    if scales is None:
        k_pool[phys, :, slot] = k.to(k_pool.dtype)
        v_pool[phys, :, slot] = v.to(v_pool.dtype)
        return ops.PagedPools(k_pool, v_pool)
    k_scale, v_scale = scales
    for pool, scale, rows in ((k_pool, k_scale, k), (v_pool, v_scale, v)):
        codes, row_scale = quantize_int8_rows(rows)
        pool[phys, :, slot] = codes
        scale[phys, :, slot] = row_scale
    return ops.PagedPools(k_pool, v_pool, k_scale, v_scale)


def _paged_chunk_scatter(p: dict, x: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, page_table: torch.Tensor,
                         start: torch.Tensor, kv_len: torch.Tensor,
                         cfg: AttnConfig, scales=None):
    """Project a chunk's QKV at absolute positions ``start[b] + i`` and
    write its K/V into the pages in place (quantized per row for int8
    pools); returns (q, the layer's pools bundle).

    Padded tail positions (``pos >= kv_len``) go to the null page 0, so a
    ragged chunk never touches a live page.  A padded position may also
    lie past the table's last block (a chunk longer than what is left of
    ``max_len``); its block index is clamped before the lookup, since
    ``torch.gather`` raises where the JAX gather returns a junk index
    that the same null-page redirect then discards."""
    b, c, _ = x.shape
    psz = k_pool.shape[2]
    positions = start[:, None] + torch.arange(c, device=x.device)   # (B, C)
    q, k, v = _project_qkv(p, x, cfg, positions)
    blk = (positions // psz).clamp(max=page_table.shape[1] - 1).long()
    phys = page_table.long().gather(1, blk)
    phys = torch.where(positions < kv_len[:, None], phys, 0)   # null sink
    slot = (positions % psz).long()
    pools = _write_rows(k_pool, v_pool, scales, phys, slot, k.transpose(1, 2),
                        v.transpose(1, 2))
    return q, pools


def paged_prefill(p: dict, x: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, page_table: torch.Tensor,
                  start: torch.Tensor, kv_len: torch.Tensor, cfg: AttnConfig,
                  scales=None, use_kernel: bool | None = None) -> torch.Tensor:
    """One prompt chunk against a paged KV cache.  x: (B, C, d), first
    token at absolute position ``start[b]``; ``kv_len`` (B,) = ``start +
    valid chunk length``; ``scales`` as in :func:`paged_decode`.  The
    chunk's K/V is scattered into the pools in place, then it attends to
    the committed prefix plus its own causal triangle.  Returns the
    output only."""
    q, pools = _paged_chunk_scatter(p, x, k_pool, v_pool, page_table, start,
                                    kv_len, cfg, scales)
    out = ops.paged_prefill(q, pools, page_table, start, kv_len,
                            use_kernel=use_kernel)
    b, c, _ = x.shape
    out = out.transpose(1, 2).reshape(b, c, cfg.n_heads * cfg.d_head)
    return out @ p["wo"]


def init_paged_pool(n_pages: int, cfg: AttnConfig, page_size: int,
                    dtype=torch.bfloat16, device="cpu",
                    lead: tuple[int, ...] = ()):
    """Zeroed physical page pools: lead + (P, Hkv, psz, Dh) k and v."""
    shape = lead + (n_pages, cfg.n_kv_heads, page_size, cfg.d_head)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_paged_scales(n_pages: int, cfg: AttnConfig, page_size: int,
                      device="cpu", lead: tuple[int, ...] = ()):
    """Per-row float32 scales of int8 page pools: lead + (P, Hkv, psz) for
    k and v.  Zeros, so an untouched row dequantizes to exactly 0, as in
    the zeroed fp pool."""
    shape = lead + (n_pages, cfg.n_kv_heads, page_size)
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


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

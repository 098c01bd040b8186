"""GQA attention: prefill, decode against a dense or a paged KV cache, and
the encoder-decoder's cross attention.

* ``full(params, x, cfg)`` — prefill over a whole sequence (kernel K1 on
  CUDA, the plain version on CPU), causal with an optional sliding
  window; returns the attention output and optionally the K/V it made.
* ``decode(params, x, cache_k, cache_v, pos, cfg)`` — one new token per
  sequence against its cache (kernel K2 on CUDA); a sliding-window arch
  keeps a ring buffer of ``window`` slots, as the JAX package does.
* ``paged_decode`` / ``paged_prefill`` / ``paged_verify`` — one new
  token, one prompt chunk, or one speculative candidate chunk per
  sequence against page pools shared by every sequence (kernels K3 / K4
  on CUDA, K5 with split-KV, K6 over int8 pools).  All write the new
  K/V into the pools in place before they read; int8 pools (``scales``
  given) get it quantized per row, codes into the pools and fp32 scales
  beside them.  With a ``mesh`` whose ``"model"`` axis has more than one
  rank the pools are this rank's KV-head slice: the new K/V's slice is
  written, and the attention runs head-sharded (:mod:`..kernels.ops`),
  the output gathered whole before ``wo``; ``full`` sends a long causal
  prompt around the ring.
* ``cross_kv`` / ``cross_full`` / ``cross_decode`` — whisper's cross
  attention: K/V made once from the encoder states, then a non-causal
  attention of the decoder's Sq rows over the encoder's Sk keys (K1
  with a key length of its own) or of one decode token (K2 over the
  cross cache).  As in the JAX package the cross path projects without
  the ``bq``/``bk``/``bv`` biases that ``init_attention`` makes (the
  decoder's self-attention adds them).

Layouts follow the JAX package: projections are ``x @ W`` with W of shape
(in, out), heads are (B, H, S, D) after the projection.
"""
from __future__ import annotations

import functools
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
         use_kernel: bool | None = None, mesh=None):
    """Whole-sequence attention.  x: (B, S, d).  ``mesh`` routes long
    causal prompts through the ring (``ops.attention``)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = ops.attention(q, k, v, causal=cfg.causal, window=cfg.window,
                        mesh=mesh, use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
    out = out @ p["wo"]
    if return_cache:
        return out, (k, v)
    return out


def decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
           cache_v: torch.Tensor, pos: torch.Tensor, cfg: AttnConfig,
           use_kernel: bool | None = None):
    """One-token decode.  x: (B, 1, d); caches (B, Hkv, W, Dh); ``pos`` (B,)
    is the absolute position of the new token.  Returns (out, cache_k,
    cache_v).

    With a sliding window the caches are a ring buffer of W slots
    (:func:`init_cache`): the new token goes to slot ``pos % W`` and the
    attention reads ``min(pos + 1, W)`` keys; RoPE is applied at absolute
    positions before caching, so the softmax over an unordered window is
    exact.  The new token's K/V is written into the caches IN PLACE
    before the read (the JAX package returns updated copies), so the
    returned caches are the tensors passed in.
    """
    b, one, _ = x.shape
    w = cache_k.shape[2]
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    slot = pos % w if cfg.window is not None else pos
    bidx = torch.arange(b, device=x.device)
    cache_k[bidx, :, slot] = k[:, :, 0].to(cache_k.dtype)
    cache_v[bidx, :, slot] = v[:, :, 0].to(cache_v.dtype)
    kv_len = torch.clamp(pos + 1, max=w).to(torch.int32)
    out = ops.decode_attention(q, cache_k, cache_v, kv_len,
                               use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(b, one, cfg.n_heads * cfg.d_head)
    return out @ p["wo"], cache_k, cache_v


def paged_decode(p: dict, x: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, page_table: torch.Tensor,
                 pos: torch.Tensor, cfg: AttnConfig, scales=None,
                 num_splits: int | None = None,
                 use_kernel: bool | None = None, mesh=None) -> torch.Tensor:
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
    pool serves only archs without one (``supports_paged_cache``).  With
    ``mesh`` the pools hold this rank's KV-head slice (module
    docstring)."""
    b, one, _ = x.shape
    psz = k_pool.shape[2]
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    phys = page_table.long().gather(1, (pos // psz)[:, None].long())[:, 0]
    slot = (pos % psz).long()
    heads = _local_heads(cfg, mesh)
    pools = _write_rows(k_pool, v_pool, scales, phys, slot,
                        k[:, heads, 0], v[:, heads, 0])
    out = ops.paged_decode(q, pools, page_table, pos + 1, mesh=mesh,
                           num_splits=num_splits, use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(b, one, cfg.n_heads * cfg.d_head)
    return out @ p["wo"]


def _local_heads(cfg: AttnConfig, mesh) -> slice:
    """This rank's slice of the KV heads: all of them unless ``mesh``'s
    model axis shards them."""
    if ops.mesh_model_axis(mesh) == 1:
        return slice(None)
    return mesh.head_slice(cfg.n_kv_heads)


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
                         cfg: AttnConfig, scales=None, mesh=None):
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
    heads = _local_heads(cfg, mesh)
    pools = _write_rows(k_pool, v_pool, scales, phys, slot,
                        k[:, heads].transpose(1, 2),
                        v[:, heads].transpose(1, 2))
    return q, pools


def _paged_chunk(attend, p: dict, x: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, page_table: torch.Tensor,
                 start: torch.Tensor, kv_len: torch.Tensor, cfg: AttnConfig,
                 scales, mesh) -> torch.Tensor:
    """Scatter a chunk's K/V into the pages, attend with ``attend`` (an
    ops entry point), project out."""
    q, pools = _paged_chunk_scatter(p, x, k_pool, v_pool, page_table, start,
                                    kv_len, cfg, scales, mesh)
    out = attend(q, pools, page_table, start, kv_len, mesh=mesh)
    b, c, _ = x.shape
    out = out.transpose(1, 2).reshape(b, c, cfg.n_heads * cfg.d_head)
    return out @ p["wo"]


def paged_prefill(p: dict, x: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, page_table: torch.Tensor,
                  start: torch.Tensor, kv_len: torch.Tensor, cfg: AttnConfig,
                  scales=None, use_kernel: bool | None = None,
                  mesh=None) -> torch.Tensor:
    """One prompt chunk against a paged KV cache.  x: (B, C, d), first
    token at absolute position ``start[b]``; ``kv_len`` (B,) = ``start +
    valid chunk length``; ``scales`` as in :func:`paged_decode`.  The
    chunk's K/V is scattered into the pools in place, then it attends to
    the committed prefix plus its own causal triangle.  Returns the
    output only."""
    return _paged_chunk(
        functools.partial(ops.paged_prefill, use_kernel=use_kernel), p, x,
        k_pool, v_pool, page_table, start, kv_len, cfg, scales, mesh)


def paged_verify(p: dict, x: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, page_table: torch.Tensor,
                 start: torch.Tensor, kv_len: torch.Tensor, cfg: AttnConfig,
                 scales=None, num_splits: int | None = None,
                 use_kernel: bool | None = None, mesh=None) -> torch.Tensor:
    """Speculative-verify attention: one candidate chunk ``[last committed
    token, draft_1 .. draft_k]`` per sequence against a paged KV cache,
    the math of :func:`paged_prefill` through :func:`ops.paged_verify`
    with ``num_splits`` (split-KV verify on the card).  Rejected drafts'
    K/V lands in the pages and the cache layer rolls it back
    (``truncate_to``); padded rows (``pos >= kv_len``) sink to page 0.
    Returns the output only."""
    return _paged_chunk(
        functools.partial(ops.paged_verify, num_splits=num_splits,
                          use_kernel=use_kernel), p, x, k_pool, v_pool,
        page_table, start, kv_len, cfg, scales, mesh)


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


def init_cross_attention(gen: torch.Generator, cfg: AttnConfig, *,
                         lead: tuple[int, ...] = (), dtype=torch.float32,
                         device="cpu") -> dict:
    return init_attention(gen, cfg, lead=lead, dtype=dtype, device=device)


def cross_kv(p: dict, enc: torch.Tensor, cfg: AttnConfig):
    """Cross-attention K/V (B, Hkv, Se, D) from encoder states (B, Se, d),
    without biases."""
    b, se, _ = enc.shape
    k = (enc @ p["wk"]).reshape(b, se, cfg.n_kv_heads, cfg.d_head)
    v = (enc @ p["wv"]).reshape(b, se, cfg.n_kv_heads, cfg.d_head)
    return k.transpose(1, 2), v.transpose(1, 2)


def cross_full(p: dict, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cfg: AttnConfig, use_kernel: bool | None = None
               ) -> torch.Tensor:
    """Cross attention of x (B, Sd, d) over the cross K/V (B, Hkv, Se, D):
    no RoPE, not causal, no bias (K1 with Sk = Se on the card)."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head).transpose(1, 2)
    out = ops.attention(q, k, v, causal=False, use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
    return out @ p["wo"]


def cross_decode(p: dict, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cfg: AttnConfig, use_kernel: bool | None = None
                 ) -> torch.Tensor:
    """One decode token x (B, 1, d) over the whole cross cache (B, Hkv, Se,
    D), no ``kv_len`` (K2 on the card)."""
    b, one, _ = x.shape
    q = (x @ p["wq"]).reshape(b, one, cfg.n_heads,
                              cfg.d_head).transpose(1, 2)
    out = ops.decode_attention(q, k, v, use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(b, one, cfg.n_heads * cfg.d_head)
    return out @ p["wo"]


def init_cache(batch: int, cfg: AttnConfig, max_len: int,
               dtype=torch.bfloat16, device="cpu",
               lead: tuple[int, ...] = ()):
    """Zeroed K and V caches of shape lead + (batch, Hkv, W, Dh): W =
    ``max_len``, or with a sliding window the ring buffer's ``min(max_len,
    window)`` slots, O(window)."""
    w = min(max_len, cfg.window) if cfg.window is not None else max_len
    shape = lead + (batch, cfg.n_kv_heads, w, cfg.d_head)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))

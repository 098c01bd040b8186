"""Plain PyTorch versions of the attention kernels.

Same semantics as the JAX package's oracles: float32 einsums, masked
scores set to ``-1e30`` (not ``-inf``), causal masks aligned at the end
(query ``i`` sits at absolute position ``i + Sk - Sq``), an optional
sliding window, an optional per-batch ``kv_len`` mask, and GQA by
repeating each kv head over its ``G = H // Hkv`` query heads.  The paged
versions gather the pages through the page table into a dense view first
and then run the same math.

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


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """A (P, Hkv, psz, D) page pool seen through a (B, nblk) page table as
    the dense (B, Hkv, nblk * psz, D) caches of its sequences."""
    b, nblk = page_table.shape
    _, hkv, psz, d = pool.shape
    return pool[page_table.long()].permute(0, 2, 1, 3, 4).reshape(
        b, hkv, nblk * psz, d)


def paged_decode_ref(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, page_table: torch.Tensor,
                     kv_len: torch.Tensor | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """One-token decode (q: (B, H, 1, D)) against (P, Hkv, psz, D) pools
    through ``page_table`` (B, nblk); entries past ``kv_len`` are masked
    (they may point anywhere, typically page 0)."""
    return decode_ref(q, gather_pages(k_pool, page_table),
                      gather_pages(v_pool, page_table), kv_len, scale)


def paged_prefill_ref(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, page_table: torch.Tensor,
                      start: torch.Tensor, kv_len: torch.Tensor,
                      scale: float | None = None) -> torch.Tensor:
    """Chunked-prefill attention over paged pools.  q: (B, H, C, D), query
    ``i`` at absolute position ``start[b] + i``; key ``j`` is visible iff
    ``j <= start[b] + i`` and ``j < kv_len[b]`` (the committed prefix plus
    the chunk's own causal triangle, whose K/V is already in the pages)."""
    b, h, c, d = q.shape
    k = gather_pages(k_pool, page_table)
    v = gather_pages(v_pool, page_table)
    g = h // k.shape[1]
    sk = k.shape[2]
    scale = float(scale if scale is not None else d ** -0.5)
    kk = torch.repeat_interleave(k, g, dim=1).float()
    vv = torch.repeat_interleave(v, g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    qi = start.to(q.device)[:, None] + torch.arange(c, device=q.device)
    kj = torch.arange(sk, device=q.device)[None, None, :]
    mask = (kj <= qi[..., None]) & (kj < kv_len.to(q.device)[:, None, None])
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)

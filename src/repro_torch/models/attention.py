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
(in, out), heads are (B, H, S, D) after the projection.  Under a layout
plan with ``DTensor`` weights (the sharded train step, the dry run),
``full`` pins q, k, v and the output to the plan's ``heads`` and
``kv_heads`` layouts, as the JAX package does, and runs the attention on
each rank's shard of batch and heads (:func:`_attention_local`).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..distributed.compression import quantize_int8_rows
from ..kernels import ops
from .layers import apply_rope, dense_init, split_last
from .sharding_ctx import (batch_spec, constrain, from_local, is_dtensor,
                           layout, local, split_dims, split_dims_by_axis,
                           whole_if_split_past)


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
    q = _heads(q, b, s, cfg.n_heads, cfg.d_head)
    k = _heads(k, b, s, cfg.n_kv_heads, cfg.d_head)
    v = _heads(v, b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _heads(t: torch.Tensor, b: int, s: int, n: int, d: int) -> torch.Tensor:
    """(B, S, n x d) -> (B, n, S, d), a transposed view; a ``DTensor``
    split finer than its ``n`` heads is gathered first."""
    t = whole_if_split_past(split_last(t), -1, n)
    return t.reshape(b, s, n, d).transpose(1, 2)


def full(p: dict, x: torch.Tensor, cfg: AttnConfig,
         positions: torch.Tensor | None = None, return_cache: bool = False,
         use_kernel: bool | None = None, mesh=None):
    """Whole-sequence attention.  x: (B, S, d).  ``mesh`` routes long
    causal prompts through the ring (``ops.attention``)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    q = constrain(q, "heads")
    k = constrain(k, "kv_heads")
    v = constrain(v, "kv_heads")
    out = _attention(q, k, v, causal=cfg.causal, window=cfg.window,
                     mesh=mesh, use_kernel=use_kernel)
    out = constrain(out, "heads")
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
    out = split_last(out) @ p["wo"]
    if return_cache:
        return out, (k, v)
    return out


def _attention(q, k, v, **kw):
    """``ops.attention``, on each rank's shard when q is a ``DTensor``."""
    if is_dtensor(q):
        return _attention_local(q, k, v, **kw)
    return ops.attention(q, k, v, **kw)


def _attention_local(q, k, v, mesh=None, **kw):
    """The attention of ``DTensor`` q (B, H, S, D) and k, v (B, Hkv, Sk,
    D) on this rank's shard: batch over the batch axes and, where the
    plan shards them (``heads``, ``kv_heads``), heads over ``model``.
    Where q's heads are split and the KV heads are not (fewer KV heads
    than ranks), each rank expands the KV heads to its q heads' (the
    same values GQA reads) and their gradient is a partial sum over
    ``model``.  The output has q's layout."""
    q_spec, kv_spec = layout(q, "heads"), layout(k, "kv_heads")
    ql = local(q, q_spec)
    h, hkv = q.shape[1], k.shape[1]
    if 1 in split_dims(q, q_spec) and 1 not in split_dims(k, kv_spec):
        kv_spec = batch_spec(k)
        g, hl = h // hkv, ql.shape[1]
        first = q.device_mesh.get_local_rank("model") * hl
        kl, vl = (local(t, kv_spec, partial_over=("model",))
                  .repeat_interleave(g, dim=1)[:, first:first + hl]
                  for t in (k, v))
    else:
        kl, vl = local(k, kv_spec), local(v, kv_spec)
    out = ops.attention(ql, kl, vl, **kw)
    return from_local(out, q, q_spec, q.shape)


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
    kv_len = torch.clamp(pos + 1, max=w).to(torch.int32)
    if is_dtensor(q):
        out = _decode_local(q, k, v, cache_k, cache_v, slot, kv_len,
                            use_kernel)
    else:
        _write_slot(cache_k, cache_v, k, v, slot)
        out = ops.decode_attention(q, cache_k, cache_v, kv_len,
                                   use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(b, one, cfg.n_heads * cfg.d_head)
    return split_last(out) @ p["wo"], cache_k, cache_v


def _write_slot(cache_k, cache_v, k, v, slot, keep=None) -> None:
    """The new token's K/V (B, Hkv, 1, D) into slot ``slot`` (B,) of each
    lane's caches (B, Hkv, W, D), in place; where ``keep`` (B,) is given,
    only the lanes it marks (the others keep what they held)."""
    bidx = torch.arange(k.shape[0], device=k.device)
    for c, t in ((cache_k, k), (cache_v, v)):
        new = t[:, :, 0].to(c.dtype)
        if keep is not None:
            new = torch.where(keep[:, None, None], new, c[bidx, :, slot])
        c[bidx, :, slot] = new


def _decode_local(q, k, v, cache_k, cache_v, slot, kv_len, use_kernel):
    """One decode token of ``DTensor`` q (B, H, 1, D), k, v (B, Hkv, 1,
    D) against ``DTensor`` caches (B, Hkv, W, D) laid out as the plan's
    cache rules place them (``distributed.sharding.cache_shardings``):
    each rank writes and reads its own shard, in place.  With ``k`` None
    nothing is written and every key is read (the cross caches).

    * Heads split over ``model``: each rank attends with its q heads to
      its KV heads.
    * Heads whole (fewer KV heads than ranks): each rank writes the whole
      new K/V into its copy and attends with its q heads (split where
      the plan's ``heads`` layout splits them) to the KV heads they read.
    * Sequence split over ``model`` (``decode_seq``): the rank that holds
      a lane's slot writes it; each rank attends with every head to its
      keys, and the float32 partial maxima, sums and outputs are merged
      over ``model`` (two all-reduces, the log-sum-exp merge).

    Returns the output in q's layout (batch split, heads as above)."""
    splits = split_dims_by_axis(cache_k)
    spec = batch_spec(q, {1: "model"} if 1 in splits else None)
    ck, cv = cache_k.to_local(), cache_v.to_local()
    kl = vl = sl = ll = None
    if k is not None:
        kl, vl = local(k, spec), local(v, spec)
        sl = local(slot, batch_spec(slot))
        ll = local(kv_len, batch_spec(kv_len))
    if 2 in splits:                      # the sequence over ``model``
        return _decode_seq_local(q, kl, vl, ck, cv, sl, ll)
    if k is not None:
        _write_slot(ck, cv, kl, vl, sl)
    q_spec = layout(q, "heads")
    if 1 not in splits and 1 in split_dims(q, q_spec):
        # q's heads split, the KV heads whole: this rank's q heads read
        # the KV heads of their groups
        ql = local(q, q_spec)
        g, hl = q.shape[1] // cache_k.shape[1], ql.shape[1]
        first = q.device_mesh.get_local_rank("model") * hl
        lo, hi = first // g, (first + hl - 1) // g + 1
        ck, cv = ck[:, lo:hi], cv[:, lo:hi]
        if hl % g or first % g:          # a group across two ranks
            ck, cv = (c.repeat_interleave(g, dim=1)[:, first - lo * g:
                                                    first - lo * g + hl]
                      for c in (ck, cv))
    else:
        q_spec = spec
        ql = local(q, q_spec)
    out = ops.decode_attention(ql, ck, cv, ll, use_kernel=use_kernel)
    return from_local(out, q, q_spec, q.shape)


def _decode_seq_local(q, kl, vl, ck, cv, slot, kv_len):
    """:func:`_decode_local` over caches whose sequence is split over
    ``model``: this rank holds slots ``[c W', (c + 1) W')``."""
    import torch.distributed._functional_collectives as fc
    dm = q.device_mesh
    spec = batch_spec(q)
    ql = local(q, spec)
    wl = ck.shape[2]
    first = dm.get_local_rank("model") * wl
    b, h, _, d = ql.shape
    keys = torch.arange(wl, device=ql.device) + first
    if kl is not None:
        mine = (slot >= first) & (slot < first + wl)
        _write_slot(ck, cv, kl, vl, (slot - first).clamp(0, wl - 1),
                    keep=mine)
        valid = keys[None] < kv_len[:, None]
    else:
        valid = torch.ones((b, wl), dtype=torch.bool, device=ql.device)
    valid = valid[:, None, None, :]
    hkv = ck.shape[1]
    qg = ql.float().reshape(b, hkv, h // hkv, d) * d ** -0.5
    s = torch.einsum("bkgd,bksd->bkgs", qg, ck.float())
    s = s.masked_fill(~valid, -1e30)
    m = s.amax(-1, keepdim=True)
    pr = torch.exp(s - m) * valid
    group = (dm, tuple(dm.mesh_dim_names).index("model"))
    top = fc.all_reduce(m, "max", group)
    f = torch.exp(m - top)
    acc = torch.einsum("bkgs,bksd->bkgd", pr, cv.float()) * f
    l_ = pr.sum(-1, keepdim=True) * f
    tot = fc.all_reduce(torch.cat([acc, l_], -1), "sum", group)
    out = (tot[..., :d] / tot[..., d:]).reshape(b, h, 1, d).to(q.dtype)
    return from_local(out, q, spec, q.shape)


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
    return (_heads(enc @ p["wk"], b, se, cfg.n_kv_heads, cfg.d_head),
            _heads(enc @ p["wv"], b, se, cfg.n_kv_heads, cfg.d_head))


def cross_full(p: dict, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cfg: AttnConfig, use_kernel: bool | None = None
               ) -> torch.Tensor:
    """Cross attention of x (B, Sd, d) over the cross K/V (B, Hkv, Se, D):
    no RoPE, not causal, no bias (K1 with Sk = Se on the card)."""
    b, s, _ = x.shape
    q = _heads(x @ p["wq"], b, s, cfg.n_heads, cfg.d_head)
    q = constrain(q, "heads")
    k = constrain(k, "kv_heads")
    v = constrain(v, "kv_heads")
    out = _attention(q, k, v, causal=False, use_kernel=use_kernel)
    out = constrain(out, "heads")
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
    return split_last(out) @ p["wo"]


def cross_decode(p: dict, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cfg: AttnConfig, use_kernel: bool | None = None
                 ) -> torch.Tensor:
    """One decode token x (B, 1, d) over the whole cross cache (B, Hkv, Se,
    D), no ``kv_len`` (K2 on the card)."""
    b, one, _ = x.shape
    q = _heads(x @ p["wq"], b, one, cfg.n_heads, cfg.d_head)
    if is_dtensor(q):
        out = _decode_local(q, None, None, k, v, None, None, use_kernel)
    else:
        out = ops.decode_attention(q, k, v, use_kernel=use_kernel)
    out = out.transpose(1, 2).reshape(b, one, cfg.n_heads * cfg.d_head)
    return split_last(out) @ p["wo"]


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

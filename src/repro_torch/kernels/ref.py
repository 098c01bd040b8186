"""Plain PyTorch versions of the attention kernels.

Same semantics as the JAX package's oracles: float32 einsums, masked
scores set to ``-1e30`` (not ``-inf``), causal masks aligned at the end
(query ``i`` sits at absolute position ``i + Sk - Sq``), an optional
sliding window, an optional per-batch ``kv_len`` mask, and GQA by
repeating each kv head over its ``G = H // Hkv`` query heads.  The paged
versions gather the pages through the page table into a dense view first
and then run the same math; given ``k_scale``/``v_scale`` (int8 pools
with per-row fp32 scales (P, Hkv, psz)) they dequantize the pools first.
:func:`paged_decode_split_ref` is the split-KV decode: per-segment
softmax states merged by :func:`combine_split_states`;
:func:`paged_prefill_split_ref` the split chunked prefill (and verify),
cutting each query tile's live key tiles exactly as the kernels K5b/K6d
do, so their partials compare as well as their output;
:func:`paged_decode_split_tiles_ref` the split decode cut as K5a cuts it.
:func:`chunked_attention` is the long-sequence plain route of
``ops.attention`` (the flash algorithm in plain ops, above
``ops.CHUNKED_THRESHOLD``).

A row that sees no key at all (``kv_len == 0``) gets a uniform softmax
over the ``-1e30`` scores here, i.e. the mean of ``v``; the kernels give
exactly 0 for such a row.  The engine never sends one.

:func:`matmul_ref` (K8's plain version), :func:`fdm_stress_ref` (K7's)
and :func:`selective_scan_ref` (K9's) follow the JAX package's oracles of
the same names.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      scale: float | None = None, block_q: int = 1024,
                      block_k: int = 1024, remat: bool = True
                      ) -> torch.Tensor:
    """Memory-efficient attention in plain ops: the flash algorithm over
    ``block_q`` query chunks by ``block_k`` key chunks, a float32 online
    softmax, so the largest intermediate is (B, H, block_q, block_k)
    instead of (B, H, S, S).  q (B, H, S, D), k, v (B, Hkv, Sk, D).

    As the JAX package's ``ref.chunked_attention``: both sequences are
    zero-padded to whole chunks, padded keys are masked, the causal and
    window masks compare unaligned positions (query ``i`` at ``i``), GQA
    repeats each kv chunk over its G query heads, masked scores are
    ``-1e30``, and every key chunk is visited (a chunk no query of the
    tile sees adds nothing once a visible one has set the row's max).
    Where a gradient is wanted and ``remat``, each key step runs under
    ``torch.utils.checkpoint``, so the backward recomputes a chunk's
    probabilities instead of keeping them."""
    b, h, s, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    bq, bk = min(block_q, s), min(block_k, sk)
    pq, pk = (-s) % bq, (-sk) % bk
    qp = torch.nn.functional.pad(q, (0, 0, 0, pq)) if pq else q
    kp = torch.nn.functional.pad(k, (0, 0, 0, pk)) if pk else k
    vp = torch.nn.functional.pad(v, (0, 0, 0, pk)) if pk else v
    nq, nk = qp.shape[2] // bq, kp.shape[2] // bk
    rows = torch.arange(bq, device=q.device)[:, None]
    cols = torch.arange(bk, device=q.device)[None, :]

    def kv_step(m_prev, l_prev, acc, qc, kc, vc, iq: int, ik: int):
        if g > 1:
            kc = kc.repeat_interleave(g, dim=1)
            vc = vc.repeat_interleave(g, dim=1)
        sco = torch.einsum("bhqd,bhkd->bhqk", qc.float(), kc.float()) * scale
        qi, kj = iq * bq + rows, ik * bk + cols
        mask = kj < sk                      # padded keys
        if causal:
            mask = mask & (qi >= kj)
        if window is not None:
            mask = mask & ((qi - kj) < window)
        sco = torch.where(mask[None, None], sco, NEG_INF)
        m_cur = torch.maximum(m_prev, sco.amax(-1))
        p = torch.exp(sco - m_cur[..., None])
        alpha = torch.exp(m_prev - m_cur)
        l_cur = l_prev * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                    vc.float())
        return m_cur, l_cur, acc

    remat = remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs = []
    for iq in range(nq):
        qc = qp[:, :, iq * bq:(iq + 1) * bq]
        m = torch.full((b, h, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, bq, d), dtype=torch.float32, device=q.device)
        for ik in range(nk):
            kc = kp[:, :, ik * bk:(ik + 1) * bk]
            vc = vp[:, :, ik * bk:(ik + 1) * bk]
            if remat:
                m, l, acc = torch.utils.checkpoint.checkpoint(
                    kv_step, m, l, acc, qc, kc, vc, iq, ik,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                m, l, acc = kv_step(m, l, acc, qc, kc, vc, iq, ik)
        l = torch.where(l == 0.0, 1.0, l)
        outs.append((acc / l[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)[:, :, :s]


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: torch.Tensor | None = None,
               scale: float | None = None) -> torch.Tensor:
    """One-token decode (q: (B, H, 1, D)) against (B, Hkv, S, D) caches."""
    return attention_ref(q, k, v, causal=False, scale=scale, kv_len=kv_len)


def _dequantize_pools(k_pool: torch.Tensor, v_pool: torch.Tensor,
                      k_scale: torch.Tensor | None,
                      v_scale: torch.Tensor | None):
    """int8 pools -> float32 through their per-row scales (P, Hkv, psz);
    pools without scales pass through."""
    if k_scale is not None:
        k_pool = k_pool.float() * k_scale[..., None]
    if v_scale is not None:
        v_pool = v_pool.float() * v_scale[..., None]
    return k_pool, v_pool


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
                     scale: float | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """One-token decode (q: (B, H, 1, D)) against (P, Hkv, psz, D) pools
    through ``page_table`` (B, nblk); entries past ``kv_len`` are masked
    (they may point anywhere, typically page 0)."""
    k_pool, v_pool = _dequantize_pools(k_pool, v_pool, k_scale, v_scale)
    return decode_ref(q, gather_pages(k_pool, page_table),
                      gather_pages(v_pool, page_table), kv_len, scale)


def combine_split_states(m: torch.Tensor, l: torch.Tensor,
                         acc: torch.Tensor):
    """Merge per-split softmax states along the split axis: ``m``/``l``
    (..., ns, rows), ``acc`` (..., ns, rows, d) -> (m*, l*, acc*) with
    ``m* = max m_i``, ``l* = sum l_i e^(m_i - m*)``, ``acc* = sum acc_i
    e^(m_i - m*)``.  An empty split (m = -1e30, l = 0, acc = 0) adds
    exactly 0."""
    m_star = m.amax(dim=-2)
    alpha = torch.exp(m - m_star[..., None, :])
    l_star = (l * alpha).sum(dim=-2)
    acc_star = (acc * alpha[..., None]).sum(dim=-3)
    return m_star, l_star, acc_star


def finalize_split_states(l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``acc / l``, with ``l == 0`` (no key seen) giving exactly 0."""
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / l[..., None]


def paged_decode_split_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           kv_len: torch.Tensor, num_splits: int,
                           scale: float | None = None,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Paged decode as ``num_splits`` segments of the table's key range,
    each with its own masked softmax state, merged by
    :func:`combine_split_states` (the two phases of the split kernels).
    A row with no key gives exactly 0."""
    b, h, _, d = q.shape
    nblk = page_table.shape[1]
    hkv, psz = k_pool.shape[1], k_pool.shape[2]
    g = h // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    k_pool, v_pool = _dequantize_pools(k_pool, v_pool, k_scale, v_scale)
    k = gather_pages(k_pool, page_table).float()
    v = gather_pages(v_pool, page_table).float()
    qg = q.reshape(b, hkv, g, d).float()
    s_total = nblk * psz
    seg = -(-s_total // num_splits)
    pad = num_splits * seg - s_total
    kj = torch.arange(s_total, device=q.device)
    valid = kj[None, :] < kv_len.to(q.device)[:, None]            # (B, S)
    scores = torch.einsum("bhgd,bhkd->bhgk", qg, k) * scale
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    ss = scores.reshape(b, hkv, g, num_splits, seg)
    m_i = ss.amax(dim=-1)                                       # (B,Hkv,G,ns)
    p = torch.exp(ss - m_i[..., None])
    empty = m_i <= NEG_INF          # a segment with no key: (m=-1e30, l=0)
    p = torch.where(empty[..., None], 0.0, p)
    m_i = torch.where(empty, NEG_INF, m_i)
    acc_i = torch.einsum("bhgsk,bhskd->bhgsd", p,
                         v.reshape(b, hkv, num_splits, seg, d))
    _, l_star, acc_star = combine_split_states(
        m_i.transpose(-1, -2), p.sum(dim=-1).transpose(-1, -2),
        acc_i.transpose(-2, -3))
    out = finalize_split_states(l_star, acc_star)               # (B,Hkv,G,D)
    return out.reshape(b, h, 1, d).to(q.dtype)


def paged_decode_split_tiles_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 page_table: torch.Tensor,
                                 kv_len: torch.Tensor, num_splits: int, *,
                                 scale: float | None = None,
                                 k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None,
                                 block_k: int = 64):
    """Split decode cut at a kernel's own partition: split ``s`` takes the
    ``s``-th contiguous share, ``ceil(tiles / num_splits)``, of the lane's
    ``tiles = ceil(kv_len / block_k)`` live key tiles (64-key tiles for
    the bf16 K5a of ``paged_decode.cu``, 32 for the SIMT template).  A
    decode is a one-row chunk at position ``kv_len - 1``, so this is
    :func:`paged_prefill_split_ref` with ``block_q`` 1.

    Returns ``(out, (m, l, acc))``: the merged output like q and the fp32
    partials in K5a's layout, (B, Hkv, ns, G) and (B, Hkv, ns, G, D); a
    split with no key gives (-1e30, 0, 0)."""
    b, h, _, d = q.shape
    hkv, ns = k_pool.shape[1], num_splits
    kv_len = kv_len.to(q.device)
    out, (m, l, acc) = paged_prefill_split_ref(
        q, k_pool, v_pool, page_table, kv_len - 1, kv_len, ns, scale=scale,
        k_scale=k_scale, v_scale=v_scale, block_q=1, block_k=block_k)
    g = h // hkv
    m, l = (x.reshape(b, hkv, g, ns).transpose(2, 3) for x in (m, l))
    return out, (m, l, acc.reshape(b, hkv, g, ns, d).transpose(2, 3))


def paged_prefill_ref(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, page_table: torch.Tensor,
                      start: torch.Tensor, kv_len: torch.Tensor,
                      scale: float | None = None,
                      k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Chunked-prefill attention over paged pools.  q: (B, H, C, D), query
    ``i`` at absolute position ``start[b] + i``; key ``j`` is visible iff
    ``j <= start[b] + i`` and ``j < kv_len[b]`` (the committed prefix plus
    the chunk's own causal triangle, whose K/V is already in the pages)."""
    b, h, c, d = q.shape
    k_pool, v_pool = _dequantize_pools(k_pool, v_pool, k_scale, v_scale)
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


def paged_prefill_split_ref(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, page_table: torch.Tensor,
                            start: torch.Tensor, kv_len: torch.Tensor,
                            num_splits: int, *, scale: float | None = None,
                            k_scale: torch.Tensor | None = None,
                            v_scale: torch.Tensor | None = None,
                            block_q: int = 64, block_k: int = 32,
                            rows: int | None = None):
    """Chunked prefill as ``num_splits`` segments of each query tile's
    live key tiles: the two phases of K5b/K6d + K5c, in plain PyTorch.

    Row ``i`` sits in query tile ``i // block_q``, whose live key tiles
    are ``t < t_hi = min(ceil(kv_len / block_k), last // block_k + 1)``
    with ``last = start + (i // block_q + 1) * block_q - 1`` the tile's
    last query position; split ``s`` takes tiles ``[s * per, min((s + 1)
    * per, t_hi))``, ``per = ceil(t_hi / num_splits)``, masked causally
    and by ``kv_len`` as :func:`paged_prefill_ref`.  A split with no key
    visible to a row gives that row (m, l, acc) = (-1e30, 0, 0).

    ``rows`` takes the bf16 kernel's flattened tiles instead: a kv head's
    chunk is C x G (position, head) rows, row ``f = i * G + h % G``, and a
    tile holds ``rows`` consecutive ones, so row (h, i)'s tile ends at
    ``last = start + ((f // rows + 1) * rows - 1) // G``; where G divides
    ``rows`` that is ``block_q = rows // G``'s partition.

    Returns ``(out, (m, l, acc))``: the merged output like q (a row with
    no key at all gives exactly 0) and the fp32 partials, (B, H, ns, C)
    and (B, H, ns, C, D)."""
    b, h, c, d = q.shape
    ns = num_splits
    k_pool, v_pool = _dequantize_pools(k_pool, v_pool, k_scale, v_scale)
    k = gather_pages(k_pool, page_table).float()
    v = gather_pages(v_pool, page_table).float()
    g = h // k.shape[1]
    sk = k.shape[2]
    scale = float(scale if scale is not None else d ** -0.5)
    kk = torch.repeat_interleave(k, g, dim=1)
    vv = torch.repeat_interleave(v, g, dim=1)
    dev = q.device
    start, kv_len = start.to(dev).long(), kv_len.to(dev).long()
    pos = torch.arange(c, device=dev)
    qi = start[:, None] + pos                                    # (B, C)
    if rows is None:
        last = (start[:, None] + (pos // block_q + 1) * block_q - 1)[:, None]
    else:                                                        # (B, H, C)
        f = pos[None] * g + torch.arange(h, device=dev)[:, None] % g
        last = start[:, None, None] + ((f // rows + 1) * rows - 1) // g
    n_live = -(-kv_len.clamp(min=0, max=sk) // block_k)           # (B,)
    t_hi = torch.minimum(n_live[:, None, None],
                         torch.div(last, block_k, rounding_mode="floor") + 1)
    t_hi = torch.where(last < 0, 0, t_hi)                  # (B, 1 or H, C)
    per = -(-t_hi // ns)
    split = torch.arange(ns, device=dev)[:, None, None, None]    # (ns,1,1,1)
    lo = torch.minimum(split * per, t_hi) * block_k        # (ns, B, ., C)
    hi = torch.minimum(t_hi, split * per + per) * block_k
    kj = torch.arange(sk, device=dev)
    visible = ((kj <= qi[..., None])
               & (kj < kv_len[:, None, None]))[:, None]          # (B,1,C,S)
    mask = visible & (kj >= lo[..., None]) & (kj < hi[..., None])
    mask = mask.permute(1, 2, 0, 3, 4)                       # (B,.,ns,C,S)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    s = torch.where(mask, s[:, :, None], NEG_INF)                # (B,H,ns,C,S)
    m = s.amax(dim=-1)              # -1e30 where the split sees no key
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhnqk,bhkd->bhnqd", p, vv)
    _, l_star, acc_star = combine_split_states(m, l, acc)
    out = finalize_split_states(l_star, acc_star).to(q.dtype)
    return out, (m, l, acc)


def matmul_ref(x: torch.Tensor, y: torch.Tensor,
               bias: torch.Tensor | None = None, epilogue: str = "none",
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``epilogue(x @ y + bias)`` in float32, cast to ``out_dtype`` (default
    x's dtype); gelu is the tanh form, as ``jax.nn.gelu``'s default."""
    out = x.float() @ y.float()
    if bias is not None:
        out = out + bias.float()
    if epilogue == "gelu":
        out = torch.nn.functional.gelu(out, approximate="tanh")
    elif epilogue == "silu":
        out = torch.nn.functional.silu(out)
    elif epilogue == "relu":
        out = torch.clamp_min(out, 0)
    elif epilogue != "none":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return out.to(out_dtype or x.dtype)


def _next(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``a`` shifted by one along ``dim``, the last plane repeated: the
    edge-clamped ``[i + 1]`` neighbour."""
    n = a.shape[dim]
    return torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)], dim)


def fdm_stress_ref(arrays: dict, state: dict, dt: float) -> dict:
    """Vectorised Sample-8 stress update with edge-clamped (i+1/j+1/k+1)
    neighbour reads (the kernel's convention)."""
    lam, rig, q = arrays["lam"], arrays["rig"], arrays["q"]
    absx, absy, absz = arrays["absx"], arrays["absy"], arrays["absz"]
    r_ip1, r_jp1, r_kp1 = _next(rig, 0), _next(rig, 1), _next(rig, 2)
    r_ip1jp1, r_ip1kp1 = _next(r_ip1, 1), _next(r_ip1, 2)
    r_jp1kp1 = _next(r_jp1, 2)
    qg = absx[:, None, None] * absy[None, :, None] * absz[None, None, :] * q
    rm2 = rig + rig
    rltheta = (arrays["dxvx"] + arrays["dyvy"] + arrays["dzvz"]) * lam
    out = {}
    out["sxx"] = (state["sxx"] + (rltheta + rm2 * arrays["dxvx"]) * dt) * qg
    out["syy"] = (state["syy"] + (rltheta + rm2 * arrays["dyvy"]) * dt) * qg
    out["szz"] = (state["szz"] + (rltheta + rm2 * arrays["dzvz"]) * dt) * qg
    stmp1 = 1.0 / rig
    stmp2 = 1.0 / r_ip1
    stmp4 = 1.0 / r_kp1
    stmp3 = stmp1 + stmp2
    rmaxy = 4.0 / (stmp3 + 1.0 / r_jp1 + 1.0 / r_ip1jp1)
    rmaxz = 4.0 / (stmp3 + stmp4 + 1.0 / r_ip1kp1)
    rmayz = 4.0 / (stmp3 + stmp4 + 1.0 / r_jp1kp1)
    out["sxy"] = (state["sxy"]
                  + (rmaxy * (arrays["dxvy"] + arrays["dyvx"])) * dt) * qg
    out["sxz"] = (state["sxz"]
                  + (rmaxz * (arrays["dxvz"] + arrays["dzvx"])) * dt) * qg
    out["syz"] = (state["syz"]
                  + (rmayz * (arrays["dyvz"] + arrays["dzvy"])) * dt) * qg
    return out


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                       return_final_state: bool = False):
    """The Mamba-1 recurrence, one time step at a time, in float32::

        h[t] = exp(dt[t] * A) * h[t-1] + (dt[t] * x[t]) * B[t]
        y[t] = sum_n C[t] * h[t] + D * x[t]

    x, dt (Bt, L, Di); a (Di, N); b, c (Bt, L, N); d (Di,).  Returns y in
    x's dtype and, with ``return_final_state``, the state after the last
    step, (Bt, Di, N) float32."""
    bsz, length, di = x.shape
    a32, d32 = a.float(), d.float()
    xs, dts, bs, cs = x.float(), dt.float(), b.float(), c.float()
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(length):
        xt, dtt = xs[:, t], dts[:, t]                     # (Bt, Di)
        da = torch.exp(dtt[..., None] * a32[None])        # (Bt, Di, N)
        h = da * h + (dtt * xt)[..., None] * bs[:, t, None, :]
        ys.append((h * cs[:, t, None, :]).sum(-1) + d32[None] * xt)
    y = torch.stack(ys, dim=1).to(x.dtype)
    if return_final_state:
        return y, h
    return y


#: the steps a chunk of :func:`selective_scan_chunked` composes at once
SCAN_CHUNK = 1024


def selective_scan_chunked(x: torch.Tensor, dt: torch.Tensor,
                           a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                           d: torch.Tensor, return_final_state: bool = False,
                           chunk: int = SCAN_CHUNK):
    """:func:`selective_scan_ref`'s recurrence in chunks of ``chunk``
    steps, K9's time partition in PyTorch operations: within a chunk the
    steps' affine maps ``h -> exp(dt A) h + dt x B`` compose by a
    log-depth (Hillis-Steele) scan, and the chunks carry the state in
    order.  Float32, the same values as the step loop up to rounding, in
    ``2 log2(chunk)`` operations a chunk where the loop takes a few a
    step (the plain route of a long sequence: ``ops.ssm_scan``)."""
    bsz, length, di = x.shape
    a32, d32 = a.float(), d.float()
    xs, dts, bs, cs = x.float(), dt.float(), b.float(), c.float()
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for lo in range(0, length, chunk):
        t = slice(lo, lo + chunk)
        decay = torch.exp(dts[:, t, :, None] * a32)          # (Bt, T, Di, N)
        u = (dts[:, t] * xs[:, t])[..., None] * bs[:, t, None, :]
        k, steps = 1, decay.shape[1]
        while k < steps:
            # step s takes the composition of steps s - k .. s: the map
            # k steps back (the identity before the chunk) comes first
            u = u + decay * torch.cat([torch.zeros_like(u[:, :k]),
                                       u[:, :-k]], dim=1)
            decay = decay * torch.cat([torch.ones_like(decay[:, :k]),
                                       decay[:, :-k]], dim=1)
            k *= 2
        hs = decay * h[:, None] + u
        ys.append((hs * cs[:, t, None, :]).sum(-1) + d32 * xs[:, t])
        h = hs[:, -1]
    y = torch.cat(ys, dim=1).to(x.dtype)
    if return_final_state:
        return y, h
    return y

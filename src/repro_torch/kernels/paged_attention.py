"""Python wrappers of the paged CUDA attention kernels (``csrc/paged_attention.cu``).

* :func:`flash_paged_decode` — one query token per sequence against K/V
  page pools (P, Hkv, psz, D), each sequence reaching its pages through a
  row of ``page_table`` (B, nblk) int32, masked to ``kv_len[b]`` keys; a
  row with ``kv_len == 0`` gives exactly 0.  ``num_splits`` 1 (the
  default) launches K3; more launches K5a (:func:`paged_decode_split`, one
  block per split of the lane's live keys, fp32 partial softmax states)
  and K5c (:func:`split_combine`, the merge).
* :func:`flash_paged_decode_quant` — the same over int8 pools with fp32
  per-row scales (P, Hkv, psz): K6a, or K6b
  (:func:`paged_decode_split_quant`) + K5c.
* :func:`flash_paged_prefill` (K4) — a chunk of C query tokens per
  sequence at absolute positions ``start[b] + i``, causal over the
  committed paged prefix plus the chunk's own triangle; key ``j`` is
  valid iff ``j < kv_len[b]``.  The chunk's K/V must already be in the
  pages (write before read).  :func:`flash_paged_prefill_quant` (K6c) is
  the same over int8 pools.

Table entries past ``ceil(kv_len / psz)`` are never read and may point
anywhere (page 0 by convention); entries below it must name pages of the
pools.  The wrappers follow the contract of :mod:`.flash_attention`:
CUDA tensors only, checked; outputs and partials from ``torch.empty``;
launch on the current stream without syncing; raise on a launch error;
each kernel counts its own launches in ``.launches`` on the function
named after it.  The plain versions live in :mod:`.ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .flash_attention import _DTYPES, HEAD_DIMS, _raise_on, _stream

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = build.load("paged_attention")
    signatures = {
        "repro_flash_paged_decode": [_P] * 6 + [_I] * 7 + [_F, _P],
        "repro_flash_paged_decode_quant": [_P] * 8 + [_I] * 7 + [_F, _P],
        "repro_paged_decode_split": [_P] * 8 + [_I] * 8 + [_F, _P],
        "repro_paged_decode_split_quant": [_P] * 10 + [_I] * 8 + [_F, _P],
        "repro_split_combine": [_P] * 4 + [_I] * 5 + [_P],
        "repro_flash_paged_prefill": [_P] * 7 + [_I] * 8 + [_F, _P],
        "repro_flash_paged_prefill_quant": [_P] * 9 + [_I] * 8 + [_F, _P],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def _check(name: str, q: torch.Tensor, k_pool: torch.Tensor,
           v_pool: torch.Tensor, page_table: torch.Tensor,
           lens: tuple[torch.Tensor, ...],
           scales: tuple[torch.Tensor, torch.Tensor] | None = None) -> None:
    """Raise on what the kernels do not take.  ``scales`` marks int8 pools:
    then the pools must be int8 and the scales float32 (P, Hkv, psz);
    otherwise q and the pools share one dtype."""
    for t in (q, k_pool, v_pool):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, "
                             f"got one on {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected 4-d q and pools, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: q and pools must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
        if t.numel() == 0:
            raise ValueError(f"{name}: empty tensor {tuple(t.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: q dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    if scales is None:
        if not (q.dtype == k_pool.dtype == v_pool.dtype):
            raise ValueError(f"{name}: q and pool dtypes differ")
    else:
        if not (k_pool.dtype == v_pool.dtype == torch.int8):
            raise ValueError(f"{name}: quantized pools must be int8, got "
                             f"{k_pool.dtype} and {v_pool.dtype}")
        for s in scales:
            if (s.dtype != torch.float32 or s.device != q.device
                    or not s.is_contiguous()
                    or s.shape != k_pool.shape[:3]):
                raise ValueError(
                    f"{name}: k_scale and v_scale must be contiguous "
                    f"float32 {tuple(k_pool.shape[:3])} tensors on q's "
                    f"device, got {s.dtype} {tuple(s.shape)} on {s.device}")
    if not (q.device == k_pool.device == v_pool.device):
        raise ValueError(f"{name}: q and pools are on different devices")
    b, h, _, d = q.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != d:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k_pool "
                         f"{tuple(k_pool.shape)} v_pool "
                         f"{tuple(v_pool.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if h % k_pool.shape[1]:
        raise ValueError(f"{name}: {h} query heads are not a multiple of "
                         f"{k_pool.shape[1]} kv heads")
    if (page_table.dim() != 2 or page_table.shape[0] != b
            or page_table.shape[1] == 0):
        raise ValueError(f"{name}: page_table must be (B={b}, nblk >= 1), "
                         f"got {tuple(page_table.shape)}")
    for t in (page_table, *lens):
        if (t.dtype != torch.int32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: page_table, start and kv_len must be "
                             "contiguous int32 tensors on q's device")
    for t in lens:
        if t.shape != (b,):
            raise ValueError(f"{name}: start and kv_len must be (B={b},), "
                             f"got {tuple(t.shape)}")


def _num_splits(num_splits: int | None, nblk: int) -> int:
    """The split count clamped to the page walk, as the JAX package's
    ``_num_splits`` does with its tile count (here whole pages: the
    kernels take no sub-page tile)."""
    return max(1, min(int(num_splits or 1), nblk))


def _decode_shape(name: str, q: torch.Tensor, k_pool: torch.Tensor,
                  scale: float | None):
    b, h, one, d = q.shape
    if one != 1:
        raise ValueError(f"{name} takes one query token, got {one}")
    _, hkv, psz, _ = k_pool.shape
    return b, h, hkv, psz, d, float(scale if scale is not None else d ** -0.5)


def _partials(q: torch.Tensor, hkv: int, ns: int):
    """fp32 (m, l, acc) of every split: (B, Hkv, ns, G) and (.., D)."""
    b, h, _, d = q.shape
    kw = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, ns, h // hkv), **kw)
    return m, torch.empty_like(m), torch.empty((b, hkv, ns, h // hkv, d), **kw)


def split_combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """K5c: merge fp32 split partials m, l (BR..., ns, rows) and acc
    (BR..., ns, rows, D) into (BR..., rows, D) of ``dtype``: max-shift
    rescale, then ``acc / l`` with an all-empty row giving exactly 0."""
    *lead, ns, rows, d = acc.shape
    out = torch.empty((*lead, rows, d), dtype=dtype, device=acc.device)
    with torch.cuda.device(acc.device):
        err = _lib().repro_split_combine(
            m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(),
            out.numel() // (rows * d), ns, rows, d, _DTYPES[dtype],
            _stream(acc))
    _raise_on("split_combine", err)
    split_combine.launches += 1
    return out


def paged_decode_split(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       kv_len: torch.Tensor, num_splits: int, *,
                       scale: float | None = None):
    """K5a: phase 1 of split decode over fp pools; returns the fp32
    partials (m, l, acc) of ``num_splits`` splits (checked by the caller)."""
    b, h, hkv, psz, d, scale = _decode_shape("paged_decode_split", q, k_pool,
                                             scale)
    m, l, acc = _partials(q, hkv, num_splits)
    with torch.cuda.device(q.device):
        err = _lib().repro_paged_decode_split(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), kv_len.data_ptr(), m.data_ptr(),
            l.data_ptr(), acc.data_ptr(), b, h, hkv, psz, page_table.shape[1],
            num_splits, d, _DTYPES[q.dtype], scale, _stream(q))
    _raise_on("paged_decode_split", err)
    paged_decode_split.launches += 1
    return m, l, acc


def paged_decode_split_quant(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, page_table: torch.Tensor,
                             kv_len: torch.Tensor, num_splits: int, *,
                             scale: float | None = None):
    """K6b: :func:`paged_decode_split` over int8 pools and their scales."""
    b, h, hkv, psz, d, scale = _decode_shape("paged_decode_split_quant", q,
                                             k_pool, scale)
    m, l, acc = _partials(q, hkv, num_splits)
    with torch.cuda.device(q.device):
        err = _lib().repro_paged_decode_split_quant(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
            kv_len.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(), b,
            h, hkv, psz, page_table.shape[1], num_splits, d, _DTYPES[q.dtype],
            scale, _stream(q))
    _raise_on("paged_decode_split_quant", err)
    paged_decode_split_quant.launches += 1
    return m, l, acc


def flash_paged_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       kv_len: torch.Tensor, *, scale: float | None = None,
                       num_splits: int | None = None) -> torch.Tensor:
    """Paged decode: q (B, H, 1, D), pools (P, Hkv, psz, D), page_table
    (B, nblk) and kv_len (B,) int32 on q's device (kv_len is clamped to
    [0, nblk * psz] on the card).  Output like q.  ``num_splits`` (clamped
    to nblk) above 1 runs K5a + K5c, else K3."""
    _check("flash_paged_decode", q, k_pool, v_pool, page_table, (kv_len,))
    b, h, hkv, psz, d, scale = _decode_shape("flash_paged_decode", q, k_pool,
                                             scale)
    ns = _num_splits(num_splits, page_table.shape[1])
    if ns > 1:
        m, l, acc = paged_decode_split(q, k_pool, v_pool, page_table, kv_len,
                                       ns, scale=scale)
        return split_combine(m, l, acc, q.dtype).reshape(b, h, 1, d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().repro_flash_paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(), b, h,
            hkv, psz, page_table.shape[1], d, _DTYPES[q.dtype], scale,
            _stream(q))
    _raise_on("flash_paged_decode", err)
    flash_paged_decode.launches += 1
    return out


def flash_paged_decode_quant(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, page_table: torch.Tensor,
                             kv_len: torch.Tensor, *,
                             scale: float | None = None,
                             num_splits: int | None = None) -> torch.Tensor:
    """:func:`flash_paged_decode` over int8 pools (P, Hkv, psz, D) with
    float32 per-row scales (P, Hkv, psz); q float32 or bfloat16, output
    like q.  K6a, or K6b + K5c for ``num_splits`` above 1."""
    _check("flash_paged_decode_quant", q, k_pool, v_pool, page_table,
           (kv_len,), (k_scale, v_scale))
    b, h, hkv, psz, d, scale = _decode_shape("flash_paged_decode_quant", q,
                                             k_pool, scale)
    ns = _num_splits(num_splits, page_table.shape[1])
    if ns > 1:
        m, l, acc = paged_decode_split_quant(q, k_pool, v_pool, k_scale,
                                             v_scale, page_table, kv_len, ns,
                                             scale=scale)
        return split_combine(m, l, acc, q.dtype).reshape(b, h, 1, d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().repro_flash_paged_decode_quant(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), b, h, hkv, psz,
            page_table.shape[1], d, _DTYPES[q.dtype], scale, _stream(q))
    _raise_on("flash_paged_decode_quant", err)
    flash_paged_decode_quant.launches += 1
    return out


def flash_paged_prefill(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        start: torch.Tensor, kv_len: torch.Tensor, *,
                        scale: float | None = None) -> torch.Tensor:
    """Paged chunked prefill: q (B, H, C, D), pools (P, Hkv, psz, D),
    page_table (B, nblk), start and kv_len (B,) int32 on q's device.
    Output like q; rows at positions ``>= kv_len`` are padding."""
    _check("flash_paged_prefill", q, k_pool, v_pool, page_table,
           (start, kv_len))
    b, h, c, d = q.shape
    _, hkv, psz, _ = k_pool.shape
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().repro_flash_paged_prefill(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), start.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), b, h, hkv, c, psz, page_table.shape[1], d,
            _DTYPES[q.dtype], scale, _stream(q))
    _raise_on("flash_paged_prefill", err)
    flash_paged_prefill.launches += 1
    return out


def flash_paged_prefill_quant(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, page_table: torch.Tensor,
                              start: torch.Tensor, kv_len: torch.Tensor, *,
                              scale: float | None = None) -> torch.Tensor:
    """K6c: :func:`flash_paged_prefill` over int8 pools with float32
    per-row scales (P, Hkv, psz); q float32 or bfloat16, output like q."""
    _check("flash_paged_prefill_quant", q, k_pool, v_pool, page_table,
           (start, kv_len), (k_scale, v_scale))
    b, h, c, d = q.shape
    _, hkv, psz, _ = k_pool.shape
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().repro_flash_paged_prefill_quant(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
            start.data_ptr(), kv_len.data_ptr(), out.data_ptr(), b, h, hkv,
            c, psz, page_table.shape[1], d, _DTYPES[q.dtype], scale,
            _stream(q))
    _raise_on("flash_paged_prefill_quant", err)
    flash_paged_prefill_quant.launches += 1
    return out


#: the kernels of this module, one launch counter each, for counters and
#: reports: K3, K5a, K5c, K6a, K6b, K4, K6c
KERNELS = (flash_paged_decode, paged_decode_split, split_combine,
           flash_paged_decode_quant, paged_decode_split_quant,
           flash_paged_prefill, flash_paged_prefill_quant)
for _kernel in KERNELS:
    _kernel.launches = 0

"""Python wrappers of the paged CUDA attention kernels (``csrc/paged_attention.cu``).

* :func:`flash_paged_decode` (K3) — one query token per sequence against
  K/V page pools (P, Hkv, psz, D), each sequence reaching its pages
  through a row of ``page_table`` (B, nblk) int32, masked to ``kv_len[b]``
  keys; a row with ``kv_len == 0`` gives exactly 0.
* :func:`flash_paged_prefill` (K4) — a chunk of C query tokens per
  sequence at absolute positions ``start[b] + i``, causal over the
  committed paged prefix plus the chunk's own triangle; key ``j`` is
  valid iff ``j < kv_len[b]``.  The chunk's K/V must already be in the
  pages (write before read).

Table entries past ``ceil(kv_len / psz)`` are never read and may point
anywhere (page 0 by convention); entries below it must name pages of the
pools.  The wrappers follow the contract of :mod:`.flash_attention`:
CUDA tensors only, checked; output from ``torch.empty``; launch on the
current stream without syncing; raise on a launch error; ``.launches``
counts the launches.  The plain versions live in :mod:`.ref`.
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
    lib.repro_flash_paged_decode.argtypes = [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]
    lib.repro_flash_paged_decode.restype = _I
    lib.repro_flash_paged_prefill.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
    lib.repro_flash_paged_prefill.restype = _I
    return lib


def _check(name: str, q: torch.Tensor, k_pool: torch.Tensor,
           v_pool: torch.Tensor, page_table: torch.Tensor,
           lens: tuple[torch.Tensor, ...]) -> None:
    for t in (q, k_pool, v_pool):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, "
                             f"got one on {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected 4-d q and pools, got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} not supported "
                             "(float32 or bfloat16)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: q and pools must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
        if t.numel() == 0:
            raise ValueError(f"{name}: empty tensor {tuple(t.shape)}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise ValueError(f"{name}: q and pool dtypes differ")
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


def flash_paged_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       kv_len: torch.Tensor, *,
                       scale: float | None = None) -> torch.Tensor:
    """Paged decode: q (B, H, 1, D), pools (P, Hkv, psz, D), page_table
    (B, nblk) and kv_len (B,) int32 on q's device (kv_len is clamped to
    [0, nblk * psz] on the card).  Output like q."""
    _check("flash_paged_decode", q, k_pool, v_pool, page_table, (kv_len,))
    b, h, one, d = q.shape
    if one != 1:
        raise ValueError(f"flash_paged_decode takes one query token, got {one}")
    _, hkv, psz, _ = k_pool.shape
    scale = float(scale if scale is not None else d ** -0.5)
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


flash_paged_decode.launches = 0
flash_paged_prefill.launches = 0

#: the kernels of this module, for counters and reports
KERNELS = (flash_paged_decode, flash_paged_prefill)

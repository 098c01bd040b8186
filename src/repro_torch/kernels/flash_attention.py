"""Python wrappers of the CUDA attention kernels (``csrc/flash_attention.cu``).

* :func:`flash_attention` (K1) — self-attention over (B, H, S, D) with
  causal and/or sliding-window masks and GQA (kv head ``h // G``).
* :func:`flash_decode` (K2) — one query token per sequence against a
  dense (B, Hkv, S, D) cache, masked to ``kv_len[b]`` keys; a row with
  ``kv_len == 0`` gives exactly 0.

Each wrapper takes CUDA tensors only, checks them, allocates its output
with ``torch.empty``, launches on the current stream without syncing,
raises on a launch error, and counts its launches in ``.launches`` (a
plain integer on the function).  The plain PyTorch versions live in
:mod:`.ref`; :mod:`.ops` picks between the two by the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = build.load("flash_attention")
    lib.repro_flash_attention.argtypes = [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]
    lib.repro_flash_attention.restype = _I
    lib.repro_flash_decode.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]
    lib.repro_flash_decode.restype = _I
    return lib


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, "
                             f"got one on {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected 4-d tensors, got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} not supported "
                             "(float32 or bfloat16)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
        if t.numel() == 0:
            raise ValueError(f"{name}: empty tensor {tuple(t.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: q, k, v dtypes differ")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v are on different devices")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if h % k.shape[1]:
        raise ValueError(f"{name}: {h} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Self-attention.  q: (B, H, S, D); k, v: (B, Hkv, S, D), H % Hkv == 0.
    Output in q's dtype."""
    _check("flash_attention", q, k, v)
    b, h, s, d = q.shape
    if k.shape[2] != s:
        raise ValueError("flash_attention is self-attention (use flash_decode)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, k.shape[1], s, d, _DTYPES[q.dtype], int(causal),
            -1 if window is None else int(window), scale, _stream(q))
    _raise_on("flash_attention", err)
    flash_attention.launches += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor | None = None, *,
                 scale: float | None = None) -> torch.Tensor:
    """Decode attention: q (B, H, 1, D) against caches (B, Hkv, S, D);
    ``kv_len`` (B,) int32 on the same device masks each cache's valid
    prefix (values are clamped to [0, S] on the card)."""
    _check("flash_decode", q, k, v)
    b, h, one, d = q.shape
    if one != 1:
        raise ValueError(f"flash_decode takes one query token, got {one}")
    s = k.shape[2]
    if kv_len is None:
        kv_len = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if (kv_len.dtype != torch.int32 or kv_len.shape != (b,)
            or kv_len.device != q.device or not kv_len.is_contiguous()):
        raise ValueError("kv_len must be a contiguous (B,) int32 tensor on "
                         "q's device")
    scale = float(scale if scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().repro_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), b, h, k.shape[1], s, d, _DTYPES[q.dtype], scale,
            _stream(q))
    _raise_on("flash_decode", err)
    flash_decode.launches += 1
    return out


flash_attention.launches = 0
flash_decode.launches = 0

#: the kernels of this module, for counters and reports
KERNELS = (flash_attention, flash_decode)

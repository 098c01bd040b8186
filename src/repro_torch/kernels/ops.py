"""Attention entry points of the model: kernel on CUDA, plain on CPU.

The model calls these, never the kernels directly.  A CUDA tensor goes
to the hand-written kernel, a CPU tensor to its plain PyTorch version;
``use_kernel=False`` asks for the plain version on either device (the
kernel-against-plain comparisons on the card use it), and
``use_kernel=True`` on CPU tensors raises instead of running anything
else.  The kernels read a contiguous layout, so the transposed q, k, v
the projections produce are made contiguous here, and the paged kernels'
int32 page tables and lengths are cast here.
"""
from __future__ import annotations

import dataclasses

import torch

from . import ref
from .flash_attention import flash_attention, flash_decode
from .paged_attention import (flash_paged_decode, flash_paged_decode_quant,
                              flash_paged_prefill, flash_paged_prefill_quant)


def _use_kernel(x: torch.Tensor, use_kernel: bool | None) -> bool:
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the CUDA "
                         f"kernels do not run on {x.device}")
    return use_kernel


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              use_kernel: bool | None = None) -> torch.Tensor:
    """Full (prefill) self-attention.  q (B, H, S, D), k/v (B, Hkv, S, D)."""
    if _use_kernel(q, use_kernel):
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window)
    return ref.attention_ref(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor | None = None, *,
                     use_kernel: bool | None = None) -> torch.Tensor:
    """One-token decode.  q (B, H, 1, D), caches (B, Hkv, S, D), kv_len (B,)."""
    if _use_kernel(q, use_kernel):
        if kv_len is not None:
            kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
        return flash_decode(q.contiguous(), k.contiguous(), v.contiguous(),
                            kv_len)
    return ref.decode_ref(q, k, v, kv_len)


@dataclasses.dataclass(frozen=True)
class PagedPools:
    """One layer's paged KV state: the ``k``/``v`` page pools, each
    (P, Hkv, page_size, D), and for int8 pools their float32 per-row
    scales ``k_scale``/``v_scale`` (P, Hkv, page_size)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def _check_pools(pools: PagedPools) -> None:
    if (pools.k_scale is None) != (pools.v_scale is None):
        raise ValueError(
            "PagedPools carries k_scale without v_scale (or vice versa): "
            "int8 pools quantize both sides, fp pools neither")


def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "tensor-parallel paged attention (mesh) is not ported yet: "
            "ROADMAP queue 1, item 10")


def _int32(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


def paged_decode(q: torch.Tensor, pools: PagedPools, page_table: torch.Tensor,
                 kv_len: torch.Tensor, *, mesh=None,
                 num_splits: int | None = None,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """Decode attention over a paged KV cache.  q (B, H, 1, D),
    ``page_table`` (B, nblk), ``kv_len`` (B,).  On the card: K3 over fp
    pools, K6a over int8 ones, or with ``num_splits`` above 1 their split
    forms (K5a / K6b) and the combine K5c.  The plain version ignores
    ``num_splits``, as the JAX package's does on the CPU."""
    _check_mesh(mesh)
    _check_pools(pools)
    if _use_kernel(q, use_kernel):
        q, table = q.contiguous(), _int32(page_table, q.device)
        kv_len = _int32(kv_len, q.device)
        if pools.quantized:
            return flash_paged_decode_quant(
                q, pools.k, pools.v, pools.k_scale, pools.v_scale, table,
                kv_len, num_splits=num_splits)
        return flash_paged_decode(q, pools.k, pools.v, table, kv_len,
                                  num_splits=num_splits)
    return ref.paged_decode_ref(q, pools.k, pools.v, page_table, kv_len,
                                k_scale=pools.k_scale, v_scale=pools.v_scale)


def paged_prefill(q: torch.Tensor, pools: PagedPools,
                  page_table: torch.Tensor, start: torch.Tensor,
                  kv_len: torch.Tensor, *, mesh=None,
                  num_splits: int | None = None,
                  use_kernel: bool | None = None) -> torch.Tensor:
    """Chunked-prefill attention over a paged KV cache (K4 on the card,
    K6c over int8 pools).  q (B, H, C, D) with its first token at absolute
    position ``start``; the chunk's K/V must already be in the pages
    (write before read)."""
    _check_mesh(mesh)
    if num_splits not in (None, 1):
        raise NotImplementedError(
            f"split-KV prefill (num_splits={num_splits}) is not ported yet: "
            "it comes with speculative verify, ROADMAP queue 1, item 5")
    _check_pools(pools)
    if _use_kernel(q, use_kernel):
        args = (_int32(page_table, q.device), _int32(start, q.device),
                _int32(kv_len, q.device))
        if pools.quantized:
            return flash_paged_prefill_quant(q.contiguous(), pools.k, pools.v,
                                             pools.k_scale, pools.v_scale,
                                             *args)
        return flash_paged_prefill(q.contiguous(), pools.k, pools.v, *args)
    return ref.paged_prefill_ref(q, pools.k, pools.v, page_table, start,
                                 kv_len, k_scale=pools.k_scale,
                                 v_scale=pools.v_scale)

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
from .paged_attention import flash_paged_decode, flash_paged_prefill


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
    (P, Hkv, page_size, D).

    The JAX bundle also carries int8 pools' per-row scales; those are not
    ported, and a bundle given scales raises."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    def __post_init__(self):
        if self.k_scale is not None or self.v_scale is not None:
            raise NotImplementedError(
                "int8 page pools (k_scale / v_scale) are not ported yet: "
                "ROADMAP queue 1, item 4")


def _check_paged_options(mesh, num_splits: int | None) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "tensor-parallel paged attention (mesh) is not ported yet: "
            "ROADMAP queue 1, item 10")
    if num_splits not in (None, 1):
        raise NotImplementedError(
            f"split-KV (num_splits={num_splits}) is not ported yet: "
            "ROADMAP queue 1, item 4")


def _int32(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


def paged_decode(q: torch.Tensor, pools: PagedPools, page_table: torch.Tensor,
                 kv_len: torch.Tensor, *, mesh=None,
                 num_splits: int | None = None,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """Decode attention over a paged KV cache (K3 on the card).  q
    (B, H, 1, D), ``page_table`` (B, nblk), ``kv_len`` (B,)."""
    _check_paged_options(mesh, num_splits)
    if _use_kernel(q, use_kernel):
        return flash_paged_decode(q.contiguous(), pools.k, pools.v,
                                  _int32(page_table, q.device),
                                  _int32(kv_len, q.device))
    return ref.paged_decode_ref(q, pools.k, pools.v, page_table, kv_len)


def paged_prefill(q: torch.Tensor, pools: PagedPools,
                  page_table: torch.Tensor, start: torch.Tensor,
                  kv_len: torch.Tensor, *, mesh=None,
                  num_splits: int | None = None,
                  use_kernel: bool | None = None) -> torch.Tensor:
    """Chunked-prefill attention over a paged KV cache (K4 on the card).
    q (B, H, C, D) with its first token at absolute position ``start``;
    the chunk's K/V must already be in the pages (write before read)."""
    _check_paged_options(mesh, num_splits)
    if _use_kernel(q, use_kernel):
        return flash_paged_prefill(q.contiguous(), pools.k, pools.v,
                                   _int32(page_table, q.device),
                                   _int32(start, q.device),
                                   _int32(kv_len, q.device))
    return ref.paged_prefill_ref(q, pools.k, pools.v, page_table, start,
                                 kv_len)

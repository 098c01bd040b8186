"""Attention entry points of the model: kernel on CUDA, plain on CPU.

The model calls these, never the kernels directly.  A CUDA tensor goes
to the hand-written kernel, a CPU tensor to its plain PyTorch version;
``use_kernel=False`` asks for the plain version on either device (the
kernel-against-plain comparisons on the card use it), and
``use_kernel=True`` on CPU tensors raises instead of running anything
else.  The kernels read a contiguous layout, so the transposed q, k, v
the projections produce are made contiguous here.
"""
from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention, flash_decode


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

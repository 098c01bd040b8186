"""int8 quantization, per tensor and per row (the JAX package's
``distributed/compression.py``).

* :func:`quantize_int8` / :func:`dequantize_int8` — one fp32 scale for the
  whole tensor (the host-swap compression of fp KV pools);
* :func:`quantize_int8_rows` / :func:`dequantize_int8_rows` — one fp32
  scale per last-axis row (the paged pool's int8 pages: each (page, head,
  slot) row quantizes on its own, so a decode append never requantizes a
  page).

The codes equal the JAX package's: ``amax / 127`` scales (at least
``1e-12 / 127``, so a zero row gives codes 0), a true division by the
scale (not a multiply by its reciprocal), rounding half to even
(``torch.round``, like ``jnp.round``) and a clip to +-127.  The error of a
round trip is at most half a step, ``amax / 254``.

* :func:`compressed_psum` — the int8 all-reduce over a process group:
  each member's tensor quantized with one scale, the codes and scales
  all-gathered, the sum taken dequantized in float32 (the JAX package's
  over a mesh axis; for a pod axis of 2-4 members, a quarter of bf16's
  wire bytes).
"""
from __future__ import annotations

import torch

from .collectives import all_gather


def _codes(y: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor,
                  generator: torch.Generator | None = None):
    """(codes int8, scale float32 0-d): one scale for the whole tensor.
    With ``generator``, stochastic rounding: uniform noise in [-0.5, 0.5)
    added before the rounding (the JAX package draws it from a key)."""
    amax = x.abs().max().float()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    y = x.float() / scale
    if generator is not None:
        y = y + (torch.rand(x.shape, generator=generator,
                            device=generator.device) - 0.5).to(y.device)
    return _codes(y), scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def quantize_int8_rows(x: torch.Tensor):
    """(codes int8, scales float32) with ``scales.shape == x.shape[:-1]``."""
    amax = x.abs().amax(dim=-1).float()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return _codes(x.float() / scale[..., None]), scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def compressed_psum(x: torch.Tensor, group,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """int8 all-gather + local sum over ``group`` (float32 result).

    An int8 all-reduce cannot sum in int8 (overflow); instead each member
    contributes its codes and scale through an all-gather and the sum is
    taken dequantized: ``sum_r scale_r * codes_r``.  Its error against
    the exact sum is at most half a step of each member's scale."""
    q, scale = quantize_int8(x, generator)
    qs = all_gather(q[None], group, dim=0)              # (members, ...)
    ss = all_gather(scale.reshape(1), group, dim=0)
    return torch.tensordot(ss.float(), qs.float(), dims=([0], [0]))


def compress_roundtrip_error(x: torch.Tensor) -> torch.Tensor:
    """Quantization round-trip error (tests / telemetry)."""
    q, s = quantize_int8(x)
    return (dequantize_int8(q, s) - x.float()).abs().max()


def compress_roundtrip_error_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row quantization round-trip error (tests / telemetry)."""
    q, s = quantize_int8_rows(x)
    return (dequantize_int8_rows(q, s) - x.float()).abs().max()

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

``compressed_psum`` (the int8 all-reduce) waits for the port's collectives
(ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import torch


def _codes(y: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor):
    """(codes int8, scale float32 0-d): one scale for the whole tensor.
    (The JAX package's stochastic rounding serves only ``compressed_psum``
    and comes with it.)"""
    amax = x.abs().max().float()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return _codes(x.float() / scale), scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def quantize_int8_rows(x: torch.Tensor):
    """(codes int8, scales float32) with ``scales.shape == x.shape[:-1]``."""
    amax = x.abs().amax(dim=-1).float()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return _codes(x.float() / scale[..., None]), scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]

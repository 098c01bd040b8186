"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``.  Asking
for CUDA on a machine without a card raises: the port never falls back
to the CPU on its own.  The CPU runs only when the caller names it, as
the tests do.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card.

    Resolving a CUDA device also turns TF32 off for matmuls and cuDNN, so
    a float32 product on the card is a real float32 product (the parity
    the reduced configs are checked at)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev

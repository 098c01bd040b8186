"""Architecture registry: ``--arch <id>`` -> ArchConfig.

Only the archs the port serves are registered.  The other archs of the
JAX package are known by name, so asking for one says which ROADMAP item
ports it instead of claiming the name does not exist.
"""
from __future__ import annotations

from .base import ArchConfig
from .deepseek_7b import CONFIG as deepseek_7b
from .yi_6b import CONFIG as yi_6b

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [yi_6b, deepseek_7b]}

_OTHER_FAMILIES = "ROADMAP queue 1, item 8 (the other model families)"

#: archs of the JAX package that the port does not run yet -> the
#: ROADMAP item that ports them
NOT_PORTED: dict[str, str] = {
    "phi4-mini-3.8b": _OTHER_FAMILIES,
    "h2o-danube-1.8b": _OTHER_FAMILIES + ": SWA ring-buffer decode",
    "pixtral-12b": _OTHER_FAMILIES + ": the vision frontend",
    "moonshot-v1-16b-a3b": _OTHER_FAMILIES + ": MoE",
    "llama4-scout-17b-a16e": _OTHER_FAMILIES + ": MoE",
    "falcon-mamba-7b": _OTHER_FAMILIES + ": Mamba-1 and kernel K9",
    "zamba2-7b": _OTHER_FAMILIES + ": Mamba-2 and the shared block",
    "whisper-tiny": _OTHER_FAMILIES + ": encoder-decoder",
}


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet; see "
            f"{NOT_PORTED[name]}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")

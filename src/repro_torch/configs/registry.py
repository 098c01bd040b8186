"""Architecture registry: ``--arch <id>`` -> ArchConfig, and the cells
(arch x shape) of static AT.

Every arch of the JAX package is registered.  ``NOT_PORTED`` is kept for
an arch the JAX package gains before the port runs it: such an arch is
known by name, so asking for it says which ROADMAP item ports it instead
of claiming the name does not exist.
"""
from __future__ import annotations

from .base import SHAPES, ArchConfig, ShapeConfig
from .deepseek_7b import CONFIG as deepseek_7b
from .falcon_mamba_7b import CONFIG as falcon_mamba_7b
from .h2o_danube_1p8b import CONFIG as h2o_danube_1p8b
from .llama4_scout_17b_a16e import CONFIG as llama4_scout_17b_a16e
from .moonshot_v1_16b_a3b import CONFIG as moonshot_v1_16b_a3b
from .phi4_mini_3p8b import CONFIG as phi4_mini_3p8b
from .pixtral_12b import CONFIG as pixtral_12b
from .whisper_tiny import CONFIG as whisper_tiny
from .yi_6b import CONFIG as yi_6b
from .zamba2_7b import CONFIG as zamba2_7b

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    yi_6b, deepseek_7b, falcon_mamba_7b, phi4_mini_3p8b,
    moonshot_v1_16b_a3b, llama4_scout_17b_a16e, h2o_danube_1p8b,
    whisper_tiny, zamba2_7b, pixtral_12b]}

#: archs of the JAX package that the port does not run yet -> the
#: ROADMAP item that ports them (none since pixtral-12b, item 8b.6)
NOT_PORTED: dict[str, str] = {}


def get_arch(name: str) -> ArchConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet; see "
            f"{NOT_PORTED[name]}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def cell_applicable(arch: ArchConfig, shape: ShapeConfig
                    ) -> tuple[bool, str]:
    """Is (arch, shape) a runnable cell?  Returns (ok, reason-if-skipped).

    long_500k needs sub-quadratic attention, so a pure full-attention arch
    (whisper-tiny's encoder-decoder among them) skips it.
    """
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("long_500k skipped: pure full-attention arch "
                       "(O(L^2) attention / O(L) KV at 524288 tokens)")
    return True, ""


def all_cells(include_skipped: bool = False):
    """The 40 (arch x shape) cells as (arch, shape, ok, reason), the
    skipped ones only with ``include_skipped``."""
    out = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            ok, reason = cell_applicable(a, s)
            if ok or include_skipped:
                out.append((a, s, ok, reason))
    return out

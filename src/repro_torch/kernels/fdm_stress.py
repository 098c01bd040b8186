"""Python wrapper of the CUDA Sample 8 stress kernel K7 (``csrc/fdm_stress.cu``).

:func:`fdm_stress` is one stress update of the paper's Sample 8
(ppOpen-APPL/FDM) over an (nx, ny, nz) float32 grid, with the JAX
package's keyword arguments: ``variant`` ``"fused"`` (one launch) or
``"split"`` (two launches, the normal part and then the shear part, each
recomputing the QG plane: SplitPointCopyDef), and the tile
``(bx, by, bz)`` one block covers, clamped to the grid.  It reads the raw
fields (``rig`` at its clamped i+1/j+1/k+1 neighbours, QG from ``q`` and
the three abs vectors) and returns the six new stresses.

The wrapper takes contiguous float32 CUDA tensors only (other dtypes
raise), allocates its outputs with ``torch.empty``, launches on the
current stream without syncing, raises on a launch error and counts its
kernel launches in ``fdm_stress.launches`` (two for ``split``).  The
plain PyTorch version is :func:`.ref.fdm_stress_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

#: the grid arrays (lam, rig, q, the nine velocity derivatives), the
#: abs vectors, and the state, in the kernel's argument order
ARRAYS = ("lam", "rig", "q", "absx", "absy", "absz", "dxvx", "dyvy", "dzvz",
          "dxvy", "dyvx", "dxvz", "dzvx", "dyvz", "dzvy")
STATE = ("sxx", "syy", "szz", "sxy", "sxz", "syz")
VARIANTS = ("fused", "split")
_FUSED, _NORMAL, _SHEAR = 0, 1, 2
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signature declared (once)."""
    lib = build.load("fdm_stress")
    lib.repro_fdm_stress.argtypes = [_P, _I, _I, _I, _I, _I, _I, _I, _F, _P]
    lib.repro_fdm_stress.restype = _I
    return lib


def _check(arrays: dict, state: dict) -> tuple[int, int, int]:
    missing = [n for n in ARRAYS if n not in arrays] + [
        n for n in STATE if n not in state]
    if missing:
        raise ValueError(f"fdm_stress: missing inputs {missing}")
    rig = arrays["rig"]
    if rig.dim() != 3:
        raise ValueError(f"fdm_stress: expected a 3-d grid, got "
                         f"{tuple(rig.shape)}")
    shape = tuple(rig.shape)
    for name in ARRAYS + STATE:
        t = arrays[name] if name in arrays else state[name]
        if t.device.type != "cuda" or t.device != rig.device:
            raise ValueError(f"fdm_stress: {name} must be a CUDA tensor on "
                             f"{rig.device}, got one on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"fdm_stress: {name} is {t.dtype}; the kernel "
                             "takes float32 only")
        if not t.is_contiguous():
            raise ValueError(f"fdm_stress: {name} must be contiguous")
        want = ((shape[ARRAYS.index(name) - 3],)
                if name in ("absx", "absy", "absz") else shape)
        if tuple(t.shape) != want:
            raise ValueError(f"fdm_stress: {name} has shape "
                             f"{tuple(t.shape)}, expected {want}")
    if 0 in shape:
        raise ValueError(f"fdm_stress: empty grid {shape}")
    return shape


def fdm_stress(arrays: dict[str, torch.Tensor],
               state: dict[str, torch.Tensor], dt: float, *,
               variant: str = "fused", bx: int = 8, by: int = 8,
               bz: int = 128) -> dict[str, torch.Tensor]:
    """One stress update step.

    ``arrays``: lam, rig, q, dxvx..dzvy (nx, ny, nz) and absx (nx,),
    absy (ny,), absz (nz,); ``state``: sxx..syz (nx, ny, nz).
    ``variant``: ``"fused"`` | ``"split"``.  Returns the new sxx..syz.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if min(bx, by, bz) < 1:
        raise ValueError(f"fdm_stress: tiles must be >= 1, got "
                         f"{(bx, by, bz)}")
    nx, ny, nz = _check(arrays, state)
    tiles = (min(bx, nx), min(by, ny), min(bz, nz))
    out = {n: torch.empty_like(state[n]) for n in STATE}
    ptrs = [arrays[n].data_ptr() for n in ARRAYS]
    ptrs += [state[n].data_ptr() for n in STATE]
    ptrs += [out[n].data_ptr() for n in STATE]
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    parts = (_FUSED,) if variant == "fused" else (_NORMAL, _SHEAR)
    device = arrays["rig"].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for part in parts:
            err = _lib().repro_fdm_stress(table, part, nx, ny, nz, *tiles,
                                          float(dt), stream)
            if err:
                raise RuntimeError(f"fdm_stress: kernel launch failed with "
                                   f"CUDA error {err}")
            fdm_stress.launches += 1
    return out


fdm_stress.launches = 0

#: the kernels of this module, for counters and reports
KERNELS = (fdm_stress,)

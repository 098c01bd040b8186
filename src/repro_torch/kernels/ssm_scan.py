"""Python wrapper of the CUDA selective scan K9 (``csrc/ssm_scan.cu``).

:func:`selective_scan` runs the Mamba-1 recurrence of falcon-mamba-7b
over x, dt (B, L, Di), A (Di, N) float32, B, C (B, L, N) and D (Di,),
with the JAX package's keyword ``chunk``: the time steps of one tile, the
install-time PP of the ``SsmChunk`` region.  A chunk longer than L is cut
to L, as the JAX wrapper does.  With ``return_final_state`` it also
returns the state after the last step, (B, Di, N) float32, which prefill
hands to decode.

The kernel is a time-parallel chunked scan: a block of 16 warps takes 16
channels of one batch entry, one warp each; lane j of a warp owns
:func:`items_per_lane` consecutive steps of the tile, composes their
affine maps per state, and a warp scan joins the lanes.  The tile's rows
are staged in shared memory in the input type and transposed into
lane-major float rows (:func:`row_floats`); :func:`smem_bytes` is the
block's whole footprint, the formula of the C library's
``repro_ssm_scan_smem_bytes``.  The grid holds as many blocks as the
card runs at once, each walking the (batch entry, 16 channels) work
items in turn.

The wrapper takes contiguous CUDA tensors only: x, dt, B, C and D all
float32 or all bfloat16, A float32, N a power of two up to 32.  It
allocates its outputs with ``torch.empty``, launches on the current
stream without syncing, raises on a launch error (a chunk whose shared
memory the card cannot give is one), counts its launches in
``selective_scan.launches`` and records the chunk of its last launch in
``selective_scan.last_chunk``.  The plain PyTorch version is
:func:`.ref.selective_scan_ref`; :func:`.ops.ssm_scan` picks between the
two by the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

CHANNELS = 16           # channels per block, one warp each
ITEMS_MAX = 16          # steps a lane owns at most: a warp pass of 512
STATES = (1, 2, 4, 8, 16, 32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def items_per_lane(chunk: int) -> int:
    """The steps a lane owns for a tile of ``chunk`` steps:
    ``ceil(chunk / 32)`` rounded up to a power of two, at most
    :data:`ITEMS_MAX` (a longer tile is scanned in passes of 512 steps)."""
    need = -(-min(chunk, 32 * ITEMS_MAX) // 32)
    return next(i for i in (1, 2, 4, 8, ITEMS_MAX) if i >= need)


def lane_stride(items: int) -> int:
    """Floats from one lane's steps to the next lane's in a lane-major row:
    4 mod 8 for ``items`` >= 4, so that 16-byte reads by 8 lanes at a time
    fall in distinct banks."""
    if items < 4:
        return items
    return items if (items // 4) % 2 else items + 4


def row_floats(chunk: int) -> int:
    """Floats of one lane-major row (a channel's x or dt, a state's B or C
    over one warp pass): the lanes that own steps, padded to 4 mod 32."""
    items = items_per_lane(chunk)
    w = min(chunk, 32 * ITEMS_MAX)
    f = -(-w // items) * lane_stride(items)
    return f + (36 - f % 32) % 32


def smem_bytes(d_state: int, chunk: int, elem_bytes: int = 2) -> int:
    """Shared memory one block of K9 takes for inputs of ``elem_bytes``
    (2: bfloat16, the served type; 4: float32): the lane-major float rows
    of its 16 channels' x and dt and of the ``d_state`` states' B and C,
    then the raw tile of ``chunk`` steps in the input type, each of its
    four regions rounded up to 16 bytes (the formula of
    ``csrc/ssm_scan.cu``)."""
    def round16(n: int) -> int:
        return -(-n // 16) * 16
    return (4 * (2 * CHANNELS + 2 * d_state) * row_floats(chunk)
            + 2 * round16(chunk * CHANNELS * elem_bytes)
            + 2 * round16(chunk * d_state * elem_bytes))


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = build.load("ssm_scan")
    lib.repro_ssm_scan.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    lib.repro_ssm_scan.restype = _I
    lib.repro_ssm_scan_smem_bytes.argtypes = [_I, _I, _I]
    lib.repro_ssm_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def kernel_smem_bytes(d_state: int, chunk: int, elem_bytes: int = 2) -> int:
    """Shared memory of one block as the built library computes it."""
    return int(_lib().repro_ssm_scan_smem_bytes(d_state, chunk, elem_bytes))


def _check(x, dt, a, b, c, d) -> tuple[int, int, int, int]:
    names = ("x", "dt", "a", "b", "c", "d")
    for name, t in zip(names, (x, dt, a, b, c, d)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"selective_scan: {name} must be a CUDA tensor "
                             f"on {x.device}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"selective_scan: {name} must be contiguous")
    if x.dtype not in _DTYPES:
        raise ValueError(f"selective_scan: x is {x.dtype}; the kernel takes "
                         "float32 or bfloat16")
    for name, t in zip(("dt", "b", "c", "d"), (dt, b, c, d)):
        if t.dtype != x.dtype:
            raise ValueError(f"selective_scan: {name} is {t.dtype}, x is "
                             f"{x.dtype}; they must share one type")
    if a.dtype != torch.float32:
        raise ValueError(f"selective_scan: a is {a.dtype}; it must be "
                         "float32")
    if x.dim() != 3:
        raise ValueError(f"selective_scan: x must be (B, L, Di), got "
                         f"{tuple(x.shape)}")
    bsz, length, di = x.shape
    if a.dim() != 2 or a.shape[0] != di:
        raise ValueError(f"selective_scan: a must be ({di}, N), got "
                         f"{tuple(a.shape)}")
    n = a.shape[1]
    if n not in STATES:
        raise ValueError(f"selective_scan: d_state {n} is not one of "
                         f"{STATES}")
    want = {"dt": (bsz, length, di), "b": (bsz, length, n),
            "c": (bsz, length, n), "d": (di,)}
    for name, t in zip(("dt", "b", "c", "d"), (dt, b, c, d)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"selective_scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    if 0 in (bsz, length, di):
        raise ValueError(f"selective_scan: empty input {tuple(x.shape)}")
    if bsz > 65535 or max(length, di) >= 2 ** 31:
        raise ValueError(f"selective_scan: shape {tuple(x.shape)} is out of "
                         "the kernel's range")
    return bsz, length, di, n


def selective_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
                   chunk: int = 64, return_final_state: bool = False):
    """y (B, L, Di) in x's dtype [, final state (B, Di, N) float32].

    ``dt`` must already be positive (softplus applied by the caller)."""
    bsz, length, di, n = _check(x, dt, a, b, c, d)
    if chunk < 1:
        raise ValueError(f"selective_scan: chunk must be >= 1, got {chunk}")
    chunk = min(int(chunk), length)
    y = torch.empty_like(x)
    h = (torch.empty((bsz, di, n), dtype=torch.float32, device=x.device)
         if return_final_state else None)
    with torch.cuda.device(x.device):
        err = _lib().repro_ssm_scan(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d.data_ptr(), y.data_ptr(),
            None if h is None else h.data_ptr(), bsz, length, di, n, chunk,
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"selective_scan: kernel launch failed with CUDA "
                           f"error {err} (chunk {chunk}, d_state {n}: "
                           f"{smem_bytes(n, chunk, x.element_size())} "
                           "bytes of shared memory)")
    selective_scan.launches += 1
    selective_scan.last_chunk = chunk
    return (y, h) if return_final_state else y


selective_scan.launches = 0
selective_scan.last_chunk = None

#: the kernels of this module, for counters and reports
KERNELS = (selective_scan,)

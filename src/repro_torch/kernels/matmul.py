"""Python wrapper of the CUDA GEMM K8 (``csrc/matmul.cu``).

:func:`matmul` computes ``epilogue(x @ y + bias)`` with float32 sums:
x (M, K) and y (K, N) both float32 or both bfloat16, an optional bias
(N,) added in float32 before the epilogue (``none``, ``gelu`` in its tanh
form, ``silu``, ``relu``), the result cast to ``out_dtype`` (default x's
dtype).  The tile ``(block_m, block_n, block_k)`` is the install-time PP
of the ``MatmulBlocks`` region; each of the three is one of
:data:`TILE_VALUES`, and a tile that is not instantiated raises.  The
kernel masks ragged edges itself, so tiles are not clamped to the shape.

The wrapper takes CUDA tensors only, checks them, allocates its output
with ``torch.empty``, launches on the current stream without syncing,
raises on a launch error, counts its launches in ``matmul.launches`` and
records the tile of its last launch in ``matmul.last_tiles``.  The plain
PyTorch version is :func:`.ref.matmul_ref`; :func:`.ops.mm` picks between
the two by the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from . import build

#: the values each of block_m, block_n, block_k takes (one kernel instance
#: per tile per dtype)
TILE_VALUES = (32, 64, 128)
TILES = frozenset(itertools.product(TILE_VALUES, repeat=3))
EPILOGUES = {"none": 0, "gelu": 1, "silu": 2, "relu": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def smem_bytes(block_m: int, block_n: int, block_k: int,
               elem_bytes: int = 2) -> int:
    """Shared memory one block of K8 takes: the (bm, bk) tile of x and the
    (bk, bn) tile of y, each row padded by 16 bytes (the formula of
    ``csrc/matmul.cu``)."""
    pad = 16 // elem_bytes
    return elem_bytes * (block_m * (block_k + pad)
                         + block_k * (block_n + pad))


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = build.load("matmul")
    lib.repro_matmul.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _P]
    lib.repro_matmul.restype = _I
    lib.repro_matmul_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.repro_matmul_smem_bytes.restype = ctypes.c_longlong
    lib.repro_smem_per_block_optin.argtypes = []
    lib.repro_smem_per_block_optin.restype = _I
    return lib


def kernel_smem_bytes(dtype: torch.dtype, block_m: int, block_n: int,
                      block_k: int) -> int:
    """Shared memory of one block as the built library computes it."""
    return int(_lib().repro_matmul_smem_bytes(_DTYPES[dtype], block_m,
                                              block_n, block_k))


def smem_per_block_limit(device: torch.device | str = "cuda") -> int:
    """The most shared memory one block may opt into on ``device``
    (232,448 bytes on an H100)."""
    with torch.cuda.device(device):
        limit = _lib().repro_smem_per_block_optin()
    if limit <= 0:
        raise RuntimeError("cudaDeviceGetAttribute("
                           "cudaDevAttrMaxSharedMemoryPerBlockOptin) failed")
    return limit


def _check(x: torch.Tensor, y: torch.Tensor, bias: torch.Tensor | None):
    for t in (x, y) + ((bias,) if bias is not None else ()):
        if t.device.type != "cuda":
            raise ValueError("matmul: the CUDA kernel takes CUDA tensors, "
                             f"got one on {t.device}")
        if t.device != x.device:
            raise ValueError("matmul: operands are on different devices")
    if x.dim() != 2 or y.dim() != 2:
        raise ValueError(f"matmul: expected 2-d x and y, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise ValueError(f"matmul: x and y must both be float32 or both "
                         f"bfloat16, got {x.dtype} and {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul: x and y must be contiguous")
    (m, k), (k2, n) = x.shape, y.shape
    if k != k2:
        raise ValueError(f"matmul: inner dims differ: {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    if 0 in (m, n, k):
        raise ValueError(f"matmul: empty operand {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    if max(m, n, k) >= 2 ** 31:
        raise ValueError("matmul: a dimension does not fit in int32")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"matmul: bias must be ({n},), got "
                         f"{tuple(bias.shape)}")


def matmul(x: torch.Tensor, y: torch.Tensor,
           bias: torch.Tensor | None = None, *, block_m: int = 64,
           block_n: int = 64, block_k: int = 64, epilogue: str = "none",
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``epilogue(x @ y + bias)``.  x (M, K), y (K, N), bias (N,)."""
    _check(x, y, bias)
    tiles = (int(block_m), int(block_n), int(block_k))
    if tiles not in TILES:
        raise ValueError(f"matmul: tile {tiles} is not instantiated; each "
                         f"of block_m, block_n, block_k is one of "
                         f"{TILE_VALUES}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"matmul: out_dtype {out_dtype} not supported "
                         "(float32 or bfloat16)")
    (m, k), n = x.shape, y.shape[1]
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().repro_matmul(
            x.data_ptr(), y.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            m, n, k, _DTYPES[x.dtype], int(out_dtype == torch.bfloat16),
            EPILOGUES[epilogue], *tiles,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"matmul: kernel launch failed with CUDA error "
                           f"{err}")
    matmul.launches += 1
    matmul.last_tiles = tiles
    return out


matmul.launches = 0
matmul.last_tiles = None

#: the kernels of this module, for counters and reports
KERNELS = (matmul,)

"""Python wrappers of the CUDA attention kernels (``csrc/flash_attention.cu``).

* :func:`flash_attention` (K1) — attention of (B, H, Sq, D) queries over
  (B, Hkv, Sk, D) keys with GQA (kv head ``h // G``, any G): causal
  and/or sliding-window self-attention (Sk = Sq), or non-causal cross
  attention with a key length of its own (whisper's decoder over its
  encoder's frames).  A bf16 query runs on the tensor cores (``block_q``-row query
  tiles, ``block_k``-key tiles by ``cp.async`` walked in 64-key softmax
  steps, P rounded to bf16 for P.V), a float32 one on the SIMT template,
  whose fp32 products keep the fp32 tolerance; the choice is the query's
  type, and ``last_kernel`` on the function names the kernel launched
  last.  The tile is the install-time AT's ``FlashBlocks`` region
  (:func:`attention_tiles`); ``by_tile`` counts launches by tile.
* :func:`flash_decode` (K2) — one query token per sequence against a
  dense (B, Hkv, S, D) cache, masked to ``kv_len[b]`` keys; a row with
  ``kv_len == 0`` gives exactly 0.  A bf16 query runs the dense mode of
  ``csrc/paged_decode.cu``'s cluster kernel (K3's: a strip is a pool of
  B pages of S keys), a float32 one the SIMT template of
  ``csrc/flash_attention.cu``; ``last_kernel`` names the one launched
  last.

Each wrapper takes CUDA tensors only, checks them, allocates its output
with ``torch.empty``, launches on the current stream without syncing,
raises on a launch error, and counts its launches in ``.launches`` (a
plain integer on the function), by tile in ``.by_tile`` and, where a
head dim with no instance of its own ran on a padded one (:func:`route`),
by that instance's width in ``.by_width``.  The plain PyTorch versions live in
:mod:`.ref`; :mod:`.ops` picks between the two by the tensor's device.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

#: head dims with instances of their own in the float32 SIMT templates
#: of K2 and of the paged kernels (K3-K6 with a float32 query)
HEAD_DIMS = (16, 32, 64, 128)
#: head dims with instances of their own in the paged kernels with a bf16
#: query (K3-K6d on the tensor cores): the SIMT templates' and
#: pixtral-12b's 160
PAGED_HEAD_DIMS = HEAD_DIMS + (160,)
#: head dims with instances of their own in K1 (both query types) and the
#: bf16 K2 (the cluster kernel's dense mode): the paged ones,
#: h2o-danube-1.8b's 80 and zamba2-7b's 112, whose sliding windows serve
#: from dense lanes, and pixtral-12b's 160
DENSE_HEAD_DIMS = (16, 32, 64, 80, 112, 128, 160)
#: the wide rungs: instances whose head dim is split across warps, a
#: 16-row slab served by one warp per 128 columns (``csrc/common.cuh``),
#: with one tile each (:data:`WIDE_TILE`, :data:`WIDE_BLOCK_K`); every head
#: dim from 257 to 512 runs on one of them
WIDE_HEAD_DIMS = (384, 512)
#: the widths of the padded instances, which every attention kernel (K1-K6d,
#: both query types) has: a head dim d with no instance of its own runs on
#: the instance of the smallest of these at or above it, its columns at and
#: past d zero in shared memory and never stored (``csrc/common.cuh``).
#: Multiples of 32, so that a float32 decode lane owns DP / 32 whole
#: columns: 80, 112 and 160 in float32 (h2o-danube, zamba2, pixtral) take
#: 96, 128 and 160; Phi-3-mini's 96 and Gemma's 256 have rungs of their
#: own; above 256 the wide rungs
MAX_HEAD_DIM = WIDE_HEAD_DIMS[-1]
PADDED_HEAD_DIMS = (64, 96, 128, 160, 192, 256) + WIDE_HEAD_DIMS
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the bf16 K1 kernel's name, as ``flash_attention.last_kernel`` gives it
TC_KERNEL = "flash_attention_tc_kernel"
#: the bf16 K1 tile of an untuned launch: (block_q, block_k)
TC_DEFAULT_TILE = (64, 64)
#: block_q and block_k of the bf16 K1 instances at the head dims of
#: TILED_HEAD_DIMS, any pair of them; the other head dims have
#: TC_DEFAULT_TILE only.  ``FlashBlocks``' candidate values.
TILE_VALUES = (64, 128)
#: the head dims of the archs the card serves: 128, h2o-danube's 80,
#: zamba2's 112 and pixtral's 160, which take every tile because
#: ``ops.attention`` hands K1 the tile ``FlashBlocks`` published whatever
#: the head dim (whisper's 64 takes the default tile: a 64-row tile
#: already wastes most of its short prompts' rows)
TILED_HEAD_DIMS = (80, 112, 128, 160)
#: the float32 SIMT template's one tile: query rows and keys
SIMT_TILE = (64, 32)
#: K1's one tile at a wide rung, both query types: 2 slabs of 16 rows (of
#: D / 128 warps each on the tensor cores; 8 warps of 4 rows in float32)
#: by 32 keys
WIDE_TILE = (32, 32)
#: the one key tile of the decode and prefill kernels at a wide rung
WIDE_BLOCK_K = 32
#: the float32 K2 kernel's name, as ``flash_decode.last_kernel`` gives it
#: (a bf16 K2 runs ``paged_attention.DECODE_TC_KERNEL``)
DECODE_SIMT_KERNEL = "flash_decode_kernel"


def part(dp: int) -> str:
    """The library part (``build``'s suffix) that holds the instance of
    ``dp``, a C entry's argument: 0 the head dims' own, a wide rung the
    wide part, any other width the padded one."""
    if dp == 0:
        return ""
    return build.WIDE if dp in WIDE_HEAD_DIMS else build.PADDED


@functools.cache
def _lib(lib_part: str = "") -> ctypes.CDLL:
    """The built library with its C signatures declared (once): the
    instances of their own, or of the part ``lib_part`` (:func:`part`)."""
    lib = build.load("flash_attention" + lib_part)
    lib.repro_flash_attention.argtypes = [
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
        _P]
    lib.repro_flash_attention.restype = _I
    lib.repro_flash_decode.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]
    lib.repro_flash_decode.restype = _I
    lib.repro_flash_attention_tc_info.argtypes = [_I, _I, _I, _I, _P]
    lib.repro_flash_attention_tc_info.restype = _I
    return lib


def head_dims(name: str, dtype: torch.dtype) -> tuple[int, ...]:
    """The head dims with instances of their own in the kernel of wrapper
    ``name`` at a query of ``dtype``: :data:`DENSE_HEAD_DIMS` for K1 and
    the bf16 K2, :data:`PAGED_HEAD_DIMS` for the paged kernels with a bf16
    query, :data:`HEAD_DIMS` for the float32 K2 and the paged kernels'
    float32 templates.  Every other head dim up to :data:`MAX_HEAD_DIM`
    runs on a padded instance (:func:`route`)."""
    if name == "flash_attention" or (name == "flash_decode"
                                     and dtype == torch.bfloat16):
        return DENSE_HEAD_DIMS
    return PAGED_HEAD_DIMS if dtype == torch.bfloat16 else HEAD_DIMS


def simt_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block of the float32 K1 (and of the
    paged prefill's SIMT template) at instance width ``d``: its query rows
    (64, 32 at a wide width) as fp32 rows of d, a 32-key K tile of rows of
    d + 1, the V tile, and the warps' 32 softmax numerators a row
    (``k1::smem_bytes``)."""
    bq = WIDE_TILE[0] if d > 256 else SIMT_TILE[0]
    return 4 * (bq * d + 32 * (d + 1) + 32 * d + bq * 32)


#: the shared memory a block may hold on an H100 (227 KB, the opt-in limit)
BLOCK_SMEM_BYTES = 232_448
#: the wide rung after the last one (five 128-column slices)
NEXT_WIDE_RUNG = MAX_HEAD_DIM + 128

#: why no head dim above MAX_HEAD_DIM runs: at the next wide rung the
#: float32 K1's and paged prefill's 32-row tile needs more shared memory
#: (simt_smem_bytes) than a block may hold; 16 rows would fit but halve
#: the rows each copied key tile serves, and no model of the repo needs it
LIMIT_REASON = (
    f"no instance above {MAX_HEAD_DIM}: at the next rung, {NEXT_WIDE_RUNG}, "
    f"the float32 attention kernels' {WIDE_TILE[0]}-row tile needs "
    f"{simt_smem_bytes(NEXT_WIDE_RUNG):,} B of shared memory, more than "
    f"the {BLOCK_SMEM_BYTES:,} B (227 KB) a block may hold")


class Route(NamedTuple):
    """The instance a launch takes: ``width`` its head dim (DP), and
    ``padded`` whether it is a padded instance (the C entries' ``dp``
    argument is then ``width``, else 0), a wide one where ``width`` is a
    wide rung."""
    width: int
    padded: bool

    @property
    def dp(self) -> int:
        return self.width if self.padded else 0

    @property
    def wide(self) -> bool:
        return self.padded and self.width in WIDE_HEAD_DIMS

    @property
    def library(self) -> str:
        """The library part holding the instance (:func:`part`)."""
        return part(self.dp)


#: the padded width every launch in a :func:`_forced_width` block takes
_FORCED_WIDTH: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "forced_width", default=None)


@contextlib.contextmanager
def _forced_width(width: int):
    """Within the block :func:`route` answers the padded instance of
    ``width`` for every head dim up to it, so every wrapper launches, and
    every tile table answers for, that instance: the tests' and the card's
    check that a padded instance gives the bits of a head dim's own.  Not
    a user option."""
    if width not in PADDED_HEAD_DIMS:
        raise ValueError(f"no padded instance of width {width}; the widths "
                         f"are {PADDED_HEAD_DIMS}")
    token = _FORCED_WIDTH.set(width)
    try:
        yield
    finally:
        _FORCED_WIDTH.reset(token)


def padded_width(d: int) -> int:
    """The smallest rung of :data:`PADDED_HEAD_DIMS` at or above ``d``."""
    return min(w for w in PADDED_HEAD_DIMS if w >= d)


def route(name: str, dtype: torch.dtype, d: int) -> Route:
    """Which instance a launch of wrapper ``name`` (``flash_attention``,
    ``flash_decode``, or any paged wrapper's name) with a query of
    ``dtype`` takes at head dim ``d``: its own where the kernel has one
    (:func:`head_dims`), else the padded instance of :func:`padded_width`
    (inside a :func:`_forced_width` block, that block's).  Every caller's
    tables derive from this: the tiles of a padded instance are its
    defaults alone.  A bf16 prefill whose group size divides none of its
    own instance's row tiles takes a padded one too
    (``paged_attention.prefill_route``).  ``ValueError`` for ``d`` outside
    1 .. :data:`MAX_HEAD_DIM` (:data:`LIMIT_REASON`), or above the forced
    width."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} not in 1..{MAX_HEAD_DIM}: "
                         + LIMIT_REASON)
    width = _FORCED_WIDTH.get()
    if width is not None:
        if width < d:
            raise ValueError(f"{name}: no padded instance of width {width} "
                             f"for head dim {d}")
        return Route(width, True)
    if d in head_dims(name, dtype):
        return Route(d, False)
    return Route(padded_width(d), True)


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, "
                             f"got one on {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected 4-d tensors, got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} not supported "
                             "(float32 or bfloat16)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
        if t.numel() == 0:
            raise ValueError(f"{name}: empty tensor {tuple(t.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: q, k, v dtypes differ")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v are on different devices")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not match")
    route(name, q.dtype, d)            # raises above MAX_HEAD_DIM
    if h % k.shape[1]:
        raise ValueError(f"{name}: {h} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def attention_tiles(dtype: torch.dtype,
                    d: int) -> tuple[tuple[int, int], ...]:
    """The (block_q, block_k) tiles K1 has an instance for, for a query
    of ``dtype`` at head dim ``d`` (on the instance of :func:`route`); a
    padded instance has the default tile alone, a wide one
    :data:`WIDE_TILE`."""
    if route("flash_attention", dtype, d).wide:
        return (WIDE_TILE,)
    if dtype != torch.bfloat16:
        return (SIMT_TILE,)
    if d not in TILED_HEAD_DIMS or route("flash_attention", dtype,
                                         d).padded:
        return (TC_DEFAULT_TILE,)
    return tuple((bq, bk) for bq in TILE_VALUES for bk in TILE_VALUES)


def attention_tile(name: str, q: torch.Tensor, block_q: int | None,
                   block_k: int | None) -> tuple[int, int]:
    """(block_q, block_k) of a K1 launch: the pair must have an instance
    at q's type and head dim (else ``ValueError`` naming those that do);
    ``None`` is the default's value."""
    tiles = attention_tiles(q.dtype, q.shape[-1])
    tile = (tiles[0][0] if block_q is None else block_q,
            tiles[0][1] if block_k is None else block_k)
    if tile not in tiles:
        raise ValueError(f"{name}: no instance for block_q={block_q!r}, "
                         f"block_k={block_k!r}; a {q.dtype} query at head "
                         f"dim {q.shape[-1]} has (block_q, block_k) in "
                         f"{tiles}")
    return tile


def check_lengths(sq: int, sk: int, causal: bool,
                  window: int | None) -> None:
    """``ValueError`` for Sq query rows over Sk != Sq keys with a causal
    mask or a window: cross attention is neither (K1 and ``ops.attention``
    take it without; the JAX model makes no other such call)."""
    if sk != sq and (causal or window is not None):
        raise ValueError(
            f"flash_attention: {sq} query rows over {sk} keys is cross "
            "attention, which is neither causal nor windowed; pass "
            "causal=False and no window (or Sk = Sq)")


def smem_bytes(block_q: int, block_k: int, d: int) -> int:
    """Dynamic shared memory of one block of the bf16 K1 at a tile: the
    Q tile and a 2-stage ring of K and V tiles, bf16 rows of d + 8
    (``k1tc::Smem``); at a wide width d also each slab's slices' partial
    scores, d / 128 of 16 rows by block_k keys in fp32."""
    partials = ((block_q // 16) * (d // 128) * 16 * block_k * 4 if d > 256
                else 0)
    return (block_q + 2 * 2 * block_k) * (d + 8) * 2 + partials


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, block_q: int | None = None,
                    block_k: int | None = None) -> torch.Tensor:
    """Attention.  q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D), H % Hkv == 0.
    Sk = Sq for self-attention; Sk != Sq (cross attention) only with
    ``causal=False`` and no window, else ``ValueError`` (the JAX package
    makes no such call).  Output in q's dtype: bfloat16 on the tensor cores at the tile of
    ``block_q`` query rows and ``block_k`` keys (one of
    :func:`attention_tiles`, 64 x 64 by default; every tile takes the same
    64-key softmax steps, so all give the same bits), float32 on the SIMT
    template, whose one tile is :data:`SIMT_TILE`.  A tile with no
    instance raises ``ValueError``.  Unlike the JAX package's kernel,
    which pads S to a multiple of the tile and clamps the tile to S, the
    card's kernel masks the keys and rows past S in the last tile, so a
    tile larger than S runs as it is; the query rows and the keys have a
    limit each.  A head dim with no instance of its own (any up to
    :data:`MAX_HEAD_DIM`) runs on a padded one (:func:`route`)."""
    tile = attention_tile("flash_attention", q, block_q, block_k)
    _check("flash_attention", q, k, v)
    b, h, s, d = q.shape
    sk = k.shape[2]
    check_lengths(s, sk, causal, window)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = float(scale if scale is not None else d ** -0.5)
    rt = route("flash_attention", q.dtype, d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib(rt.library).repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, k.shape[1], s, sk, d, rt.dp, _DTYPES[q.dtype], int(causal),
            -1 if window is None else int(window), scale, *tile,
            _stream(q))
    _raise_on("flash_attention", err)
    flash_attention.launches += 1
    flash_attention.by_tile[tile] += 1
    if rt.padded:
        flash_attention.by_width[rt.width] += 1
    flash_attention.last_kernel = (TC_KERNEL if q.dtype == torch.bfloat16
                                   else "flash_attention_kernel")
    return out


def tc_info(d: int, block_q: int = TC_DEFAULT_TILE[0],
            block_k: int = TC_DEFAULT_TILE[1], dp: int = 0) -> dict[str, int]:
    """What the card makes of the tensor-core K1 instance for head dim
    ``d`` (``dp`` 0), or of the padded one of width ``dp``, at the tile
    ``block_q`` x ``block_k``: registers per thread, local (spill) bytes,
    dynamic shared memory, and resident blocks per SM.  Needs the card."""
    out = (ctypes.c_int * 4)()
    _raise_on("tc_info", _lib(part(dp)).repro_flash_attention_tc_info(
        d, dp, block_q, block_k, ctypes.addressof(out)))
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), out))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor | None = None, *,
                 scale: float | None = None, block_k: int | None = None,
                 _cluster: int | None = None) -> torch.Tensor:
    """Decode attention: q (B, H, 1, D) against caches (B, Hkv, S, D);
    ``kv_len`` (B,) int32 on the same device masks each cache's valid
    prefix (values are clamped to [0, S] on the card).  A bfloat16 q runs
    the cluster kernel's dense mode in clusters of
    ``paged_attention.cluster_size`` CTAs per (lane, kv head), which
    ``_cluster`` overrides (tests only), at ``block_k`` keys a tile (one of
    ``paged_attention.decode_block_ks``, 64 by default; the run-time AT's
    ``DecodeBucket`` tile); a float32 q the SIMT template, whose one tile
    is 32 keys.  A tile with no instance raises ``ValueError``.  A head
    dim with no instance of its own runs on a padded one (:func:`route`)."""
    from . import paged_attention as pa    # it imports this module
    _check("flash_decode", q, k, v)
    rt = route("flash_decode", q.dtype, q.shape[-1])
    bk = pa.decode_tile("flash_decode", q, block_k)
    b, h, one, d = q.shape
    if one != 1:
        raise ValueError(f"flash_decode takes one query token, got {one}")
    s = k.shape[2]
    if kv_len is None:
        kv_len = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if (kv_len.dtype != torch.int32 or kv_len.shape != (b,)
            or kv_len.device != q.device or not kv_len.is_contiguous()):
        raise ValueError("kv_len must be a contiguous (B,) int32 tensor on "
                         "q's device")
    scale = float(scale if scale is not None else d ** -0.5)
    hkv = k.shape[1]
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), b, h, hkv, s, d, rt.dp)
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            c = pa.decode_cluster("flash_decode", q, b, hkv, _cluster, bk)
            lib = pa._dec_lib(rt.library)
            err = lib.repro_flash_decode_tc(*args, c, bk, scale, _stream(q))
            kernel = pa.DECODE_TC_KERNEL
        else:
            err = _lib(rt.library).repro_flash_decode(
                *args, _DTYPES[q.dtype], scale, _stream(q))
            kernel = DECODE_SIMT_KERNEL
    _raise_on("flash_decode", err)
    flash_decode.launches += 1
    flash_decode.by_tile[bk] += 1
    if rt.padded:
        flash_decode.by_width[rt.width] += 1
    flash_decode.last_kernel = kernel
    return out


flash_attention.launches = 0
flash_attention.last_kernel = None
flash_attention.by_tile = collections.Counter()
flash_attention.by_width = collections.Counter()
flash_decode.launches = 0
flash_decode.last_kernel = None
flash_decode.by_tile = collections.Counter()
flash_decode.by_width = collections.Counter()

#: the kernels of this module, for counters and reports
KERNELS = (flash_attention, flash_decode)

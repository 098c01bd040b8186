"""Python wrappers of the paged CUDA attention kernels (``csrc/paged_attention.cu``;
``csrc/paged_decode.cu`` for the decode with a bf16 query over bf16 or
int8 pools, in one pass or split; ``csrc/paged_prefill.cu``
for the prefill chunk with a bf16 query over bf16 or int8 pools, in one
pass or split).

* :func:`flash_paged_decode` — one query token per sequence against K/V
  page pools (P, Hkv, psz, D), each sequence reaching its pages through a
  row of ``page_table`` (B, nblk) int32, masked to ``kv_len[b]`` keys; a
  row with ``kv_len == 0`` gives exactly 0.  ``num_splits`` 1 (the
  default) launches K3: for a bf16 query ``paged_decode.cu``'s kernel, one
  thread-block cluster of :func:`cluster_size` CTAs per (lane, kv head),
  each CTA walking a contiguous share of the lane's key tiles (rows by
  16-byte ``cp.async`` copies, products on the tensor cores with P rounded
  to bf16) and the CTAs merging their softmax states through distributed
  shared memory; for a float32 query the SIMT template of
  ``paged_attention.cu``, whose fp32 products keep the fp32 tolerance.
  ``last_kernel`` on the function names the one launched last.  More
  splits run K5a (one CTA per split of the lane's live keys writing fp32
  partial softmax states) and K5c (the merge): for a bf16 query in one
  launch, :func:`paged_decode_split_merged` (the cluster kernel's
  partials mode, each split a contiguous share of the lane's key tiles
  (``block_k``, 64 by default), whose last split of each lane and kv
  head to finish merges them as K5c does); for float32 two, :func:`paged_decode_split` (the SIMT
  template's 32-key tiles) and :func:`split_combine`.
* :func:`flash_paged_decode_quant` — the same over int8 pools with fp32
  per-row scales (P, Hkv, psz): K6a (the cluster kernel for a bf16 query,
  the SIMT template for float32), or K6b with K5c
  (:func:`paged_decode_split_quant_merged` for a bf16 query, the same
  partials mode over int8 pools; for float32 the SIMT template's
  :func:`paged_decode_split_quant` + :func:`split_combine`).
* :func:`flash_paged_prefill` (K4) — a chunk of C query tokens per
  sequence at absolute positions ``start[b] + i``, causal over the
  committed paged prefix plus the chunk's own triangle; key ``j`` is
  valid iff ``j < kv_len[b]``.  The chunk's K/V must already be in the
  pages (write before read).  A bf16 query runs on the tensor cores
  (``paged_prefill.cu``: GQA folded into the query tiles, ``cp.async``
  page copies, P rounded to bf16 for P.V); a float32 query on the SIMT
  template of ``paged_attention.cu``, whose fp32 products keep the fp32
  tolerance.  The choice is the query's type; ``last_kernel`` on the
  function names the one launched last.  ``num_splits`` above 1 runs K5b
  (each query tile's live key tiles cut into splits, fp32 partials of the
  chunk's C rows) and K5c: for a bf16 query in one launch,
  :func:`paged_prefill_split_merged` (the tensor-core kernel's partials
  mode, whose tiles are ``block_q`` chunk rows (:func:`default_block_q`:
  32 // G where G divides 32) and ``block_k`` keys (128), merged in its
  epilogue by the last split of each tile), for float32
  :func:`paged_prefill_split` (the SIMT template's 64 rows and 32 keys)
  and :func:`split_combine`.
  :func:`flash_paged_prefill_quant` is the same over int8 pools: K6c, or
  K6d with K5c (:func:`paged_prefill_split_quant_merged` for a bf16
  query; :func:`paged_prefill_split_quant` + :func:`split_combine` for
  float32).

Tiles (the run-time AT's parameters, read by :mod:`.ops` from
``at.tuned``): the decode kernel takes ``block_k``, keys per K/V tile
(:data:`DECODE_BLOCK_KS` at the head dims of ``TILED_HEAD_DIMS``,
:data:`DECODE_TILE_KEYS` elsewhere); the tensor-core prefill kernel
``block_q`` (query positions per tile, as in the JAX package: the
kernel's row tile is ``block_q`` x G query rows of one kv head; where G
divides no row tile, the tile's rows) and ``block_k``
(:func:`prefill_tiles`).  On the card a tile spans whole pages
where the TPU kernel's ``block_k`` was a sub-page tile that had to divide
the page.
A float32 query keeps the SIMT templates' one tile.  A tile the kernel has
no instance for raises ``ValueError`` naming the tiles it has; ``None``
is the default tile, what an untuned call runs.  ``by_tile`` on each
wrapper counts its launches by tile.

The merged entries count the arrivals of a tile's splits on int32
counters, one set per (device, stream) made here once (zeroed at
allocation) and left all zero by every launch, since the last split of a
tile resets its counter: no launch clears them.  :func:`paged_decode_split`
and its siblings keep returning the partials (tests, the phase-1 sweep).

Table entries past ``ceil(kv_len / psz)`` are never read and may point
anywhere (page 0 by convention); entries below it must name pages of the
pools.  The tensor-core kernel (K4, K5b, K6c and K6d with a bf16 query)
takes any group size G = H / Hkv: a row tile is a run of a kv head's
(position, head) rows, ``block_q`` positions of the G heads where G
divides one of its row tiles (at D 128: G a power of two up to 64, G 3,
6, 12 and 24 through the 48-row tile, or G 5, 10, 20, 40 and 80 through
the 80-row tile; at D 160 G a power of two up to 64; elsewhere G
dividing 32), else the padded instances' one tile of 32 flattened rows
(:func:`flattened`, :func:`prefill_route`).  Every kernel takes every head dim up to
:data:`~.flash_attention.MAX_HEAD_DIM`: the head dims of
:data:`~.flash_attention.PAGED_HEAD_DIMS` (bf16) and
:data:`~.flash_attention.HEAD_DIMS` (float32) have
instances of their own, the others run on the padded instances
(:func:`~.flash_attention.route`).  The decode kernel of a bf16 query
takes any G: its query rows come in 16-row slabs, one cluster each.
The wrappers follow the contract of :mod:`.flash_attention`:
CUDA tensors only, checked; outputs and partials from ``torch.empty``;
launch on the current stream without syncing; raise on a launch error;
each kernel counts its own launches in ``.launches`` on the function
named after it.  The plain versions live in :mod:`.ref`.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import build
from .flash_attention import (_DTYPES, PADDED_HEAD_DIMS, TILED_HEAD_DIMS,
                              WIDE_BLOCK_K, WIDE_HEAD_DIMS, WIDE_TILE, Route,
                              _raise_on, _stream, padded_width, part, route)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: query rows of the tensor-core prefill kernel's default tile: a run of
#: a kv head's (position, head) rows, block_q positions of its G heads
#: where G divides it
TC_TILE_ROWS = 32
#: keys per K/V tile of the tensor-core kernel
TC_TILE_KEYS = 128
#: its name, as ``last_kernel`` on the wrappers gives it
TC_KERNEL = "paged_prefill_tc_kernel"
#: the one-pass decode kernel of a bf16 query (K3, K6a) and its float32
#: counterpart, as ``last_kernel`` on the decode wrappers gives them
DECODE_TC_KERNEL = "paged_decode_tc_kernel"
DECODE_SIMT_KERNEL = "paged_decode_kernel"
#: the CTAs of one cluster of the decode kernel, per (lane, kv head); K2
#: (:func:`.flash_attention.flash_decode`) takes the same
CLUSTER_SIZES = (1, 2, 4, 8)
#: keys per tile of the decode kernel (a stage of its ring); a cluster's
#: rank walks a contiguous share of the lane's tiles
DECODE_TILE_KEYS = 64


#: query rows of one CTA of the decode kernel (an mma slab); its merged
#: split route counts arrivals per (lane, kv head, slab)
DECODE_SLAB_ROWS = 16


#: the most CTAs an SM holds at once that the cluster rule counts on: what
#: the decode kernel's D = 128 instances hold (``decode_tc_info``'s
#: ``blocks_per_sm``, shared memory bound); an instance whose shared
#: memory leaves fewer counts those (:data:`DECODE_CTAS`)
DECODE_CTAS_PER_SM = 2
#: an SM's shared memory, and what the card reserves of it for each block
SM_SHARED_BYTES = 228 * 1024
BLOCK_RESERVED_BYTES = 1024
#: the table entries a decode CTA stages at which its shared memory is
#: reckoned (a rank's share of 64 pages; the build phase's ``decode_tc_info``)
DECODE_TABLE_ENTRIES = 64
#: the key tiles of the decode kernel at the head dims of TILED_HEAD_DIMS:
#: D 128 and 160 (the paged archs the card serves; 160 is pixtral-12b's)
#: and, in the dense mode (K2) alone, D 80 (h2o-danube-1.8b) and D 112
#: (zamba2-7b's shared block), dense lanes only; other head dims have
#: DECODE_TILE_KEYS only
DECODE_BLOCK_KS = (32, 64)
#: the tensor-core prefill kernel's D = 128 instances: query rows (block_q
#: x G) by keys.  The 48-row tile (3 slabs) is phi4-mini's: 16 chunk rows
#: at G 3; the 80-row tile (5 slabs) llama4-scout's: 16 chunk rows at G 5.
TC_ROW_TILES = (16, 32, 48, 64, 80)
TC_BLOCK_KS = (64, 128)
#: the row tiles by head dim: D 128's, and at pixtral-12b's D 160 rows 16,
#: 32 and 64 (block_q 4, 8 and 16 at its G 4), both by TC_BLOCK_KS; other
#: head dims have TC_TILE_ROWS x TC_TILE_KEYS only
TC_ROW_TILES_BY_D = {128: TC_ROW_TILES, 160: (16, 32, 64)}
#: the one tile of the float32 SIMT templates: keys of the decode walk,
#: chunk rows and keys of the prefill walk
SIMT_DECODE_TILE_KEYS = 32
SIMT_PREFILL_TILE = (64, 32)


def decode_block_ks(dtype: torch.dtype, d: int,
                    dense: bool = False) -> tuple[int, ...]:
    """The key tiles the decode kernel has an instance for, for a query
    of ``dtype`` at head dim ``d``, in its dense mode (K2) with ``dense``,
    else its paged ones (at D 80 and 112 the dense mode has instances of
    its own, the paged modes run on padded ones), on the instance of
    :func:`~.flash_attention.route`: a padded instance has
    :data:`DECODE_TILE_KEYS` alone, a wide one
    :data:`~.flash_attention.WIDE_BLOCK_K`."""
    if dtype != torch.bfloat16:
        return (SIMT_DECODE_TILE_KEYS,)
    rt = route("flash_decode" if dense else "flash_paged_decode", dtype, d)
    return _instance_block_ks(rt.width, rt.padded)


def _instance_block_ks(width: int, padded: bool) -> tuple[int, ...]:
    """The key tiles of the bf16 decode instance of ``width`` (a padded
    one with ``padded``)."""
    if width in WIDE_HEAD_DIMS:
        return (WIDE_BLOCK_K,)
    return (DECODE_BLOCK_KS if width in TILED_HEAD_DIMS and not padded
            else (DECODE_TILE_KEYS,))


def _row_tiles(rt: Route, d: int) -> tuple[int, ...]:
    """The query-row tiles of the tensor-core prefill instance ``rt`` at
    head dim ``d``: a padded instance has :data:`TC_TILE_ROWS` alone."""
    if rt.padded:
        return (TC_TILE_ROWS,)
    return TC_ROW_TILES_BY_D.get(d, (TC_TILE_ROWS,))


def _folds(rows: tuple[int, ...], g: int) -> bool:
    """Whether ``g`` divides one of the row tiles ``rows`` with a
    power-of-two quotient (``block_q`` positions of all ``g`` heads)."""
    return any(r % g == 0 and (r // g) & (r // g - 1) == 0 for r in rows)


def flattened(d: int, g: int) -> bool:
    """Whether ``g`` divides none of the row tiles of the bf16 prefill
    kernel's instance at head dim ``d`` with a power-of-two quotient: the
    tile then spans no whole number of positions, so the launch takes a
    padded instance, whose rows are flattened (:func:`prefill_route`), and
    the ladder calls its tile by its rows (:func:`prefill_tiles`)."""
    rt = route("flash_paged_prefill", torch.bfloat16, d)
    return not _folds(_row_tiles(rt, d), g)


def prefill_route(name: str, dtype: torch.dtype, d: int, g: int) -> Route:
    """The instance of a prefill or verify launch of wrapper ``name`` at
    head dim ``d`` and group size ``g``: :func:`~.flash_attention.route`'s,
    but for a bf16 query whose ``g`` is :func:`flattened` at a head dim's
    own instance, the padded one of
    :func:`~.flash_attention.padded_width` (at D 128, the rung 128), which
    takes any G: only the padded instances flatten the rows."""
    rt = route(name, dtype, d)
    if dtype == torch.bfloat16 and not rt.padded and flattened(d, g):
        return Route(padded_width(d), True)
    return rt


def prefill_tiles(dtype: torch.dtype, d: int, g: int
                  ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(block_qs, block_ks) the prefill kernels have an instance for, for a
    query of ``dtype`` at head dim ``d`` and group size ``g``, on the
    instance of :func:`prefill_route`: a padded instance has the default
    tile alone, 32 rows by :func:`padded_block_k` keys.

    A row tile of the tensor-core kernel holds consecutive rows of a kv
    head's C x G (position, head) rows.  Where ``g`` divides one of the
    row tiles with a power-of-two quotient, the ladder calls a tile by
    ``block_q``, the positions of all ``g`` heads it holds, as the JAX
    package's tiles are (so the 48-row tile serves G 3 at block_q 16, not
    G 8 at 6, and the 80-row tile G 5 at 16, not G 8 at 10).  Where ``g``
    divides none (:func:`flattened`: G 7, 9, 11, ..., G 3 and 5 at D 160,
    G above 80), a tile spans no whole number of positions and runs on a
    padded instance, whose one tile the ladder calls by its rows,
    ``block_q`` 32, which :func:`prefill_rows` hands the kernel as it is.
    ``d`` outside 1 .. :data:`~.flash_attention.MAX_HEAD_DIM` has none:
    ((), ())."""
    try:
        rt = prefill_route("flash_paged_prefill", dtype, d, g)
    except ValueError:
        return (), ()
    if dtype != torch.bfloat16:
        rows, keys = simt_prefill_tile(d)
        return (rows,), (keys,)
    rows = _row_tiles(rt, d)
    if rt.padded:
        keys = (padded_block_k(rt.width),)
    else:
        keys = TC_BLOCK_KS if d in TC_ROW_TILES_BY_D else (TC_TILE_KEYS,)
    if not _folds(rows, g):
        return (TC_TILE_ROWS,), keys
    return tuple(r // g for r in rows
                 if r % g == 0 and (r // g) & (r // g - 1) == 0), keys


def prefill_rows(d: int, g: int, block_q: int) -> int:
    """The query rows of the bf16 prefill tile the ladder calls
    ``block_q`` at head dim ``d`` and group size ``g``: ``block_q`` x
    ``g``, or ``block_q`` itself where ``g`` divides no row tile."""
    return block_q if flattened(d, g) else block_q * g


def padded_block_k(width: int) -> int:
    """The keys of a padded prefill instance's one tile:
    :data:`TC_TILE_KEYS`, but 64 at width 256, whose 128-key ring would
    not fit a block's shared memory, and 32 at a wide rung
    (``paged_prefill.cu``'s pad_bn)."""
    if width in WIDE_HEAD_DIMS:
        return WIDE_BLOCK_K
    return 64 if width > 192 else TC_TILE_KEYS


def simt_prefill_tile(d: int) -> tuple[int, int]:
    """(chunk rows, keys) of the float32 prefill SIMT template's one tile
    at head dim ``d``: :data:`SIMT_PREFILL_TILE`, or at a wide rung
    :data:`~.flash_attention.WIDE_TILE` (``k4::bq``)."""
    return (WIDE_TILE if route("flash_paged_prefill", torch.float32, d).wide
            else SIMT_PREFILL_TILE)


def tc_row_tiles(d: int) -> tuple[int, ...]:
    """The query-row tiles of the tensor-core prefill kernel's instance at
    head dim ``d`` (:func:`~.flash_attention.route`'s, whatever the group
    size); a padded instance has :data:`TC_TILE_ROWS` alone."""
    return _row_tiles(route("flash_paged_prefill", torch.bfloat16, d), d)


def default_block_q(d: int, g: int) -> int:
    """The ``block_q`` of an untuned bf16 prefill launch at head dim ``d``
    and group size ``g``: that of the largest row tile up to
    :data:`TC_TILE_ROWS` (32 // G for G 1, 2, 4, 8), else of the smallest
    row tile ``g`` has (G 3: 16, the 48-row tile; G 5: 16, the 80-row
    tile); where ``g`` divides no row tile, :data:`TC_TILE_ROWS` rows."""
    if flattened(d, g):
        return TC_TILE_ROWS
    block_qs = prefill_tiles(torch.bfloat16, d, g)[0]
    fits = [bq for bq in block_qs if bq * g <= TC_TILE_ROWS]
    return max(fits) if fits else min(block_qs)


def default_block_k(dtype: torch.dtype, d: int) -> int:
    """The ``block_k`` of an untuned prefill launch: :data:`TC_TILE_KEYS`
    for a bf16 query where the instance has it (else its one tile's), the
    SIMT template's for float32."""
    keys = prefill_tiles(dtype, d, 1)[1]
    if dtype != torch.bfloat16:
        return keys[0]
    return TC_TILE_KEYS if TC_TILE_KEYS in keys else keys[0]


def decode_tile(name: str, q: torch.Tensor, block_k: int | None) -> int:
    """The key tile of a decode launch (K2 where ``name`` is
    ``flash_decode``): ``block_k``, which must have an instance (else
    ``ValueError`` naming those that do), or the default."""
    tiles = decode_block_ks(q.dtype, q.shape[-1], name == "flash_decode")
    if block_k is None:
        return DECODE_TILE_KEYS if DECODE_TILE_KEYS in tiles else tiles[0]
    if block_k not in tiles:
        raise ValueError(f"{name}: no instance for block_k={block_k!r}; a "
                         f"{q.dtype} query at head dim {q.shape[-1]} has "
                         f"block_k in {tiles}")
    return block_k


def prefill_tile(name: str, q: torch.Tensor, hkv: int,
                 block_q: int | None,
                 block_k: int | None) -> tuple[int, int]:
    """(block_q, block_k) of a prefill or verify launch: each must have an
    instance at q's type, head dim and group size (else ``ValueError``
    naming those that do); ``None`` is the default."""
    g = q.shape[1] // hkv
    d = q.shape[-1]
    block_qs, block_ks = prefill_tiles(q.dtype, d, g)
    if not block_qs:
        route(name, q.dtype, d)             # raises: no head dim above 256
    bf16 = q.dtype == torch.bfloat16
    if block_q is None:
        block_q = default_block_q(d, g) if bf16 else block_qs[0]
    if block_k is None:
        block_k = default_block_k(q.dtype, d)
    if block_q not in block_qs or block_k not in block_ks:
        raise ValueError(
            f"{name}: no instance for block_q={block_q!r}, block_k="
            f"{block_k!r}; a {q.dtype} query at head dim {q.shape[-1]} and "
            f"group size {g} has block_q in {block_qs} and block_k in "
            f"{block_ks}")
    return block_q, block_k


def decode_smem_bytes(d: int, block_k: int, quant: bool,
                      nblk: int = DECODE_TABLE_ENTRIES) -> int:
    """Dynamic shared memory of one CTA of the bf16 decode kernel at head
    dim ``d``, ``block_k`` keys a tile, over int8 pools with ``quant``
    (``dec::Smem`` of ``csrc/paged_decode.cu``): the ring of 3 K and V
    stages (rows of D x the pool's element size + 16 bytes), for int8 the
    K and V tiles widened to bf16 rows of D + 8 and the ring's scales, the
    16-row Q slab, then ``nblk`` page-table entries.  A wide width (d
    above 256) has a ring of 2 stages, a copy of the scales for each of its
    d / 128 column slices, and the slices' partial scores of each 16-key
    group in two buffers (fp32 16 x 16 each)."""
    slices = d // 128 if d > 256 else 1
    row, stages, slab = d + 8, 2 if d > 256 else 3, 16
    kv_row = d * (1 if quant else 2) + 16
    ring = 2 * stages * block_k * kv_row
    widened = 2 * block_k * row * 2 if quant else 0
    scales = slices * stages * 2 * block_k * 4 if quant else 0
    partials = 2 * (block_k // 16) * slices * 16 * 16 * 4 if d > 256 else 0
    return ring + widened + slab * row * 2 + scales + partials + 4 * nblk


def decode_ctas_per_sm(d: int, block_k: int, quant: bool) -> int:
    """The CTAs an SM holds at once of the bf16 decode instance at (``d``,
    ``block_k``, int8 pools with ``quant``) that the cluster rule counts
    on: those its shared memory (:func:`decode_smem_bytes`) allows, at
    most :data:`DECODE_CTAS_PER_SM`.  1 at D 160 and 64 keys (bf16 and
    int8) and at the wide rungs, 2 at every other instance; the card's
    ``decode_tc_info`` confirms it."""
    fits = SM_SHARED_BYTES // (decode_smem_bytes(d, block_k, quant)
                               + BLOCK_RESERVED_BYTES)
    return max(1, min(DECODE_CTAS_PER_SM, fits))


#: the host's table of :func:`decode_ctas_per_sm` by (instance width, key
#: tile, int8 pools) over the bf16 decode kernel's instances: those of
#: their own and the padded ones (:data:`PADDED_HEAD_DIMS`, 64 keys; the
#: wide rungs 32)
DECODE_CTAS = {(d, bk, quant): decode_ctas_per_sm(d, bk, quant)
               for d in sorted(set(PADDED_HEAD_DIMS + TILED_HEAD_DIMS
                                   + (16, 32, 64)))
               for bk in (DECODE_BLOCK_KS if d in TILED_HEAD_DIMS
                          else _instance_block_ks(d, True))
               for quant in (False, True)}


def cluster_size(b: int, hkv: int, sm_count: int, d: int = 128,
                 block_k: int = DECODE_TILE_KEYS,
                 quant: bool = False) -> int:
    """The CTAs per (lane, kv head) cluster of the bf16 decode kernel: the
    largest of :data:`CLUSTER_SIZES` with ``b * hkv * c`` at most the CTAs
    the card holds at once (:data:`DECODE_CTAS` an SM for the instance of
    width ``d`` that the launch takes, ``block_k`` keys and int8 pools
    with ``quant``), so
    that every CTA runs in one wave (1 when even that does not fit).  From
    the shapes alone: it never reads ``kv_len``, which would sync the
    decode step with the host."""
    per_sm = DECODE_CTAS.get((d, block_k, quant), DECODE_CTAS_PER_SM)
    fits = [c for c in CLUSTER_SIZES if b * hkv * c <= per_sm * sm_count]
    return max(fits, default=1)


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (a host query, cached)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _lib(lib_part: str = "") -> ctypes.CDLL:
    """The built library with its C signatures declared (once): the
    instances of their own, or of the part ``lib_part``
    (:func:`~.flash_attention.part`)."""
    lib = build.load("paged_attention" + lib_part)
    signatures = {
        "repro_flash_paged_decode": [_P] * 6 + [_I] * 8 + [_F, _P],
        "repro_flash_paged_decode_quant": [_P] * 8 + [_I] * 8 + [_F, _P],
        "repro_paged_decode_split": [_P] * 8 + [_I] * 9 + [_F, _P],
        "repro_paged_decode_split_quant": [_P] * 10 + [_I] * 9 + [_F, _P],
        "repro_split_combine": [_P] * 4 + [_I] * 5 + [_P],
        "repro_paged_prefill_f32": [_P] * 7 + [_I] * 9 + [_F, _P],
        "repro_paged_prefill_f32_quant": [_P] * 9 + [_I] * 9 + [_F, _P],
        "repro_paged_prefill_split": [_P] * 9 + [_I] * 10 + [_F, _P],
        "repro_paged_prefill_split_quant": [_P] * 11 + [_I] * 10 + [_F, _P],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def prefill_part(dp: int, quant: bool) -> str:
    """The library part (``build``'s suffix) of ``csrc/paged_prefill.cu``
    that holds the tensor-core instance of ``dp`` (a C entry's argument)
    over int8 (``quant``) or bf16 pools: the padded and wide parts hold
    both, the own instances build apart by their pools
    (``build.OWN_PARTS``)."""
    if dp or not quant:
        return part(dp)
    return build.INT8_POOLS


@functools.cache
def _tc_lib(lib_part: str = "") -> ctypes.CDLL:
    """The tensor-core prefill library (``csrc/paged_prefill.cu``) of the
    part ``lib_part`` (:func:`prefill_part`)."""
    lib = build.load("paged_prefill" + lib_part)
    for name, argtypes in (
            ("repro_flash_paged_prefill", [_P] * 7 + [_I] * 11 + [_F, _P]),
            ("repro_flash_paged_prefill_quant",
             [_P] * 9 + [_I] * 11 + [_F, _P]),
            ("repro_paged_prefill_split_tc",
             [_P] * 9 + [_I] * 12 + [_F, _P]),
            ("repro_paged_prefill_split_quant_tc",
             [_P] * 11 + [_I] * 12 + [_F, _P]),
            ("repro_paged_prefill_split_merged_tc",
             [_P] * 11 + [_I] * 11 + [_F, _P]),
            ("repro_paged_prefill_split_quant_merged_tc",
             [_P] * 13 + [_I] * 11 + [_F, _P]),
            ("repro_paged_prefill_tc_info", [_I] * 6 + [_P])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


@functools.cache
def _dec_lib(lib_part: str = "") -> ctypes.CDLL:
    """The one-pass decode library of a bf16 query (``csrc/paged_decode.cu``)."""
    lib = build.load("paged_decode" + lib_part)
    for name, argtypes in (
            ("repro_flash_paged_decode_tc", [_P] * 6 + [_I] * 9 + [_F, _P]),
            ("repro_flash_paged_decode_quant_tc",
             [_P] * 8 + [_I] * 9 + [_F, _P]),
            ("repro_flash_decode_tc", [_P] * 5 + [_I] * 8 + [_F, _P]),
            ("repro_paged_decode_split_tc", [_P] * 8 + [_I] * 9 + [_F, _P]),
            ("repro_paged_decode_split_quant_tc",
             [_P] * 10 + [_I] * 9 + [_F, _P]),
            ("repro_paged_decode_split_merged_tc",
             [_P] * 10 + [_I] * 9 + [_F, _P]),
            ("repro_paged_decode_split_quant_merged_tc",
             [_P] * 12 + [_I] * 9 + [_F, _P]),
            ("repro_paged_decode_tc_info", [_I] * 5 + [_P])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def check_tc_shape(name: str, h: int, hkv: int, d: int) -> None:
    """Raise on a shape the tensor-core prefill kernel does not take: a
    head dim outside 1 .. :data:`~.flash_attention.MAX_HEAD_DIM` (those
    without an instance of their own run on a padded one), or H not a
    multiple of Hkv.  Every group size G = H / Hkv has a row tile: the
    kernel's tiles are runs of a kv head's (position, head) rows
    (:func:`prefill_tiles`)."""
    route(name, torch.bfloat16, d)
    if hkv < 1 or h < hkv or h % hkv:
        raise ValueError(f"{name}: {h} query heads are not a multiple of "
                         f"{hkv} kv heads")


def _prefill_entry(name: str, q: torch.Tensor, hkv: int, quant: bool,
                   block_q: int, block_k: int, rt: Route):
    """The C entry of K4 (K6c with ``quant``) for q's type, the name of
    the kernel it launches and its trailing arguments after D: the
    instance's ``dp``, then for bfloat16 (the tensor-core kernel, its
    shape checked) the tile's rows and keys, and the dtype code (the SIMT
    template for float32)."""
    if q.dtype == torch.bfloat16:
        h, d = q.shape[1], q.shape[3]
        check_tc_shape(name, h, hkv, d)
        lib = _tc_lib(prefill_part(rt.dp, quant))
        entry = "repro_flash_paged_prefill"
        kernel = TC_KERNEL
        tile = (prefill_rows(d, h // hkv, block_q), block_k)
    else:
        lib, entry = _lib(rt.library), "repro_paged_prefill_f32"
        kernel, tile = "paged_prefill_kernel", ()
    return (getattr(lib, entry + ("_quant" if quant else "")), kernel,
            (rt.dp, *tile, _DTYPES[q.dtype]))


#: the instances of the tensor-core prefill kernel, by kind: K4 (bf16
#: pools, one pass), K6c (int8 pools), K5b (bf16 pools, partials) and K6d
#: (int8 pools, partials)
TC_KINDS = ("bf16", "int8", "bf16 split", "int8 split")


def tc_info(d: int, kind: str, nblk: int = 0, *, rows: int = TC_TILE_ROWS,
            block_k: int = TC_TILE_KEYS, dp: int = 0) -> dict[str, int]:
    """What the card makes of the tensor-core prefill instance for head
    dim ``d`` (``dp`` 0), or of the padded one of width ``dp``, of
    ``kind`` (one of :data:`TC_KINDS`) at a tile of
    ``rows`` query rows and ``block_k`` keys: registers per thread, local
    (spill) bytes, dynamic shared memory at ``nblk`` table entries, and
    resident blocks per SM.  Needs the card."""
    out = (ctypes.c_int * 4)()
    lib = _tc_lib(prefill_part(dp, kind.startswith("int8")))
    err = lib.repro_paged_prefill_tc_info(
        d, dp, TC_KINDS.index(kind), nblk, rows, block_k,
        ctypes.addressof(out))
    _raise_on("tc_info", err)
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), out))


#: the instances of the decode kernel, by kind: K3 (bf16 pools), K6a
#: (int8 pools), K2 (its dense mode: bf16 strips), K5a (its partials
#: mode: bf16 pools) and K6b (its partials mode: int8 pools)
DECODE_KINDS = ("bf16", "int8", "bf16 dense", "bf16 split", "int8 split")


def decode_tc_info(d: int, kind: str, nblk: int = 0, *,
                   block_k: int = DECODE_TILE_KEYS, dp: int = 0) -> dict:
    """What the card makes of the bf16 decode instance for head dim ``d``
    (``dp`` 0), or of the padded one of width ``dp``, of ``kind`` (one of
    :data:`DECODE_KINDS`) at ``block_k`` keys a tile:
    registers per thread, local (spill) bytes, dynamic shared memory at
    ``nblk`` table entries (the dense mode stages none), resident CTAs per
    SM, and under ``clusters`` the clusters of each of
    :data:`CLUSTER_SIZES` CTAs the card holds at once.  Needs the card."""
    out = (ctypes.c_int * 8)()
    err = _dec_lib(part(dp)).repro_paged_decode_tc_info(
        d, dp, DECODE_KINDS.index(kind), nblk, block_k, ctypes.addressof(out))
    _raise_on("decode_tc_info", err)
    info = dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm"), out[:4]))
    info["clusters"] = dict(zip(CLUSTER_SIZES, out[4:]))
    return info


def decode_cluster(name: str, q: torch.Tensor, b: int, hkv: int,
                   cluster: int | None, block_k: int = DECODE_TILE_KEYS,
                   quant: bool = False) -> int:
    """The cluster size of a bf16 decode launch (K3, K6a, K2) on q's card
    at ``block_k`` keys a tile over int8 pools with ``quant``, on the
    instance of :func:`~.flash_attention.route`: ``cluster`` if given (one
    of :data:`CLUSTER_SIZES`, else raise), else :func:`cluster_size` of the
    card for that instance's width."""
    if cluster is None:
        index = q.device.index
        cluster = cluster_size(b, hkv, sm_count(
            torch.cuda.current_device() if index is None else index),
            route(name, q.dtype, q.shape[-1]).width, block_k, quant)
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"{name}: cluster size {cluster!r} not in "
                         f"{CLUSTER_SIZES}")
    return cluster


def _decode_entry(name: str, q: torch.Tensor, b: int, hkv: int, quant: bool,
                  cluster: int | None, block_k: int, rt: Route):
    """The C entry of K3 (K6a with ``quant``) for q's type, the name of the
    kernel it launches and its trailing arguments: the instance's ``dp``,
    then for bfloat16 the cluster kernel, its cluster size
    (:func:`decode_cluster`) and key tile, for float32 the SIMT template
    and the dtype code."""
    suffix = "_quant" if quant else ""
    if q.dtype == torch.bfloat16:
        fn = getattr(_dec_lib(rt.library),
                     f"repro_flash_paged_decode{suffix}_tc")
        return fn, DECODE_TC_KERNEL, (rt.dp, decode_cluster(
            name, q, b, hkv, cluster, block_k, quant), block_k)
    fn = getattr(_lib(rt.library), f"repro_flash_paged_decode{suffix}")
    return fn, DECODE_SIMT_KERNEL, (rt.dp, _DTYPES[q.dtype])


def _split_decode_entry(q: torch.Tensor, quant: bool, block_k: int,
                        rt: Route):
    """The C entry of K5a (K6b with ``quant``) for q's type, the name of the
    kernel it launches and its extra trailing arguments: the instance's
    ``dp``, then for bfloat16 the cluster kernel's partials mode and its
    key tile, for float32 the SIMT template and the dtype code."""
    suffix = "_quant" if quant else ""
    if q.dtype == torch.bfloat16:
        return (getattr(_dec_lib(rt.library),
                        f"repro_paged_decode_split{suffix}_tc"),
                DECODE_TC_KERNEL, (rt.dp, block_k))
    return (getattr(_lib(rt.library), f"repro_paged_decode_split{suffix}"),
            DECODE_SIMT_KERNEL, (rt.dp, _DTYPES[q.dtype]))


def _check(name: str, q: torch.Tensor, k_pool: torch.Tensor,
           v_pool: torch.Tensor, page_table: torch.Tensor,
           lens: tuple[torch.Tensor, ...],
           scales: tuple[torch.Tensor, torch.Tensor] | None = None) -> None:
    """Raise on what the kernels do not take.  ``scales`` marks int8 pools:
    then the pools must be int8 and the scales float32 (P, Hkv, psz);
    otherwise q and the pools share one dtype."""
    for t in (q, k_pool, v_pool):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, "
                             f"got one on {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected 4-d q and pools, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: q and pools must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
        if t.numel() == 0:
            raise ValueError(f"{name}: empty tensor {tuple(t.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: q dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    if scales is None:
        if not (q.dtype == k_pool.dtype == v_pool.dtype):
            raise ValueError(f"{name}: q and pool dtypes differ")
    else:
        if not (k_pool.dtype == v_pool.dtype == torch.int8):
            raise ValueError(f"{name}: quantized pools must be int8, got "
                             f"{k_pool.dtype} and {v_pool.dtype}")
        for s in scales:
            if (s.dtype != torch.float32 or s.device != q.device
                    or not s.is_contiguous()
                    or s.shape != k_pool.shape[:3]):
                raise ValueError(
                    f"{name}: k_scale and v_scale must be contiguous "
                    f"float32 {tuple(k_pool.shape[:3])} tensors on q's "
                    f"device, got {s.dtype} {tuple(s.shape)} on {s.device}")
    if not (q.device == k_pool.device == v_pool.device):
        raise ValueError(f"{name}: q and pools are on different devices")
    b, h, _, d = q.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != d:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k_pool "
                         f"{tuple(k_pool.shape)} v_pool "
                         f"{tuple(v_pool.shape)} do not match")
    route(name, q.dtype, d)            # raises above MAX_HEAD_DIM
    if h % k_pool.shape[1]:
        raise ValueError(f"{name}: {h} query heads are not a multiple of "
                         f"{k_pool.shape[1]} kv heads")
    if (page_table.dim() != 2 or page_table.shape[0] != b
            or page_table.shape[1] == 0):
        raise ValueError(f"{name}: page_table must be (B={b}, nblk >= 1), "
                         f"got {tuple(page_table.shape)}")
    for t in (page_table, *lens):
        if (t.dtype != torch.int32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: page_table, start and kv_len must be "
                             "contiguous int32 tensors on q's device")
    for t in lens:
        if t.shape != (b,):
            raise ValueError(f"{name}: start and kv_len must be (B={b},), "
                             f"got {tuple(t.shape)}")


def _num_splits(num_splits: int | None, keys: int, block_k: int) -> int:
    """The split count clamped to the ``block_k``-key tiles of a table of
    ``keys`` slots, as the JAX package's ``_num_splits`` clamps to its
    tile count (a lane's kv_len stays on the card: reading it would sync
    the step with the host)."""
    return max(1, min(int(num_splits or 1), -(-keys // block_k)))


def _check_splits(name: str, num_splits: int) -> None:
    if not isinstance(num_splits, int) or num_splits < 1:
        raise ValueError(f"{name}: num_splits must be an int >= 1, got "
                         f"{num_splits!r}")


def _decode_shape(name: str, q: torch.Tensor, k_pool: torch.Tensor,
                  scale: float | None):
    b, h, one, d = q.shape
    if one != 1:
        raise ValueError(f"{name} takes one query token, got {one}")
    _, hkv, psz, _ = k_pool.shape
    return b, h, hkv, psz, d, float(scale if scale is not None else d ** -0.5)


def _partials(q: torch.Tensor, hkv: int, ns: int):
    """fp32 (m, l, acc) of every split: (B, Hkv, ns, G) and (.., D)."""
    b, h, _, d = q.shape
    kw = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, ns, h // hkv), **kw)
    return m, torch.empty_like(m), torch.empty((b, hkv, ns, h // hkv, d), **kw)


def _prefill_shape(q: torch.Tensor, k_pool: torch.Tensor,
                   scale: float | None):
    b, h, c, d = q.shape
    _, hkv, psz, _ = k_pool.shape
    return b, h, hkv, c, psz, d, float(scale if scale is not None
                                       else d ** -0.5)


def _prefill_partials(q: torch.Tensor, ns: int):
    """fp32 (m, l, acc) of every split of a chunk: (B, H, ns, C) and
    (.., D), the chunk's C rows only."""
    b, h, c, d = q.shape
    kw = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, ns, c), **kw)
    return m, torch.empty_like(m), torch.empty((b, h, ns, c, d), **kw)


#: the arrival counters of the merged split routes, by (device index,
#: stream): int32, zeroed when made, all zero between launches
_ARRIVALS: dict[tuple[int, int], torch.Tensor] = {}


def _arrivals(q: torch.Tensor, tiles: int) -> torch.Tensor:
    """The arrival counters of q's device and current stream, at least
    ``tiles`` of them: made (zeroed) at the first launch on the stream and
    remade, twice as large, when a larger grid needs more.  A launch never
    clears them: its last split of each tile resets that tile's counter,
    so they are all zero between launches (and a captured decode step
    stays replayable)."""
    key = (q.device.index, _stream(q))
    ws = _ARRIVALS.get(key)
    if ws is None or ws.numel() < tiles:
        grown = tiles if ws is None else max(tiles, 2 * ws.numel())
        ws = torch.zeros(grown, dtype=torch.int32, device=q.device)
        _ARRIVALS[key] = ws
    return ws


def arrival_counters() -> list[torch.Tensor]:
    """Every arrival-counter workspace made so far (one per device and
    stream); all zero between launches."""
    return list(_ARRIVALS.values())


def _raise_merged(name: str, err: int, counters: torch.Tensor) -> None:
    """Raise on a merged launch's error, after zeroing its counters (a
    launch that failed may have left some counted)."""
    if err:
        counters.zero_()
        _raise_on(name, err)


def _check_bf16(name: str, q: torch.Tensor) -> None:
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the merged split kernel takes a bfloat16 "
                         f"q, got {q.dtype} (float32: the split kernel and "
                         "split_combine)")


def split_combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """K5c: merge fp32 split partials m, l (BR..., ns, rows) and acc
    (BR..., ns, rows, D) into (BR..., rows, D) of ``dtype``: max-shift
    rescale, then ``acc / l`` with an all-empty row giving exactly 0.  A
    bf16 query's split routes merge in the phase-1 kernel instead (the
    ``*_merged`` entries, bit-equal over the same partials)."""
    *lead, ns, rows, d = acc.shape
    out = torch.empty((*lead, rows, d), dtype=dtype, device=acc.device)
    with torch.cuda.device(acc.device):
        err = _lib().repro_split_combine(
            m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(),
            out.numel() // (rows * d), ns, rows, d, _DTYPES[dtype],
            _stream(acc))
    _raise_on("split_combine", err)
    split_combine.launches += 1
    return out


def _count(wrapper, kernel: str, tile, rt: Route) -> None:
    """One launch of ``wrapper``'s kernel at ``tile`` on the instance
    ``rt`` (``by_width`` counts the launches on padded instances)."""
    wrapper.launches += 1
    wrapper.by_tile[tile] += 1
    wrapper.last_kernel = kernel
    if rt.padded:
        wrapper.by_width[rt.width] += 1


def paged_decode_split(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       kv_len: torch.Tensor, num_splits: int, *,
                       scale: float | None = None,
                       block_k: int | None = None):
    """K5a: phase 1 of split decode over fp pools; returns the fp32
    partials (m, l, acc) of ``num_splits`` splits (checked by the caller),
    (B, Hkv, ns, G) and (.., D).  A bfloat16 q runs the cluster kernel's
    partials mode (split s takes the s-th contiguous share of the lane's
    live ``block_k``-key tiles, 64 by default), a float32 q the SIMT
    template (32-key tiles); ``last_kernel`` names the one launched
    last."""
    name = "paged_decode_split"
    b, h, hkv, psz, d, scale = _decode_shape(name, q, k_pool, scale)
    rt = route(name, q.dtype, q.shape[-1])
    bk = decode_tile(name, q, block_k)
    m, l, acc = _partials(q, hkv, num_splits)
    fn, kernel, extra = _split_decode_entry(q, False, bk, rt)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 page_table.data_ptr(), kv_len.data_ptr(), m.data_ptr(),
                 l.data_ptr(), acc.data_ptr(), b, h, hkv, psz,
                 page_table.shape[1], num_splits, d, *extra, scale,
                 _stream(q))
    _raise_on(name, err)
    _count(paged_decode_split, kernel, bk, rt)
    return m, l, acc


def paged_decode_split_quant(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, page_table: torch.Tensor,
                             kv_len: torch.Tensor, num_splits: int, *,
                             scale: float | None = None,
                             block_k: int | None = None):
    """K6b: :func:`paged_decode_split` over int8 pools and their scales.
    A bfloat16 q runs the cluster kernel's partials mode over int8 pools
    (split s the s-th contiguous share of the lane's live ``block_k``-key
    tiles, as K5a), a float32 q the SIMT template (32-key tiles);
    ``last_kernel`` names the one launched last."""
    name = "paged_decode_split_quant"
    b, h, hkv, psz, d, scale = _decode_shape(name, q, k_pool, scale)
    rt = route(name, q.dtype, q.shape[-1])
    bk = decode_tile(name, q, block_k)
    m, l, acc = _partials(q, hkv, num_splits)
    fn, kernel, extra = _split_decode_entry(q, True, bk, rt)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(),
                 page_table.data_ptr(), kv_len.data_ptr(), m.data_ptr(),
                 l.data_ptr(), acc.data_ptr(), b, h, hkv, psz,
                 page_table.shape[1], num_splits, d, *extra, scale,
                 _stream(q))
    _raise_on(name, err)
    _count(paged_decode_split_quant, kernel, bk, rt)
    return m, l, acc


def _decode_merged(name: str, fn, q: torch.Tensor, pools: tuple,
                   page_table: torch.Tensor, kv_len: torch.Tensor,
                   num_splits: int, scale: float | None,
                   return_partials: bool, block_k: int, rt: Route):
    """One launch of the cluster kernel's partials mode with K5c's merge
    in its epilogue: ``pools`` is (k, v) or (k, v, k_scale, v_scale)."""
    b, h, hkv, psz, d, scale = _decode_shape(name, q, pools[0], scale)
    m, l, acc = _partials(q, hkv, num_splits)
    out = torch.empty_like(q)
    counters = _arrivals(q, b * hkv * -(-(h // hkv) // DECODE_SLAB_ROWS))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), *(t.data_ptr() for t in pools),
                 page_table.data_ptr(), kv_len.data_ptr(), m.data_ptr(),
                 l.data_ptr(), acc.data_ptr(), out.data_ptr(),
                 counters.data_ptr(), b, h, hkv, psz, page_table.shape[1],
                 num_splits, d, rt.dp, block_k, scale, _stream(q))
    _raise_merged(name, err, counters)
    return (out, (m, l, acc)) if return_partials else out


def paged_decode_split_merged(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, page_table: torch.Tensor,
                              kv_len: torch.Tensor, num_splits: int, *,
                              scale: float | None = None,
                              return_partials: bool = False,
                              block_k: int | None = None):
    """K5a with K5c's merge in its epilogue, one launch (bfloat16 q only):
    :func:`paged_decode_split`'s cluster-kernel partials mode at
    ``block_k`` keys a tile, whose last split of each (lane, kv head,
    16-row slab) to finish merges the ns splits' partials into o (B, H, 1,
    D) bf16 as :func:`split_combine` does, bit for bit.  ``num_splits`` is
    checked by the caller.  The partials pass through device memory (L2);
    ``return_partials`` returns them beside o, ``(o, (m, l, acc))``."""
    name = "paged_decode_split_merged"
    _check_bf16(name, q)
    rt = route(name, q.dtype, q.shape[-1])
    bk = decode_tile(name, q, block_k)
    out = _decode_merged(name, _dec_lib(
        rt.library).repro_paged_decode_split_merged_tc, q, (k_pool, v_pool),
        page_table, kv_len, num_splits, scale, return_partials, bk, rt)
    _count(paged_decode_split_merged, DECODE_TC_KERNEL, bk, rt)
    return out


def paged_decode_split_quant_merged(q: torch.Tensor, k_pool: torch.Tensor,
                                    v_pool: torch.Tensor,
                                    k_scale: torch.Tensor,
                                    v_scale: torch.Tensor,
                                    page_table: torch.Tensor,
                                    kv_len: torch.Tensor, num_splits: int, *,
                                    scale: float | None = None,
                                    return_partials: bool = False,
                                    block_k: int | None = None):
    """K6b with K5c's merge in its epilogue: :func:`paged_decode_split_merged`
    over int8 pools and their scales (the partials mode of
    :func:`paged_decode_split_quant`), one launch, bfloat16 q only."""
    name = "paged_decode_split_quant_merged"
    _check_bf16(name, q)
    rt = route(name, q.dtype, q.shape[-1])
    bk = decode_tile(name, q, block_k)
    out = _decode_merged(name, _dec_lib(
        rt.library).repro_paged_decode_split_quant_merged_tc, q,
        (k_pool, v_pool, k_scale, v_scale), page_table, kv_len, num_splits,
        scale, return_partials, bk, rt)
    _count(paged_decode_split_quant_merged, DECODE_TC_KERNEL, bk, rt)
    return out


def _paged_decode(name: str, wrapper, q: torch.Tensor, pools: tuple,
                  page_table: torch.Tensor, kv_len: torch.Tensor,
                  scale: float | None, num_splits: int | None,
                  block_k: int | None, cluster: int | None,
                  cluster_hkv: int | None = None) -> torch.Tensor:
    """The body of :func:`flash_paged_decode` (``pools`` (k, v)) and
    :func:`flash_paged_decode_quant` (``pools`` (k, v, k_scale, v_scale))."""
    quant = len(pools) == 4
    _check(name, q, pools[0], pools[1], page_table, (kv_len,),
           pools[2:] or None)
    b, h, hkv, psz, d, scale = _decode_shape(name, q, pools[0], scale)
    rt = route(name, q.dtype, q.shape[-1])
    bk = decode_tile(name, q, block_k)
    ns = _num_splits(num_splits, page_table.shape[1] * psz, bk)
    if ns > 1 and q.dtype == torch.bfloat16:
        merged = (paged_decode_split_quant_merged if quant
                  else paged_decode_split_merged)
        return merged(q, *pools, page_table, kv_len, ns, scale=scale,
                      block_k=bk)
    if ns > 1:
        split = paged_decode_split_quant if quant else paged_decode_split
        m, l, acc = split(q, *pools, page_table, kv_len, ns, scale=scale,
                          block_k=bk)
        return split_combine(m, l, acc, q.dtype).reshape(b, h, 1, d)
    fn, kernel, last = _decode_entry(name, q, b, cluster_hkv or hkv, quant,
                                     cluster, bk, rt)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), *(t.data_ptr() for t in pools),
                 page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(), b,
                 h, hkv, psz, page_table.shape[1], d, *last, scale,
                 _stream(q))
    _raise_on(name, err)
    _count(wrapper, kernel, bk, rt)
    return out


def flash_paged_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       kv_len: torch.Tensor, *, scale: float | None = None,
                       num_splits: int | None = None,
                       block_k: int | None = None,
                       cluster_hkv: int | None = None,
                       _cluster: int | None = None) -> torch.Tensor:
    """Paged decode: q (B, H, 1, D), pools (P, Hkv, psz, D), page_table
    (B, nblk) and kv_len (B,) int32 on q's device (kv_len is clamped to
    [0, nblk * psz] on the card).  Output like q.  ``block_k`` is the key
    tile, keys per K/V tile (a ring stage; whole pages): for a bfloat16 q
    one of :func:`decode_block_ks` (64 by default), for float32 the SIMT
    template's 32; another raises ``ValueError``.  ``num_splits``
    (clamped to the table's ``block_k``-key tiles) above 1 runs K5a and
    K5c, else K3: for a bfloat16 q the cluster kernel (K5a and K5c: its
    partials mode merging in its epilogue, one launch), for float32 the
    SIMT templates (K5a, then K5c).  ``cluster_hkv`` is the KV-head count
    :func:`cluster_size` sizes the cluster for (default the pools'): a
    tensor-parallel rank, whose pools hold a slice of the heads, passes
    the unsharded count, so that it launches the unsharded cluster on its
    heads.  A head dim with no instance of its own runs on a padded one
    (:func:`~.flash_attention.route`).  ``_cluster`` overrides
    :func:`cluster_size` (tests only)."""
    return _paged_decode("flash_paged_decode", flash_paged_decode, q,
                         (k_pool, v_pool), page_table, kv_len, scale,
                         num_splits, block_k, _cluster, cluster_hkv)


def flash_paged_decode_quant(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, page_table: torch.Tensor,
                             kv_len: torch.Tensor, *,
                             scale: float | None = None,
                             num_splits: int | None = None,
                             block_k: int | None = None,
                             cluster_hkv: int | None = None,
                             _cluster: int | None = None) -> torch.Tensor:
    """:func:`flash_paged_decode` over int8 pools (P, Hkv, psz, D) with
    float32 per-row scales (P, Hkv, psz); q float32 or bfloat16, output
    like q, ``block_k`` and ``cluster_hkv`` as there.  K6a (the cluster kernel for bfloat16,
    as K3), or K6b and K5c for ``num_splits`` above 1 (bfloat16: the
    cluster kernel's partials mode merging in its epilogue, one launch, as
    K5a; float32: the SIMT template, then K5c)."""
    return _paged_decode("flash_paged_decode_quant", flash_paged_decode_quant,
                         q, (k_pool, v_pool, k_scale, v_scale), page_table,
                         kv_len, scale, num_splits, block_k, _cluster,
                         cluster_hkv)


def _prefill_split(name: str, wrapper, q: torch.Tensor, pools: tuple,
                   page_table: torch.Tensor, start: torch.Tensor,
                   kv_len: torch.Tensor, num_splits: int,
                   scale: float | None, block_q: int | None,
                   block_k: int | None):
    """The body of :func:`paged_prefill_split` and
    :func:`paged_prefill_split_quant` (``pools`` with the scales)."""
    _check(name, q, pools[0], pools[1], page_table, (start, kv_len),
           pools[2:] or None)
    _check_splits(name, num_splits)
    b, h, hkv, c, psz, d, scale = _prefill_shape(q, pools[0], scale)
    suffix = "_quant" if len(pools) == 4 else ""
    rt = prefill_route(name, q.dtype, d, h // hkv)
    tile = prefill_tile(name, q, hkv, block_q, block_k)
    if q.dtype == torch.bfloat16:
        check_tc_shape(name, h, hkv, d)
        fn = getattr(_tc_lib(prefill_part(rt.dp, bool(suffix))),
                     f"repro_paged_prefill_split{suffix}_tc")
        kernel = TC_KERNEL
        extra = (prefill_rows(d, h // hkv, tile[0]), tile[1])
    else:
        fn = getattr(_lib(rt.library), f"repro_paged_prefill_split{suffix}")
        kernel, extra = "paged_prefill_kernel", ()
    m, l, acc = _prefill_partials(q, num_splits)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), *(t.data_ptr() for t in pools),
                 page_table.data_ptr(), start.data_ptr(), kv_len.data_ptr(),
                 m.data_ptr(), l.data_ptr(), acc.data_ptr(), b, h, hkv, c,
                 psz, page_table.shape[1], num_splits, d, rt.dp, *extra,
                 _DTYPES[q.dtype], scale, _stream(q))
    _raise_on(name, err)
    _count(wrapper, kernel, tile, rt)
    return m, l, acc


def paged_prefill_split(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        start: torch.Tensor, kv_len: torch.Tensor,
                        num_splits: int, *, scale: float | None = None,
                        block_q: int | None = None,
                        block_k: int | None = None):
    """K5b: phase 1 of split prefill/verify over fp pools; returns the
    fp32 partials (m, l, acc) of ``num_splits`` splits, (B, H, ns, C) and
    (.., D).  A bfloat16 q runs the tensor-core kernel's partials mode
    (its shape checked as K4's) at the tile (``block_q``, ``block_k``) of
    :func:`prefill_tile`, a float32 q the SIMT template; ``last_kernel``
    names the one launched last."""
    return _prefill_split("paged_prefill_split", paged_prefill_split, q,
                          (k_pool, v_pool), page_table, start, kv_len,
                          num_splits, scale, block_q, block_k)


def paged_prefill_split_quant(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, page_table: torch.Tensor,
                              start: torch.Tensor, kv_len: torch.Tensor,
                              num_splits: int, *, scale: float | None = None,
                              block_q: int | None = None,
                              block_k: int | None = None):
    """K6d: :func:`paged_prefill_split` over int8 pools and their scales.
    A bfloat16 q runs the tensor-core kernel's partials mode over int8
    pools (its shape checked as K6c's), a float32 q the SIMT template;
    ``last_kernel`` names the one launched last."""
    return _prefill_split("paged_prefill_split_quant",
                          paged_prefill_split_quant, q,
                          (k_pool, v_pool, k_scale, v_scale), page_table,
                          start, kv_len, num_splits, scale, block_q, block_k)


def _prefill_merged(name: str, wrapper, entry: str, q: torch.Tensor,
                    pools: tuple,
                    page_table: torch.Tensor, start: torch.Tensor,
                    kv_len: torch.Tensor, num_splits: int,
                    scale: float | None, return_partials: bool,
                    block_q: int | None, block_k: int | None):
    """One launch of the tensor-core partials mode with K5c's merge in its
    epilogue: ``pools`` is (k, v) or (k, v, k_scale, v_scale)."""
    _check(name, q, pools[0], pools[1], page_table, (start, kv_len),
           pools[2:] or None)
    _check_splits(name, num_splits)
    _check_bf16(name, q)
    b, h, hkv, c, psz, d, scale = _prefill_shape(q, pools[0], scale)
    check_tc_shape(name, h, hkv, d)
    rt = prefill_route(name, q.dtype, d, h // hkv)
    bq, bk = prefill_tile(name, q, hkv, block_q, block_k)
    rows = prefill_rows(d, h // hkv, bq)
    fn = getattr(_tc_lib(prefill_part(rt.dp, len(pools) == 4)), entry)
    m, l, acc = _prefill_partials(q, num_splits)
    out = torch.empty_like(q)
    # a counter per query tile: rows of the kv head's C x G rows
    counters = _arrivals(q, b * hkv * -(-c * (h // hkv) // rows))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), *(t.data_ptr() for t in pools),
                 page_table.data_ptr(), start.data_ptr(), kv_len.data_ptr(),
                 m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(),
                 counters.data_ptr(), b, h, hkv, c, psz, page_table.shape[1],
                 num_splits, d, rt.dp, rows, bk, scale, _stream(q))
    _raise_merged(name, err, counters)
    _count(wrapper, TC_KERNEL, (bq, bk), rt)
    return (out, (m, l, acc)) if return_partials else out


def paged_prefill_split_merged(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, page_table: torch.Tensor,
                               start: torch.Tensor, kv_len: torch.Tensor,
                               num_splits: int, *, scale: float | None = None,
                               return_partials: bool = False,
                               block_q: int | None = None,
                               block_k: int | None = None):
    """K5b with K5c's merge in its epilogue, one launch (bfloat16 q only):
    :func:`paged_prefill_split`'s tensor-core partials mode at the tile
    (``block_q``, ``block_k``), whose last split of each (lane, kv head, q
    tile) to finish merges the ns splits' partials into o (B, H, C, D)
    bf16 as :func:`split_combine` does, bit for bit.  ``return_partials``
    returns the partials beside o, ``(o, (m, l, acc))``."""
    return _prefill_merged("paged_prefill_split_merged",
                           paged_prefill_split_merged,
                           "repro_paged_prefill_split_merged_tc", q,
                           (k_pool, v_pool), page_table, start, kv_len,
                           num_splits, scale, return_partials, block_q,
                           block_k)


def paged_prefill_split_quant_merged(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     k_scale: torch.Tensor,
                                     v_scale: torch.Tensor,
                                     page_table: torch.Tensor,
                                     start: torch.Tensor, kv_len: torch.Tensor,
                                     num_splits: int, *,
                                     scale: float | None = None,
                                     return_partials: bool = False,
                                     block_q: int | None = None,
                                     block_k: int | None = None):
    """K6d with K5c's merge in its epilogue: :func:`paged_prefill_split_merged`
    over int8 pools and their scales, one launch, bfloat16 q only."""
    return _prefill_merged("paged_prefill_split_quant_merged",
                           paged_prefill_split_quant_merged,
                           "repro_paged_prefill_split_quant_merged_tc",
                           q, (k_pool, v_pool, k_scale, v_scale), page_table,
                           start, kv_len, num_splits, scale, return_partials,
                           block_q, block_k)


def _paged_prefill(name: str, wrapper, q: torch.Tensor, pools: tuple,
                   page_table: torch.Tensor, start: torch.Tensor,
                   kv_len: torch.Tensor, scale: float | None,
                   num_splits: int | None, block_q: int | None,
                   block_k: int | None) -> torch.Tensor:
    """The body of :func:`flash_paged_prefill` (``pools`` (k, v)) and
    :func:`flash_paged_prefill_quant` (with the scales)."""
    quant = len(pools) == 4
    psz = pools[0].shape[2] if pools[0].dim() == 4 else 1
    keys = page_table.shape[-1] * psz
    bk = block_k if block_k is not None else default_block_k(
        q.dtype, q.shape[-1])
    ns = _num_splits(num_splits, keys, bk)
    if ns > 1 and q.dtype == torch.bfloat16:     # checks its inputs
        merged = (paged_prefill_split_quant_merged if quant
                  else paged_prefill_split_merged)
        return merged(q, *pools, page_table, start, kv_len, ns, scale=scale,
                      block_q=block_q, block_k=block_k)
    if ns > 1:              # K5b / K6d check their inputs
        split = paged_prefill_split_quant if quant else paged_prefill_split
        m, l, acc = split(q, *pools, page_table, start, kv_len, ns,
                          scale=scale, block_q=block_q, block_k=block_k)
        return split_combine(m, l, acc, q.dtype)
    _check(name, q, pools[0], pools[1], page_table, (start, kv_len),
           pools[2:] or None)
    b, h, hkv, c, psz, d, scale = _prefill_shape(q, pools[0], scale)
    rt = prefill_route(name, q.dtype, d, h // hkv)
    tile = prefill_tile(name, q, hkv, block_q, block_k)
    fn, kernel, extra = _prefill_entry(name, q, hkv, quant, *tile, rt)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), *(t.data_ptr() for t in pools),
                 page_table.data_ptr(), start.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), b, h, hkv, c, psz, page_table.shape[1], d,
                 *extra, scale, _stream(q))
    _raise_on(name, err)
    _count(wrapper, kernel, tile, rt)
    return out


def flash_paged_prefill(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        start: torch.Tensor, kv_len: torch.Tensor, *,
                        scale: float | None = None,
                        num_splits: int | None = None,
                        block_q: int | None = None,
                        block_k: int | None = None) -> torch.Tensor:
    """Paged chunked prefill: q (B, H, C, D), pools (P, Hkv, psz, D),
    page_table (B, nblk), start and kv_len (B,) int32 on q's device.
    Output like q; rows at positions ``>= kv_len`` are padding.
    ``block_q`` names the tile (:func:`prefill_tiles`: query positions per
    tile, the kernel's row tile ``block_q`` x G query rows, G = H / Hkv;
    where G divides no row tile, the tile's rows) and ``block_k`` counts
    keys per K/V tile (whole pages): one of :func:`prefill_tiles` each,
    :func:`default_block_q` and :func:`default_block_k` by default (128
    keys for a bfloat16 q at its own head dims), the SIMT template's 64
    and 32 for float32; another raises ``ValueError``.
    ``num_splits`` (clamped to the table's ``block_k``-key tiles) above 1
    runs K5b and K5c (for a bfloat16 q in one launch,
    :func:`paged_prefill_split_merged`), else K4: on the tensor cores for
    a bfloat16 q, the SIMT template for float32.  A head dim with no
    instance of its own, or a group size that divides none of the row
    tiles of the head dim's own instance, runs on a padded one
    (:func:`prefill_route`)."""
    return _paged_prefill("flash_paged_prefill", flash_paged_prefill, q,
                          (k_pool, v_pool), page_table, start, kv_len, scale,
                          num_splits, block_q, block_k)


def flash_paged_prefill_quant(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, page_table: torch.Tensor,
                              start: torch.Tensor, kv_len: torch.Tensor, *,
                              scale: float | None = None,
                              num_splits: int | None = None,
                              block_q: int | None = None,
                              block_k: int | None = None) -> torch.Tensor:
    """:func:`flash_paged_prefill` over int8 pools with float32 per-row
    scales (P, Hkv, psz); q float32 or bfloat16, output like q, the tiles
    as there.  K6c (on the tensor cores for bfloat16, as K4), or K6d and
    K5c for ``num_splits`` above 1 (for bfloat16 in one launch,
    :func:`paged_prefill_split_quant_merged`)."""
    return _paged_prefill("flash_paged_prefill_quant",
                          flash_paged_prefill_quant, q,
                          (k_pool, v_pool, k_scale, v_scale), page_table,
                          start, kv_len, scale, num_splits, block_q, block_k)


#: the split routes that merge in the phase-1 kernel (K5c in the epilogue
#: of K5a, K6b, K5b and K6d), bfloat16 q
MERGED = (paged_decode_split_merged, paged_decode_split_quant_merged,
          paged_prefill_split_merged, paged_prefill_split_quant_merged)
#: the kernels of this module, one launch counter each, for counters and
#: reports: K3, K5a, K5c, K6a, K6b, K4, K6c, K5b, K6d, and the merged
#: routes
KERNELS = (flash_paged_decode, paged_decode_split, split_combine,
           flash_paged_decode_quant, paged_decode_split_quant,
           flash_paged_prefill, flash_paged_prefill_quant,
           paged_prefill_split, paged_prefill_split_quant) + MERGED
for _kernel in KERNELS:
    _kernel.launches = 0
    if _kernel is not split_combine:      # one kernel: no route to name
        _kernel.last_kernel = None
        _kernel.by_tile = collections.Counter()
        _kernel.by_width = collections.Counter()

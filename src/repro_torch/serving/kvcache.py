"""KV-cache backends of the serving engine: dense lanes and paged blocks.

* :class:`DenseKVCache` — the JAX package's dense layout: every decode
  lane owns a contiguous ``max_len`` strip in the stacked ``(L, n_lanes,
  Hkv, max_len, Dh)`` caches.  Memory is O(n_lanes * max_len) however
  many tokens are live.
* :class:`PagedKVCache` — a shared pool of ``n_pages`` pages of
  ``page_size`` tokens (per layer) with a per-lane page table mapping
  logical KV blocks to physical pages.  Memory scales with live tokens,
  admission is page allocation, and a preempted sequence's pages swap out
  to host memory and back without re-running prefill.

Page 0 of the pool is the *null page*: idle lanes decode with ``pos = 0``
and a zeroed table row, and padded chunk positions are redirected there,
so their discarded K/V writes never land in a live page.

The paged pool can hold **int8 pages** (``kv_dtype="int8"``): int8 K/V
pools plus float32 per-(page, head, slot)-row scales in
``caches["kv_scale"]``, (L, P, Hkv, psz) with the page axis at position 1
like the pools', so every page-indexed copy (admit, swap) treats scales
and pools alike.  Writes quantize on the way in (admission here, the
chunk scatter and decode append in the model) and the attention kernels
dequantize next to their loads.

Both backends are written in place: admission copies into the caches,
and the model's steps append to them.  Swap handles are host numpy
copies: float32 for fp caches (exact for bf16 and fp32; numpy has no
bfloat16), the native int8 codes plus float32 scales for int8 pools
(bit-exact, half the bytes).  ``swap_compress=True`` packs an fp cache's
swap through :func:`quantize_int8` instead (a quarter of the float32
bytes, int8-round-trip accurate); an int8 pool ignores it.  The prefix
index of the JAX cache is not ported (ROADMAP queue 1, item 5).

The engine talks to both through the same methods::

    admit(lane, prefill_caches, prompt_len) -> bool
    ensure_capacity(lane, pos) -> bool        # page alloc on boundary
    ensure_tokens(lane, n_tokens) -> bool     # chunk-granular (paged)
    swap_out(lane) -> handle                  # preemption
    swap_in(lane, handle) -> bool
    release(lane)
    decode_extra(mask_lanes) -> tuple         # (page_table,) when paged
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..distributed.compression import (dequantize_int8, quantize_int8,
                                       quantize_int8_rows)

NULL_PAGE = 0

KV_DTYPES = ("fp", "int8")


@dataclass
class PackedTree:
    """int8 host copy of a swap handle's arrays, one float32 scale per
    array: the lossy host swap of fp caches (``swap_compress=True``).
    int8 pools never need it: their payload is already int8 + per-row
    scales and round-trips bit-exactly."""

    payload: list[tuple[np.ndarray, float]]

    def host_bytes(self) -> int:
        return sum(q.nbytes + 4 for q, _ in self.payload)


def _pack_tree(arrays) -> PackedTree:
    payload = []
    for a in arrays:
        q, scale = quantize_int8(torch.from_numpy(a))
        payload.append((q.numpy(), float(scale)))
    return PackedTree(payload)


def _unpack_tree(packed: PackedTree) -> tuple[np.ndarray, ...]:
    return tuple(dequantize_int8(torch.from_numpy(q), scale).numpy()
                 for q, scale in packed.payload)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy: int8 stays int8, float32 stays float32, other
    floats (bf16) widen to float32 exactly (numpy has no bfloat16)."""
    if t.dtype not in (torch.int8, torch.float32):
        t = t.float()
    return t.to("cpu", copy=True).numpy()


class DenseKVCache:
    """Per-lane contiguous KV strips."""

    kind = "dense"
    kv_dtype = "fp"

    def __init__(self, model, n_lanes: int, max_len: int,
                 device: str | torch.device, swap_compress: bool = False):
        self.n_lanes = n_lanes
        self.max_len = max_len
        self.swap_compress = swap_compress
        self.caches = model.init_caches(n_lanes, max_len, device=device)

    def _leaves(self) -> tuple[torch.Tensor, ...]:
        return self.caches["kv"]

    # -- engine interface ---------------------------------------------------
    def prefill_len(self, prompt_len: int) -> int:
        return self.max_len

    def admit(self, lane: int, prefill_caches: dict, prompt_len: int) -> bool:
        """Copy batch entry 0 of the prefill caches into ``lane`` (in place;
        positions past the source's length are zeroed)."""
        for full, one in zip(self._leaves(), prefill_caches["kv"]):
            dst, src = full[:, lane], one[:, 0]
            n = min(dst.shape[-2], src.shape[-2])
            dst[..., :n, :].copy_(src[..., :n, :])
            dst[..., n:, :].zero_()
        return True

    def ensure_capacity(self, lane: int, pos: int) -> bool:
        return pos < self.max_len

    def release(self, lane: int) -> None:
        pass

    def decode_extra(self, mask_lanes=()) -> tuple:
        return ()

    def swap_out(self, lane: int) -> tuple[np.ndarray, ...] | PackedTree:
        """Copies of the lane's strips as host float32 numpy (exact for
        bf16 and fp32 caches; numpy has no bfloat16), packed to int8 with
        ``swap_compress``."""
        handle = tuple(_host(full[:, lane]) for full in self._leaves())
        return _pack_tree(handle) if self.swap_compress else handle

    def swap_in(self, lane: int, handle) -> bool:
        if isinstance(handle, PackedTree):
            handle = _unpack_tree(handle)
        for full, host in zip(self._leaves(), handle):
            full[:, lane].copy_(torch.from_numpy(host))
        return True

    # -- accounting ---------------------------------------------------------
    def cache_tokens(self) -> int:
        """Token capacity held in device memory (fixed for dense)."""
        return self.n_lanes * self.max_len

    def pool_bytes(self) -> int:
        """Device bytes held by the cache, from the actual tensor dtypes."""
        return int(sum(t.numel() * t.element_size() for t in self._leaves()))

    def kv_bytes_per_token(self) -> float:
        return self.pool_bytes() / float(self.n_lanes * self.max_len)

    def capacity_tokens(self) -> int:
        return self.n_lanes * self.max_len

    def stats(self) -> dict:
        return {"kind": self.kind, "kv_dtype": self.kv_dtype,
                "cache_tokens": self.cache_tokens(),
                "pool_bytes": self.pool_bytes(),
                "kv_bytes_per_token": self.kv_bytes_per_token(),
                "capacity_tokens": self.capacity_tokens()}


@dataclass
class PageHandle:
    """Host copy of a swapped-out sequence's pages, page axis at position
    1: ``chunks`` holds one array per cache leaf (float32 (L, n_blocks,
    Hkv, psz, Dh) per fp pool; int8 codes and float32 (L, n_blocks, Hkv,
    psz) scales for int8 pools), or ``packed`` their int8 packing
    (``swap_compress``); exactly one of the two is set."""

    chunks: tuple[np.ndarray, ...] | None
    n_blocks: int
    packed: PackedTree | None = None

    def host_bytes(self) -> int:
        if self.packed is not None:
            return self.packed.host_bytes()
        return int(sum(c.nbytes for c in self.chunks))


class PagedKVCache:
    """Paged KV cache: a free-page pool, per-lane page tables and host
    swap space.

    Lane ``i``'s logical block ``b`` lives in physical page ``table[i,
    b]`` of every layer's pool.  Pages are lane-exclusive while allocated
    (refcount 0 or 1: the prefix index that shares pages is not ported),
    so the in-place writes of two lanes never meet outside the null page.
    """

    kind = "paged"

    def __init__(self, model, n_lanes: int, max_len: int, n_pages: int,
                 page_size: int, device: str | torch.device,
                 kv_dtype: str = "fp", swap_compress: bool = False):
        if not model.supports_paged_cache:
            raise ValueError(
                f"arch {model.cfg.name!r} does not support the paged KV "
                "cache; use cache='dense'")
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                             f"(choose from {KV_DTYPES})")
        self.n_lanes = n_lanes
        self.max_len = max_len
        self.page_size = page_size
        self.n_pages = n_pages
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        # int8 pools swap their compact payload losslessly; the flag packs
        # fp pools' swaps only (lossy)
        self.swap_compress = swap_compress and not self.quantized
        self.max_blocks = math.ceil(max_len / page_size)
        self.caches = model.init_paged_caches(n_pages, page_size,
                                              device=device,
                                              quantized=self.quantized)
        self.device = self.caches["kv"][0].device
        self.table = np.zeros((n_lanes, self.max_blocks), np.int32)
        self.n_blocks = [0] * n_lanes
        # page 0 is the null page (idle-lane write sink), never allocated
        self._free = list(range(n_pages - 1, 0, -1))
        self.refcount = np.zeros(n_pages, np.int32)
        self.swap_outs = 0
        self.swap_ins = 0

    def _leaves(self) -> tuple[torch.Tensor, ...]:
        """Every page-indexed leaf: the pools, then an int8 pool's scales."""
        return self.caches["kv"] + self.caches.get("kv_scale", ())

    # -- page pool ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def _alloc(self, n: int) -> list[int] | None:
        """``n`` pages off the free list, or None (nothing taken)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.refcount[pages] = 1
        return pages

    def _free_lane(self, lane: int) -> None:
        for p in self.table[lane, :self.n_blocks[lane]]:
            p = int(p)
            if p != NULL_PAGE:
                self.refcount[p] = 0
                self._free.append(p)
        self.table[lane, :] = NULL_PAGE
        self.n_blocks[lane] = 0

    def _pages_tensor(self, pages) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pages, np.int64),
                               device=self.device)

    # -- engine interface ---------------------------------------------------
    def prefill_len(self, prompt_len: int) -> int:
        """Page-aligned prefill cache length (tight, not max_len)."""
        return math.ceil(prompt_len / self.page_size) * self.page_size

    def can_admit(self, prompt_len: int) -> bool:
        return math.ceil(prompt_len / self.page_size) <= len(self._free)

    def admit(self, lane: int, prefill_caches: dict, prompt_len: int) -> bool:
        """Allocate the prompt's pages and copy batch entry 0 of the
        (L, 1, Hkv, nblk * psz, Dh) prefill caches into them (quantized
        per row, codes and scales, into int8 pools)."""
        nblk = math.ceil(prompt_len / self.page_size)
        pages = self._alloc(nblk)
        if pages is None:
            return False
        idx = self._pages_tensor(pages)
        scales = self.caches.get("kv_scale", (None, None))
        for pool, scale, dense in zip(self.caches["kv"], scales,
                                      prefill_caches["kv"]):
            l, _, hkv, _, d = dense.shape
            rows = dense[:, 0, :, :nblk * self.page_size].reshape(
                l, hkv, nblk, self.page_size, d).transpose(1, 2)
            if scale is None:
                pool[:, idx] = rows.to(pool.dtype)
            else:
                pool[:, idx], scale[:, idx] = quantize_int8_rows(rows)
        self.table[lane, :nblk] = pages
        self.n_blocks[lane] = nblk
        return True

    def ensure_capacity(self, lane: int, pos: int) -> bool:
        """Make sure the page holding ``pos`` is allocated (called before
        every decode step; allocation happens on page-boundary crossings)."""
        if pos >= self.max_len:
            return False
        return self.ensure_tokens(lane, pos + 1)

    def ensure_tokens(self, lane: int, n_tokens: int) -> bool:
        """Chunk-granular growth: allocate pages until the lane covers
        positions ``[0, n_tokens)``.  Pages taken before a failure stay
        with the lane (a retry uses them; release or swap-out frees
        them)."""
        if n_tokens > self.max_len:
            return False
        need = math.ceil(n_tokens / self.page_size)
        while self.n_blocks[lane] < need:
            page = self._alloc(1)
            if page is None:
                return False
            self.table[lane, self.n_blocks[lane]] = page[0]
            self.n_blocks[lane] += 1
        return True

    def truncate_to(self, lane: int, committed_len: int) -> int:
        """Keep the pages covering ``[0, committed_len)`` and free the rest
        (K/V past ``committed_len`` in the last kept page is masked by
        ``kv_len``).  Returns the number of pages freed."""
        keep = math.ceil(committed_len / self.page_size)
        nblk = self.n_blocks[lane]
        if keep >= nblk:
            return 0
        for p in self.table[lane, keep:nblk]:
            self.refcount[int(p)] = 0
            self._free.append(int(p))
        self.table[lane, keep:nblk] = NULL_PAGE
        self.n_blocks[lane] = keep
        return nblk - keep

    def release(self, lane: int) -> None:
        self._free_lane(lane)

    def swap_out(self, lane: int) -> PageHandle:
        """Copy the lane's pages to host memory, then free them.  The copy
        is complete before the pages return to the free list (the pools
        are written in place, so a later admission may reuse them).  int8
        pools copy their codes and scales as they are; fp pools copy
        float32, or pack it to int8 with ``swap_compress``."""
        nblk = self.n_blocks[lane]
        idx = self._pages_tensor(self.table[lane, :nblk])
        chunks = tuple(_host(leaf[:, idx]) for leaf in self._leaves())
        self._free_lane(lane)
        self.swap_outs += 1
        if self.swap_compress:
            return PageHandle(chunks=None, n_blocks=nblk,
                              packed=_pack_tree(chunks))
        return PageHandle(chunks=chunks, n_blocks=nblk)

    def swap_in(self, lane: int, handle: PageHandle) -> bool:
        pages = self._alloc(handle.n_blocks)
        if pages is None:
            return False
        idx = self._pages_tensor(pages)
        chunks = handle.chunks if handle.packed is None \
            else _unpack_tree(handle.packed)
        for pool, chunk in zip(self._leaves(), chunks):
            pool[:, idx] = torch.from_numpy(chunk).to(pool.device, pool.dtype)
        self.table[lane, :handle.n_blocks] = pages
        self.table[lane, handle.n_blocks:] = NULL_PAGE
        self.n_blocks[lane] = handle.n_blocks
        self.swap_ins += 1
        return True

    def decode_extra(self, mask_lanes=()) -> tuple[torch.Tensor]:
        """The page table for the batched decode step, on the pools'
        device.  ``mask_lanes`` (mid-prefill lanes) get a zeroed row, so
        their dummy decode writes land in the null page, not in their
        live prefill pages."""
        tbl = self.table
        if mask_lanes:
            tbl = tbl.copy()
            tbl[list(mask_lanes), :] = NULL_PAGE
        return (torch.from_numpy(tbl).to(self.device),)

    def table_row(self, lane: int) -> torch.Tensor:
        """This lane's logical->physical mapping, (1, nblk), on the pools'
        device, for the single-sequence prefill-chunk step."""
        return torch.from_numpy(self.table[lane:lane + 1].copy()).to(
            self.device)

    # -- accounting ---------------------------------------------------------
    def cache_tokens(self) -> int:
        """Token capacity currently held by live sequences."""
        return self.used_pages * self.page_size

    def pool_bytes(self) -> int:
        """Device bytes held by the pools, from the actual tensor dtypes
        (an int8 pool counts its codes and its float32 scales)."""
        return int(sum(t.numel() * t.element_size() for t in self._leaves()))

    def kv_bytes_per_token(self) -> float:
        return self.pool_bytes() / float(self.n_pages * self.page_size)

    def capacity_tokens(self) -> int:
        """Allocatable token capacity (page 0 is the reserved null page)."""
        return (self.n_pages - 1) * self.page_size

    def stats(self) -> dict:
        return {"kind": self.kind, "page_size": self.page_size,
                "n_pages": self.n_pages, "used_pages": self.used_pages,
                "free_pages": self.free_pages,
                "cache_tokens": self.cache_tokens(),
                "kv_dtype": self.kv_dtype,
                "pool_bytes": self.pool_bytes(),
                "kv_bytes_per_token": self.kv_bytes_per_token(),
                "capacity_tokens": self.capacity_tokens(),
                "swap_outs": self.swap_outs, "swap_ins": self.swap_ins}


def make_kv_cache(model, cache: str, n_lanes: int, max_len: int,
                  device: str | torch.device, n_pages: int | None = None,
                  page_size: int = 16, kv_dtype: str = "fp",
                  swap_compress: bool = False) -> DenseKVCache | PagedKVCache:
    """Build a KV-cache backend by name (``dense`` | ``paged``)."""
    if cache == "dense":
        if kv_dtype != "fp":
            raise ValueError("quantized KV storage is a paged-pool feature; "
                             "use cache='paged'")
        return DenseKVCache(model, n_lanes, max_len, device,
                            swap_compress=swap_compress)
    if cache == "paged":
        if n_pages is None:
            # default pool: every lane at full length (parity with dense)
            n_pages = n_lanes * math.ceil(max_len / page_size) + 1
        return PagedKVCache(model, n_lanes, max_len, n_pages, page_size,
                            device, kv_dtype=kv_dtype,
                            swap_compress=swap_compress)
    raise ValueError(f"unknown cache backend {cache!r} (dense | paged)")

"""KV-cache backends of the serving engine: dense lanes and paged blocks.

* :class:`DenseKVCache` — the JAX package's dense layout: every decode
  lane owns a contiguous ``max_len`` strip in the stacked ``(L, n_lanes,
  Hkv, max_len, Dh)`` caches.  Memory is O(n_lanes * max_len) however
  many tokens are live.  For a Mamba-1 stack a lane owns its layers'
  conv and recurrent state instead, O(n_lanes) whatever ``max_len``; the
  paged pool does not apply to it.
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

With ``prefix_cache=True`` the paged pool is also **content-addressed
and refcounted**, as the JAX package's: every committed full prompt page
carries a chained hash key (:func:`chain_hash`), an index maps key ->
physical page, and an admission whose leading pages hash to indexed
entries is seeded with those pages instead of prefilling them again.
``refcount[p]`` counts the lanes holding page ``p``; a shared or indexed
page is copy-on-write (:meth:`PagedKVCache.cow_writable`).  The pool is
three-state: used (refcount >= 1), cached (refcount 0 but indexed,
reclaimed by the allocator under pressure, LRU by last hit or FIFO by
publish order) and free.  Every release of a page goes through
``_unref``, so a shared page is never freed under another lane.

Tensor-parallel serving (``mesh`` with a ``"model"`` axis of m > 1
ranks) shards the paged pool's KV-head axis: each rank allocates only its
contiguous ``Hkv / m`` slice of every pool and of an int8 pool's scales
(head axis 2 of (L, P, Hkv, psz[, D])), so its pool bytes drop by m, and
admission copies that slice of the prefill caches.  The page tables, the
allocator, the prefix index and the refcounts are host state, the same on
every rank; swaps and copy-on-write act on the local slice.  The dense
lanes do not shard (as in the JAX package).

Both backends are written in place: admission copies into the caches,
the model's steps append to them, and a copy-on-write copies one page of
every pool leaf in place.  Swap handles are host numpy copies: float32
for fp caches (exact for bf16 and fp32; numpy has no bfloat16), the
native int8 codes plus float32 scales for int8 pools (bit-exact, half
the bytes).  ``swap_compress=True`` packs an fp cache's swap through
:func:`quantize_int8` instead (a quarter of the float32 bytes,
int8-round-trip accurate); an int8 pool ignores it.

The engine talks to both through the same methods::

    admit(lane, prefill_caches, prompt_len) -> bool
    ensure_capacity(lane, pos) -> bool        # page alloc on boundary
    swap_out(lane) -> handle                  # preemption
    swap_in(lane, handle) -> bool
    release(lane)
    decode_extra(mask_lanes) -> tuple         # (page_table,) when paged

and, since chunked prefill and speculation need the paged pool, to it
alone through::

    ensure_tokens(lane, n_tokens) -> bool     # chunk-granular growth
    truncate_to(lane, committed_len) -> int   # speculative rollback
"""
from __future__ import annotations

import hashlib
import math
from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np
import torch

from ..distributed.compression import (dequantize_int8, quantize_int8,
                                       quantize_int8_rows)
from ..kernels.ops import mesh_model_axis

NULL_PAGE = 0

PREFIX_EVICTION_POLICIES = ("lru", "fifo")

KV_DTYPES = ("fp", "int8")


def chain_hash(parent: str, tokens: Sequence[int]) -> str:
    """Rolling page key: the page's token ids chained with the parent
    page's key, so a hit on page *b* implies the whole prefix through *b*
    matches (the JAX package's digest, byte for byte)."""
    data = parent + "|" + ",".join(str(int(t)) for t in tokens)
    return hashlib.sha1(data.encode()).hexdigest()


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


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict/tuple cache tree, in a fixed order
    (dict insertion order, then tuple order), as ``jax.tree.leaves``."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def lane_set(full: torch.Tensor, one: torch.Tensor, lane: int) -> None:
    """Write batch entry 0 of ``one`` into lane ``lane`` of the stacked
    ``full`` (batch axis 1), in place and cast to ``full``'s dtype; every
    trailing axis is cropped to the lane's size or zero-padded up to it
    (only the KV sequence axis ever differs), as the JAX package's
    ``_lane_set``.  Other lanes are never written."""
    dst, src = full[:, lane], one[:, 0]
    if tuple(src.shape) != tuple(dst.shape):
        cut = (slice(None),) + tuple(
            slice(0, min(s, d)) for s, d in zip(src.shape[1:],
                                                 dst.shape[1:]))
        dst.zero_()
        dst, src = dst[cut], src[cut]
    dst.copy_(src)


class DenseKVCache:
    """Per-lane contiguous decode state: KV strips for attention stacks,
    the conv and recurrent state of every Mamba-1 layer for SSM stacks.
    Every method works leaf by leaf over the cache tree, whatever it
    holds."""

    kind = "dense"
    kv_dtype = "fp"
    prefix_cache = False

    def __init__(self, model, n_lanes: int, max_len: int,
                 device: str | torch.device, swap_compress: bool = False):
        self.n_lanes = n_lanes
        self.max_len = max_len
        self.swap_compress = swap_compress
        self.caches = model.init_caches(n_lanes, max_len, device=device)

    def _leaves(self) -> list[torch.Tensor]:
        return tree_leaves(self.caches)

    # -- engine interface ---------------------------------------------------
    def prefill_len(self, prompt_len: int) -> int:
        return self.max_len

    def admit(self, lane: int, prefill_caches: dict, prompt_len: int) -> bool:
        """Copy batch entry 0 of the prefill caches into ``lane`` (in place;
        positions past the source's length are zeroed)."""
        for full, one in zip(self._leaves(), tree_leaves(prefill_caches),
                             strict=True):
            lane_set(full, one, lane)
        return True

    def ensure_capacity(self, lane: int, pos: int) -> bool:
        return pos < self.max_len

    def release(self, lane: int) -> None:
        pass

    def decode_extra(self, mask_lanes=()) -> tuple:
        return ()

    def swap_out(self, lane: int) -> tuple[np.ndarray, ...] | PackedTree:
        """Copies of the lane's leaves (KV strips or SSM state) as host
        float32 numpy (exact for bf16 and fp32 caches; numpy has no
        bfloat16), packed to int8 with ``swap_compress``."""
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
    """Paged KV cache: a refcounted page pool, per-lane page tables, host
    swap space and an optional content-addressed prefix index.

    Lane ``i``'s logical block ``b`` lives in physical page ``table[i,
    b]`` of every layer's pool.  Without the prefix cache pages are
    lane-exclusive while allocated; with it, full committed prompt pages
    publish into the index and may be held by several lanes at once, and
    every write into such a page goes through :meth:`cow_writable` first,
    so the in-place writes of two lanes never meet outside the null page.
    """

    kind = "paged"

    def __init__(self, model, n_lanes: int, max_len: int, n_pages: int,
                 page_size: int, device: str | torch.device,
                 kv_dtype: str = "fp", swap_compress: bool = False,
                 prefix_cache: bool = False, prefix_min_match: int = 1,
                 prefix_eviction: str = "lru", mesh=None):
        if not model.supports_paged_cache:
            raise ValueError(
                f"arch {model.cfg.name!r} does not support the paged KV "
                "cache; use cache='dense'")
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                             f"(choose from {KV_DTYPES})")
        model_axis = mesh_model_axis(mesh)
        self.heads = slice(None)          # this rank's KV heads
        if model_axis > 1:
            hkv, h = model.cfg.n_kv_heads, model.cfg.n_heads
            if hkv % model_axis or h % model_axis:
                raise ValueError(
                    f"tensor-parallel paged serving shards the KV-head "
                    f"axis: arch {model.cfg.name!r} has kv_heads={hkv} "
                    f"(q heads {h}), not divisible by the mesh's 'model' "
                    f"axis of size {model_axis} — choose a mesh whose "
                    f"model axis divides the head counts, or drop --mesh")
            self.heads = mesh.head_slice(hkv)
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
                                              quantized=self.quantized,
                                              model_axis=model_axis)
        self.device = self.caches["kv"][0].device
        self.table = np.zeros((n_lanes, self.max_blocks), np.int32)
        self.n_blocks = [0] * n_lanes
        # page 0 is the null page (idle-lane write sink), never allocated
        self._free = list(range(n_pages - 1, 0, -1))
        self.refcount = np.zeros(n_pages, np.int32)   # lane refs per page
        self.swap_outs = 0
        self.swap_ins = 0
        # -- prefix cache (content-addressed index over full pages) --------
        self.prefix_cache = prefix_cache
        self.prefix_min_match = max(1, int(prefix_min_match))
        self.set_prefix_policy(eviction=prefix_eviction)
        self._index: dict[str, int] = {}      # chain hash -> physical page
        self._page_key: dict[int, str] = {}   # physical page -> chain hash
        self._last_hit: dict[int, int] = {}   # page -> last match/publish
        self._pub_order: dict[int, int] = {}  # page -> publish tick (FIFO)
        self._chain: list[tuple[str, int]] = [("", 0)] * n_lanes
        self._tick = 0
        self._n_cached = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.hit_tokens = 0                   # prompt tokens never re-run
        self.pages_saved = 0                  # seeded, not prefilled again
        self.cow_copies = 0
        self.index_evictions = 0

    def _leaves(self) -> tuple[torch.Tensor, ...]:
        """Every page-indexed leaf: the pools, then an int8 pool's scales."""
        return self.caches["kv"] + self.caches.get("kv_scale", ())

    # -- page pool ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Refcount-zero pages kept resident by the prefix index: the
        reclaimable state between used and free (a maintained counter)."""
        return self._n_cached

    @property
    def used_pages(self) -> int:
        """Pages held by at least one lane (a shared page counts once)."""
        return (self.n_pages - 1) - len(self._free) - self._n_cached

    def _alloc(self, n: int) -> list[int] | None:
        """``n`` private pages (refcount 1 each): free pages first, then
        refcount-zero index entries evicted by the reuse policy; None
        (nothing taken) when the pool cannot supply them."""
        if n > len(self._free) + self._n_cached:
            return None
        pages = []
        for _ in range(n):
            p = self._free.pop() if self._free else self._evict_one()
            self.refcount[p] = 1
            pages.append(p)
        return pages

    def _evict_one(self) -> int:
        """Reclaim one refcount-zero index entry: ``lru`` evicts the page
        hit longest ago, ``fifo`` the oldest published."""
        order = self._last_hit if self.prefix_eviction == "lru" \
            else self._pub_order
        victim = min((p for p in self._page_key if self.refcount[p] == 0),
                     key=lambda p: order.get(p, 0))
        self._unpublish(victim)
        self.index_evictions += 1
        return victim

    def _unpublish(self, p: int) -> None:
        key = self._page_key.pop(p, None)
        if key is not None:
            if self._index.get(key) == p:
                del self._index[key]
            if self.refcount[p] == 0:
                self._n_cached -= 1
        self._last_hit.pop(p, None)
        self._pub_order.pop(p, None)

    def _unref(self, p: int) -> None:
        """Drop one lane's reference.  A page returns to the free list only
        at refcount zero and outside the index; an indexed one stays
        resident as cached capacity until the allocator evicts it."""
        p = int(p)
        if p == NULL_PAGE:
            return
        self.refcount[p] -= 1
        if self.refcount[p] <= 0:
            if p in self._page_key:
                self._n_cached += 1
            else:
                self._free.append(p)

    def _free_lane(self, lane: int) -> None:
        for p in self.table[lane, :self.n_blocks[lane]]:
            self._unref(p)
        self.table[lane, :] = NULL_PAGE
        self.n_blocks[lane] = 0
        self._chain[lane] = ("", 0)

    def _pages_tensor(self, pages) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pages, np.int64),
                               device=self.device)

    # -- engine interface ---------------------------------------------------
    def prefill_len(self, prompt_len: int) -> int:
        """Page-aligned prefill cache length (tight, not max_len)."""
        return math.ceil(prompt_len / self.page_size) * self.page_size

    def can_admit(self, prompt_len: int) -> bool:
        return math.ceil(prompt_len / self.page_size) \
            <= len(self._free) + self._n_cached

    def admit(self, lane: int, prefill_caches: dict, prompt_len: int) -> bool:
        """Allocate the prompt's pages and copy batch entry 0 of the
        (L, 1, Hkv, nblk * psz, Dh) prefill caches into them (quantized
        per row, codes and scales, into int8 pools); under a mesh, this
        rank's slice of the heads."""
        nblk = math.ceil(prompt_len / self.page_size)
        pages = self._alloc(nblk)
        if pages is None:
            return False
        idx = self._pages_tensor(pages)
        scales = self.caches.get("kv_scale", (None, None))
        for pool, scale, dense in zip(self.caches["kv"], scales,
                                      prefill_caches["kv"]):
            dense = dense[:, :, self.heads]
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
        """Speculative rollback: keep the pages covering ``[0,
        committed_len)`` and drop the lane's reference to the rest (K/V
        past ``committed_len`` in the last kept page is masked by
        ``kv_len`` and overwritten by the next accepted token).  A page
        another lane or the index still holds is not freed.  Returns the
        number of pages the lane gave up."""
        keep = math.ceil(committed_len / self.page_size)
        nblk = self.n_blocks[lane]
        if keep >= nblk:
            return 0
        for p in self.table[lane, keep:nblk]:
            self._unref(p)
        self.table[lane, keep:nblk] = NULL_PAGE
        self.n_blocks[lane] = keep
        return nblk - keep

    def release(self, lane: int) -> None:
        self._free_lane(lane)

    def swap_out(self, lane: int) -> PageHandle:
        """Copy the lane's pages to host memory, then drop its references
        (shared pages stay with their other holders).  The copy is
        complete before the pages return to the pool (the pools are
        written in place, so a later admission may reuse them).  int8
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
        self._chain[lane] = ("", 0)   # resumed prefill re-walks the chain
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

    # -- prefix cache: match / seed / publish / copy-on-write --------------
    def set_prefix_policy(self, min_match: int | None = None,
                          eviction: str | None = None) -> None:
        """Reuse-policy knobs (the JAX package tunes them in its
        ``PrefixPolicy`` region; here they are plain arguments):
        ``min_match`` — the fewest consecutive page hits a match needs to
        be used; ``eviction`` — ``lru`` | ``fifo`` reclaim order of
        refcount-zero index entries."""
        if min_match is not None:
            self.prefix_min_match = max(1, int(min_match))
        if eviction is not None:
            if eviction not in PREFIX_EVICTION_POLICIES:
                raise ValueError(
                    f"unknown prefix eviction policy {eviction!r} "
                    f"(choose from {PREFIX_EVICTION_POLICIES})")
            self.prefix_eviction = eviction

    def match_prefix(self, prompt: Sequence[int]) -> tuple[list[int], str]:
        """The prompt's full pages walked through the chained-hash index:
        (matched physical pages, chain key of the last hit), cut to empty
        below ``min_match`` pages.  A pure lookup: no refcount moves."""
        pages: list[int] = []
        chain = ""
        if not self.prefix_cache:
            return pages, chain
        psz = self.page_size
        for b in range(len(prompt) // psz):
            key = chain_hash(chain, prompt[b * psz:(b + 1) * psz])
            p = self._index.get(key)
            if p is None:
                break
            pages.append(p)
            chain = key
        if len(pages) < self.prefix_min_match:
            return [], ""
        return pages, chain

    def seed_prefix(self, lane: int, prompt: Sequence[int]) -> int:
        """Admission-time reuse: point the lane's leading table rows at
        the matched shared pages (refcount + 1 each) instead of prefilling
        them.  Returns the position prefill starts at: the cached token
        count, capped at ``len(prompt) - 1`` so the last prompt position
        is always recomputed (its logits give the first token).  For a
        fully cached page-aligned prompt that position lies inside the
        last shared page, and the write goes through the copy-on-write
        of :meth:`cow_writable`."""
        if not self.prefix_cache:
            return 0
        self._tick += 1
        self.prefix_lookups += 1
        pages, chain = self.match_prefix(prompt)
        if not pages:
            self._chain[lane] = ("", 0)
            return 0
        for p in pages:
            if self.refcount[p] == 0:         # cached -> used
                self._n_cached -= 1
            self.refcount[p] += 1
            self._last_hit[p] = self._tick
        self.table[lane, :len(pages)] = np.asarray(pages, np.int32)
        self.table[lane, len(pages):] = NULL_PAGE
        self.n_blocks[lane] = len(pages)
        self._chain[lane] = (chain, len(pages))
        start = min(len(pages) * self.page_size, len(prompt) - 1)
        self.prefix_hits += 1
        self.hit_tokens += start
        self.pages_saved += len(pages)
        return start

    def publish_prefix(self, lane: int, prompt: Sequence[int],
                       upto: int) -> None:
        """Publish the lane's newly full committed prompt pages (``upto``
        prompt tokens are committed) into the index.  Only full pages
        publish; a key already indexed (another lane published the same
        prefix first) keeps its entry and this lane's copy stays
        private."""
        if not self.prefix_cache:
            return
        psz = self.page_size
        chain, done = self._chain[lane]
        n_full = min(int(upto), len(prompt)) // psz
        for b in range(done, n_full):
            key = chain_hash(chain, prompt[b * psz:(b + 1) * psz])
            self._tick += 1
            p = self._index.get(key)
            if p is None:
                p = int(self.table[lane, b])
                if p != NULL_PAGE:
                    self._index[key] = p
                    self._page_key[p] = key
                    self._pub_order[p] = self._tick
            self._last_hit[p] = self._tick
            chain = key
        self._chain[lane] = (chain, max(done, n_full))

    def cow_writable(self, lane: int, pos: int) -> bool:
        """Copy-on-write guard: make the page holding ``pos`` private to
        the lane before a K/V write lands there.  A page another lane
        holds, or one backing an index entry (a write would make its
        content disagree with its key), is copied into a fresh page, in
        place on every pool leaf (k, v and an int8 pool's scales), and
        the lane drops its reference to the original.  Returns False only
        when the pool cannot supply the copy (page pressure)."""
        if not self.prefix_cache:
            return True
        blk = int(pos) // self.page_size
        if blk >= self.n_blocks[lane]:
            return True                  # not allocated yet: fresh
        p = int(self.table[lane, blk])
        if p == NULL_PAGE:
            return True
        if self.refcount[p] <= 1 and p not in self._page_key:
            return True                  # already private
        fresh = self._alloc(1)
        if fresh is None:
            return False
        q = fresh[0]
        for leaf in self._leaves():
            leaf[:, q] = leaf[:, p]
        self._unref(p)
        self.table[lane, blk] = q
        self.cow_copies += 1
        return True

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
        out = {"kind": self.kind, "page_size": self.page_size,
               "n_pages": self.n_pages, "used_pages": self.used_pages,
               "free_pages": self.free_pages,
               "cached_pages": self.cached_pages,
               "cache_tokens": self.cache_tokens(),
               "kv_dtype": self.kv_dtype,
               "pool_bytes": self.pool_bytes(),
               "kv_bytes_per_token": self.kv_bytes_per_token(),
               "capacity_tokens": self.capacity_tokens(),
               "swap_outs": self.swap_outs, "swap_ins": self.swap_ins}
        if self.prefix_cache:
            out["prefix"] = {
                "lookups": self.prefix_lookups,
                "hits": self.prefix_hits,
                "hit_tokens": self.hit_tokens,
                "pages_saved": self.pages_saved,
                "cached_pages": self.cached_pages,
                "cow_copies": self.cow_copies,
                "evictions": self.index_evictions,
                "min_match": self.prefix_min_match,
                "eviction": self.prefix_eviction,
            }
        return out


def make_kv_cache(model, cache: str, n_lanes: int, max_len: int,
                  device: str | torch.device, n_pages: int | None = None,
                  page_size: int = 16, kv_dtype: str = "fp",
                  swap_compress: bool = False, prefix_cache: bool = False,
                  prefix_min_match: int = 1, prefix_eviction: str = "lru",
                  mesh=None) -> DenseKVCache | PagedKVCache:
    """Build a KV-cache backend by name (``dense`` | ``paged``); ``mesh``
    shards the paged pool's KV heads (the dense lanes refuse one)."""
    if cache == "dense":
        if prefix_cache:
            raise ValueError("prefix caching shares pages of the paged "
                             "pool; use cache='paged'")
        if kv_dtype != "fp":
            raise ValueError("quantized KV storage is a paged-pool feature; "
                             "use cache='paged'")
        if mesh_model_axis(mesh) > 1:
            raise ValueError(
                "tensor-parallel serving shards the paged page pools; "
                "use cache='paged' with --mesh")
        return DenseKVCache(model, n_lanes, max_len, device,
                            swap_compress=swap_compress)
    if cache == "paged":
        if n_pages is None:
            # default pool: every lane at full length (parity with dense)
            n_pages = n_lanes * math.ceil(max_len / page_size) + 1
        return PagedKVCache(model, n_lanes, max_len, n_pages, page_size,
                            device, kv_dtype=kv_dtype,
                            swap_compress=swap_compress,
                            prefix_cache=prefix_cache,
                            prefix_min_match=prefix_min_match,
                            prefix_eviction=prefix_eviction, mesh=mesh)
    raise ValueError(f"unknown cache backend {cache!r} (dense | paged)")

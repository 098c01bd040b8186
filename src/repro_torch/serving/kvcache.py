"""KV-cache backend of the serving engine: dense per-lane strips.

:class:`DenseKVCache` is the JAX package's dense layout: every decode lane
owns a contiguous ``max_len`` strip in the stacked ``(L, n_lanes, Hkv,
max_len, Dh)`` caches.  Memory is O(n_lanes * max_len) however many
tokens are live.  Admission copies the prefill strip into the lane in
place, and the model's decode step appends to the caches in place.  A
preempted lane swaps out to host numpy and back.

The paged pool is the next slice of the port (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import numpy as np
import torch

_PAGED = ("the paged KV pool is not ported yet: ROADMAP queue 1, item 3 "
          "(paged KV serving)")


class DenseKVCache:
    """Per-lane contiguous KV strips."""

    kind = "dense"
    kv_dtype = "fp"

    def __init__(self, model, n_lanes: int, max_len: int,
                 device: str | torch.device):
        self.n_lanes = n_lanes
        self.max_len = max_len
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

    def swap_out(self, lane: int) -> tuple[np.ndarray, ...]:
        """Copies of the lane's strips as host float32 numpy (exact for
        bf16 and fp32 caches; numpy has no bfloat16)."""
        return tuple(full[:, lane].to("cpu", torch.float32, copy=True).numpy()
                     for full in self._leaves())

    def swap_in(self, lane: int, handle: tuple[np.ndarray, ...]) -> bool:
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


def make_kv_cache(model, cache: str, n_lanes: int, max_len: int,
                  device: str | torch.device) -> DenseKVCache:
    if cache == "dense":
        return DenseKVCache(model, n_lanes, max_len, device)
    if cache == "paged":
        raise NotImplementedError(_PAGED)
    raise ValueError(f"unknown cache backend {cache!r} (dense | paged)")

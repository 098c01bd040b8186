"""Model facade: one object per architecture over the decoder functions of
:mod:`.transformer`.  Every method is a function of (params, inputs);
``init`` and ``init_caches`` take the device to allocate on."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ArchConfig
from ..device import resolve
from . import transformer


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def init(self, seed: int = 0, device: str | torch.device = "cuda") -> dict:
        """Random weights from ``seed`` (a ``torch.Generator`` on ``device``;
        they do not equal the JAX package's draws — load those through
        :func:`repro_torch.bridge.params_from_jax`)."""
        return transformer.init_params(self.cfg, seed, resolve(device))

    def prefill(self, params: dict, tokens: torch.Tensor,
                max_len: int | None = None, use_kernel: bool | None = None):
        return transformer.prefill(params, tokens, self.cfg, max_len,
                                   use_kernel=use_kernel)

    def decode_step(self, params: dict, caches: dict, token: torch.Tensor,
                    pos: torch.Tensor, use_kernel: bool | None = None):
        return transformer.decode_step(params, caches, token, pos, self.cfg,
                                       use_kernel=use_kernel)

    def init_caches(self, batch: int, max_len: int,
                    device: str | torch.device = "cuda") -> dict:
        return transformer.init_caches(self.cfg, batch, max_len,
                                       resolve(device))

    # -- paged KV (serving) ------------------------------------------------
    @property
    def supports_paged_cache(self) -> bool:
        return transformer.supports_paged_cache(self.cfg)

    def init_paged_caches(self, n_pages: int, page_size: int,
                          device: str | torch.device = "cuda",
                          quantized: bool = False) -> dict:
        return transformer.init_paged_caches(self.cfg, n_pages, page_size,
                                             resolve(device), quantized)

    def paged_decode_step(self, params: dict, caches: dict,
                          page_table: torch.Tensor, token: torch.Tensor,
                          pos: torch.Tensor, use_kernel: bool | None = None,
                          num_splits: int | None = None):
        return transformer.paged_decode_step(params, caches, page_table,
                                             token, pos, self.cfg,
                                             use_kernel=use_kernel,
                                             num_splits=num_splits)

    def paged_prefill_step(self, params: dict, caches: dict,
                           page_table: torch.Tensor, tokens: torch.Tensor,
                           start: torch.Tensor, kv_len: torch.Tensor,
                           logit_idx: torch.Tensor,
                           use_kernel: bool | None = None):
        return transformer.paged_prefill_step(params, caches, page_table,
                                              tokens, start, kv_len,
                                              logit_idx, self.cfg,
                                              use_kernel=use_kernel)


def build_model(cfg: ArchConfig) -> Model:
    transformer.check_supported(cfg)
    return Model(cfg)

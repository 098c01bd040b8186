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

    def forward(self, params: dict, tokens: torch.Tensor,
                use_kernel: bool | None = None):
        """tokens (B, S) -> (final-normed hidden (B, S, d), aux_loss)."""
        return transformer.forward(params, tokens, self.cfg,
                                   use_kernel=use_kernel)

    def head_logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """float32 logits of :meth:`forward`'s hidden states."""
        return transformer.head_logits(params, hidden, self.cfg)

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

    # -- speculative decoding (serving) ------------------------------------
    def speculative_step(self, params: dict, caches: dict,
                         page_table: torch.Tensor, tokens: torch.Tensor,
                         start: torch.Tensor, kv_len: torch.Tensor,
                         num_splits: int | None = None,
                         use_kernel: bool | None = None):
        """Verify one candidate chunk per lane; full (B, C, V) logits."""
        return transformer.speculative_step(params, caches, page_table,
                                            tokens, start, kv_len, self.cfg,
                                            num_splits=num_splits,
                                            use_kernel=use_kernel)

    def draft_model(self, depth_frac: float = 0.5,
                    width_frac: float = 1.0) -> "Model":
        """The reduced-depth (and optionally width) draft of this arch."""
        return build_model(self.cfg.draft_config(depth_frac, width_frac))

    def slice_draft_params(self, params: dict, draft_model: "Model") -> dict:
        """Self-speculative draft weights: views of the target's leading
        layers."""
        return transformer.slice_draft_params(params, self.cfg,
                                              draft_model.cfg)


def build_model(cfg: ArchConfig) -> Model:
    transformer.check_supported(cfg)
    return Model(cfg)

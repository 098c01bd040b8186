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


def build_model(cfg: ArchConfig) -> Model:
    transformer.check_supported(cfg)
    return Model(cfg)

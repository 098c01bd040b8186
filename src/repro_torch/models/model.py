"""Model facade: one object per architecture, dispatching to the decoder
functions of :mod:`.transformer` or, for an encoder-decoder arch
(whisper), to :mod:`.encdec`.  Every method is a function of (params,
inputs); ``init`` and ``init_caches`` take the device to allocate on."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ArchConfig
from ..device import resolve
from . import encdec, transformer


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def init(self, seed: int = 0, device: str | torch.device = "cuda",
             dtype: torch.dtype | str | None = None) -> dict:
        """Random weights from ``seed`` (a ``torch.Generator`` on ``device``;
        they do not equal the JAX package's draws — load those through
        :func:`repro_torch.bridge.params_from_jax`), held in ``dtype``
        (default ``compute_dtype``; a trainer passes ``param_dtype``)."""
        init = (encdec.init_params if self.cfg.is_encoder_decoder
                else transformer.init_params)
        return init(self.cfg, seed, resolve(device), dtype)

    def train_loss(self, params: dict, batch: dict,
                   use_kernel: bool | None = None) -> torch.Tensor:
        """The mean next-token cross entropy of ``batch`` (tokens,
        labels, optional loss_mask and frontend_embeds), float32, the
        MoE's aux loss added; differentiable through every route of the
        kernels it runs (K1, K9)."""
        if self.cfg.is_encoder_decoder:
            return encdec.train_loss(params, batch, self.cfg,
                                     use_kernel=use_kernel)
        return transformer.train_loss(params, batch, self.cfg,
                                      use_kernel=use_kernel)

    def forward(self, params: dict, tokens: torch.Tensor,
                use_kernel: bool | None = None,
                frontend_embeds: torch.Tensor | None = None):
        """tokens (B, S) -> (final-normed hidden (B, S', d), aux_loss);
        with ``frontend_embeds`` (B, F, d), a vision arch's patches, S' =
        F + S, else S.  An encoder-decoder arch takes its encoder's
        frames (B, Se, d) as ``frontend_embeds`` and returns its decoder's
        teacher-forced hidden (B, S, d) with a zero aux loss."""
        if self.cfg.is_encoder_decoder:
            if frontend_embeds is None:
                raise ValueError(
                    "forward without frontend_embeds is decoder-only: the "
                    f"encoder-decoder {self.cfg.name!r} needs its encoder's "
                    "frames (frontend_embeds) for its teacher-forced pass")
            enc = encdec.encode(params, frontend_embeds, self.cfg,
                                use_kernel)
            hidden = encdec.decode_train(params, tokens, enc, self.cfg,
                                         use_kernel)
            return hidden, torch.zeros((), dtype=torch.float32,
                                       device=hidden.device)
        return transformer.forward(params, tokens, self.cfg,
                                   use_kernel=use_kernel,
                                   frontend_embeds=frontend_embeds)

    def head_logits(self, params: dict, hidden: torch.Tensor) -> torch.Tensor:
        """float32 logits of :meth:`forward`'s hidden states."""
        return transformer.head_logits(params, hidden, self.cfg)

    def prefill(self, params: dict, tokens: torch.Tensor,
                max_len: int | None = None, use_kernel: bool | None = None,
                frontend_embeds: torch.Tensor | None = None, mesh=None):
        """(last-token logits, caches).  An encoder-decoder arch takes its
        encoder's input, ``frontend_embeds`` (B, Se, d); a decoder arch
        with a vision frontend (pixtral-12b) may take its patch embeddings
        (B, F, d), put in front of the prompt (the caches then hold F + S
        positions); a decoder arch without a frontend raises
        ``ValueError`` when given any.  ``mesh`` sends a decoder's long
        causal prompts around the ring (tensor-parallel serving)."""
        if self.cfg.is_encoder_decoder:
            if frontend_embeds is None:
                raise ValueError(f"{self.cfg.name!r} is an encoder-decoder: "
                                 "prefill needs frontend_embeds")
            return encdec.prefill(params, tokens, self.cfg, frontend_embeds,
                                  max_len, use_kernel=use_kernel)
        return transformer.prefill(params, tokens, self.cfg, max_len,
                                   use_kernel=use_kernel,
                                   frontend_embeds=frontend_embeds,
                                   mesh=mesh)

    def decode_step(self, params: dict, caches: dict, token: torch.Tensor,
                    pos: torch.Tensor, use_kernel: bool | None = None):
        step = (encdec.decode_step if self.cfg.is_encoder_decoder
                else transformer.decode_step)
        return step(params, caches, token, pos, self.cfg,
                    use_kernel=use_kernel)

    def init_caches(self, batch: int, max_len: int,
                    device: str | torch.device = "cuda") -> dict:
        init = (encdec.init_caches if self.cfg.is_encoder_decoder
                else transformer.init_caches)
        return init(self.cfg, batch, max_len, resolve(device))

    # -- paged KV (serving) ------------------------------------------------
    @property
    def supports_paged_cache(self) -> bool:
        return (not self.cfg.is_encoder_decoder
                and transformer.supports_paged_cache(self.cfg))

    def init_paged_caches(self, n_pages: int, page_size: int,
                          device: str | torch.device = "cuda",
                          quantized: bool = False,
                          model_axis: int = 1) -> dict:
        """Page pools; ``model_axis`` > 1 allocates one tensor-parallel
        rank's slice of the KV heads."""
        if self.cfg.is_encoder_decoder:
            raise ValueError("paged KV cache is decoder-only")
        return transformer.init_paged_caches(self.cfg, n_pages, page_size,
                                             resolve(device), quantized,
                                             model_axis)

    def paged_decode_step(self, params: dict, caches: dict,
                          page_table: torch.Tensor, token: torch.Tensor,
                          pos: torch.Tensor, use_kernel: bool | None = None,
                          num_splits: int | None = None, mesh=None):
        return transformer.paged_decode_step(params, caches, page_table,
                                             token, pos, self.cfg,
                                             use_kernel=use_kernel,
                                             num_splits=num_splits,
                                             mesh=mesh)

    def paged_prefill_step(self, params: dict, caches: dict,
                           page_table: torch.Tensor, tokens: torch.Tensor,
                           start: torch.Tensor, kv_len: torch.Tensor,
                           logit_idx: torch.Tensor,
                           use_kernel: bool | None = None, mesh=None):
        return transformer.paged_prefill_step(params, caches, page_table,
                                              tokens, start, kv_len,
                                              logit_idx, self.cfg,
                                              use_kernel=use_kernel,
                                              mesh=mesh)

    # -- speculative decoding (serving) ------------------------------------
    def speculative_step(self, params: dict, caches: dict,
                         page_table: torch.Tensor, tokens: torch.Tensor,
                         start: torch.Tensor, kv_len: torch.Tensor,
                         num_splits: int | None = None,
                         use_kernel: bool | None = None, mesh=None):
        """Verify one candidate chunk per lane; full (B, C, V) logits."""
        return transformer.speculative_step(params, caches, page_table,
                                            tokens, start, kv_len, self.cfg,
                                            num_splits=num_splits,
                                            use_kernel=use_kernel,
                                            mesh=mesh)

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

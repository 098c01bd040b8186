"""Architecture configuration schema (the port's own copy).

The fields and derived properties follow the JAX package's ``ArchConfig``
exactly, so a config built here describes the same network; only the
parts the dense serving path reads are kept as methods.  ``reduced()``
returns the CPU test configuration of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def pad_to(x: int, mult: int) -> int:
    return x + (-x) % mult


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 => d_model // n_heads
    act: str = "silu"
    norm: str = "rms"           # rms | ln
    rope_theta: float = 10000.0
    use_rope: bool = True
    qkv_bias: bool = False
    tie_embeddings: bool = False
    window: int | None = None   # sliding-window attention
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512
    # --- SSM ---
    ssm_version: int = 0        # 0 = none, 1 = mamba1, 2 = mamba2
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    d_inner: int = 0            # 0 => 2 * d_model
    # --- hybrid (zamba2): shared attention block period ---
    attn_period: int = 0        # 0 = never
    # --- encoder-decoder (whisper) ---
    n_encoder_layers: int = 0
    # --- modality frontend stub ---
    frontend: str = "none"      # none | audio | vision
    frontend_seq: int = 0       # stub embedding length (frames / patches)
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, 128)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    def layer_kinds(self) -> list[str]:
        """Per-decoder-layer block kind."""
        if self.family in ("dense", "vlm"):
            return ["attn_mlp"] * self.n_layers
        if self.family == "moe":
            return ["attn_moe"] * self.n_layers
        if self.family == "ssm":
            return ["mamba1"] * self.n_layers
        if self.family == "hybrid":
            return ["mamba2"] * self.n_layers
        if self.family == "encdec":
            return ["encdec_layer"] * self.n_layers
        raise ValueError(self.family)

    def reduced(self) -> "ArchConfig":
        """CPU test config of the same family (float32 compute and cache,
        so prefill/decode parity checks compare algorithms, not bf16
        rounding)."""
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_group_size=16,
            capacity_factor=4.0 if self.n_experts else self.capacity_factor,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_version else 64,
            ssm_chunk=8,
            d_inner=128 if self.ssm_version else 0,
            attn_period=2 if self.attn_period else 0,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            window=min(self.window, 32) if self.window else None,
            frontend_seq=8 if self.frontend != "none" else 0,
            compute_dtype="float32",
            cache_dtype="float32",
        )

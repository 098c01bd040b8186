"""Architecture configuration schema and input-shape registry (the
port's own copy).

The fields and derived properties follow the JAX package's ``ArchConfig``
exactly, so a config built here describes the same network; only the
parts the serving, training and static-AT paths read are kept as methods
(``param_count`` and ``active_param_count`` size the weights and the
analytic step costs).  ``reduced()`` returns the CPU test configuration
of the same family, ``draft_config()`` the speculative draft.
:data:`SHAPES` holds the four input shapes (``ShapeConfig``) that the
cells of static AT pair with each arch.
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
    def ssm_d_inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, 128)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k?  SSM / hybrid / SWA qualify."""
        return self.ssm_version > 0 or self.window is not None

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

    def n_shared_attn_applications(self) -> int:
        """How often the shared attention block runs (zamba2: after
        every ``attn_period``-th layer)."""
        if self.attn_period <= 0:
            return 0
        return len(range(self.attn_period - 1, self.n_layers,
                         self.attn_period))

    def param_count(self) -> int:
        """Analytic parameter count (weight bytes = this x the dtype's)."""
        d, ff, v = self.d_model, self.d_ff, self.padded_vocab
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        attn = d * hq + 2 * d * hkv + hq * d
        mlp = 3 * d * ff
        n = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            n += self.n_layers * (attn + mlp)
        elif self.family == "moe":
            experts = 3 * d * ff * self.n_experts
            shared = 3 * d * ff * self.n_shared_experts
            router = d * self.n_experts
            n += self.n_layers * (attn + experts + shared + router)
        elif self.family == "ssm":
            di, ns = self.ssm_d_inner, self.ssm_state
            r = max(d // 16, 1)
            m1 = (d * 2 * di + di * (r + 2 * ns) + r * di + di * d
                  + 4 * di + di * ns)
            n += self.n_layers * m1
        elif self.family == "hybrid":
            di, ns = self.ssm_d_inner, self.ssm_state
            h = self.ssm_n_heads
            m2 = d * (2 * di + 2 * ns + h) + di * d + (di + 2 * ns) * 4
            n += self.n_layers * m2
            n += attn + mlp        # one shared attention block
        elif self.family == "encdec":
            n += self.n_encoder_layers * (attn + mlp)
            n += self.n_layers * (2 * attn + mlp)   # self + cross
        return n

    def active_param_count(self) -> int:
        """Parameters a token activates (MoE: its top-k and the shared
        experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, ff, v = self.d_model, self.d_ff, self.padded_vocab
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        attn = d * hq + 2 * d * hkv + hq * d
        active_experts = 3 * d * ff * (self.top_k + self.n_shared_experts)
        router = d * self.n_experts
        n = v * d * (1 if self.tie_embeddings else 2)
        n += self.n_layers * (attn + active_experts + router)
        return n

    def draft_config(self, depth_frac: float = 0.5,
                     width_frac: float = 1.0) -> "ArchConfig":
        """Speculative-decoding draft: the same family at reduced depth
        (and optionally width), sharing the target's vocabulary.

        The default keeps the width, so the draft can be self-speculative:
        its weights are the target's leading layers
        (:func:`repro_torch.models.transformer.slice_draft_params`) with
        the embedding and head shared.  ``width_frac < 1`` describes an
        independently initialised draft (its own geometry, nothing
        shared)."""
        def scale(n: int, frac: float, floor: int = 1) -> int:
            return max(floor, int(n * frac))

        kw: dict = {"name": f"{self.name}-draft",
                    "n_layers": scale(self.n_layers, depth_frac)}
        if width_frac < 1.0:
            kw.update(d_model=scale(self.d_model, width_frac, 32),
                      n_heads=scale(self.n_heads, width_frac),
                      d_ff=scale(self.d_ff, width_frac, 32),
                      d_head=self.head_dim)       # keep head geometry
            kw["n_kv_heads"] = max(1, min(self.n_kv_heads, kw["n_heads"]))
        return dataclasses.replace(self, **kw)

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


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

"""moonshot-v1-16b-a3b (Moonlight) — MoE 64e top-6 + 2 shared experts.
[hf:moonshotai/Moonlight-16B-A3B; hf]

48L d_model=2048 16H (kv=16) d_ff=1408 (per expert) vocab=163840.
DeepSeek-V3-style fine-grained experts; on one card every expert is
local (the JAX package shards them over the model axis).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    n_experts=64, top_k=6, n_shared_experts=2,
)

"""llama4-scout-17b-16e — MoE 16e top-1 + 1 shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

48L d_model=5120 40H (kv=8) d_ff=8192(per-expert) vocab=202048.  40 query
heads over 8 kv heads (G 5: the prefill kernel's 80-row tile); top-1
routing with a shared expert per Llama-4.  107.8 B parameters, 215.5 GB
in bf16: one card holds a depth cut of it (``chip_smoke.py`` serves 12
of the 48 layers).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, rope_theta=500000.0,
    n_experts=16, top_k=1, n_shared_experts=1,
)

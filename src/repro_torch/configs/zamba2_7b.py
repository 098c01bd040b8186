"""zamba2-7b — Mamba-2 backbone + one shared attention block.
[arXiv:2411.15242; unverified]

81 Mamba-2 layers, d_model=3584, d_inner=7168 (112 SSM heads of 64),
state 64, chunk 128; a shared transformer block (32 q / 32 kv heads: D
112, G 1; a 4096-key sliding window; a gated SiLU MLP of 14336) applied
after every 6th layer, 13 times, with the same weights each time.
vocab=32000.  The JAX package's config, field for field.  Its decode
state is O(1) in the sequence for the SSM layers and O(window) for the
shared block's ring buffers, so it is served from dense lanes, never the
paged pool.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_version=2, ssm_state=64, ssm_head_dim=64, ssm_chunk=128,
    d_inner=7168, attn_period=6, window=4096,
)

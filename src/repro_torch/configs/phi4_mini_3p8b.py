"""phi4-mini-3.8b — dense, RoPE SwiGLU GQA.  [arXiv:2412.08905; hf]

32L d_model=3072 24H (kv=8) d_ff=8192 vocab=200064.  24 heads do not divide
the 16-way model axis — the flagship `select according estimated` layout
case (tp vs fsdp attention).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200064, tie_embeddings=True,
)

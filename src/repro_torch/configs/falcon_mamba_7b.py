"""falcon-mamba-7b — attention-free Mamba-1.  [arXiv:2410.05355; unverified]

64L d_model=4096 d_ff=0 vocab=65024 ssm_state=16, d_inner=8192.
The JAX package's config, field for field.  Decode keeps O(1)-in-sequence
recurrent state, so it is served from dense lanes, never the paged pool.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=0, vocab_size=65024,
    ssm_version=1, ssm_state=16, d_inner=8192,
)

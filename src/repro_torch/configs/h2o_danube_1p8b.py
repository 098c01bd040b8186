"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]

24L d_model=2560 32H (kv=8) d_ff=6912 vocab=32000, window 4096.  Head dim
80 (G 4).  The SWA ring-buffer KV cache is O(window): a lane holds the
last 4096 keys at slot ``pos % 4096`` (``models/attention.py``), on
dense lanes only, as in the JAX package.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32000, window=4096,
)

"""whisper-tiny — encoder-decoder audio backbone (conv frontend stubbed).
[arXiv:2212.04356; unverified]

4 + 4 layers, d_model=384, 6 heads (kv=6: D 64, G 1), d_ff=1536,
vocab=51865 (padded to 51968).  LayerNorm, GELU MLP, no RoPE
(sinusoidal encoder positions, learned decoder positions), tied
embeddings.  The JAX package's config, field for field: the audio conv
stem is a stub, so the encoder takes (B, 1500, d) frame embeddings.  It
runs through the model entry points (``prefill`` with the frames, then
``decode_step``); the serving engine refuses it, as the JAX engine
passes no frames.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    n_encoder_layers=4, norm="ln", act="gelu", use_rope=False,
    qkv_bias=True, tie_embeddings=True,
    frontend="audio", frontend_seq=1500,
)

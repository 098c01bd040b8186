"""pixtral-12b — VLM: pixtral-ViT frontend (stub) + mistral-nemo decoder.
[hf:mistralai/Pixtral-12B-2409; unverified]

40L d_model=5120 32H (kv=8: D 160, G 4) d_ff=14336 vocab=131072.  The
JAX package's config, field for field.  The vision tower is a stub: 1024
precomputed patch embeddings, projected by ``frontend_proj`` and put in
front of the text, reach the decoder through ``Model.prefill(
frontend_embeds=...)`` (and ``Model.forward``); the serving engine serves
it text-only, as the JAX engine does.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=131072, rope_theta=1000000000.0,
    frontend="vision", frontend_seq=1024,
)

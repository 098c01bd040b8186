"""Encoder-decoder model (whisper-tiny's backbone), the JAX package's
``models/encdec.py`` function for function.

The audio conv frontend is a stub, as in the JAX package: the encoder
takes precomputed frame embeddings (B, Se, d) through a learned
projection.  Encoder: sinusoidal positions, then per layer LayerNorm ->
bidirectional self-attention (K1, not causal) -> residual -> LayerNorm ->
GELU MLP -> residual, and a final LayerNorm.  Decoder: learned positions
(8192 rows), then per layer causal self-attention (K1 at prefill, K2 in
decode), cross attention over the encoder states (K1 with the encoder's
key length at prefill, K2 over the cross cache in decode) and the GELU
MLP, each behind a LayerNorm and with a residual; the head is the tied
``embed.T`` with float32 logits.  No RoPE anywhere.

The parameter tree keeps the JAX names (``frontend_proj``,
``enc_layers``, ``enc_ln``, ``embed``, ``pos_embed``, ``dec_layers``,
``dec_ln``), the layer leaves stacked (L, ...), so
:func:`repro_torch.bridge.params_from_jax` carries it as it is.  The
serving engine does not take this model (the JAX engine passes no
frames to prefill): it runs through :func:`prefill` and
:func:`decode_step`.  Training runs :func:`train_loss`: the encoder,
then :func:`decode_train` (the teacher-forced decoder pass, K1 for the
causal self attention and for the cross attention over the encoder's
key length) and the chunked cross entropy through the tied head
``embed.T``, whose gradient joins the embedding's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import attention as attn
from .layers import (apply_mlp, chunked_cross_entropy, dense_init,
                     embed_init, init_mlp, layer_norm, sinusoidal_positions)
from .sharding_ctx import (constrain, constrain_layer_params, for_compute,
                           is_dtensor, stack_layers, take_rows)
from .transformer import (_cast, _layer, _unstack, torch_dtype,
                          weights_dtype)

#: rows of the decoder's learned position table (a decode position is
#: taken modulo it)
POS_ROWS = 8192


def _acfg(cfg: ArchConfig, causal: bool) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, causal=causal, use_rope=False,
        qkv_bias=cfg.qkv_bias)


def _ln(p: dict, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, p["w"], p["b"])


def _ln_init(lead: tuple[int, ...], d: int, **kw) -> dict:
    return {"w": torch.ones(lead + (d,), **kw),
            "b": torch.zeros(lead + (d,), **kw)}


def init_params(cfg: ArchConfig, seed: int = 0, device="cpu",
                dtype: torch.dtype | str | None = None) -> dict:
    """Random weights from ``seed`` with the JAX package's distributions,
    held on ``device`` in ``dtype`` (default ``compute_dtype``; a trainer
    passes ``param_dtype``)."""
    dtype = weights_dtype(cfg, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, kw = cfg.d_model, dict(dtype=dtype, device=device)
    enc, dec = (cfg.n_encoder_layers,), (cfg.n_layers,)
    return {
        "frontend_proj": dense_init(gen, d, d, **kw),
        "enc_layers": {
            "ln1": _ln_init(enc, d, **kw),
            "attn": attn.init_attention(gen, _acfg(cfg, False), lead=enc,
                                        **kw),
            "ln2": _ln_init(enc, d, **kw),
            "mlp": init_mlp(gen, d, cfg.d_ff, gated=False, lead=enc, **kw)},
        "enc_ln": _ln_init((), d, **kw),
        "embed": embed_init(gen, cfg.padded_vocab, d, **kw),
        "pos_embed": embed_init(gen, POS_ROWS, d, **kw),
        "dec_layers": {
            "ln1": _ln_init(dec, d, **kw),
            "self_attn": attn.init_attention(gen, _acfg(cfg, True),
                                             lead=dec, **kw),
            "ln_x": _ln_init(dec, d, **kw),
            "cross_attn": attn.init_cross_attention(gen, _acfg(cfg, False),
                                                    lead=dec, **kw),
            "ln2": _ln_init(dec, d, **kw),
            "mlp": init_mlp(gen, d, cfg.d_ff, gated=False, lead=dec, **kw)},
        "dec_ln": _ln_init((), d, **kw),
    }


def encode(params: dict, frames: torch.Tensor, cfg: ArchConfig,
           use_kernel: bool | None = None) -> torch.Tensor:
    """frames (B, Se, d) stub embeddings -> encoder states (B, Se, d)."""
    dtype = torch_dtype(cfg.compute_dtype)
    x = frames.to(dtype) @ for_compute(params["frontend_proj"]).to(dtype)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(dtype)
    x = constrain(x, "hidden")
    acfg = _acfg(cfg, False)
    for lp in _unstack(_cast(params["enc_layers"], dtype),
                       cfg.n_encoder_layers):
        lp = constrain_layer_params(lp)
        x = x + constrain(attn.full(lp["attn"], _ln(lp["ln1"], x), acfg,
                                    use_kernel=use_kernel), "hidden")
        x = x + constrain(apply_mlp(lp["mlp"], _ln(lp["ln2"], x),
                                    act="gelu"), "hidden")
    return _ln(_cast(params["enc_ln"], dtype), x)


def _embed(params: dict, tokens: torch.Tensor, pos: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    """Token embeddings plus the learned positions ``pos % POS_ROWS``."""
    dtype = torch_dtype(cfg.compute_dtype)
    pe = params["pos_embed"]
    return (take_rows(params["embed"], tokens).to(dtype)
            + take_rows(pe, pos % pe.shape[0]).to(dtype))


def decode_train(params: dict, tokens: torch.Tensor, enc: torch.Tensor,
                 cfg: ArchConfig,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """The teacher-forced decoder pass: tokens (B, S) over the encoder
    states ``enc`` (B, Se, d) -> final-normed hidden (B, S, d)."""
    dtype = torch_dtype(cfg.compute_dtype)
    s = tokens.shape[1]
    x = _embed(params, tokens, torch.arange(s, device=tokens.device), cfg)
    x = constrain(x, "hidden")
    sa, ca = _acfg(cfg, True), _acfg(cfg, False)
    for lp in _unstack(_cast(params["dec_layers"], dtype), cfg.n_layers):
        lp = constrain_layer_params(lp)
        x = x + constrain(attn.full(lp["self_attn"], _ln(lp["ln1"], x), sa,
                                    use_kernel=use_kernel), "hidden")
        k, v = attn.cross_kv(lp["cross_attn"], enc, ca)
        x = x + constrain(attn.cross_full(
            lp["cross_attn"], _ln(lp["ln_x"], x), k, v, ca,
            use_kernel=use_kernel), "hidden")
        x = x + constrain(apply_mlp(lp["mlp"], _ln(lp["ln2"], x),
                                    act="gelu"), "hidden")
    return _ln(_cast(params["dec_ln"], dtype), x)


def train_loss(params: dict, batch: dict, cfg: ArchConfig,
               n_loss_chunks: int = 8,
               use_kernel: bool | None = None) -> torch.Tensor:
    """batch: frontend_embeds (B, Se, d), tokens and labels (B, S),
    optional loss_mask (B, S) -> the mean cross entropy of the decoder's
    next-token logits through the tied head (float32)."""
    enc = encode(params, batch["frontend_embeds"], cfg, use_kernel)
    hidden = decode_train(params, batch["tokens"], enc, cfg, use_kernel)
    b, s, d = hidden.shape
    w = for_compute(params["embed"].T).to(torch_dtype(cfg.compute_dtype))
    mask = batch.get("loss_mask")
    mask = mask.reshape(-1).float() if mask is not None else None
    return chunked_cross_entropy(constrain(hidden.reshape(b * s, d),
                                           "logits_hidden"), w,
                                 batch["labels"].reshape(-1), mask,
                                 n_chunks=n_loss_chunks)


def _logits(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The final LayerNorm and the tied head on (B, d) -> float32 (B, V)."""
    dtype = torch_dtype(cfg.compute_dtype)
    x = _ln(_cast(params["dec_ln"], dtype), x)
    return (x @ for_compute(params["embed"].T).to(dtype)).float()


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device="cpu") -> dict:
    """Zeroed decode state: {"kv": (K, V)} the decoder's self-attention
    caches, each (L, batch, Hkv, max_len, Dh), and {"cross_kv": (K, V)}
    the cross caches, each (L, batch, Hkv, Se, Dh) with Se =
    ``frontend_seq`` (or 128), all in ``cache_dtype``."""
    dtype = torch_dtype(cfg.cache_dtype)
    lead = (cfg.n_layers,)
    se = cfg.frontend_seq or 128
    cross = lead + (batch, cfg.n_kv_heads, se, cfg.head_dim)
    return {"kv": attn.init_cache(batch, _acfg(cfg, True), max_len, dtype,
                                  device, lead=lead),
            "cross_kv": (torch.zeros(cross, dtype=dtype, device=device),
                         torch.zeros(cross, dtype=dtype, device=device))}


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            frontend_embeds: torch.Tensor, max_len: int | None = None,
            use_kernel: bool | None = None):
    """Encode ``frontend_embeds`` (B, Se, d), then run the decoder over the
    prompt ``tokens`` (B, S); returns (last-token logits (B, V) float32,
    caches): the self K/V zero-padded to ``max_len`` (>= S) and the cross
    K/V of every layer (L, B, Hkv, Se, Dh)."""
    b, s = tokens.shape
    max_len = max(max_len or s, s)
    enc = encode(params, frontend_embeds, cfg, use_kernel)
    x = constrain(_embed(params, tokens, torch.arange(s, device=tokens.device),
                         cfg), "hidden")
    sa, ca = _acfg(cfg, True), _acfg(cfg, False)
    dtype, cdt = torch_dtype(cfg.compute_dtype), torch_dtype(cfg.cache_dtype)
    sharded = is_dtensor(x)
    if sharded:             # over a mesh: each layer's K/V kept, then stacked
        kept = {"k": [], "v": [], "xk": [], "xv": []}
    else:
        sk, sv = attn.init_cache(b, sa, max_len, cdt, tokens.device,
                                 lead=(cfg.n_layers,))
        cross = (cfg.n_layers, b, cfg.n_kv_heads, enc.shape[1], cfg.head_dim)
        xk = torch.empty(cross, dtype=cdt, device=tokens.device)
        xv = torch.empty_like(xk)
    layers = _cast(params["dec_layers"], dtype)
    for i in range(cfg.n_layers):
        lp = constrain_layer_params(_layer(layers, i))
        h, (k, v) = attn.full(lp["self_attn"], _ln(lp["ln1"], x), sa,
                              return_cache=True, use_kernel=use_kernel)
        x = x + constrain(h, "hidden")
        ck, cv = attn.cross_kv(lp["cross_attn"], enc, ca)
        if sharded:
            for key, t in (("k", k), ("v", v), ("xk", ck), ("xv", cv)):
                kept[key].append(t)
        else:
            sk[i, :, :, :s] = k
            sv[i, :, :, :s] = v
            xk[i], xv[i] = ck, cv
        x = x + constrain(attn.cross_full(
            lp["cross_attn"], _ln(lp["ln_x"], x), ck, cv, ca,
            use_kernel=use_kernel), "hidden")
        x = x + constrain(apply_mlp(lp["mlp"], _ln(lp["ln2"], x),
                                    act="gelu"), "hidden")
    if sharded:
        def slots(t):
            return F.pad(t.to(cdt), (0, 0, 0, max_len - t.shape[2]))

        sk, sv = (stack_layers(kept[key], slots) for key in ("k", "v"))
        xk, xv = (stack_layers(kept[key], lambda t: t.to(cdt))
                  for key in ("xk", "xv"))
    return _logits(params, x[:, -1], cfg), {"kv": (sk, sv),
                                             "cross_kv": (xk, xv)}


def decode_step(params: dict, caches: dict, token: torch.Tensor,
                pos: torch.Tensor, cfg: ArchConfig,
                use_kernel: bool | None = None):
    """token (B, 1) int, pos (B,) int -> (logits (B, V) float32, caches).
    The self caches get slot ``pos`` in place (``kv_len = pos + 1``); the
    cross caches are read whole."""
    x = constrain(_embed(params, token, pos[:, None], cfg), "hidden")
    sa, ca = _acfg(cfg, True), _acfg(cfg, False)
    sk, sv = caches["kv"]
    xk, xv = caches["cross_kv"]
    layers = _cast(params["dec_layers"], torch_dtype(cfg.compute_dtype))
    for i in range(cfg.n_layers):
        lp = constrain_layer_params(_layer(layers, i))
        h, _, _ = attn.decode(lp["self_attn"], _ln(lp["ln1"], x), sk[i],
                              sv[i], pos, sa, use_kernel=use_kernel)
        x = x + constrain(h, "hidden")
        x = x + constrain(attn.cross_decode(
            lp["cross_attn"], _ln(lp["ln_x"], x), xk[i], xv[i], ca,
            use_kernel=use_kernel), "hidden")
        x = x + constrain(apply_mlp(lp["mlp"], _ln(lp["ln2"], x),
                                    act="gelu"), "hidden")
    return _logits(params, x[:, 0], cfg), caches

"""Decoder LM assembly for the ``attn_mlp`` layer kind (the dense archs).

Layers are stacked along a leading axis as in the JAX package (every
leaf of ``params["layers"]`` is (L, ...)), and the JAX ``lax.scan`` over
them is a Python loop here.  Per layer: ``rms_norm`` -> attention ->
residual -> ``rms_norm`` -> gated-SiLU MLP -> residual; then the final
norm and the LM head, whose logits are float32 over ``padded_vocab``.

Weights may be held in any float dtype: every use casts them to
``compute_dtype`` first, which is what the JAX package does, so holding
them in ``compute_dtype`` already (as :func:`init_params` and the bridge
do) is the same arithmetic at half the memory for bf16.

Modes: ``prefill`` (whole prompt, K/V collected into caches padded to
``max_len``) and ``decode_step`` (one token per lane against the caches,
written in place); on the paged KV pool ``paged_prefill_step`` (one
prompt chunk per lane) and ``paged_decode_step``, which write into the
layer-stacked page pools in place (and into their per-row scales, for
int8 pools).  Other layer kinds are not ported yet.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import attention as attn
from .layers import apply_mlp, dense_init, embed_init, init_mlp, rms_norm

_OTHER_FAMILIES = "ROADMAP queue 1, item 8 (the other model families)"


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what this slice of the port does not run."""
    kind = cfg.layer_kinds()[0]
    if kind != "attn_mlp":
        raise NotImplementedError(
            f"layer kind {kind!r} ({cfg.name}) is not ported yet: "
            f"{_OTHER_FAMILIES}")
    for what, unsupported in (
            ("the frontend stub", cfg.frontend != "none"),
            ("layer norm", cfg.norm != "rms"),
            (f"activation {cfg.act!r}", cfg.act != "silu"),
            ("sliding-window decode", cfg.window is not None)):
        if unsupported:
            raise NotImplementedError(
                f"{what} ({cfg.name}) is not ported yet: {_OTHER_FAMILIES}")


def attn_config(cfg: ArchConfig) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, rope_theta=cfg.rope_theta, window=cfg.window,
        causal=True, use_rope=cfg.use_rope, qkv_bias=cfg.qkv_bias)


def _cast(tree, dtype: torch.dtype):
    """Every tensor leaf of a nested dict as ``dtype`` (no copy when it
    already is)."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _layer(tree, i: int):
    """Layer ``i`` of the (L, ...) stacked leaves (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(cfg: ArchConfig, seed: int = 0, device="cpu") -> dict:
    """Random weights from ``seed`` with the JAX package's distributions,
    held in ``compute_dtype`` on ``device``."""
    check_supported(cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    lead, d = (cfg.n_layers,), cfg.d_model
    kw = dict(dtype=dtype, device=device)
    layers = {
        "norm1_w": torch.ones(lead + (d,), **kw),
        "norm2_w": torch.ones(lead + (d,), **kw),
        "attn": attn.init_attention(gen, attn_config(cfg), lead=lead, **kw),
        "mlp": init_mlp(gen, d, cfg.d_ff, lead=lead, **kw),
    }
    p = {"embed": embed_init(gen, cfg.padded_vocab, d, **kw),
         "layers": layers,
         "final_norm_w": torch.ones((d,), **kw)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.padded_vocab, **kw)
    return p


def embed_tokens(params: dict, tokens: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, d) in compute dtype."""
    return params["embed"][tokens].to(torch_dtype(cfg.compute_dtype))


def lm_head_weight(params: dict, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Final norm + LM head on (B, d) hidden states -> float32 (B, V)."""
    dtype = torch_dtype(cfg.compute_dtype)
    x = rms_norm(x, params["final_norm_w"].to(dtype))
    return (x @ lm_head_weight(params, cfg).to(dtype)).float()


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device="cpu") -> dict:
    """Stacked per-layer KV caches {"kv": (K, V)}, each
    (L, batch, Hkv, max_len, Dh) in ``cache_dtype``."""
    check_supported(cfg)
    return {"kv": attn.init_cache(batch, attn_config(cfg), max_len,
                                  torch_dtype(cfg.cache_dtype), device,
                                  lead=(cfg.n_layers,))}


def decode_step(params: dict, caches: dict, token: torch.Tensor,
                pos: torch.Tensor, cfg: ArchConfig,
                use_kernel: bool | None = None):
    """token (B, 1) int, pos (B,) int -> (logits (B, V), caches).

    The caches are updated in place (slot ``pos`` of every layer) and
    returned."""
    check_supported(cfg)
    x = embed_tokens(params, token, cfg)
    acfg = attn_config(cfg)
    layers = _cast(params["layers"], torch_dtype(cfg.compute_dtype))
    ck, cv = caches["kv"]
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        h, _, _ = attn.decode(lp["attn"], rms_norm(x, lp["norm1_w"]),
                              ck[i], cv[i], pos, acfg, use_kernel=use_kernel)
        x = x + h
        x = x + apply_mlp(lp["mlp"], rms_norm(x, lp["norm2_w"]))
    return _logits(params, x[:, 0], cfg), caches


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            max_len: int | None = None, use_kernel: bool | None = None):
    """Forward over the prompt; returns (last-token logits, caches).

    ``max_len`` sizes the returned KV caches (>= prompt length; the
    positions past the prompt are zero) so decode steps have room to
    append."""
    check_supported(cfg)
    x = embed_tokens(params, tokens, cfg)
    b, s, _ = x.shape
    acfg = attn_config(cfg)
    max_len = max(max_len or s, s)
    caches = init_caches(cfg, b, max_len, device=x.device)
    ck, cv = caches["kv"]
    layers = _cast(params["layers"], torch_dtype(cfg.compute_dtype))
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        h, (k, v) = attn.full(lp["attn"], rms_norm(x, lp["norm1_w"]), acfg,
                              return_cache=True, use_kernel=use_kernel)
        ck[i, :, :, :s] = k
        cv[i, :, :, :s] = v
        x = x + h
        x = x + apply_mlp(lp["mlp"], rms_norm(x, lp["norm2_w"]))
    return _logits(params, x[:, -1], cfg), caches


def supports_paged_cache(cfg: ArchConfig) -> bool:
    """Paged KV applies to plain attention stacks (no SSM state, no
    sliding-window ring buffer, no shared-attention block)."""
    return (cfg.layer_kinds()[0] in ("attn_mlp", "attn_moe")
            and cfg.attn_period == 0 and cfg.window is None)


def init_paged_caches(cfg: ArchConfig, n_pages: int, page_size: int,
                      device="cpu", quantized: bool = False) -> dict:
    """Layer-stacked page pools {"kv": (K, V)}, each (L, P, Hkv, psz, Dh)
    in ``cache_dtype``: O(n_pages * page_size) tokens of KV in total,
    which lanes borrow through their page tables.

    ``quantized=True`` makes int8 pools and adds ``"kv_scale"``: (L, P,
    Hkv, psz) float32 per-row scales for k and v, zeros, with the page
    axis at position 1 like the pools', so page-indexed copies (admit,
    swap) treat scales and pools alike."""
    if not supports_paged_cache(cfg):
        raise ValueError(
            f"arch {cfg.name!r} does not support the paged KV cache "
            "(needs a plain attention stack: no SSM/SWA/shared-attn)")
    check_supported(cfg)
    acfg, lead = attn_config(cfg), (cfg.n_layers,)
    if quantized:
        return {"kv": attn.init_paged_pool(n_pages, acfg, page_size,
                                           torch.int8, device, lead=lead),
                "kv_scale": attn.init_paged_scales(n_pages, acfg, page_size,
                                                   device, lead=lead)}
    return {"kv": attn.init_paged_pool(n_pages, acfg, page_size,
                                       torch_dtype(cfg.cache_dtype), device,
                                       lead=lead)}


def _layer_scales(caches: dict, i: int):
    """Layer ``i``'s (k_scale, v_scale) of int8 pools, None for fp pools."""
    if "kv_scale" not in caches:
        return None
    ks, vs = caches["kv_scale"]
    return ks[i], vs[i]


def paged_decode_step(params: dict, caches: dict, page_table: torch.Tensor,
                      token: torch.Tensor, pos: torch.Tensor,
                      cfg: ArchConfig, use_kernel: bool | None = None,
                      num_splits: int | None = None):
    """One decode step over the page pools.  token (B, 1) int, pos (B,)
    int, page_table (B, nblk) int32 shared by every layer; ``num_splits``
    the split-KV degree of every layer's attention (None or 1: one pass).
    Returns (logits (B, V), caches); the pools are updated in place."""
    check_supported(cfg)
    x = embed_tokens(params, token, cfg)
    acfg = attn_config(cfg)
    layers = _cast(params["layers"], torch_dtype(cfg.compute_dtype))
    kp, vp = caches["kv"]
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        x = x + attn.paged_decode(lp["attn"], rms_norm(x, lp["norm1_w"]),
                                  kp[i], vp[i], page_table, pos, acfg,
                                  _layer_scales(caches, i),
                                  num_splits=num_splits,
                                  use_kernel=use_kernel)
        x = x + apply_mlp(lp["mlp"], rms_norm(x, lp["norm2_w"]))
    return _logits(params, x[:, 0], cfg), caches


def paged_prefill_step(params: dict, caches: dict, page_table: torch.Tensor,
                       tokens: torch.Tensor, start: torch.Tensor,
                       kv_len: torch.Tensor, logit_idx: torch.Tensor,
                       cfg: ArchConfig, use_kernel: bool | None = None):
    """One prompt chunk of prefill over the page pools.

    tokens (B, C) int, a fixed-size chunk whose ragged tail is padding
    (masked by ``kv_len``, its K/V sunk into the null page); start (B,)
    the absolute position of the chunk's first token; kv_len (B,) =
    start + valid chunk length; ``logit_idx`` (B,) the chunk row whose
    logits come back (the last valid prompt token on the final chunk).
    Returns (logits (B, V), caches); the pools are updated in place."""
    check_supported(cfg)
    x = embed_tokens(params, tokens, cfg)
    acfg = attn_config(cfg)
    layers = _cast(params["layers"], torch_dtype(cfg.compute_dtype))
    kp, vp = caches["kv"]
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        x = x + attn.paged_prefill(lp["attn"], rms_norm(x, lp["norm1_w"]),
                                   kp[i], vp[i], page_table, start, kv_len,
                                   acfg, _layer_scales(caches, i),
                                   use_kernel=use_kernel)
        x = x + apply_mlp(lp["mlp"], rms_norm(x, lp["norm2_w"]))
    rows = torch.arange(x.shape[0], device=x.device)
    return _logits(params, x[rows, logit_idx.long()], cfg), caches

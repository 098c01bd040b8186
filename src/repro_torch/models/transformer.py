"""Decoder LM assembly for the ``attn_mlp`` (dense archs), ``attn_moe``
(MoE archs), ``mamba1`` (falcon-mamba) and ``mamba2`` (zamba2) layer
kinds; the encoder-decoder (whisper) is :mod:`.encdec`.

Layers are stacked along a leading axis as in the JAX package (every
leaf of ``params["layers"]`` is (L, ...)), and the JAX ``lax.scan`` over
them is a Python loop here.  Per ``attn_mlp`` layer: ``rms_norm`` ->
attention -> residual -> ``rms_norm`` -> gated-SiLU MLP -> residual; an
``attn_moe`` layer has the MoE (:mod:`.moe`) in the MLP's place; per
``mamba1`` or ``mamba2`` layer: ``rms_norm`` -> Mamba block ->
residual; then the final norm and the LM head, whose logits are float32
over ``padded_vocab``.  A hybrid stack (zamba2, ``attn_period`` > 0)
also runs one shared transformer block (``params["shared_attn"]``: the
same weights at every application) after every ``attn_period``-th
layer, and keeps one KV ring buffer per application, ``shared_kv``
(napp, B, Hkv, W, Dh) each for K and V.

The MoE's capacity drops depend on the whole token set of a call, so
every mode hands it the step's tokens as the JAX step does: the (B, S)
batch flattened lane-major, idle lanes and chunk padding included.

Weights may be held in any float dtype: every use casts them to
``compute_dtype`` first, which is what the JAX package does, so holding
them in ``compute_dtype`` already (as :func:`init_params` and the bridge
do by default, for serving) is the same arithmetic at half the memory
for bf16.  A trainer holds them in ``param_dtype`` (``dtype=``), as the
JAX package does, and the casts carry the gradients back to them.

A vision-language arch (pixtral-12b) also holds ``frontend_proj`` (d x
d): ``forward`` and ``prefill`` take its stubbed vision tower's patch
embeddings, ``frontend_embeds`` (B, F, d), project them and put them in
front of the token embeddings, so the sequence is F + S positions long
(RoPE runs over all of them, and the caches hold them all).

Modes: ``forward`` (tokens -> final-normed hidden states; each layer
under the installed plan's remat policy, :func:`remat_wrap`) and
``train_loss`` (the chunked cross entropy over the tokens, the MoE's aux
loss added), ``prefill``
(whole prompt, K/V collected into caches padded to ``max_len``, or each
Mamba-1 layer's final conv and recurrent state) and ``decode_step`` (one
token per lane against the caches, written in place); on the paged KV
pool, which the attention stacks alone use, ``paged_prefill_step`` (one
prompt chunk per lane), ``paged_decode_step`` and ``speculative_step``
(one candidate chunk per lane, logits at every position), which write
into the layer-stacked page pools in place (and into their per-row
scales, for int8 pools).  ``slice_draft_params`` gives the
self-speculative draft its weights as views of the target's leading
layers (the MoE's stacked experts too).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..configs.base import ArchConfig
from . import attention as attn
from . import moe
from . import ssm
from .layers import (apply_mlp, chunked_cross_entropy, dense_init,
                     embed_init, init_mlp, rms_norm)
from .sharding_ctx import (constrain, constrain_layer_params, current_plan,
                           for_compute, is_dtensor, stack_layers, take_rows)

_OTHER_FAMILIES = "ROADMAP queue 1, item 8 (the other model families)"
_KINDS = ("attn_mlp", "attn_moe", "mamba1", "mamba2", "encdec_layer")


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what the port does not run: layer norm, GELU and the
    audio frontend outside the encoder-decoder family, which alone has
    them.  A decoder's vision frontend stub (pixtral-12b) runs."""
    kind = cfg.layer_kinds()[0]
    if kind not in _KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} ({cfg.name}) is not ported yet: "
            f"{_OTHER_FAMILIES}")
    if cfg.is_encoder_decoder:
        return
    for what, unsupported in (
            (f"the {cfg.frontend} frontend stub",
             cfg.frontend not in ("none", "vision")),
            ("layer norm", cfg.norm != "rms"),
            (f"activation {cfg.act!r}", cfg.act != "silu")):
        if unsupported:
            raise NotImplementedError(
                f"{what} outside the encoder-decoder family ({cfg.name}) "
                f"is not ported: {_OTHER_FAMILIES}")


def attn_config(cfg: ArchConfig) -> attn.AttnConfig:
    return attn.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, rope_theta=cfg.rope_theta, window=cfg.window,
        causal=True, use_rope=cfg.use_rope, qkv_bias=cfg.qkv_bias)


def moe_config(cfg: ArchConfig) -> moe.MoEConfig:
    return moe.MoEConfig(
        d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
        top_k=cfg.top_k, n_shared_experts=cfg.n_shared_experts,
        capacity_factor=cfg.capacity_factor, group_size=cfg.moe_group_size)


def mamba1_config(cfg: ArchConfig) -> ssm.Mamba1Config:
    return ssm.Mamba1Config(cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state)


def mamba2_config(cfg: ArchConfig) -> ssm.Mamba2Config:
    return ssm.Mamba2Config(cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state,
                            cfg.ssm_n_heads, cfg.ssm_head_dim,
                            chunk=cfg.ssm_chunk)


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


def _unstack(tree, n: int) -> list:
    """The (L, ...) stacked leaves as ``n`` per-layer dicts of views, by
    one ``unbind`` a leaf: its backward stacks the layers' gradients once
    (indexing layer by layer would add a zero-filled (L, ...) tensor per
    layer)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(tree.unbind(0))


def weights_dtype(cfg: ArchConfig, dtype: torch.dtype | str | None):
    """The dtype weights are held in: ``dtype`` (a name or a torch
    dtype), else ``compute_dtype``, the serving default."""
    if dtype is None:
        return torch_dtype(cfg.compute_dtype)
    return torch_dtype(dtype) if isinstance(dtype, str) else dtype


def init_params(cfg: ArchConfig, seed: int = 0, device="cpu",
                dtype: torch.dtype | str | None = None) -> dict:
    """Random weights from ``seed`` with the JAX package's distributions,
    held on ``device`` in ``dtype`` (default ``compute_dtype``; a trainer
    passes ``param_dtype``)."""
    check_supported(cfg)
    dtype = weights_dtype(cfg, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    lead, d = (cfg.n_layers,), cfg.d_model
    kw = dict(dtype=dtype, device=device)
    kind = cfg.layer_kinds()[0]
    if kind == "mamba1":
        layers = {"norm1_w": torch.ones(lead + (d,), **kw),
                  "ssm": ssm.init_mamba1(gen, mamba1_config(cfg), lead=lead,
                                         **kw)}
    elif kind == "mamba2":
        layers = {"norm1_w": torch.ones(lead + (d,), **kw),
                  "ssm": ssm.init_mamba2(gen, mamba2_config(cfg), lead=lead,
                                         **kw)}
    else:
        layers = {
            "norm1_w": torch.ones(lead + (d,), **kw),
            "norm2_w": torch.ones(lead + (d,), **kw),
            "attn": attn.init_attention(gen, attn_config(cfg), lead=lead,
                                        **kw),
        }
        if cfg.layer_kinds()[0] == "attn_moe":
            layers["moe"] = moe.init_moe(gen, moe_config(cfg), lead=lead,
                                         **kw)
        else:
            layers["mlp"] = init_mlp(gen, d, cfg.d_ff, lead=lead, **kw)
    p = {"embed": embed_init(gen, cfg.padded_vocab, d, **kw),
         "layers": layers,
         "final_norm_w": torch.ones((d,), **kw)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.padded_vocab, **kw)
    if cfg.attn_period > 0:     # zamba2's shared attention block
        p["shared_attn"] = {
            "attn": attn.init_attention(gen, attn_config(cfg), **kw),
            "mlp": init_mlp(gen, d, cfg.d_ff, **kw),
            "norm1_w": torch.ones((d,), **kw),
            "norm2_w": torch.ones((d,), **kw)}
    if cfg.frontend != "none":  # the vision stub's patch projection
        p["frontend_proj"] = dense_init(gen, d, d, **kw)
    return p


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                 frontend_embeds: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, d) in compute dtype; with
    ``frontend_embeds`` (B, F, d) -> (B, F + S, d): the patches projected
    by ``frontend_proj``, then the tokens (the JAX package's order).  An
    arch without a frontend has no ``frontend_proj`` and raises
    ``ValueError``."""
    dtype = torch_dtype(cfg.compute_dtype)
    x = take_rows(params["embed"], tokens).to(dtype)
    if frontend_embeds is None:
        return constrain(x, "hidden")
    if "frontend_proj" not in params:
        raise ValueError(
            f"{cfg.name!r} has no frontend (frontend={cfg.frontend!r}): it "
            "takes no frontend_embeds")
    fe = frontend_embeds.to(dtype) @ params["frontend_proj"].to(dtype)
    return constrain(torch.cat([fe, x], dim=1), "hidden")


def lm_head_weight(params: dict, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _final_norm(params: dict, x: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    return rms_norm(x, params["final_norm_w"].to(torch_dtype(
        cfg.compute_dtype)))


def head_logits(params: dict, hidden: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """LM head on final-normed hidden states (``forward``'s output) ->
    float32 logits over ``padded_vocab``."""
    w = for_compute(lm_head_weight(params, cfg)).to(
        torch_dtype(cfg.compute_dtype))
    return (hidden @ w).float()


def _logits(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Final norm + LM head on (B, d) hidden states -> float32 (B, V)."""
    return head_logits(params, _final_norm(params, x, cfg), cfg)


def _ffn(lp: dict, h: torch.Tensor, cfg: ArchConfig, kind: str,
         with_aux: bool = False):
    """The feed-forward half of an attention layer on its normed input h
    (B, S, d): the gated MLP, or the MoE over the step's B x S tokens.
    Returns (out, aux): the MoE's aux loss with ``with_aux``, else None."""
    if kind == "attn_moe":
        return moe.apply_moe(lp["moe"], h, moe_config(cfg), with_aux)
    return apply_mlp(lp["mlp"], h), None


def apply_layer(p: dict, x: torch.Tensor, cfg: ArchConfig, kind: str,
                use_kernel: bool | None = None):
    """Whole-sequence application of one layer (weights in compute dtype).
    Returns (x, aux_loss): the MoE's load-balancing loss, 0 for the other
    kinds."""
    aux = None
    # each branch's output joins the residual in the "hidden" layout (over
    # a mesh: a row-parallel product's partial sums all-reduced there)
    if kind in ("attn_mlp", "attn_moe"):
        x = x + constrain(attn.full(p["attn"], rms_norm(x, p["norm1_w"]),
                                    attn_config(cfg), use_kernel=use_kernel),
                          "hidden")
        out, aux = _ffn(p, rms_norm(x, p["norm2_w"]), cfg, kind,
                        with_aux=True)
        x = x + constrain(out, "hidden")
    elif kind == "mamba1":
        x = x + constrain(ssm.apply_mamba1(
            p["ssm"], rms_norm(x, p["norm1_w"]), mamba1_config(cfg),
            use_kernel=use_kernel), "hidden")
    elif kind == "mamba2":
        x = x + constrain(ssm.apply_mamba2(
            p["ssm"], rms_norm(x, p["norm1_w"]), mamba2_config(cfg)),
            "hidden")
    else:
        raise ValueError(kind)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return constrain(x, "hidden"), aux


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep the matrix products' outputs, recompute
    everything else (``jax.checkpoint_policies.checkpoint_dots``)."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn):
    """``fn`` under the installed plan's remat policy: ``none`` (as it
    is), ``full`` (``torch.utils.checkpoint``: only the inputs kept, the
    body recomputed in the backward) or ``dots`` (selective checkpoint
    keeping the outputs of ``aten.mm``/``bmm``/``addmm``)."""
    plan = current_plan()
    policy = plan.remat if plan is not None else "none"
    if policy == "none":
        return fn
    if policy == "full":
        context = ckpt.noop_context_fn
    elif policy == "dots":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    _save_dots)
    else:
        raise ValueError(f"unknown remat policy {policy!r} (none, dots, "
                         "full)")
    # no layer draws a random number, so the recompute needs no saved RNG
    # state (saving it reads the CUDA generator, which a graph capture of
    # the train step does not allow)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                             context_fn=context, preserve_rng_state=False)


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            use_kernel: bool | None = None,
            frontend_embeds: torch.Tensor | None = None):
    """tokens (B, S) -> (final-normed hidden (B, S', d), aux_loss): the
    train/prefill forward without the caches; S' = F + S with
    ``frontend_embeds`` (B, F, d) in front (:func:`embed_tokens`), else
    S.  A ``mamba1`` stack runs one selective scan (K9 on the card) per
    layer, without the final state; a hybrid stack its shared block after
    every ``attn_period``-th layer.  Each layer (with the shared block
    after it) runs under :func:`remat_wrap`."""
    check_supported(cfg)
    x = embed_tokens(params, tokens, cfg, frontend_embeds)
    kind = cfg.layer_kinds()[0]
    layers = _unstack(_cast(params["layers"], torch_dtype(cfg.compute_dtype)),
                      cfg.n_layers)
    shared = _shared(params, cfg)

    def body(lp, x, i):
        x, a = apply_layer(constrain_layer_params(lp), x, cfg, kind,
                           use_kernel)
        if _applies(cfg, i):
            x = _shared_block(shared, x, cfg, use_kernel)[0]
        return x, a

    body = remat_wrap(body)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(layers):
        x, a = body(lp, x, i)
        aux = aux + a
    return _final_norm(params, x, cfg), aux


def train_loss(params: dict, batch: dict, cfg: ArchConfig,
               n_loss_chunks: int | None = None,
               use_kernel: bool | None = None) -> torch.Tensor:
    """batch: tokens (B, S), labels (B, S), optional loss_mask (B, S) and
    frontend_embeds (B, F, d) -> the mean next-token cross entropy
    (float32), the MoE's aux loss added.  The frontend's F prefix
    positions carry no loss.  ``n_loss_chunks`` defaults to the installed
    plan's ``loss_chunks`` (8 without a plan)."""
    if n_loss_chunks is None:
        plan = current_plan()
        n_loss_chunks = plan.loss_chunks if plan is not None else 8
    hidden, aux = forward(params, batch["tokens"], cfg, use_kernel,
                          batch.get("frontend_embeds"))
    fs = hidden.shape[1] - batch["labels"].shape[1]
    if fs > 0:                   # the vision prefix carries no loss
        hidden = hidden[:, fs:]
    b, s, d = hidden.shape
    mask = batch.get("loss_mask")
    mask = mask.reshape(-1).float() if mask is not None else None
    w = for_compute(lm_head_weight(params, cfg)).to(
        torch_dtype(cfg.compute_dtype))
    loss = chunked_cross_entropy(constrain(hidden.reshape(b * s, d),
                                           "logits_hidden"), w,
                                 batch["labels"].reshape(-1), mask,
                                 n_chunks=n_loss_chunks)
    return loss + aux


def _shared(params: dict, cfg: ArchConfig) -> dict | None:
    """The shared block's weights in compute dtype, None without one."""
    if cfg.attn_period <= 0:
        return None
    return _cast(params["shared_attn"], torch_dtype(cfg.compute_dtype))


def _applies(cfg: ArchConfig, i: int) -> bool:
    """Does the shared block run after layer ``i``?"""
    return cfg.attn_period > 0 and (i + 1) % cfg.attn_period == 0


def _app_index(cfg: ArchConfig, i: int) -> int:
    """Which application of the shared block follows layer ``i`` (its
    ``shared_kv`` slot)."""
    return (i + 1) // cfg.attn_period - 1


def _shared_block(sp: dict, x: torch.Tensor, cfg: ArchConfig,
                  use_kernel: bool | None):
    """The shared transformer block over a whole sequence: windowed
    causal attention (K1 on the card), then the gated MLP, each with a
    residual.  Returns (x, (k, v)): the K/V the attention made."""
    sp = for_compute(sp)
    h, kv = attn.full(sp["attn"], rms_norm(x, sp["norm1_w"]),
                      attn_config(cfg), return_cache=True,
                      use_kernel=use_kernel)
    x = x + constrain(h, "hidden")
    return x + constrain(apply_mlp(sp["mlp"], rms_norm(x, sp["norm2_w"])),
                         "hidden"), kv


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device="cpu") -> dict:
    """Stacked per-layer decode state: for attention stacks KV caches
    {"kv": (K, V)}, each (L, batch, Hkv, W, Dh) in ``cache_dtype``, W =
    ``max_len`` or, with a sliding window, the ring buffer's
    ``min(max_len, window)`` slots (:func:`attn.init_cache`);
    for ``mamba1`` {"ssm": {"conv": (L, batch, d_conv - 1, Di), "h": (L,
    batch, Di, N)}}, both float32 as in the JAX package (``max_len`` does
    not size it); for ``mamba2`` {"ssm": {"conv": (L, batch, d_conv - 1,
    Di + 2N), "h": (L, batch, H, N, P)}}, float32, and the shared block's
    rings {"shared_kv": (K, V)}, each (napp, batch, Hkv, W, Dh) in
    ``cache_dtype``."""
    check_supported(cfg)
    kind, lead = cfg.layer_kinds()[0], (cfg.n_layers,)
    if kind == "mamba1":
        return {"ssm": ssm.init_mamba1_state(batch, mamba1_config(cfg),
                                             lead=lead, device=device)}
    if kind == "mamba2":
        return {"ssm": ssm.init_mamba2_state(batch, mamba2_config(cfg),
                                             lead=lead, device=device),
                "shared_kv": _init_shared_kv(cfg, batch, max_len, device)}
    return {"kv": attn.init_cache(batch, attn_config(cfg), max_len,
                                  torch_dtype(cfg.cache_dtype), device,
                                  lead=lead)}


def _init_shared_kv(cfg: ArchConfig, batch: int, max_len: int, device):
    """Zeroed rings of the shared block, one per application."""
    return attn.init_cache(batch, attn_config(cfg), max_len,
                           torch_dtype(cfg.cache_dtype), device,
                           lead=(cfg.n_shared_attn_applications(),))


def decode_step(params: dict, caches: dict, token: torch.Tensor,
                pos: torch.Tensor, cfg: ArchConfig,
                use_kernel: bool | None = None):
    """token (B, 1) int, pos (B,) int -> (logits (B, V), caches).

    The caches are updated in place (slot ``pos`` of every layer, ``pos %
    window`` of a sliding-window ring buffer, or every Mamba layer's conv
    and recurrent state, which ignore ``pos``, and the shared block's
    ring of each application) and returned."""
    check_supported(cfg)
    x = embed_tokens(params, token, cfg)
    layers = _cast(params["layers"], torch_dtype(cfg.compute_dtype))
    kind = cfg.layer_kinds()[0]
    if kind in ("mamba1", "mamba2"):
        step, mcfg = ((ssm.step_mamba1, mamba1_config(cfg))
                      if kind == "mamba1" else
                      (ssm.step_mamba2, mamba2_config(cfg)))
        state, shared = caches["ssm"], for_compute(_shared(params, cfg))
        acfg = attn_config(cfg)
        for i in range(cfg.n_layers):
            lp = constrain_layer_params(_layer(layers, i))
            h, new = step(lp["ssm"], rms_norm(x, lp["norm1_w"]),
                          _layer(state, i), mcfg)
            for key, t in new.items():
                state[key][i].copy_(t)
            x = x + constrain(h, "hidden")
            if _applies(cfg, i):
                a = _app_index(cfg, i)
                sk, sv = caches["shared_kv"]
                h, _, _ = attn.decode(shared["attn"],
                                      rms_norm(x, shared["norm1_w"]),
                                      sk[a], sv[a], pos, acfg,
                                      use_kernel=use_kernel)
                x = x + constrain(h, "hidden")
                x = x + constrain(apply_mlp(shared["mlp"],
                                            rms_norm(x, shared["norm2_w"])),
                                  "hidden")
        return _logits(params, x[:, 0], cfg), caches
    acfg = attn_config(cfg)
    ck, cv = caches["kv"]
    for i in range(cfg.n_layers):
        lp = constrain_layer_params(_layer(layers, i))
        h, _, _ = attn.decode(lp["attn"], rms_norm(x, lp["norm1_w"]),
                              ck[i], cv[i], pos, acfg, use_kernel=use_kernel)
        x = x + constrain(h, "hidden")
        x = x + constrain(_ffn(lp, rms_norm(x, lp["norm2_w"]), cfg, kind)[0],
                          "hidden")
    return _logits(params, x[:, 0], cfg), caches


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            max_len: int | None = None, use_kernel: bool | None = None,
            frontend_embeds: torch.Tensor | None = None, mesh=None):
    """Forward over the prompt; returns (last-token logits, caches).

    With ``frontend_embeds`` (B, F, d) the prompt is the F projected
    patches and then the S tokens (:func:`embed_tokens`): the caches hold
    S' = F + S positions and decode continues at position S'.
    ``max_len`` sizes the returned KV caches (>= S'; the positions past
    the prompt are zero) so decode steps have room to append.  A sliding-window arch keeps only the prompt's last W keys, W
    = ``min(max_len, window)``, in the ring buffer's layout (slot ``pos %
    W``, as decode indexes it): rolled by ``(S - W) % W`` when the prompt
    is longer than W, zero-padded when it is shorter.  A ``mamba1`` stack
    returns each layer's final state instead, {"ssm": {"conv": (L, B,
    d_conv - 1, Di) in compute dtype, "h": (L, B, Di, N) float32}}, from
    one selective scan per layer (K9 on the card, which returns the state
    itself).  A ``mamba2`` stack returns each layer's final state from the
    chunked SSD, {"ssm": {"conv": (L, B, d_conv - 1, Di + 2N), "h": (L,
    B, H, N, P) float32}}, and the shared block's K/V of each application
    in its ring layout, {"shared_kv": (K, V)} each (napp, B, Hkv, W, Dh):
    collected as the block runs, not as the JAX package's zero-padded
    stack of every layer compacted by a 0/1 selector (whose values are
    the same).  ``mesh`` routes an attention stack's long causal prompts
    through the ring (``ops.attention``); the caches come back whole on
    every rank."""
    check_supported(cfg)
    x = embed_tokens(params, tokens, cfg, frontend_embeds)
    kind = cfg.layer_kinds()[0]
    if kind in ("mamba1", "mamba2"):
        return _prefill_ssm(params, x, cfg, max_len, use_kernel)
    if is_dtensor(x):
        return _prefill_sharded(params, x, cfg, max_len, use_kernel)
    b, s, _ = x.shape
    acfg = attn_config(cfg)
    max_len = max(max_len or s, s)
    caches = init_caches(cfg, b, max_len, device=x.device)
    ck, cv = caches["kv"]
    w = ck.shape[3]
    n = min(s, w)
    layers = _cast(params["layers"], torch_dtype(cfg.compute_dtype))
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        h, (k, v) = attn.full(lp["attn"], rms_norm(x, lp["norm1_w"]), acfg,
                              return_cache=True, use_kernel=use_kernel,
                              mesh=mesh)
        ck[i, :, :, :n] = _ring(k, w)
        cv[i, :, :, :n] = _ring(v, w)
        x = x + h
        x = x + _ffn(lp, rms_norm(x, lp["norm2_w"]), cfg, kind)[0]
    return _logits(params, x[:, -1], cfg), caches


def _prefill_sharded(params: dict, x, cfg: ArchConfig,
                     max_len: int | None, use_kernel: bool | None):
    """:func:`prefill` of an attention stack over a mesh (``DTensor``
    weights and prompt): the layers as ``forward`` runs them, each
    layer's K/V kept in the plan's ``kv_heads`` layout, ringed and padded
    to the cache's slots on each rank's shard."""
    s = x.shape[1]
    kind = cfg.layer_kinds()[0]
    acfg = attn_config(cfg)
    w = min(max(max_len or s, s), cfg.window or max(max_len or s, s))
    ks, vs = [], []
    for lp in _unstack(_cast(params["layers"],
                             torch_dtype(cfg.compute_dtype)), cfg.n_layers):
        lp = constrain_layer_params(lp)
        h, (k, v) = attn.full(lp["attn"], rms_norm(x, lp["norm1_w"]), acfg,
                              return_cache=True, use_kernel=use_kernel)
        x = x + constrain(h, "hidden")
        x = x + constrain(_ffn(lp, rms_norm(x, lp["norm2_w"]), cfg,
                               kind)[0], "hidden")
        ks.append(k)
        vs.append(v)
    cdt = torch_dtype(cfg.cache_dtype)

    def slots(t):          # (L-less) local (B, Hkv, S, D) -> W slots
        t = _ring(t, w).to(cdt)
        return F.pad(t, (0, 0, 0, w - t.shape[2]))

    return _logits(params, x[:, -1], cfg), {
        "kv": (stack_layers(ks, slots), stack_layers(vs, slots))}


def _ring(k: torch.Tensor, w: int) -> torch.Tensor:
    """A prompt's keys (B, Hkv, S, Dh) as a cache of ``w`` slots holds
    them: all S when they fit, else the last ``w`` at slot ``pos % w``
    (the JAX package's ``kv_out``)."""
    s = k.shape[2]
    if s <= w:
        return k
    return torch.roll(k[:, :, s - w:], (s - w) % w, dims=2)


def _prefill_ssm(params: dict, x: torch.Tensor, cfg: ArchConfig,
                 max_len: int | None, use_kernel: bool | None):
    """Prefill of a Mamba-1 or Mamba-2 stack (and a hybrid's shared
    block): every layer's final state, and the block's rings."""
    b, s, _ = x.shape
    if cfg.layer_kinds()[0] == "mamba1":
        apply = functools.partial(ssm.apply_mamba1, use_kernel=use_kernel)
        mcfg = mamba1_config(cfg)
    else:
        apply, mcfg = ssm.apply_mamba2, mamba2_config(cfg)
    layers = _cast(params["layers"], torch_dtype(cfg.compute_dtype))
    shared = _shared(params, cfg)
    sharded = is_dtensor(x)
    if shared is not None and not sharded:
        sk, sv = shared_kv = _init_shared_kv(cfg, b, max(max_len or s, s),
                                             x.device)
        n = min(s, sk.shape[3])
    w = min(max(max_len or s, s), cfg.window or max(max_len or s, s))
    states, ring_k, ring_v = [], [], []
    for i in range(cfg.n_layers):
        lp = constrain_layer_params(_layer(layers, i))
        h, st = apply(lp["ssm"], rms_norm(x, lp["norm1_w"]), mcfg,
                      return_state=True)
        x = x + constrain(h, "hidden")
        states.append(st)
        if _applies(cfg, i):
            x, (k, v) = _shared_block(shared, x, cfg, use_kernel)
            if sharded:
                ring_k.append(k)
                ring_v.append(v)
                continue
            a = _app_index(cfg, i)
            sk[a, :, :, :n] = _ring(k, sk.shape[3])
            sv[a, :, :, :n] = _ring(v, sk.shape[3])
    caches = {"ssm": {key: torch.stack([st[key] for st in states])
                      for key in ("conv", "h")}}
    if shared is not None and sharded:
        cdt = torch_dtype(cfg.cache_dtype)

        def slots(t):
            t = _ring(t, w).to(cdt)
            return F.pad(t, (0, 0, 0, w - t.shape[2]))

        shared_kv = (stack_layers(ring_k, slots), stack_layers(ring_v, slots))
    if shared is not None:
        caches["shared_kv"] = shared_kv
    return _logits(params, x[:, -1], cfg), caches


def supports_paged_cache(cfg: ArchConfig) -> bool:
    """Paged KV applies to plain attention stacks (no SSM state, no
    sliding-window ring buffer, no shared-attention block)."""
    return (cfg.layer_kinds()[0] in ("attn_mlp", "attn_moe")
            and cfg.attn_period == 0 and cfg.window is None)


def init_paged_caches(cfg: ArchConfig, n_pages: int, page_size: int,
                      device="cpu", quantized: bool = False,
                      model_axis: int = 1) -> dict:
    """Layer-stacked page pools {"kv": (K, V)}, each (L, P, Hkv, psz, Dh)
    in ``cache_dtype``: O(n_pages * page_size) tokens of KV in total,
    which lanes borrow through their page tables.

    ``quantized=True`` makes int8 pools and adds ``"kv_scale"``: (L, P,
    Hkv, psz) float32 per-row scales for k and v, zeros, with the page
    axis at position 1 like the pools', so page-indexed copies (admit,
    swap) treat scales and pools alike.  ``model_axis`` > 1: the KV heads
    are split over a tensor-parallel axis of that size, and the pools (and
    scales) hold one rank's ``Hkv / model_axis`` of them."""
    if not supports_paged_cache(cfg):
        raise ValueError(
            f"arch {cfg.name!r} does not support the paged KV cache "
            "(needs a plain attention stack: no SSM/SWA/shared-attn)")
    check_supported(cfg)
    acfg, lead = attn_config(cfg), (cfg.n_layers,)
    if cfg.n_kv_heads % model_axis:
        raise ValueError(f"kv_heads={cfg.n_kv_heads} does not divide a "
                         f"model axis of {model_axis}")
    acfg = acfg._replace(n_kv_heads=cfg.n_kv_heads // model_axis)
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
                      num_splits: int | None = None, mesh=None):
    """One decode step over the page pools.  token (B, 1) int, pos (B,)
    int, page_table (B, nblk) int32 shared by every layer; ``num_splits``
    the split-KV degree of every layer's attention (None or 1: one pass);
    ``mesh`` runs it head-sharded over pools of this rank's KV-head slice.
    Returns (logits (B, V), caches); the pools are updated in place."""
    check_supported(cfg)
    x = embed_tokens(params, token, cfg)
    acfg, kind = attn_config(cfg), cfg.layer_kinds()[0]
    layers = _cast(params["layers"], torch_dtype(cfg.compute_dtype))
    kp, vp = caches["kv"]
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        x = x + attn.paged_decode(lp["attn"], rms_norm(x, lp["norm1_w"]),
                                  kp[i], vp[i], page_table, pos, acfg,
                                  _layer_scales(caches, i),
                                  num_splits=num_splits,
                                  use_kernel=use_kernel, mesh=mesh)
        x = x + _ffn(lp, rms_norm(x, lp["norm2_w"]), cfg, kind)[0]
    return _logits(params, x[:, 0], cfg), caches


def _paged_chunk_layers(params: dict, caches: dict, page_table: torch.Tensor,
                        tokens: torch.Tensor, start: torch.Tensor,
                        kv_len: torch.Tensor, cfg: ArchConfig,
                        attend) -> torch.Tensor:
    """Every layer over one chunk per lane, the chunk's attention through
    ``attend`` (:func:`attn.paged_prefill` or :func:`attn.paged_verify`
    with its keywords bound); returns the last hidden states (B, C, d)."""
    check_supported(cfg)
    x = embed_tokens(params, tokens, cfg)
    acfg, kind = attn_config(cfg), cfg.layer_kinds()[0]
    layers = _cast(params["layers"], torch_dtype(cfg.compute_dtype))
    kp, vp = caches["kv"]
    for i in range(cfg.n_layers):
        lp = _layer(layers, i)
        x = x + attend(lp["attn"], rms_norm(x, lp["norm1_w"]), kp[i], vp[i],
                       page_table, start, kv_len, acfg,
                       _layer_scales(caches, i))
        x = x + _ffn(lp, rms_norm(x, lp["norm2_w"]), cfg, kind)[0]
    return x


def paged_prefill_step(params: dict, caches: dict, page_table: torch.Tensor,
                       tokens: torch.Tensor, start: torch.Tensor,
                       kv_len: torch.Tensor, logit_idx: torch.Tensor,
                       cfg: ArchConfig, use_kernel: bool | None = None,
                       mesh=None):
    """One prompt chunk of prefill over the page pools.

    tokens (B, C) int, a fixed-size chunk whose ragged tail is padding
    (masked by ``kv_len``, its K/V sunk into the null page); start (B,)
    the absolute position of the chunk's first token; kv_len (B,) =
    start + valid chunk length; ``logit_idx`` (B,) the chunk row whose
    logits come back (the last valid prompt token on the final chunk);
    ``mesh`` as in :func:`paged_decode_step`.  Returns (logits (B, V),
    caches); the pools are updated in place."""
    x = _paged_chunk_layers(
        params, caches, page_table, tokens, start, kv_len, cfg,
        functools.partial(attn.paged_prefill, use_kernel=use_kernel,
                          mesh=mesh))
    rows = torch.arange(x.shape[0], device=x.device)
    return _logits(params, x[rows, logit_idx.long()], cfg), caches


def speculative_step(params: dict, caches: dict, page_table: torch.Tensor,
                     tokens: torch.Tensor, start: torch.Tensor,
                     kv_len: torch.Tensor, cfg: ArchConfig,
                     num_splits: int | None = None,
                     use_kernel: bool | None = None, mesh=None):
    """Speculative verify: score every position of one candidate chunk
    per lane in one call.

    tokens (B, C) int, ``[last committed token, draft_1 .. draft_k]`` at
    absolute positions ``start .. start + C - 1`` (rows at positions
    ``>= kv_len`` are padding, their K/V sunk into the null page); start
    and kv_len (B,); ``num_splits`` the split-KV degree of every layer's
    verify attention; ``mesh`` as in :func:`paged_decode_step`.  The math
    of :func:`paged_prefill_step`, but the
    full logits come back: the accept rule needs the target's
    distribution at every drafted position.  Returns (logits (B, C, V)
    float32, caches); the pools are updated in place."""
    x = _paged_chunk_layers(
        params, caches, page_table, tokens, start, kv_len, cfg,
        functools.partial(attn.paged_verify, num_splits=num_splits,
                          use_kernel=use_kernel, mesh=mesh))
    return _logits(params, x, cfg), caches


def slice_draft_params(params: dict, cfg: ArchConfig,
                       draft_cfg: ArchConfig) -> dict:
    """Self-speculative draft weights: the target's leading
    ``draft_cfg.n_layers`` layers, as views of the stacked (L, ...)
    leaves (no copy: at full width the draft costs no weight memory),
    sharing the embedding, final norm and head.  Needs the target's
    width (``draft_config(width_frac=1.0)``): a narrower draft has its
    own geometry and takes its own weights."""
    if (draft_cfg.d_model, draft_cfg.n_heads, draft_cfg.head_dim) != \
            (cfg.d_model, cfg.n_heads, cfg.head_dim):
        raise ValueError(
            "slice_draft_params needs a same-width draft config; "
            "width-reduced drafts take independently initialised params")
    if draft_cfg.n_layers > cfg.n_layers:
        raise ValueError("draft is deeper than the target")

    def head(tree):
        if isinstance(tree, dict):
            return {k: head(v) for k, v in tree.items()}
        return tree[:draft_cfg.n_layers]

    return {**params, "layers": head(params["layers"])}

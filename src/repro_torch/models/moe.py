"""Mixture-of-Experts layer: grouped top-k capacity routing (GShard-style),
the JAX package's ``models/moe.py`` written with index dispatch.

The routing is the JAX package's, decision for decision.  The step's
tokens are cut into groups of ``min(group_size, tokens)`` (the ragged
tail padded; its padded rows route nowhere but still count in the aux
loss), each token picks its top-k experts by router probability (ties to
the lower expert index, as ``jax.lax.top_k``), and each expert takes at
most ``capacity`` (token, choice) pairs per group, queued choice-major:
every token's first choice, then every second choice, and so on.  A pair
past its expert's capacity is dropped; a token whose every choice is
dropped gets only the shared experts.

Where the JAX package builds one-hot (group, token, expert, slot)
dispatch and combine tensors and contracts them with einsums (the TPU
form), this module scatters each kept pair's token into its (expert,
slot) row of an (E, groups x capacity, d) buffer, runs the experts as
batched products over that buffer and gathers each token's kept outputs
back with its gate weights.  The queue positions come from one
exclusive cumsum over the (choice, token) pairs in choice-major order;
it counts dropped pairs as the reference's running count does.  Every
expert is computed over its whole buffer, the slots no pair filled
included (zeros in, zeros out): the product reads all E experts' weights
on every step.

Under a layout plan with ``DTensor`` weights (the sharded train step, the
dry run) each rank routes its own batch shard's tokens over every expert
and runs only its ``model`` slice of the experts (the JAX package pins
the expert buffer to ``moe_experts``: experts over ``model``); the
output is a partial sum over ``model``, all-reduced where the layer
joins the residual.  A shard must hold whole routing groups.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import apply_mlp, dense_init
from .sharding_ctx import (batch_axes_of, batch_spec, constrain, from_local,
                           is_dtensor, local)


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int                  # per-expert FFN width
    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    group_size: int = 512
    aux_loss_weight: float = 0.01


def init_moe(gen: torch.Generator, cfg: MoEConfig, *,
             lead: tuple[int, ...] = (), dtype=torch.float32,
             device="cpu") -> dict:
    """Random weights with the JAX package's distributions, each made in
    ``dtype`` on ``device``: the router and the shared experts uniform in
    +-in^-0.5, ``w_gate`` and ``w_up`` normal x d^-0.5, ``w_down`` normal
    x f^-0.5.  Shapes ``lead`` + (d, E), (E, d, f), (E, f, d); the shared
    experts one gated MLP of width f x ``n_shared_experts``."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    kw = dict(lead=lead, dtype=dtype, device=device)

    def normal(shape, std):
        w = torch.empty(lead + shape, dtype=dtype, device=device)
        return w.normal_(0.0, std, generator=gen)

    p = {"router": dense_init(gen, d, e, **kw),
         "w_gate": normal((e, d, f), d ** -0.5),
         "w_up": normal((e, d, f), d ** -0.5),
         "w_down": normal((e, f, d), f ** -0.5)}
    if cfg.n_shared_experts:
        sf = f * cfg.n_shared_experts
        p["shared"] = {"w_gate": dense_init(gen, d, sf, **kw),
                       "w_up": dense_init(gen, d, sf, **kw),
                       "w_down": dense_init(gen, sf, d, **kw)}
    return p


def capacity(cfg: MoEConfig, group: int) -> int:
    c = int(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, 4)


_trace: tuple[list, bool] | None = None      # (records, with inputs)


@contextlib.contextmanager
def trace_routing(inputs: bool = False):
    """Record every :func:`apply_moe` call made while the block runs: a
    dict per call with, for its T = B x S tokens, ``top_i`` (T, k) (the
    chosen experts) and ``keep`` (T, k) (False for a pair past its
    expert's capacity), and with ``inputs`` its input ``x`` (B, S, d).
    The records hold the call's own tensors (no copy, no launch).  Yields
    the list the records go to."""
    global _trace
    outer, _trace = _trace, ([], inputs)
    try:
        yield _trace[0]
    finally:
        _trace = outer


_replay = None                  # an iterator over records to route by


@contextlib.contextmanager
def replay_routing(records: list[dict]):
    """Route the :func:`apply_moe` calls made while the block runs as the
    recorded calls (of :func:`trace_routing`) were routed: call i takes
    ``records[i]["top_i"]``, the same experts in the same order, so the
    same queue positions and drops; its gate weights are its own router
    probabilities at those experts.  This holds two runs whose inputs
    differ by rounding to one routing, so what they compute beside it can
    be compared."""
    global _replay
    outer, _replay = _replay, iter(records)
    try:
        yield
    finally:
        _replay = outer


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index (the
    order of ``jax.lax.top_k``; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(p: dict, x: torch.Tensor, cfg: MoEConfig,
              with_aux: bool = True):
    """x (B, S, d) -> (out (B, S, d), aux_loss): the B x S tokens, in
    that (lane-major) order, are the step's token set.  ``with_aux=False``
    skips the aux loss (returned as None), which serving discards."""
    if is_dtensor(x):
        return _apply_moe_sharded(p, x, cfg, with_aux)
    out, aux = _moe(p, x, cfg, with_aux)
    if cfg.n_shared_experts:
        out = out + apply_mlp(p["shared"], x.reshape(-1, x.shape[-1]))
    return out.reshape(x.shape), aux


def _apply_moe_sharded(p: dict, x, cfg: MoEConfig, with_aux: bool):
    """:func:`apply_moe` of a ``DTensor`` x: the routed experts on this
    rank's batch shard and ``model`` slice of the experts (all of them
    where ``model`` does not divide their count), the shared experts as
    ``DTensor`` products.  The router is used whole by every rank, so its
    gradient is a partial sum over every axis; the aux loss is each
    rank's share of the mean."""
    from ..distributed.sharding import P
    dm = x.device_mesh
    names = tuple(dm.mesh_dim_names)
    m = dm.size(names.index("model")) if "model" in names else 1
    e = cfg.n_experts
    ch = "model" if m > 1 and e % m == 0 else None
    b, s, d = x.shape
    g = max(min(cfg.group_size, b * s), 1)     # the whole batch's groups
    spec, ax = batch_spec(x), batch_axes_of(x)
    parts = math.prod(dm.size(names.index(a)) for a in ax)
    if (b // parts) * s % g:
        # a batch shard holds no whole routing group (a decode step's few
        # tokens): every rank routes the whole batch
        spec, ax = P(*(None,) * x.dim()), ()
    # each rank's tokens feed only its experts: their gradient is a
    # partial sum over "model" where the experts are split
    xl = local(x, spec, partial_over=("model",) if ch else ())
    everywhere = tuple(names)
    lp = {"router": local(p["router"], P(), partial_over=everywhere)}
    for k in ("w_gate", "w_up", "w_down"):
        lp[k] = local(p[k], P(ch, None, None), partial_over=ax)
    el = lp["w_gate"].shape[0]
    lo = dm.get_local_rank("model") * el if ch else 0
    out, aux = _moe(lp, xl, cfg._replace(group_size=g), with_aux, lo, el)
    out = from_local(out.reshape(xl.shape), x, spec, tuple(x.shape),
                     partial_over=("model",) if ch else ())
    if aux is not None:
        # every rank's mean over its tokens, summed over the mesh
        aux = from_local(aux / dm.size(), x, P(), (), partial_over=everywhere)
    if cfg.n_shared_experts:
        out = out + apply_mlp(p["shared"], x.reshape(-1, d)).reshape(x.shape)
    return out, aux


def _moe(p: dict, x: torch.Tensor, cfg: MoEConfig, with_aux: bool,
         lo: int = 0, n_local: int | None = None):
    """The routed experts of :func:`apply_moe` on plain tensors: (out (B x
    S, d), aux).  Every token routes over all E experts; only experts
    ``lo .. lo + n_local`` (``p``'s expert weights, all E by default) take
    pairs, and ``out`` sums their share of each token's output."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    g = max(min(cfg.group_size, t), 1)
    n_groups = -(-t // g)              # ceil: the ragged tail is padded,
    pad = n_groups * g - t             # never dropped
    valid = None
    if pad:
        tokens = torch.cat([tokens, tokens.new_zeros(pad, d)])
        valid = torch.arange(n_groups * g, device=x.device) < t
    e, k = cfg.n_experts, cfg.top_k
    el = e if n_local is None else n_local
    c = capacity(cfg, g)

    logits = (tokens @ p["router"]).float()                 # (T', E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, k)                         # (T', k)
    if _replay is not None:
        top_i = torch.cat([next(_replay)["top_i"], top_i[t:]])
        top_p = probs.gather(1, top_i)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    aux = None
    if with_aux:
        # load balancing (Switch): mean prob x mean assignment share per
        # group, the padded rows' (uniform) choices included
        me = probs.view(n_groups, g, e).mean(1)
        ce = torch.zeros(n_groups, e, device=x.device).scatter_add_(
            1, top_i.reshape(n_groups, g * k),
            torch.ones(n_groups, g * k, device=x.device)) / g
        aux = (me * ce).sum(-1).mean() * e * cfg.aux_loss_weight

    # each (choice, token) pair's place in its expert's queue: pairs in
    # choice-major order within a group, an exclusive count per expert
    idx = top_i.view(n_groups, g, k).transpose(1, 2).reshape(n_groups, k * g)
    onehot = F.one_hot(idx, e)                              # (G, k g, E)
    if valid is not None:
        vpair = valid.view(n_groups, 1, g).expand(n_groups, k, g).reshape(
            n_groups, k * g)
        onehot = onehot * vpair[..., None]
    pos = onehot.cumsum(1).gather(2, idx[..., None])[..., 0] - 1
    keep = pos < c
    if valid is not None:
        keep = keep & vpair
    if el < e:                         # another rank's experts take these
        keep = keep & (idx >= lo) & (idx < lo + el)
    # kept pairs -> rows of the (E, G x C) expert buffer; dropped pairs
    # -> its last row, a sink no expert reads
    slot = (idx - lo) * (n_groups * c) + pos
    if n_groups > 1:
        slot = slot + (torch.arange(n_groups, device=x.device) * c)[:, None]
    sink = el * n_groups * c
    src = tokens.view(n_groups, 1, g, d).expand(n_groups, k, g, d)
    buf = tokens.new_zeros(sink + 1, d)
    buf.index_copy_(0, torch.where(keep, slot, sink).reshape(-1),
                    src.reshape(-1, d))
    expert_in = constrain(buf[:sink].view(el, n_groups * c, d),
                          "moe_experts")
    act = F.silu(torch.bmm(expert_in, p["w_gate"])) \
        * torch.bmm(expert_in, p["w_up"])
    expert_out = constrain(torch.bmm(act, p["w_down"]),
                           "moe_experts").view(sink, d)

    # combine: each token's kept outputs weighted by its gate, in x's
    # dtype as the reference's ``comb.astype(x.dtype)``; a dropped pair
    # reads row 0 at weight 0
    keep_tk = keep.view(n_groups, k, g).transpose(1, 2).reshape(-1, k)
    slot_tk = slot.view(n_groups, k, g).transpose(1, 2).reshape(-1)
    w = torch.where(keep_tk, top_p, 0.0).to(x.dtype)        # (T', k)
    picked = expert_out[torch.where(keep_tk.reshape(-1), slot_tk, 0)]
    out = torch.bmm(w[:, None, :], picked.view(-1, k, d))[:, 0]
    if _trace is not None:
        records, with_x = _trace
        records.append({"top_i": top_i[:t], "keep": keep_tk[:t],
                        **({"x": x} if with_x else {})})

    return out[:t], aux

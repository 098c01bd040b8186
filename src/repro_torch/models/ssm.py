"""State-space blocks: Mamba-1 (falcon-mamba-7b) and Mamba-2 / SSD
(zamba2-7b).

The JAX package's Mamba-1 block, function for function.  Prefill and
``forward`` run the whole sequence: in-projection, the depthwise causal
conv, the selective scan (kernel K9 on the card, through
:func:`..kernels.ops.ssm_scan`, which also hands prefill the final state)
and the gated out-projection.  Decode is the O(1)-per-token recurrence in
plain tensor ops, as the JAX step is jnp.

Mamba-2 (:func:`apply_mamba2`, :func:`step_mamba2`) is plain PyTorch
throughout, as the JAX package's is jnp (no Pallas kernel there, so no
kernel here): prefill runs the chunked SSD algorithm
(:func:`ssd_chunked`: dense intra-chunk products, a sequential pass over
the chunks' states), decode the one-step recurrence.  Both cast to
float32 exactly where the JAX code does: ``dt``, ``b``, ``c``, ``x * dt``
and the state ``h``.

Types follow the JAX package's promotion rules, which PyTorch's matmul
does not apply by itself: the serving lanes keep the conv state in
float32 while a bf16 prefill hands over a bf16 one, and a decode step
against a float32 conv state promotes the conv output, and every product
it feeds, to float32 (:func:`_mm`).  The recurrent state is always
float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import causal_conv1d, dense_init, rms_norm
from .sharding_ctx import (batch_axes_of, batch_spec, constrain_to,
                           from_local, is_dtensor, local, split_dims,
                           whole_if_split_past)


class Mamba1Config(NamedTuple):
    d_model: int
    d_inner: int           # 2 * d_model
    d_state: int           # 16
    d_conv: int = 4
    dt_rank: int = 0       # d_model // 16 default


def m1_dt_rank(cfg: Mamba1Config) -> int:
    return cfg.dt_rank or max(cfg.d_model // 16, 1)


def init_mamba1(gen: torch.Generator, cfg: Mamba1Config, *,
                lead: tuple[int, ...] = (), dtype=torch.float32,
                device="cpu") -> dict:
    """Random weights with the JAX package's distributions: uniform dense
    projections, conv taps normal x 0.2, zero biases, ``a_log`` the log of
    1..N for every channel, ``d_skip`` one."""
    di, n, r = cfg.d_inner, cfg.d_state, m1_dt_rank(cfg)
    kw = dict(lead=lead, dtype=dtype, device=device)
    conv_w = torch.empty(lead + (cfg.d_conv, di), dtype=dtype, device=device)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": dense_init(gen, cfg.d_model, 2 * di, **kw),
        "conv_w": conv_w.normal_(0.0, 1.0, generator=gen) * 0.2,
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=device),
        "x_proj": dense_init(gen, di, r + 2 * n, **kw),
        "dt_proj": dense_init(gen, r, di, **kw),
        "dt_bias": torch.zeros(lead + (di,), dtype=dtype, device=device),
        "a_log": a_log.expand(lead + (di, n)).to(dtype).clone(),
        "d_skip": torch.ones(lead + (di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, di, cfg.d_model, **kw),
    }


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted type of the two, as ``jnp.matmul``."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype) @ w.to(dtype)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None):
    """``causal_conv1d``; on a ``DTensor`` x (B, L, C), on this rank's
    shard of batch and, where ``model`` divides them, channels (each
    channel's taps are its own)."""
    if not is_dtensor(x):
        return causal_conv1d(x, w, b)
    from ..distributed.sharding import P
    spec = batch_spec(x, {2: "model"})
    ch = "model" if 2 in split_dims(x, spec) else None
    ax = batch_axes_of(x)
    out = causal_conv1d(local(x, spec), local(w, P(None, ch), partial_over=ax),
                        None if b is None
                        else local(b, P(ch), partial_over=ax))
    return from_local(out, x, spec, tuple(x.shape))


def _scan_local(fn, x, per_channel: tuple, weights: tuple, shared: tuple,
                dim: int):
    """``fn(x, *per_channel, *weights, *shared)`` on this rank's shard of a
    ``DTensor`` x: batch over the batch axes and, where ``model`` divides
    it, x's dimension ``dim`` (Mamba-1's channels, Mamba-2's heads), which
    ``per_channel`` (batch-major, that dimension at ``dim`` too) and
    ``weights`` (that dimension first) share; ``shared`` (B, L, N) every
    channel reads, so their gradient is a partial sum over ``model``.
    The result has x's layout; a (result, final state) pair gives the
    state (B, that dimension, ...) batch- and channel-split alike."""
    from ..distributed.sharding import P
    spec = batch_spec(x, {dim: "model"})
    ch = "model" if dim in split_dims(x, spec) else None
    ax = batch_axes_of(x)
    args = [local(x, spec)]
    args += [local(t, batch_spec(t, {dim: ch})) for t in per_channel]
    args += [local(w, P(ch, *(None,) * (w.dim() - 1)), partial_over=ax)
             for w in weights]
    args += [local(t, batch_spec(t), partial_over=("model",) if ch else ())
             for t in shared]
    out = fn(*args)
    if not isinstance(out, tuple):
        return from_local(out, x, spec, tuple(x.shape))
    y, state = out
    glob = (x.shape[0], x.shape[dim], *state.shape[2:])
    return (from_local(y, x, spec, tuple(x.shape)),
            from_local(state, x, P(spec[0], ch), glob))


def apply_mamba1(p: dict, x: torch.Tensor, cfg: Mamba1Config,
                 return_state: bool = False,
                 use_kernel: bool | None = None):
    """x (B, L, d) -> (B, L, d) [, the final decode state {"conv", "h"}].

    One selective scan per call: K9 on the card, with the final state when
    ``return_state`` asks for it."""
    di, n, r = cfg.d_inner, cfg.d_state, m1_dt_rank(cfg)
    xin_raw, z = _in_proj(x, p["in_proj"], [di, di])
    xin = F.silu(_conv(xin_raw, p["conv_w"], p["conv_b"]))
    dt, bmat, cmat = _row_parallel(xin, p["x_proj"]).split([r, n, n], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())
    if is_dtensor(xin):
        out = _scan_local(
            lambda xl, dtl, al, dl, bl, cl: ops.ssm_scan(
                xl, dtl, al, bl, cl, dl, return_final_state=return_state,
                use_kernel=use_kernel),
            xin, (dt,), (a, p["d_skip"]), (bmat, cmat), 2)
    else:
        out = ops.ssm_scan(xin, dt, a, bmat, cmat, p["d_skip"],
                           return_final_state=return_state,
                           use_kernel=use_kernel)
    y, hf = out if return_state else (out, None)
    out = (y * F.silu(z)) @ p["out_proj"]
    if return_state:
        return out, {"conv": _conv_tail(xin_raw, cfg.d_conv), "h": hf}
    return out


def _in_proj(x: torch.Tensor, w: torch.Tensor, sizes: list) -> tuple:
    """``(x @ w).split(sizes, dim=-1)``.  Over a mesh the weight is split
    into its column blocks first (gathered whole over ``model`` for it)
    and each block split over ``model`` again where it divides, so each
    product stays column-parallel."""
    if not is_dtensor(w):
        return (x @ w).split(sizes, dim=-1)
    from ..distributed.sharding import P
    return tuple(x @ constrain_to(blk, P(None, "model"))
                 for blk in w.split(sizes, dim=-1))


def _row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; over a mesh, with ``w``'s rows split over ``model`` as x's
    channels are and the partial sums all-reduced into x's batch layout
    (the small projection every channel shard feeds)."""
    if not is_dtensor(x):
        return x @ w
    from ..distributed.sharding import P
    out = x @ constrain_to(w, P("model", None))
    return constrain_to(out, batch_spec(out))


def _conv_tail(raw: torch.Tensor, d_conv: int) -> torch.Tensor:
    """Last ``d_conv - 1`` pre-conv inputs (front-padded with zeros), the
    decode conv state."""
    b, length, c = raw.shape
    k = d_conv - 1
    if length >= k:
        return raw[:, length - k:].clone()
    return torch.cat([raw.new_zeros((b, k - length, c)), raw], dim=1)


def init_mamba1_state(batch: int, cfg: Mamba1Config, *,
                      lead: tuple[int, ...] = (), dtype=torch.float32,
                      device="cpu") -> dict:
    """Zero decode state: conv (batch, d_conv - 1, Di) in ``dtype``
    (float32 by default, as in the JAX package), h (batch, Di, N)
    float32."""
    return {
        "conv": torch.zeros(lead + (batch, cfg.d_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros(lead + (batch, cfg.d_inner, cfg.d_state),
                         dtype=torch.float32, device=device),
    }


def step_mamba1(p: dict, x: torch.Tensor, state: dict, cfg: Mamba1Config):
    """One decode step.  x (B, 1, d) -> (y (B, 1, d), new state).  The
    state passed in is not written; the caller stores the new one."""
    di, n, r = cfg.d_inner, cfg.d_state, m1_dt_rank(cfg)
    xin, z = (x[:, 0] @ p["in_proj"]).split(di, dim=-1)       # (B, Di)
    conv_buf = torch.cat([state["conv"], xin[:, None]], dim=1)
    xc = F.silu((conv_buf * p["conv_w"][None]).sum(dim=1) + p["conv_b"])
    dt, bmat, cmat = _mm(xc, p["x_proj"]).split([r, n, n], dim=-1)
    dt = F.softplus(_mm(dt, p["dt_proj"]) + p["dt_bias"])     # (B, Di)
    a = -torch.exp(p["a_log"].float())                        # (Di, N)
    da = torch.exp(dt.float()[..., None] * a[None])           # (B, Di, N)
    h = da * state["h"] + (dt * xc).float()[..., None] \
        * bmat.float()[:, None, :]
    y = (h * cmat.float()[:, None, :]).sum(-1) \
        + p["d_skip"].float() * xc.float()
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return y[:, None], {"conv": conv_buf[:, 1:], "h": h}


# --------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2-7b)
# --------------------------------------------------------------------------


class Mamba2Config(NamedTuple):
    d_model: int
    d_inner: int          # n_heads * head_dim
    d_state: int          # 64
    n_heads: int
    head_dim: int
    d_conv: int = 4
    chunk: int = 64


def init_mamba2(gen: torch.Generator, cfg: Mamba2Config, *,
                lead: tuple[int, ...] = (), dtype=torch.float32,
                device="cpu") -> dict:
    """Random weights with the JAX package's distributions: uniform dense
    projections, conv taps normal x 0.2 over the x, B and C channels,
    zero biases, ``a_log`` the log of 1..H, ``d_skip`` and the gated
    norm's weight one."""
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    conv_dim = di + 2 * n
    kw = dict(lead=lead, dtype=dtype, device=device)
    conv_w = torch.empty(lead + (cfg.d_conv, conv_dim), dtype=dtype,
                         device=device)
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": dense_init(gen, cfg.d_model, 2 * di + 2 * n + h, **kw),
        "conv_w": conv_w.normal_(0.0, 1.0, generator=gen) * 0.2,
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        "a_log": a_log.expand(lead + (h,)).to(dtype).clone(),
        "dt_bias": torch.zeros(lead + (h,), dtype=dtype, device=device),
        "d_skip": torch.ones(lead + (h,), dtype=dtype, device=device),
        "norm_w": torch.ones(lead + (di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, di, cfg.d_model, **kw),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """L[i, j] = sum_{j < t <= i} a_t for i >= j, else -inf.  a: (..., Q)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_head: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                chunk: int, return_final_state: bool = False):
    """The SSD (Mamba-2) chunked algorithm.  x (B, L, H, P); dt (B, L, H),
    positive; a_head (H,), negative; b, c (B, L, N); d_skip (H,) -> y (B,
    L, H, P) in x's dtype [, the final state (B, H, N, P) float32].

    L is padded with zeros to a multiple of the chunk (``min(chunk, L)``);
    a padded step has dt = 0, so its decay is exp(0) = 1 and its input 0,
    and the final state is exact."""
    bs, length, h, pdim = x.shape
    n = b.shape[-1]
    q = min(chunk, length)
    pad = (-length) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = x.shape[1] // q
    xc = x.reshape(bs, nc, q, h, pdim)
    dtc = dt.reshape(bs, nc, q, h).float()
    bc = b.reshape(bs, nc, q, n).float()
    cc = c.reshape(bs, nc, q, n).float()
    a = dtc * a_head                                     # (B, nc, Q, H)

    # intra-chunk: dense products
    lmat = torch.exp(_segsum(a.transpose(2, 3)))         # (B, nc, H, Q, Q)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)     # (B, nc, Q, Q)
    w = scores[:, :, None] * lmat                        # (B, nc, H, Q, Q)
    xdt = xc.float() * dtc[..., None]                    # (B, nc, Q, H, P)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", w, xdt)

    # the chunks' states and the recurrence over chunks
    a_cum = torch.cumsum(a, dim=2)                       # (B, nc, Q, H)
    a_tot = a_cum[:, :, -1]                              # (B, nc, H)
    decay_out = torch.exp(a_tot[:, :, None] - a_cum)     # (B, nc, Q, H)
    s_c = torch.einsum("bcjn,bcjhp,bcjh->bchnp", bc, xdt, decay_out)
    h_run = torch.zeros((bs, h, n, pdim), dtype=torch.float32,
                        device=x.device)
    h_in = []
    for i in range(nc):
        h_in.append(h_run)
        h_run = torch.exp(a_tot[:, i])[..., None, None] * h_run + s_c[:, i]
    h_in = torch.stack(h_in, dim=1)                      # (B, nc, H, N, P)

    decay_in = torch.exp(a_cum)                          # (B, nc, Q, H)
    y_inter = torch.einsum("bcin,bchnp,bcih->bcihp", cc, h_in, decay_in)
    y = y_intra + y_inter + xc.float() * d_skip[:, None]
    y = y.reshape(bs, nc * q, h, pdim)[:, :length].to(x.dtype)
    if return_final_state:
        return y, h_run
    return y


def apply_mamba2(p: dict, x: torch.Tensor, cfg: Mamba2Config,
                 return_state: bool = False):
    """x (B, L, d) -> (B, L, d) [, the final decode state {"conv": (B,
    d_conv - 1, Di + 2N), "h": (B, H, N, P) float32}]."""
    di, n, h, pd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    z, xbc_raw, dt = _in_proj(x, p["in_proj"], [di, di + 2 * n, h])
    xbc = F.silu(_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xin, bmat, cmat = xbc.split([di, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])                   # (B, L, H)
    a_head = -torch.exp(p["a_log"].float())              # (H,)
    bsz, length, _ = x.shape
    xh = whole_if_split_past(xin, -1, h).reshape(bsz, length, h, pd)
    if is_dtensor(xh):
        out = _scan_local(
            lambda xl, dtl, al, dl, bl, cl: ssd_chunked(
                xl, dtl, al, bl, cl, dl, cfg.chunk,
                return_final_state=return_state),
            xh, (dt,), (a_head, p["d_skip"]), (bmat, cmat), 2)
    else:
        out = ssd_chunked(xh, dt, a_head, bmat, cmat, p["d_skip"],
                          cfg.chunk, return_final_state=return_state)
    y, hf = out if return_state else (out, None)
    y = y.reshape(bsz, length, di) * F.silu(z)
    # the gated norm runs over whole rows (gathered over a mesh)
    y = rms_norm(constrain_to(y, batch_spec(y)) if is_dtensor(y) else y,
                 p["norm_w"])
    out = y @ p["out_proj"]
    if return_state:
        return out, {"conv": _conv_tail(xbc_raw, cfg.d_conv), "h": hf}
    return out


def init_mamba2_state(batch: int, cfg: Mamba2Config, *,
                      lead: tuple[int, ...] = (), dtype=torch.float32,
                      device="cpu") -> dict:
    """Zero decode state: conv (batch, d_conv - 1, Di + 2N) in ``dtype``
    (float32 by default, as in the JAX package), h (batch, H, N, P)
    float32."""
    conv_dim = cfg.d_inner + 2 * cfg.d_state
    return {
        "conv": torch.zeros(lead + (batch, cfg.d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "h": torch.zeros(lead + (batch, cfg.n_heads, cfg.d_state,
                                 cfg.head_dim),
                         dtype=torch.float32, device=device),
    }


def step_mamba2(p: dict, x: torch.Tensor, state: dict, cfg: Mamba2Config):
    """One decode step.  x (B, 1, d) -> (y (B, 1, d), new state).  The
    state passed in is not written; the caller stores the new one.  A
    float32 conv state promotes the conv output to float32, as
    ``jnp`` does."""
    di, n, h, pd = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    z, xbc, dt = (x[:, 0] @ p["in_proj"]).split([di, di + 2 * n, h], dim=-1)
    conv_buf = torch.cat([state["conv"], xbc[:, None]], dim=1)
    xbc = F.silu((conv_buf * p["conv_w"][None]).sum(dim=1) + p["conv_b"])
    xin, bmat, cmat = xbc.split([di, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"]).float()           # (B, H)
    a_head = -torch.exp(p["a_log"].float())
    da = torch.exp(dt * a_head[None])                    # (B, H)
    xh = xin.reshape(-1, h, pd).float()
    hst = da[..., None, None] * state["h"] + torch.einsum(
        "bn,bhp,bh->bhnp", bmat.float(), xh, dt)
    y = torch.einsum("bn,bhnp->bhp", cmat.float(), hst) \
        + p["d_skip"][None, :, None] * xh
    y = y.reshape(-1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"])
    return (y @ p["out_proj"])[:, None], {"conv": conv_buf[:, 1:], "h": hst}

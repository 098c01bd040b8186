"""State-space block Mamba-1 (falcon-mamba-7b).

The JAX package's Mamba-1 block, function for function.  Prefill and
``forward`` run the whole sequence: in-projection, the depthwise causal
conv, the selective scan (kernel K9 on the card, through
:func:`..kernels.ops.ssm_scan`, which also hands prefill the final state)
and the gated out-projection.  Decode is the O(1)-per-token recurrence in
plain tensor ops, as the JAX step is jnp.  Mamba-2 (zamba2-7b) is not
ported yet.

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
from .layers import causal_conv1d, dense_init


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


def apply_mamba1(p: dict, x: torch.Tensor, cfg: Mamba1Config,
                 return_state: bool = False,
                 use_kernel: bool | None = None):
    """x (B, L, d) -> (B, L, d) [, the final decode state {"conv", "h"}].

    One selective scan per call: K9 on the card, with the final state when
    ``return_state`` asks for it."""
    di, n, r = cfg.d_inner, cfg.d_state, m1_dt_rank(cfg)
    xin_raw, z = (x @ p["in_proj"]).split(di, dim=-1)
    xin = F.silu(causal_conv1d(xin_raw, p["conv_w"], p["conv_b"]))
    dt, bmat, cmat = (xin @ p["x_proj"]).split([r, n, n], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())
    out = ops.ssm_scan(xin, dt, a, bmat, cmat, p["d_skip"],
                       return_final_state=return_state,
                       use_kernel=use_kernel)
    y, hf = out if return_state else (out, None)
    out = (y * F.silu(z)) @ p["out_proj"]
    if return_state:
        return out, {"conv": _conv_tail(xin_raw, cfg.d_conv), "h": hf}
    return out


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

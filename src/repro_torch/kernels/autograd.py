"""Gradients through the kernels the train path runs: K1 and K9.

The CUDA kernels compute the forward pass only; so do the JAX package's
(its kernels have no ``custom_vjp``, and no backward kernel).  Two
``torch.autograd.Function``s give the train path its gradients:

* :class:`FlashAttentionFn` (K1): ``forward`` launches
  :func:`.flash_attention.flash_attention` with the caller's mask
  (causal, window, a cross key length Sk != Sq) and GQA, and saves q, k,
  v and the output; ``backward`` is the closed-form attention gradient
  in float32 PyTorch ops (:func:`attention_backward`), P recomputed
  under K1's mask rules.
* :class:`SelectiveScanFn` (K9): ``forward`` launches
  :func:`.ssm_scan.selective_scan` without the final state and saves
  its inputs; ``backward`` runs the reverse-time recurrence in float32
  PyTorch ops (:func:`selective_scan_backward`), a loop over L.

Neither backward is the plain version of its kernel: each is the
gradient of the function the kernel computes.  On a CPU tensor the
forward is the kernel's plain version (:mod:`.ref`), as in every
wrapper; on a CUDA tensor it is the kernel, which raises on a failed
build or launch (nothing falls back).  Each Function counts the kernel
launches its forward makes in ``.launches`` (the wrapper's own count
goes up too).

Every other kernel entry point (K2-K8: ``ops.mm``,
``ops.decode_attention``, ``ops.paged_decode``, ``ops.paged_prefill``,
``ops.paged_verify``, ``fdm_stress``) calls :func:`refuse_grad` first,
so no route hands back a tensor without a ``grad_fn`` where a gradient
was asked for.
"""
from __future__ import annotations

import torch

from . import flash_attention as fa
from . import ref
from . import ssm_scan as k9

#: the ROADMAP item that gave K1 and K9 their gradient
GRAD_ITEM = "ROADMAP queue 1, item 9a"


def wants_grad(*tensors: torch.Tensor | None) -> bool:
    """Is a gradient asked for through a call on ``tensors``?"""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: torch.Tensor | None) -> None:
    """``RuntimeError`` when grad is enabled and one of ``tensors``
    requires it: the kernel behind ``name`` has no backward, and its
    output would carry no ``grad_fn``."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{name}: this kernel route has no backward, so its output "
            "would carry no gradient; only K1 (ops.attention) and K9 "
            f"(ops.ssm_scan) take one ({GRAD_ITEM}). Call it under "
            "torch.no_grad() or on inputs that do not require grad")


def visible_keys(sq: int, sk: int, causal: bool, window: int | None,
                 device) -> torch.Tensor:
    """K1's mask (Sq, Sk) bool: query ``i`` sits at absolute position
    ``i + Sk - Sq``; causal keeps keys at or before it, a window the last
    ``window`` of those."""
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kj = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= (qi - kj) < window
    return mask


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, dout: torch.Tensor, *,
                       causal: bool, window: int | None,
                       scale: float | None = None):
    """(dq, dk, dv) of ``out = softmax(scale q k^T + mask) v`` in float32,
    returned in q's, k's and v's types.  q (B, H, Sq, D), k, v (B, Hkv,
    Sk, D) contiguous, ``out`` the forward's output.  The G = H / Hkv
    query heads of a kv head are folded into its rows, so dk and dv come
    out summed over the group::

        P = softmax(scale Q K^T + mask)   (-1e30 where masked; a row with
                                           no visible key is 0, as K1's)
        D = rowsum(dO o O);  dS = P o (dO V^T - D)
        dQ = scale dS K;  dK = scale dS^T Q;  dV = P^T dO
    """
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = float(scale if scale is not None else d ** -0.5)
    rows = (b, hkv, g * sq, d)
    qf = q.float().reshape(rows)
    kf, vf = k.float(), v.float()
    of, dof = out.float().reshape(rows), dout.float().reshape(rows)
    mask = visible_keys(sq, sk, causal, window, q.device).repeat(g, 1)
    s = torch.matmul(qf, kf.transpose(-1, -2)).mul_(scale)
    p = torch.softmax(s.masked_fill_(~mask, ref.NEG_INF), dim=-1)
    del s
    p.mul_(mask.any(dim=-1, keepdim=True))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = torch.matmul(dof, vf.transpose(-1, -2)).sub_(delta).mul_(p)
    dq = torch.matmul(ds, kf).mul_(scale).reshape(b, h, sq, d)
    dk = torch.matmul(ds.transpose(-1, -2), qf).mul_(scale)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """K1 with a gradient: ``apply(q, k, v, causal, window, kernel_kw)``.
    ``kernel_kw`` are K1's keywords (``block_q``, ``block_k``,
    ``scale``); the plain forward of a CPU tensor reads ``scale`` alone.
    The gradients come back in q's, k's and v's shapes and types."""

    launches = 0

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None,
                kernel_kw: dict):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if q.is_cuda:
            out = fa.flash_attention(q, k, v, causal=causal, window=window,
                                     **kernel_kw)
            FlashAttentionFn.launches += 1
        else:
            out = ref.attention_ref(q, k, v, causal=causal, window=window,
                                    scale=kernel_kw.get("scale"))
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = (causal, window, kernel_kw.get("scale"))
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = attention_backward(q, k, v, out, dout, causal=causal,
                                        window=window, scale=scale)
        return dq, dk, dv, None, None, None


def scan_states(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor):
    """The forward recurrence in float32, every step kept: (decay, h),
    each (B, L, Di, N), ``decay[t] = exp(dt[t] A)`` and ``h[t] =
    decay[t] h[t-1] + (dt[t] x[t]) B[t]`` (the arithmetic of
    :func:`.ref.selective_scan_ref`)."""
    dts = dt.float()
    decay = torch.exp(dts[..., None] * a.float())
    inp = (dts * x.float())[..., None] * b.float()[:, :, None, :]
    hs = torch.empty_like(decay)
    h = torch.zeros_like(decay[:, 0])
    for t in range(x.shape[1]):
        h = decay[:, t] * h + inp[:, t]
        hs[:, t] = h
    return decay, hs


def selective_scan_backward(x: torch.Tensor, dt: torch.Tensor,
                            a: torch.Tensor, b: torch.Tensor,
                            c: torch.Tensor, d: torch.Tensor,
                            gy: torch.Tensor):
    """(dx, d dt, dA, dB, dC, dD) of ``y = selective_scan(x, dt, A, B, C,
    D)`` for the output gradient ``gy`` (B, L, Di), in float32, returned
    in the inputs' types.  With ``a_t = exp(dt_t A)`` and the recomputed
    states h_t (:func:`scan_states`), the state gradient runs backwards
    in time::

        g_t = gy_t C_t + a_{t+1} o g_{t+1}
        dC_t = sum_Di gy_t h_t;  dD = sum gy x
        dx_t = gy_t D + dt_t sum_N g_t B_t
        dB_t = sum_Di g_t dt_t x_t
        d dt_t = sum_N g_t a_t h_{t-1} A + x_t sum_N g_t B_t
        dA = sum_{B,L} g_t a_t h_{t-1} dt_t
    """
    length = x.shape[1]
    xs, dts, bs, cs = x.float(), dt.float(), b.float(), c.float()
    a32, gyf = a.float(), gy.float()
    decay, hs = scan_states(x, dt, a, b)
    gh = torch.empty_like(hs)
    g = torch.zeros_like(hs[:, 0])
    for t in range(length - 1, -1, -1):
        if t + 1 < length:
            g = g * decay[:, t + 1]
        g = g + gyf[:, t, :, None] * cs[:, t, None, :]
        gh[:, t] = g
    dc = torch.einsum("bld,bldn->bln", gyf, hs)
    dd = (gyf * xs).sum(dim=(0, 1))
    gb = torch.einsum("bldn,bln->bld", gh, bs)            # sum_N g_t B_t
    dx = gyf * d.float() + dts * gb
    db = torch.einsum("bldn,bld->bln", gh, dts * xs)
    # g_t a_t h_{t-1}, in place over gh (h_{-1} = 0)
    gh.mul_(decay)
    gh[:, 1:].mul_(hs[:, :-1])
    gh[:, 0].zero_()
    ddt = torch.einsum("bldn,dn->bld", gh, a32) + xs * gb
    da = torch.einsum("bldn,bld->dn", gh, dts)
    return (dx.to(x.dtype), ddt.to(dt.dtype), da.to(a.dtype), db.to(b.dtype),
            dc.to(c.dtype), dd.to(d.dtype))


class SelectiveScanFn(torch.autograd.Function):
    """K9 with a gradient, without the final state:
    ``apply(x, dt, a, b, c, d, kernel_kw)`` -> y (B, L, Di).
    ``kernel_kw`` are K9's keywords (``chunk``); the plain forward of a
    CPU tensor reads none."""

    launches = 0

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d, kernel_kw: dict):
        args = tuple(t.contiguous() for t in (x, dt, a, b, c, d))
        if x.is_cuda:
            y = k9.selective_scan(*args, **kernel_kw)
            SelectiveScanFn.launches += 1
        else:
            y = ref.selective_scan_ref(*args)
        ctx.save_for_backward(*args)
        return y

    @staticmethod
    def backward(ctx, gy):
        return (*selective_scan_backward(*ctx.saved_tensors, gy), None)


#: the Functions of this module, for counters and reports
FUNCTIONS = (FlashAttentionFn, SelectiveScanFn)

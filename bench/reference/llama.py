"""A llama-layout decoder in plain PyTorch, float32.

Per layer: RMSNorm -> q, k, v products -> split-half rotary embedding
(angles ``pos x theta^(-2i/Dh)``) -> causal attention, query head ``h``
reading key/value head ``h // (H / Hkv)`` -> output product -> residual
-> RMSNorm -> ``(silu(x Wg) * (x Wu)) Wd`` -> residual; then the final
RMSNorm and the LM head.  Weights are the benchmark's (``benchcore.
weights``), read in whatever dtype they are held in and used in float32.

``precision="fp8"`` is the control: every product's two inputs rounded
to float8 e4m3 first (a scale per weight tensor and per activation row,
as fp8 inference scales them), the rest as in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def no_tf32() -> None:
    """Real float32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor, dim: int | None) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with a scale per slice along
    ``dim`` (None: one scale for the tensor)."""
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True))
    scale = torch.clamp(amax, min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Products:
    """``a @ w`` in the reference's precision.  Under ``fp8`` a weight is
    rounded once per tensor (:meth:`weight`) and each activation row as
    it enters a product."""

    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.precision = precision

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return fp8(w, None) if self.precision == "fp8" else w

    def __call__(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":      # the gradient passes straight through
            a = a + (fp8(a.detach(), -1) - a.detach())
        return a @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (H, S, Dh) at positions 0..S-1."""
    s, dh = x.shape[1], x.shape[2]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                          device=x.device) / dh))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 512) -> torch.Tensor:
    """q (H, S, Dh), k, v (Hkv, S, Dh) -> (S, H x Dh); query rows in
    blocks, so a block's scores are (H, block, S)."""
    h, s, dh = q.shape
    g = h // k.shape[0]
    k = k.repeat_interleave(g, dim=0)
    v = v.repeat_interleave(g, dim=0)
    out = torch.empty_like(q)
    keys = torch.arange(s, device=q.device)
    for r0 in range(0, s, block):
        r1 = min(r0 + block, s)
        sc = (q[:, r0:r1] @ k[:, :r1].transpose(1, 2)) / dh ** 0.5
        mask = keys[None, :r1] > torch.arange(r0, r1, device=q.device)[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        out[:, r0:r1] = torch.softmax(sc, dim=-1) @ v[:, :r1]
    return out.transpose(0, 1).reshape(s, h * dh)


def layer(x: torch.Tensor, lw: dict, m: dict, mm: Products) -> torch.Tensor:
    """One decoder layer over a sequence x (S, d), float32; ``lw`` holds
    the layer's weights as ``mm.weight`` made them."""
    s = x.shape[0]
    h = rms_norm(x, lw["norm1_w"], m["eps"])
    q = mm(h, lw["wq"]).reshape(s, m["H"], m["Dh"]).transpose(0, 1)
    k = mm(h, lw["wk"]).reshape(s, m["Hkv"], m["Dh"]).transpose(0, 1)
    v = mm(h, lw["wv"]).reshape(s, m["Hkv"], m["Dh"]).transpose(0, 1)
    a = causal_attention(rope(q, m["theta"]), rope(k, m["theta"]), v)
    x = x + mm(a, lw["wo"])
    h = rms_norm(x, lw["norm2_w"], m["eps"])
    return x + mm(F.silu(mm(h, lw["w_gate"])) * mm(h, lw["w_up"]),
                  lw["w_down"])


_LAYER_KEYS = (("norm1_w", ("norm1_w",)), ("norm2_w", ("norm2_w",)),
               ("wq", ("attn", "wq")), ("wk", ("attn", "wk")),
               ("wv", ("attn", "wv")), ("wo", ("attn", "wo")),
               ("w_up", ("mlp", "w_up")), ("w_down", ("mlp", "w_down")),
               ("w_gate", ("mlp", "w_gate")))


def layer_weights(weights: dict, i: int, mm: Products,
                  grad: bool = False) -> dict:
    """Layer ``i``'s weights as the reference uses them (views of the
    stacked leaves; float32, or through fp8 under the control)."""
    out = {}
    for name, path in _LAYER_KEYS:
        t = weights["layers"]
        for k in path:
            t = t[k]
        t = t[i]
        if name.startswith("norm"):
            out[name] = t.float()
        elif grad:
            out[name] = t.float() if mm.precision == "f32" else ste_fp8(t)
        else:
            out[name] = mm.weight(t)
    return out


def ste_fp8(w: torch.Tensor) -> torch.Tensor:
    """fp8-rounded weight whose gradient passes straight through."""
    w = w.float()
    return w + (fp8(w, None) - w).detach()


@torch.no_grad()
def served_logits(weights: dict, m: dict, seqs: list[list[int]],
                  rows: list[list[int]], precision: str = "f32"
                  ) -> list[torch.Tensor]:
    """For each token sequence, the float32 logits (len(rows), V) at the
    given positions: layer by layer over all sequences, so each layer's
    weights are converted once."""
    no_tf32()
    mm = Products(precision)
    dev = weights["embed"].device
    xs = [weights["embed"][torch.tensor(s, device=dev)].float() for s in seqs]
    for i in range(m["L"]):
        lw = layer_weights(weights, i, mm)
        xs = [layer(x, lw, m, mm) for x in xs]
        del lw
    head = mm.weight(weights["lm_head"])
    out = []
    for x, r in zip(xs, rows):
        h = rms_norm(x[torch.tensor(r, device=dev)],
                     weights["final_norm_w"], m["eps"])
        out.append(mm(h, head))
    return out

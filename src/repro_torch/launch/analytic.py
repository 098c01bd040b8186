"""First-principles FLOP/byte model per (arch x shape): the roofline's
memory term and the MODEL_FLOPS yardstick (the port's copy of the JAX
package's ``launch/analytic.py``, line for line, so its floats are
bit-equal).

FLOPs are exact einsum counts; bytes are HBM traffic under a
flash-aware attention (KV streamed once per 128-row q block),
capacity-dispatch MoE and ring-buffer caches.  A train step's
MODEL_FLOPS, 6 N_active D, over its measured time and the card's bf16
peak is its share of the peak.

Conventions: fwd matmul (m, k) @ (k, n) = 2mkn FLOPs; bwd = 2x fwd;
bf16 activations/weights on the wire, fp32 optimizer state.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..configs.base import ArchConfig, ShapeConfig

BF16 = 2
F32 = 4


@dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0          # HBM traffic
    detail: dict = field(default_factory=dict)

    def add(self, name: str, flops: float = 0.0, bytes: float = 0.0,
            mult: float = 1.0):
        self.flops += flops * mult
        self.bytes += bytes * mult
        self.detail[name] = {"flops": flops * mult, "bytes": bytes * mult}


def _attn_core(b, h, sq, sk, dh, causal=True, window=None):
    """Flash attention core: FLOPs and HBM traffic (KV streamed per q-block,
    q/out resident once; block_q=128 reuse factor on KV reads)."""
    frac = 1.0
    if window is not None and sk > window:
        frac = min(1.0, window / sk)
    elif causal and sq == sk:
        frac = 0.5
    flops = 4.0 * b * h * sq * sk * dh * frac + 6.0 * b * h * sq * sk * frac
    # traffic: q + out once; kv streamed once per q block-row that needs it
    n_q_blocks = max(sq // 128, 1)
    kv_reads = min(n_q_blocks, max(1.0, n_q_blocks * frac))
    bytes_ = (2 * b * h * sq * dh) * BF16 \
        + (2 * b * h * sk * dh) * BF16 * kv_reads
    return flops, bytes_


def layer_costs(cfg: ArchConfig, b: int, s: int, kind: str,
                decode_cache_len: int = 0) -> Costs:
    """One decoder layer, one *forward* pass over (b, s) tokens."""
    c = Costs()
    d = cfg.d_model
    t = b * s
    fam = cfg.family
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim

    def dense(name, m, k, n, mult=1.0):
        c.add(name, flops=2.0 * m * k * n,
              bytes=(m * k + k * n + m * n) * BF16, mult=mult)

    if fam in ("dense", "vlm", "moe", "encdec"):
        dense("qkv", t, d, hq + 2 * hkv)
        dense("attn_out", t, hq, d)
        if kind == "decode":
            sk = min(decode_cache_len, cfg.window or decode_cache_len)
            fl, by = _attn_core(b, cfg.n_heads, 1, sk, cfg.head_dim,
                                causal=False)
            # decode reads the whole (windowed) cache once
            by = (2 * b * cfg.n_kv_heads * sk * cfg.head_dim) * BF16 \
                + 2 * b * hq * BF16
            c.add("attn_core", fl, by)
        else:
            fl, by = _attn_core(b, cfg.n_heads, s, s, cfg.head_dim,
                                causal=True, window=cfg.window)
            c.add("attn_core", fl, by)
    if fam in ("dense", "vlm", "encdec"):
        dense("mlp", t, d, 3 * cfg.d_ff)
    if fam == "moe":
        c.add("router", flops=2.0 * t * d * cfg.n_experts,
              bytes=(t * d + d * cfg.n_experts) * BF16)
        # capacity dispatch: top_k * capacity_factor tokens hit experts
        eff_t = t * cfg.top_k * cfg.capacity_factor
        dense("experts", eff_t, d, 3 * cfg.d_ff)
        # dispatch/combine einsums + all-to-all staging
        cap_elems = eff_t * d
        c.add("dispatch", flops=4.0 * cap_elems,
              bytes=4 * cap_elems * BF16)
        if cfg.n_shared_experts:
            dense("shared_expert", t, d,
                  3 * cfg.d_ff * cfg.n_shared_experts)
    if fam == "ssm" and cfg.ssm_version == 1:
        di, n = cfg.ssm_d_inner, cfg.ssm_state
        r = max(d // 16, 1)
        dense("in_proj", t, d, 2 * di)
        dense("x_proj", t, di, r + 2 * n)
        dense("dt_proj", t, r, di)
        dense("out_proj", t, di, d)
        # selective scan: ~10 flops per (t, di, n) cell
        c.add("scan", flops=10.0 * t * di * n,
              bytes=(4 * t * di + 2 * t * n) * BF16 + t * di * BF16)
        c.add("conv", flops=2.0 * t * di * 4, bytes=2 * t * di * BF16)
    if fam == "hybrid" and cfg.ssm_version == 2:
        di, n = cfg.ssm_d_inner, cfg.ssm_state
        h = cfg.ssm_n_heads
        q = cfg.ssm_chunk
        dense("in_proj", t, d, 2 * di + 2 * n + h)
        dense("out_proj", t, di, d)
        c.add("conv", flops=2.0 * t * (di + 2 * n) * 4,
              bytes=2 * t * (di + 2 * n) * BF16)
        if kind == "decode":
            c.add("ssd_step", flops=6.0 * b * h * n * cfg.ssm_head_dim,
                  bytes=2 * b * h * n * cfg.ssm_head_dim * F32)
        else:
            nc = max(s // q, 1)
            p = cfg.ssm_head_dim
            intra = 2.0 * b * nc * q * q * (n + h * p) + 3.0 * b * nc * h * q * q
            states = 4.0 * b * nc * q * h * n * p
            c.add("ssd", flops=intra + states,
                  bytes=(3 * t * di + 2 * t * n) * BF16
                  + 2 * b * nc * h * n * p * F32)
    return c


def shared_attn_costs(cfg: ArchConfig, b: int, s: int, kind: str,
                      cache_len: int = 0) -> Costs:
    """zamba2 shared attention+MLP block (one application)."""
    c = Costs()
    d = cfg.d_model
    t = b * s
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim

    def dense(name, m, k, n):
        c.add(name, flops=2.0 * m * k * n,
              bytes=(m * k + k * n + m * n) * BF16)

    dense("qkv", t, d, hq + 2 * hkv)
    dense("attn_out", t, hq, d)
    dense("mlp", t, d, 3 * cfg.d_ff)
    if kind == "decode":
        sk = min(cache_len, cfg.window or cache_len)
        fl, _ = _attn_core(b, cfg.n_heads, 1, sk, cfg.head_dim, causal=False)
        by = (2 * b * cfg.n_kv_heads * sk * cfg.head_dim) * BF16
        c.add("attn_core", fl, by)
    else:
        fl, by = _attn_core(b, cfg.n_heads, s, s, cfg.head_dim, True,
                            cfg.window)
        c.add("attn_core", fl, by)
    return c


def embed_head_costs(cfg: ArchConfig, b: int, s: int, kind: str) -> Costs:
    c = Costs()
    d, v = cfg.d_model, cfg.padded_vocab
    t = b * s if kind != "decode" else b
    c.add("embed", flops=0.0, bytes=(t * d) * BF16 + t * 4)
    if kind in ("train",):
        c.add("head", flops=2.0 * t * d * v,
              bytes=(t * d + d * v + t * v) * BF16)
    else:
        tt = b  # prefill/decode: last-position logits only... prefill: b
        c.add("head", flops=2.0 * tt * d * v,
              bytes=(tt * d + d * v + tt * v) * BF16)
    return c


def optimizer_costs(cfg: ArchConfig) -> Costs:
    c = Costs()
    n = cfg.param_count()
    # read p, m, v, g; write p, m, v (fp32)
    c.add("adamw", flops=12.0 * n, bytes=7.0 * n * F32)
    return c


def step_costs(cfg: ArchConfig, shape: ShapeConfig) -> Costs:
    """Whole step: forward (+backward+optimizer for train)."""
    kind = shape.kind
    b, s = shape.global_batch, shape.seq_len
    if kind == "decode":
        per_layer = layer_costs(cfg, b, 1, "decode", decode_cache_len=s)
        eh = embed_head_costs(cfg, b, 1, "decode")
    else:
        per_layer = layer_costs(cfg, b, s, kind)
        eh = embed_head_costs(cfg, b, s, kind)
    total = Costs()
    bwd_mult = 3.0 if kind == "train" else 1.0   # fwd + 2x bwd
    total.add("layers", per_layer.flops * bwd_mult,
              per_layer.bytes * bwd_mult, mult=cfg.n_layers)
    # weight traffic: every parameter read once per fwd (+once per bwd)
    wt = cfg.param_count() * BF16 * (2 if kind == "train" else 1)
    total.add("weights", 0.0, wt)
    napp = cfg.n_shared_attn_applications()
    if napp:
        sc = shared_attn_costs(cfg, b, 1 if kind == "decode" else s, kind,
                               cache_len=s)
        total.add("shared_attn", sc.flops * bwd_mult, sc.bytes * bwd_mult,
                  mult=napp)
    if cfg.is_encoder_decoder and kind != "decode":
        enc_layer = layer_costs(cfg, b, cfg.frontend_seq or s, kind)
        total.add("encoder", enc_layer.flops * bwd_mult,
                  enc_layer.bytes * bwd_mult, mult=cfg.n_encoder_layers)
    total.add("embed_head", eh.flops * bwd_mult, eh.bytes * bwd_mult)
    if kind == "train":
        oc = optimizer_costs(cfg)
        total.add("optimizer", oc.flops, oc.bytes)
    return total


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch      # decode: one token per seq

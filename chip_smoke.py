#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

Phases, one line each (a failed check raises and the script exits
non-zero; nothing falls back to the CPU or to the plain versions):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: nvcc compiles every CUDA source of the port (``csrc/*.cu``),
   all in parallel;
3. K1 ``flash_attention`` against its plain version at the prefill shapes
   of yi-6b and deepseek-7b and a few edge shapes, with its time, bound,
   plain time and the time of torch's SDPA on the same inputs;
4. K2 ``flash_decode`` likewise at the decode shapes, plus a
   ``kv_len == 0`` row that must come out exactly 0;
5. serve: ``serve_config`` on yi-6b at full width (32 layers, d_model
   4096, random weights from a seed), 8 requests over 4 lanes; every
   request must finish with 32 tokens, and the kernels' launch counters,
   zeroed just before, must show K1 once per layer per admission and K2
   once per layer per decode step;
6. logits: prefill + 4 decode steps at the full config, through the
   kernels and through the plain versions, must agree.

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Exits 2 without printing a result
when no CUDA device is present.

Usage::

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.serve import ServeConfig, serve_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet, dense): the least
# time a kernel could take is the larger of bytes / HBM rate and
# operations / peak rate for the operands' type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}   # rtol = atol
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
BF16 = torch.bfloat16


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def randn(shape, seed: int, dtype) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def compare(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol * |want|."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    err = (got - want).abs()
    tol = TOL[dtype]
    check(bool((err <= tol + tol * want.abs()).all()),
          f"max abs err {float(err.max()):.3e} over tolerance {tol}")
    return float(err.max())


def time_ms(fn, iters: int = 20) -> tuple[float, float]:
    """(device ms, call ms) of one call of ``fn``, means over ``iters``.

    Device ms: CUDA events around each launch, all enqueued behind a spin
    kernel so the host's launch overhead is not in the interval, and each
    after a 64 MiB write that evicts the 50 MB L2 (on the main path a
    layer's KV cache is cold: it is not read again until the next step).
    Call ms: host clock around back-to-back calls ending in a sync, i.e.
    what a caller waits per call, wrapper overhead included."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)      # ~50 ms of spinning at ~2 GHz
    for start, end in marks:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    device = sum(s.elapsed_time(e) for s, e in marks) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return device, (time.perf_counter() - t0) * 1e3 / iters


def bound(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name!r} count {torch.cuda.device_count()} "
          f"capability {torch.cuda.get_device_capability(0)}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = build.build_all()
    fa._lib()
    dt = time.perf_counter() - t0
    print(f"[2 build] {len(paths)} source(s) built and loaded in {dt:.1f}s: "
          + ", ".join(p.name for p in paths.values()))
    for p in paths.values():
        log = p.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    ptxas {line.strip()}")


def phase_k1() -> dict:
    # (label, B, H, Hkv, S, D, dtype, causal, window)
    cases = [("yi-6b prefill", 1, 32, 4, 512, 128, BF16, True, None),
             ("deepseek-7b prefill", 1, 32, 32, 512, 128, BF16, True, None),
             ("S=300", 1, 32, 4, 300, 128, BF16, True, None),
             ("window=64", 1, 32, 4, 512, 128, BF16, True, 64),
             ("non-causal", 1, 32, 4, 512, 128, BF16, False, None),
             ("fp32 reduced", 2, 4, 2, 100, 16, torch.float32, True, None)]
    errs = []
    for i, (label, b, h, hkv, s, d, dtype, causal, window) in enumerate(cases):
        q = randn((b, h, s, d), 10 * i, dtype)
        k = randn((b, hkv, s, d), 10 * i + 1, dtype)
        v = randn((b, hkv, s, d), 10 * i + 2, dtype)
        err = compare(fa.flash_attention(q, k, v, causal=causal, window=window),
                      ref.attention_ref(q, k, v, causal=causal, window=window),
                      dtype)
        errs.append(f"{label} {err:.2e}")
    print(f"[3 K1 flash_attention] max abs err vs plain (tol bf16 "
          f"{TOL[BF16]}, fp32 {TOL[torch.float32]}): " + "; ".join(errs))

    # timing at the main path's shape: a yi-6b prefill of 512 tokens
    b, h, hkv, s, d = 1, 32, 4, 512, 128
    q, k, v = (randn((b, n, s, d), 90 + j, BF16)
               for j, n in enumerate((h, hkv, hkv)))
    err = compare(fa.flash_attention(q, k, v), ref.attention_ref(q, k, v), BF16)
    pairs = s * (s + 1) // 2                      # causal (q, k) pairs
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    bound_ms, bound_by = bound(n_bytes, 4 * b * h * pairs * d, BF16)
    times = {
        "ms": time_ms(lambda: fa.flash_attention(q, k, v)),
        "plain_ms": time_ms(lambda: ref.attention_ref(q, k, v)),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))}
    print(f"[3 K1 flash_attention] yi-6b prefill B=1 H=32 Hkv=4 S=512 D=128 "
          f"bf16, device ms (ms per call incl. host): "
          + ", ".join(f"{k} {d:.4f} ({c:.4f})" for k, (d, c) in times.items())
          + f", bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "flash_attention", "route": "cuda", "source": SOURCE,
            "replaces": "src/repro/kernels/flash_attention.py:106",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            **{k: d for k, (d, _) in times.items()}}


def phase_k2() -> dict:
    # (label, B, H, Hkv, S, D, dtype)
    cases = [("yi-6b decode", 4, 32, 4, 1024, 128, BF16),
             ("deepseek-7b decode", 4, 32, 32, 1024, 128, BF16),
             ("fp32 reduced", 2, 4, 2, 64, 16, torch.float32)]
    errs = []
    for i, (label, b, h, hkv, s, d, dtype) in enumerate(cases):
        q = randn((b, h, 1, d), 100 + 10 * i, dtype)
        k = randn((b, hkv, s, d), 101 + 10 * i, dtype)
        v = randn((b, hkv, s, d), 102 + 10 * i, dtype)
        gen = torch.Generator(device="cuda").manual_seed(103 + 10 * i)
        kv_len = torch.randint(1, s + 1, (b,), generator=gen, device="cuda",
                               dtype=torch.int32)
        err = compare(fa.flash_decode(q, k, v, kv_len),
                      ref.decode_ref(q, k, v, kv_len), dtype)
        errs.append(f"{label} {err:.2e}")
    # a row with kv_len == 0 is exactly 0 (the plain version gives the
    # mean of v there, so that row is checked on its own)
    q = randn((2, 32, 1, 128), 140, BF16)
    k = randn((2, 4, 256, 128), 141, BF16)
    kv_len = torch.tensor([0, 77], dtype=torch.int32, device="cuda")
    out = fa.flash_decode(q, k, k, kv_len)
    torch.cuda.synchronize()
    check(bool((out[0] == 0).all()), "kv_len == 0 row is not exactly 0")
    compare(out[1:], ref.decode_ref(q, k, k, kv_len)[1:], BF16)
    errs.append("kv_len==0 row exactly 0")
    print(f"[4 K2 flash_decode] max abs err vs plain (tol bf16 {TOL[BF16]}, "
          f"fp32 {TOL[torch.float32]}): " + "; ".join(errs))

    # timing at the main path's shape: yi-6b, 4 lanes, max_len 1024
    b, h, hkv, s, d = 4, 32, 4, 1024, 128
    q = randn((b, h, 1, d), 150, BF16)
    k = randn((b, hkv, s, d), 151, BF16)
    v = randn((b, hkv, s, d), 152, BF16)
    gen = torch.Generator(device="cuda").manual_seed(153)
    kv_len = torch.randint(1, s + 1, (b,), generator=gen, device="cuda",
                           dtype=torch.int32)
    err = compare(fa.flash_decode(q, k, v, kv_len),
                  ref.decode_ref(q, k, v, kv_len), BF16)
    keys = int(kv_len.sum())
    n_bytes = 2 * (2 * keys * hkv * d + 2 * b * h * d) + 4 * b
    bound_ms, bound_by = bound(n_bytes, 4 * h * keys * d, BF16)
    mask = (torch.arange(s, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
    times = {
        "ms": time_ms(lambda: fa.flash_decode(q, k, v, kv_len)),
        "plain_ms": time_ms(lambda: ref.decode_ref(q, k, v, kv_len)),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True))}
    print(f"[4 K2 flash_decode] yi-6b decode B=4 H=32 Hkv=4 S=1024 D=128 "
          f"bf16 kv_len={kv_len.tolist()}, device ms (ms per call incl. "
          f"host): "
          + ", ".join(f"{k} {d:.4f} ({c:.4f})" for k, (d, c) in times.items())
          + f", bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "flash_decode", "route": "cuda", "source": SOURCE,
            "replaces": "src/repro/kernels/flash_attention.py:203",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            **{k: d for k, (d, _) in times.items()}}


def phase_serve(smi: str) -> dict[str, int]:
    n_layers, n_requests, max_new = 32, 8, 32
    for kernel in fa.KERNELS:
        kernel.launches = 0
    report = serve_config(ServeConfig(
        arch="yi-6b", reduced=False, n_requests=n_requests, n_lanes=4,
        max_len=1024, prompt_len=512, max_new=max_new, device="cuda"))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in fa.KERNELS}
    check(report["finished"] == n_requests,
          f"{report['finished']}/{n_requests} requests finished")
    check(all(len(t) == max_new for t in report["outputs"].values()),
          "a request did not get its 32 tokens")
    check(launches["flash_attention"] == n_layers * n_requests,
          f"K1 launched {launches['flash_attention']} times, expected "
          f"{n_layers * n_requests} (one per layer per admission)")
    check(launches["flash_decode"] == n_layers * report["decode_steps"],
          f"K2 launched {launches['flash_decode']} times, expected "
          f"{n_layers} x {report['decode_steps']} decode steps")
    print(f"[5 serve] yi-6b full (32 layers, d_model 4096): "
          f"{report['finished']}/{n_requests} requests, "
          f"{report['generated_tokens']} tokens in {report['wall_s']:.3f}s = "
          f"{report['tokens_per_s']:.1f} tok/s, p50 ttft "
          f"{report['p50_ttft_s']:.4f}s, p50 itl {report['p50_itl_s']:.4f}s, "
          f"{report['decode_steps']} decode steps, launches {launches} "
          f"on {smi}")
    return launches


def phase_logits() -> None:
    """Prefill + 4 decode steps of one prompt at the full config, through
    the kernels and through the plain versions, fed the same tokens.

    Tolerance: both paths compute attention in float32 from the same bf16
    inputs and round the output to bf16, so they differ by at most an ulp
    of bf16 (2^-8 relative) per attention output element; 32 layers of
    bf16 matmuls carry that into the logits.  The check allows 5e-2 of
    the logits' own scale (their max magnitude), and reports the argmax
    agreement beside it."""
    cfg = get_arch("yi-6b")
    model = build_model(cfg)
    params = model.init(0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen,
                           device="cuda")
    tokens: list[int] = []
    runs = {}
    for use_kernel in (False, True):
        logits, caches = model.prefill(params, prompt, 256,
                                       use_kernel=use_kernel)
        steps = [logits]
        for i in range(4):
            if not use_kernel:
                tokens.append(int(steps[-1][0].argmax()))
            token = torch.tensor([[tokens[i]]], device="cuda")
            pos = torch.tensor([prompt.shape[1] + i], device="cuda")
            logits, caches = model.decode_step(params, caches, token, pos,
                                               use_kernel=use_kernel)
            steps.append(logits)
        runs[use_kernel] = torch.stack(steps)
    torch.cuda.synchronize()
    plain, kern = runs[False], runs[True]
    check(tuple(kern.shape) == (5, 1, cfg.padded_vocab), "logits shape")
    check(bool(torch.isfinite(kern).all() and torch.isfinite(plain).all()),
          "logits are not finite")
    scale = float(plain.abs().max())
    err = float((kern - plain).abs().max())
    agree = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    check(err <= 5e-2 * scale,
          f"logits differ by {err:.3e}, over 5e-2 x scale {scale:.3e}")
    print(f"[6 logits] yi-6b full, prefill 128 + 4 decode steps: kernels vs "
          f"plain max abs diff {err:.3e} (logit scale {scale:.3e}, tol "
          f"{5e-2 * scale:.3e}), argmax agrees {agree}/5")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    rows = [phase_k1(), phase_k2()]
    launches = phase_serve(smi)
    phase_logits()
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

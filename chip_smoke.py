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
   4096, random weights from a seed), 8 requests over 4 dense lanes;
   every request must finish with 32 tokens, and the kernels' launch
   counters, zeroed just before, must show K1 once per layer per
   admission, K2 once per layer per decode step, and no K3 or K4;
6. logits: prefill + 4 decode steps at the full config, through the
   kernels and through the plain versions, must agree;
7. K3 ``flash_paged_decode`` against its plain version at the paged
   decode shapes (shuffled pages, table entries past ``kv_len`` on page
   0), plus a ``kv_len == 0`` row that must come out exactly 0, with its
   time, bound, plain time and the time of SDPA on the pre-gathered K/V;
8. K4 ``flash_paged_prefill`` likewise at the prefill-chunk shapes (a
   chunk at 0, at 384, starting mid-page, a ragged last chunk);
9. paged serve: the same requests through the paged KV pool with chunked
   prefill (chunks of 128, pages of 16); every request must finish with
   32 tokens and the counters must show K4 once per layer per chunk, K3
   once per layer per decode step, and no K1 or K2;
10. paged logits: a 300-token prompt as chunks of 128 (the last ragged)
   + 4 paged decode steps at the full config, kernels against plain.

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Exits 2 without printing a result
when no CUDA device is present.

Usage::

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch.serve import ServeConfig, serve_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet, dense): the least
# time a kernel could take is the larger of bytes / HBM rate and
# operations / peak rate for the operands' type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}   # rtol = atol
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
PAGED_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
KERNELS = fa.KERNELS + pa.KERNELS
BF16 = torch.bfloat16
SERVE = dict(arch="yi-6b", reduced=False, n_requests=8, n_lanes=4,
             max_len=1024, prompt_len=512, max_new=32, device="cuda")


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
    pa._lib()
    dt = time.perf_counter() - t0
    print(f"[2 build] {len(paths)} source(s) built and loaded in {dt:.1f}s: "
          + ", ".join(p.name for p in paths.values()))
    for p in paths.values():
        log = p.with_suffix(".log")
        if log.exists():
            text = log.read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spills = [int(r) for r in
                      re.findall(r"(\d+) bytes spill stores", text)]
            print(f"    ptxas {p.name}: {len(regs)} kernels, registers "
                  f"max {max(regs, default=0)}, spill stores "
                  f"{sum(spills)} bytes in {sum(1 for x in spills if x)} "
                  f"kernels (full report in {log.name})")


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


def serve_with_counts(**kw) -> tuple[dict, dict[str, int]]:
    """One ``serve_config`` run of the phase-5 requests, with every
    kernel's launch counter zeroed just before and read just after."""
    for kernel in KERNELS:
        kernel.launches = 0
    report = serve_config(ServeConfig(**SERVE, **kw))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in KERNELS}
    n_requests, max_new = SERVE["n_requests"], SERVE["max_new"]
    check(report["finished"] == n_requests,
          f"{report['finished']}/{n_requests} requests finished")
    check(all(len(t) == max_new for t in report["outputs"].values()),
          "a request did not get its 32 tokens")
    return report, launches


def phase_serve(smi: str) -> tuple[dict, dict[str, int]]:
    n_layers, n_requests = 32, SERVE["n_requests"]
    report, launches = serve_with_counts()
    check(launches["flash_paged_decode"] == launches["flash_paged_prefill"]
          == 0, f"the dense serve launched paged kernels: {launches}")
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
    return report, launches


def phase_logits(model, params) -> None:
    """Prefill + 4 decode steps of one prompt at the full config, through
    the kernels and through the plain versions, fed the same tokens.

    Tolerance: both paths compute attention in float32 from the same bf16
    inputs and round the output to bf16, so they differ by at most an ulp
    of bf16 (2^-8 relative) per attention output element; 32 layers of
    bf16 matmuls carry that into the logits.  The check allows 5e-2 of
    the logits' own scale (their max magnitude), and reports the argmax
    agreement beside it."""
    cfg = model.cfg
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


def paged_case(b, h, hkv, d, psz, nblk, kv_len, dtype, seed, c=1):
    """q (B, H, c, D), bf16/fp32 pools of B * nblk pages plus the null
    page, a table of shuffled distinct pages whose entries past kv_len
    point at page 0, and kv_len (B,) int32."""
    n_pages = b * nblk + 1
    q = randn((b, h, c, d), seed, dtype)
    kp = randn((n_pages, hkv, psz, d), seed + 1, dtype)
    vp = randn((n_pages, hkv, psz, d), seed + 2, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1)
    table = table.reshape(b, nblk).to(torch.int32)
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    live = torch.arange(nblk, device="cuda")[None, :] * psz < lens[:, None]
    table = torch.where(live, table, 0).to(torch.int32).contiguous()
    return q, kp, vp, table, lens


def phase_k3() -> dict:
    # (label, B, H, Hkv, D, psz, nblk, kv_len, dtype)
    cases = [("yi-6b paged decode", 4, 32, 4, 128, 16, 64,
              [1024, 517, 33, 300], BF16),
             ("deepseek-7b paged decode", 4, 32, 32, 128, 16, 64,
              [700, 1024, 16, 1], BF16),
             ("fp32 reduced", 2, 4, 2, 16, 8, 8, [61, 7], torch.float32)]
    errs = []
    for i, (label, b, h, hkv, d, psz, nblk, kv_len, dtype) in enumerate(cases):
        q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                            dtype, 200 + 10 * i)
        err = compare(pa.flash_paged_decode(q, kp, vp, table, lens),
                      ref.paged_decode_ref(q, kp, vp, table, lens), dtype)
        errs.append(f"{label} {err:.2e}")
    q, kp, vp, table, lens = paged_case(2, 32, 4, 128, 16, 8, [0, 77], BF16,
                                        240)
    out = pa.flash_paged_decode(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    check(bool((out[0] == 0).all()), "K3: kv_len == 0 row is not exactly 0")
    compare(out[1:], ref.paged_decode_ref(q, kp, vp, table, lens)[1:], BF16)
    errs.append("kv_len==0 row exactly 0")
    print(f"[7 K3 flash_paged_decode] max abs err vs plain (tol bf16 "
          f"{TOL[BF16]}, fp32 {TOL[torch.float32]}): " + "; ".join(errs))

    # timing at the main path's shape: yi-6b, 4 lanes of max_len 1024 in
    # pages of 16 (the pool of the paged serve phase)
    b, h, hkv, d, psz, nblk = 4, 32, 4, 128, 16, 64
    kv_len = [839, 720, 190, 544]
    q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                        BF16, 250)
    err = compare(pa.flash_paged_decode(q, kp, vp, table, lens),
                  ref.paged_decode_ref(q, kp, vp, table, lens), BF16)
    keys = sum(kv_len)
    live_pages = sum(-(-n // psz) for n in kv_len)
    n_bytes = 2 * (2 * keys * hkv * d + 2 * b * h * d) + 4 * (live_pages + b)
    bound_ms, bound_by = bound(n_bytes, 4 * h * keys * d, BF16)
    k_dense = ref.gather_pages(kp, table)          # gathered once, untimed
    v_dense = ref.gather_pages(vp, table)
    mask = (torch.arange(nblk * psz, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    times = {
        "ms": time_ms(lambda: pa.flash_paged_decode(q, kp, vp, table, lens)),
        "plain_ms": time_ms(
            lambda: ref.paged_decode_ref(q, kp, vp, table, lens)),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k_dense, v_dense, attn_mask=mask, enable_gqa=True))}
    print(f"[7 K3 flash_paged_decode] yi-6b B=4 H=32 Hkv=4 D=128 psz=16 "
          f"nblk=64 bf16 kv_len={kv_len}, device ms (ms per call incl. "
          f"host): "
          + ", ".join(f"{k} {d:.4f} ({c:.4f})" for k, (d, c) in times.items())
          + f", bound {bound_ms:.5f} ms ({bound_by}); library = SDPA with a "
          f"kv_len mask on the pre-gathered dense K/V (gather not timed)")
    return {"name": "flash_paged_decode", "route": "cuda",
            "source": PAGED_SOURCE,
            "replaces": "src/repro/kernels/flash_attention.py:434",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            **{k: d for k, (d, _) in times.items()}}


def phase_k4() -> dict:
    # (label, H, Hkv, D, psz, C, start, valid rows, dtype): sequence 0 has
    # the chunk at ``start``; sequence 1 a full chunk at 0
    cases = [("yi-6b chunk at 0", 32, 4, 128, 16, 128, 0, 128, BF16),
             ("yi-6b chunk at 384", 32, 4, 128, 16, 128, 384, 128, BF16),
             ("mid-page start 200", 32, 4, 128, 16, 128, 200, 128, BF16),
             ("ragged last chunk", 32, 4, 128, 16, 128, 256, 44, BF16),
             ("deepseek-7b chunk", 32, 32, 128, 16, 128, 256, 128, BF16),
             ("fp32 reduced", 4, 2, 16, 8, 8, 12, 5, torch.float32)]
    errs = []
    for i, (label, h, hkv, d, psz, c, start, valid, dtype) in enumerate(cases):
        nblk = -(-(start + c) // psz)
        q, kp, vp, table, lens = paged_case(2, h, hkv, d, psz, nblk,
                                            [start + valid, c], dtype,
                                            300 + 10 * i, c=c)
        starts = torch.tensor([start, 0], dtype=torch.int32, device="cuda")
        got = pa.flash_paged_prefill(q, kp, vp, table, starts, lens)
        want = ref.paged_prefill_ref(q, kp, vp, table, starts, lens)
        # rows at positions >= kv_len are padding: not compared
        err = max(compare(got[:1, :, :valid], want[:1, :, :valid], dtype),
                  compare(got[1:], want[1:], dtype))
        errs.append(f"{label} {err:.2e}")
    q, kp, vp, table, lens = paged_case(2, 32, 4, 128, 16, 2, [0, 20], BF16,
                                        370, c=8)
    starts = torch.tensor([0, 12], dtype=torch.int32, device="cuda")
    out = pa.flash_paged_prefill(q, kp, vp, table, starts, lens)
    torch.cuda.synchronize()
    check(bool((out[0] == 0).all()), "K4: rows with no key are not exactly 0")
    compare(out[1:], ref.paged_prefill_ref(q, kp, vp, table, starts,
                                           lens)[1:], BF16)
    errs.append("kv_len==0 rows exactly 0")
    print(f"[8 K4 flash_paged_prefill] max abs err vs plain (tol bf16 "
          f"{TOL[BF16]}, fp32 {TOL[torch.float32]}): " + "; ".join(errs))

    # timing at the main path's shape: a yi-6b chunk of 128 at start 384
    # (kv_len 512) in pages of 16
    h, hkv, d, psz, c, start = 32, 4, 128, 16, 128, 384
    kv = start + c
    q, kp, vp, table, lens = paged_case(1, h, hkv, d, psz, kv // psz, [kv],
                                        BF16, 380, c=c)
    starts = torch.tensor([start], dtype=torch.int32, device="cuda")
    err = compare(pa.flash_paged_prefill(q, kp, vp, table, starts, lens),
                  ref.paged_prefill_ref(q, kp, vp, table, starts, lens), BF16)
    pairs = sum(start + i + 1 for i in range(c))   # causal (q, k) pairs
    n_bytes = 2 * (2 * q.numel() + 2 * kv * hkv * d) + 4 * (kv // psz + 2)
    bound_ms, bound_by = bound(n_bytes, 4 * h * pairs * d, BF16)
    k_dense = ref.gather_pages(kp, table)          # gathered once, untimed
    v_dense = ref.gather_pages(vp, table)
    causal = (torch.arange(kv, device="cuda")[None, :]
              <= start + torch.arange(c, device="cuda")[:, None])
    times = {
        "ms": time_ms(lambda: pa.flash_paged_prefill(q, kp, vp, table, starts,
                                                     lens)),
        "plain_ms": time_ms(lambda: ref.paged_prefill_ref(q, kp, vp, table,
                                                          starts, lens)),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k_dense, v_dense, attn_mask=causal, enable_gqa=True))}
    print(f"[8 K4 flash_paged_prefill] yi-6b B=1 H=32 Hkv=4 C=128 D=128 "
          f"psz=16 bf16 start=384 kv_len=512 ({pairs} causal pairs per "
          f"head), device ms (ms per call incl. host): "
          + ", ".join(f"{k} {d:.4f} ({c:.4f})" for k, (d, c) in times.items())
          + f", bound {bound_ms:.5f} ms ({bound_by}); library = SDPA with "
          f"the causal mask on the pre-gathered dense K/V (gather not timed)")
    return {"name": "flash_paged_prefill", "route": "cuda",
            "source": PAGED_SOURCE,
            "replaces": "src/repro/kernels/flash_attention.py:668",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            **{k: d for k, (d, _) in times.items()}}


def phase_paged_serve(smi: str, dense: dict) -> dict[str, int]:
    n_layers = 32
    report, launches = serve_with_counts(cache="paged", page_size=16,
                                         prefill_chunk=128)
    check(launches["flash_paged_prefill"] == n_layers * report["prefill_chunks"],
          f"K4 launched {launches['flash_paged_prefill']} times, expected "
          f"{n_layers} x {report['prefill_chunks']} prefill chunks")
    check(launches["flash_paged_decode"] == n_layers * report["decode_steps"],
          f"K3 launched {launches['flash_paged_decode']} times, expected "
          f"{n_layers} x {report['decode_steps']} decode steps")
    check(launches["flash_attention"] == launches["flash_decode"] == 0,
          f"the paged serve launched dense kernels: {launches}")
    check(report["cache"]["n_pages"] == 257, "default pool is not 257 pages")
    same = sum(a == b for rid, toks in report["outputs"].items()
               for a, b in zip(toks, dense["outputs"][rid]))
    total = sum(len(t) for t in report["outputs"].values())
    print(f"[9 paged serve] yi-6b full, pages of 16 (257), chunks of 128: "
          f"{report['finished']}/{SERVE['n_requests']} requests, "
          f"{report['generated_tokens']} tokens in {report['wall_s']:.3f}s = "
          f"{report['tokens_per_s']:.1f} tok/s, p50 ttft "
          f"{report['p50_ttft_s']:.4f}s, p50 itl {report['p50_itl_s']:.4f}s, "
          f"{report['prefill_chunks']} prefill chunks, "
          f"{report['decode_steps']} decode steps, preemptions "
          f"{report['preemptions']}, launches {launches}, kv "
          f"{json.dumps(report['cache'])}; greedy tokens equal to the dense "
          f"serve's (reported only: bf16 sums differ in order) "
          f"{same}/{total}, on {smi}")
    return launches


def phase_paged_logits(model, params) -> None:
    """A 300-token prompt as chunks of 128 (the last one ragged, its
    padded positions past the table's last block) and 4 paged decode
    steps at the full config, through the kernels and through the plain
    versions, fed the same tokens; same tolerance as phase 6."""
    cfg = model.cfg
    psz, c, plen, max_len = 16, 128, 300, 320
    nblk = max_len // psz
    gen = torch.Generator(device="cuda").manual_seed(8)
    prompt = torch.randint(0, cfg.vocab_size, (1, plen), generator=gen,
                           device="cuda")
    table = (torch.randperm(nblk, generator=gen, device="cuda") + 1)
    table = table.to(torch.int32)[None]
    dev = lambda *x: torch.tensor(x, device="cuda")  # noqa: E731
    tokens: list[int] = []
    runs = {}
    for use_kernel in (False, True):
        caches = model.init_paged_caches(nblk + 1, psz, device="cuda")
        steps = []
        for start in range(0, plen, c):
            end = min(start + c, plen)
            chunk = torch.zeros((1, c), dtype=torch.long, device="cuda")
            chunk[0, :end - start] = prompt[0, start:end]
            logits, caches = model.paged_prefill_step(
                params, caches, table, chunk, dev(start), dev(end),
                dev(end - start - 1), use_kernel=use_kernel)
            steps.append(logits)
        for i in range(4):
            if not use_kernel:
                tokens.append(int(steps[-1][0].argmax()))
            logits, caches = model.paged_decode_step(
                params, caches, table, dev([tokens[i]]), dev(plen + i),
                use_kernel=use_kernel)
            steps.append(logits)
        runs[use_kernel] = torch.stack(steps)
    torch.cuda.synchronize()
    plain, kern = runs[False], runs[True]
    check(tuple(kern.shape) == (7, 1, cfg.padded_vocab), "paged logits shape")
    check(bool(torch.isfinite(kern).all() and torch.isfinite(plain).all()),
          "paged logits are not finite")
    scale = float(plain.abs().max())
    err = float((kern - plain).abs().max())
    agree = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    check(err <= 5e-2 * scale,
          f"paged logits differ by {err:.3e}, over 5e-2 x scale {scale:.3e}")
    print(f"[10 paged logits] yi-6b full, 300-token prompt as chunks of 128 "
          f"+ 4 paged decode steps: kernels vs plain max abs diff {err:.3e} "
          f"(logit scale {scale:.3e}, tol {5e-2 * scale:.3e}), argmax "
          f"agrees {agree}/7")


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
    dense, launches = phase_serve(smi)
    model = build_model(get_arch("yi-6b"))
    params = model.init(0, "cuda")
    phase_logits(model, params)
    rows += [phase_k3(), phase_k4()]
    launches.update({k: n for k, n in phase_paged_serve(smi, dense).items()
                     if k.startswith("flash_paged")})
    phase_paged_logits(model, params)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

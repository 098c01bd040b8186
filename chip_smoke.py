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
   + 4 paged decode steps at the full config, kernels against plain;
11. split-KV decode, K5a (phase 1) + K5c (combine), against the split and
   the one-pass plain versions at the phase-7 shapes for 2, 3 and 8
   splits, ``num_splits=1`` equal to K3 exactly, a ``kv_len == 0`` row
   exactly 0, and a sweep of the split count at the phase-7 timing shape
   with phase 1 and the combine timed apart;
12. int8 pages: K6a (decode), K6b + K5c (split decode, 8 splits) and K6c
   (prefill chunk) against their plain versions on pools quantized from
   the phase-7 and phase-8 cases, rows without keys exactly 0, with
   times at the phase-7 and phase-8 timing shapes;
13. serves of the phase-5 requests from the paged pool in chunks of 128:
   int8 pages with 8 splits, int8 pages in one pass, and fp pages with 8
   splits; every request must finish with 32 tokens and each serve's
   counters must show its kernels once per layer per chunk or decode
   step, and no other kernel;
14. int8 paged logits: phase 10's prompt and decode steps (two in one
   pass, two with 8 splits) over int8 pools, kernels against plain.

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
from repro_torch.distributed.compression import quantize_int8_rows  # noqa: E402
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
FLASH = "src/repro/kernels/flash_attention.py"
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
    check(all(launches[k.__name__] == 0 for k in pa.KERNELS),
          f"the dense serve launched paged kernels: {launches}")
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
    the kernels and through the plain versions, fed the same tokens."""
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
    print(f"[6 logits] yi-6b full, prefill 128 + 4 decode steps: "
          + check_logits(runs[False], runs[True], cfg.padded_vocab, "logits"))


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


def greedy_agreement(report: dict, other: dict) -> str:
    """Tokens equal position by position to another serve's, as a count."""
    same = sum(a == b for rid, toks in report["outputs"].items()
               for a, b in zip(toks, other["outputs"][rid]))
    return f"{same}/{sum(len(t) for t in report['outputs'].values())}"


def only_launched(launches: dict[str, int], kernels, what: str) -> None:
    """Every kernel outside ``kernels`` was launched no time."""
    names = {k.__name__ for k in kernels}
    stray = {k: n for k, n in launches.items() if n and k not in names}
    check(not stray, f"{what} launched other kernels: {stray}")


def phase_paged_serve(smi: str, dense: dict) -> tuple[dict, dict[str, int]]:
    n_layers = 32
    report, launches = serve_with_counts(cache="paged", page_size=16,
                                         prefill_chunk=128)
    check(launches["flash_paged_prefill"] == n_layers * report["prefill_chunks"],
          f"K4 launched {launches['flash_paged_prefill']} times, expected "
          f"{n_layers} x {report['prefill_chunks']} prefill chunks")
    check(launches["flash_paged_decode"] == n_layers * report["decode_steps"],
          f"K3 launched {launches['flash_paged_decode']} times, expected "
          f"{n_layers} x {report['decode_steps']} decode steps")
    only_launched(launches, (pa.flash_paged_prefill, pa.flash_paged_decode),
                  "the paged serve")
    check(report["cache"]["n_pages"] == 257, "default pool is not 257 pages")
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
          f"{greedy_agreement(report, dense)}, on {smi}")
    return report, launches


def paged_logits(model, params, quantized: bool = False,
                 splits=(None,) * 4) -> tuple[torch.Tensor, torch.Tensor]:
    """A 300-token prompt as chunks of 128 (the last one ragged, its
    padded positions past the table's last block) and one paged decode
    step per entry of ``splits`` (its ``num_splits``) at the full config,
    through the kernels and through the plain versions, fed the same
    tokens; returns the (plain, kernel) logits of every step."""
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
        caches = model.init_paged_caches(nblk + 1, psz, device="cuda",
                                         quantized=quantized)
        steps = []
        for start in range(0, plen, c):
            end = min(start + c, plen)
            chunk = torch.zeros((1, c), dtype=torch.long, device="cuda")
            chunk[0, :end - start] = prompt[0, start:end]
            logits, caches = model.paged_prefill_step(
                params, caches, table, chunk, dev(start), dev(end),
                dev(end - start - 1), use_kernel=use_kernel)
            steps.append(logits)
        for i, ns in enumerate(splits):
            if not use_kernel:
                tokens.append(int(steps[-1][0].argmax()))
            logits, caches = model.paged_decode_step(
                params, caches, table, dev([tokens[i]]), dev(plen + i),
                use_kernel=use_kernel, num_splits=ns)
            steps.append(logits)
        runs[use_kernel] = torch.stack(steps)
    torch.cuda.synchronize()
    return runs[False], runs[True]


def check_logits(plain: torch.Tensor, kern: torch.Tensor, vocab: int,
                 what: str) -> str:
    """Kernel against plain logits of the same steps (phases 6, 10, 14).

    Tolerance: both paths compute attention in float32 from the same bf16
    inputs and round the output to bf16, so they differ by at most an ulp
    of bf16 (2^-8 relative) per attention output element (int8 pages:
    the same codes and scales on both paths); 32 layers of bf16 matmuls
    carry that into the logits.  The check allows 5e-2 of the logits' own
    scale (their max magnitude), and reports the argmax agreement beside
    it."""
    check(tuple(kern.shape) == (plain.shape[0], 1, vocab), f"{what} shape")
    check(bool(torch.isfinite(kern).all() and torch.isfinite(plain).all()),
          f"{what} are not finite")
    scale = float(plain.abs().max())
    err = float((kern - plain).abs().max())
    agree = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    check(err <= 5e-2 * scale,
          f"{what} differ by {err:.3e}, over 5e-2 x scale {scale:.3e}")
    return (f"kernels vs plain max abs diff {err:.3e} (logit scale "
            f"{scale:.3e}, tol {5e-2 * scale:.3e}), argmax agrees "
            f"{agree}/{plain.shape[0]}")


def phase_paged_logits(model, params) -> None:
    plain, kern = paged_logits(model, params)
    print(f"[10 paged logits] yi-6b full, 300-token prompt as chunks of 128 "
          f"+ 4 paged decode steps: "
          + check_logits(plain, kern, model.cfg.padded_vocab, "paged logits"))


def row(name: str, source: str, replaces: str, err: float, n_bytes: float,
        n_ops: float, times: dict, dtype=BF16) -> dict:
    """One kernel's entry of the ``kernels`` JSON line."""
    bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "bound_ms": bound_ms,
            "bound_by": bound_by,
            **{k: (None if v is None else v[0]) for k, v in times.items()}}


def fmt_times(times: dict) -> str:
    return ", ".join(f"{k} {v[0]:.4f} ({v[1]:.4f})" for k, v in times.items()
                     if v is not None)


def decode_bytes(kv_len, b, h, hkv, d, psz, kv_elem: int, q_elem: int,
                 scale_bytes: int = 0) -> float:
    """Bytes a paged decode must move: every live K/V row (and its scales)
    once, q in and o out, the live table entries and kv_len."""
    keys = sum(kv_len)
    live_pages = sum(-(-n // psz) for n in kv_len)
    return (2 * keys * hkv * (d * kv_elem + scale_bytes)
            + 2 * b * h * d * q_elem + 4 * (live_pages + b))


def phase_k5() -> list[dict]:
    # (label, B, H, Hkv, D, psz, nblk, kv_len, dtype): the phase-7 cases
    cases = [("yi-6b paged decode", 4, 32, 4, 128, 16, 64,
              [1024, 517, 33, 300], BF16),
             ("deepseek-7b paged decode", 4, 32, 32, 128, 16, 64,
              [700, 1024, 16, 1], BF16),
             ("fp32 reduced", 2, 4, 2, 16, 8, 8, [61, 7], torch.float32)]
    errs = []
    for i, (label, b, h, hkv, d, psz, nblk, kv_len, dtype) in enumerate(cases):
        q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                            dtype, 200 + 10 * i)
        one_pass = ref.paged_decode_ref(q, kp, vp, table, lens)
        check(torch.equal(pa.flash_paged_decode(q, kp, vp, table, lens,
                                                num_splits=1),
                          pa.flash_paged_decode(q, kp, vp, table, lens)),
              f"K5 {label}: num_splits=1 is not K3's output")
        for ns in (2, 3, 8):
            got = pa.flash_paged_decode(q, kp, vp, table, lens, num_splits=ns)
            err = max(compare(got, ref.paged_decode_split_ref(
                q, kp, vp, table, lens, ns), dtype),
                compare(got, one_pass, dtype))
            errs.append(f"{label} ns={ns} {err:.2e}")
    q, kp, vp, table, lens = paged_case(2, 32, 4, 128, 16, 8, [0, 77], BF16,
                                        240)
    out = pa.flash_paged_decode(q, kp, vp, table, lens, num_splits=8)
    torch.cuda.synchronize()
    check(bool((out[0] == 0).all()), "K5: kv_len == 0 row is not exactly 0")
    compare(out[1:], ref.paged_decode_ref(q, kp, vp, table, lens)[1:], BF16)
    errs.append("kv_len==0 row exactly 0; ns=1 equal to K3")
    print(f"[11 K5 split-KV decode] max abs err vs plain (tol bf16 "
          f"{TOL[BF16]}, fp32 {TOL[torch.float32]}): " + "; ".join(errs))

    # the split-count sweep at the phase-7 timing shape
    b, h, hkv, d, psz, nblk = 4, 32, 4, 128, 16, 64
    kv_len = [839, 720, 190, 544]
    q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                        BF16, 250)
    want = ref.paged_decode_ref(q, kp, vp, table, lens)
    sweep = []
    for ns in (1, 2, 4, 8, 16):
        if ns == 1:
            p1 = time_ms(lambda: pa.flash_paged_decode(q, kp, vp, table, lens))
            sweep.append(f"ns=1 (K3) {p1[0]:.4f}")
            continue
        parts = pa.paged_decode_split(q, kp, vp, table, lens, ns)
        p1 = time_ms(lambda: pa.paged_decode_split(q, kp, vp, table, lens, ns))
        p2 = time_ms(lambda: pa.split_combine(*parts, BF16))
        whole = time_ms(lambda: pa.flash_paged_decode(q, kp, vp, table, lens,
                                                      num_splits=ns))
        sweep.append(f"ns={ns} phase 1 {p1[0]:.4f} + combine {p2[0]:.4f} = "
                     f"{p1[0] + p2[0]:.4f} (one call {whole[0]:.4f})")
        if ns == 8:
            parts8, t1, t2 = parts, p1, p2
    print(f"[11 K5 split-KV decode] yi-6b B=4 H=32 Hkv=4 D=128 psz=16 "
          f"nblk=64 bf16 kv_len={kv_len}, device ms by split count: "
          + "; ".join(sweep))

    ns, g = 8, h // hkv
    err1 = compare(pa.flash_paged_decode(q, kp, vp, table, lens, num_splits=ns),
                   want, BF16)
    m, l, acc = parts8
    _, l_star, acc_star = ref.combine_split_states(m, l, acc)
    err2 = compare(pa.split_combine(m, l, acc, BF16),
                   ref.finalize_split_states(l_star, acc_star).to(BF16), BF16)
    partial_bytes = 4 * b * hkv * ns * g * (2 + d)
    k_dense = ref.gather_pages(kp, table)          # gathered once, untimed
    v_dense = ref.gather_pages(vp, table)
    mask = (torch.arange(nblk * psz, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    keys = sum(kv_len)
    k5a = {"ms": t1,
           "plain_ms": time_ms(lambda: ref.paged_decode_split_ref(
               q, kp, vp, table, lens, ns)),
           "library_ms": time_ms(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k_dense, v_dense, attn_mask=mask, enable_gqa=True))}
    k5c = {"ms": t2,
           "plain_ms": time_ms(lambda: ref.finalize_split_states(
               *ref.combine_split_states(m, l, acc)[1:]).to(BF16)),
           "library_ms": None}
    rows = [row("paged_decode_split", PAGED_SOURCE, f"{FLASH}:535", err1,
                decode_bytes(kv_len, b, h, hkv, d, psz, 2, 2) + partial_bytes,
                4 * h * keys * d, k5a),
            row("split_combine", PAGED_SOURCE, f"{FLASH}:315", err2,
                partial_bytes + 2 * b * h * d, 4 * b * h * ns * d, k5c)]
    print(f"[11 K5 split-KV decode] ns=8 at that shape, device ms (ms per "
          f"call incl. host): K5a {fmt_times(k5a)}, bound "
          f"{rows[0]['bound_ms']:.5f} ms ({rows[0]['bound_by']}); K5c "
          f"{fmt_times(k5c)}, bound {rows[1]['bound_ms']:.5f} ms "
          f"({rows[1]['bound_by']}); plain K5a = the split plain version "
          f"(both phases), K5c = combine + finalize on the same partials; "
          f"library = SDPA with a kv_len mask on the pre-gathered K/V "
          f"(gather not timed)")
    return rows


def phase_k6() -> list[dict]:
    errs = []
    # decode on pools quantized from the phase-7 cases
    cases = [("yi-6b paged decode", 4, 32, 4, 128, 16, 64,
              [1024, 517, 33, 300], BF16),
             ("deepseek-7b paged decode", 4, 32, 32, 128, 16, 64,
              [700, 1024, 16, 1], BF16),
             ("fp32 reduced", 2, 4, 2, 16, 8, 8, [61, 7], torch.float32),
             ("kv_len 0", 2, 32, 4, 128, 16, 8, [0, 77], BF16)]
    for i, (label, b, h, hkv, d, psz, nblk, kv_len, dtype) in enumerate(cases):
        q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                            dtype, 400 + 10 * i)
        (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
        want = ref.paged_decode_ref(q, k8, v8, table, lens, k_scale=ks,
                                    v_scale=vs)
        for ns in (1, 8):
            got = pa.flash_paged_decode_quant(q, k8, v8, ks, vs, table, lens,
                                              num_splits=ns)
            live = torch.tensor(kv_len, device="cuda") > 0
            if not bool(live.all()):
                torch.cuda.synchronize()
                check(bool((got[~live] == 0).all()),
                      f"K6 ns={ns}: kv_len == 0 row is not exactly 0")
            err = compare(got[live], want[live], dtype)
            errs.append(f"{label} ns={ns} {err:.2e}")
    # prefill chunks on pools quantized from the phase-8 cases
    cases = [("yi-6b chunk at 0", 32, 4, 128, 16, 128, 0, 128, BF16),
             ("yi-6b chunk at 384", 32, 4, 128, 16, 128, 384, 128, BF16),
             ("mid-page start 200", 32, 4, 128, 16, 128, 200, 128, BF16),
             ("ragged last chunk", 32, 4, 128, 16, 128, 256, 44, BF16),
             ("fp32 reduced", 4, 2, 16, 8, 8, 12, 5, torch.float32)]
    for i, (label, h, hkv, d, psz, c, start, valid, dtype) in enumerate(cases):
        nblk = -(-(start + c) // psz)
        q, kp, vp, table, lens = paged_case(2, h, hkv, d, psz, nblk,
                                            [start + valid, c], dtype,
                                            500 + 10 * i, c=c)
        (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
        starts = torch.tensor([start, 0], dtype=torch.int32, device="cuda")
        got = pa.flash_paged_prefill_quant(q, k8, v8, ks, vs, table, starts,
                                           lens)
        want = ref.paged_prefill_ref(q, k8, v8, table, starts, lens,
                                     k_scale=ks, v_scale=vs)
        err = max(compare(got[:1, :, :valid], want[:1, :, :valid], dtype),
                  compare(got[1:], want[1:], dtype))
        errs.append(f"{label} {err:.2e}")
    q, kp, vp, table, lens = paged_case(2, 32, 4, 128, 16, 2, [0, 20], BF16,
                                        570, c=8)
    (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
    starts = torch.tensor([0, 12], dtype=torch.int32, device="cuda")
    out = pa.flash_paged_prefill_quant(q, k8, v8, ks, vs, table, starts, lens)
    torch.cuda.synchronize()
    check(bool((out[0] == 0).all()), "K6c: rows with no key are not exactly 0")
    errs.append("rows without keys exactly 0")
    print(f"[12 K6 int8 pages] max abs err vs plain (tol bf16 {TOL[BF16]}, "
          f"fp32 {TOL[torch.float32]}): " + "; ".join(errs))

    # decode timings at the phase-7 timing shape
    b, h, hkv, d, psz, nblk = 4, 32, 4, 128, 16, 64
    kv_len = [839, 720, 190, 544]
    q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                        BF16, 250)
    (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
    want = ref.paged_decode_ref(q, k8, v8, table, lens, k_scale=ks,
                                v_scale=vs)
    k_dense = ref.gather_pages(k8.to(BF16) * ks[..., None].to(BF16), table)
    v_dense = ref.gather_pages(v8.to(BF16) * vs[..., None].to(BF16), table)
    mask = (torch.arange(nblk * psz, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_dense, v_dense, attn_mask=mask, enable_gqa=True))
    keys, ns, g = sum(kv_len), 8, h // hkv
    n_bytes = decode_bytes(kv_len, b, h, hkv, d, psz, 1, 2, scale_bytes=4)
    k6a = {"ms": time_ms(lambda: pa.flash_paged_decode_quant(
               q, k8, v8, ks, vs, table, lens)),
           "plain_ms": time_ms(lambda: ref.paged_decode_ref(
               q, k8, v8, table, lens, k_scale=ks, v_scale=vs)),
           "library_ms": sdpa}
    k6b = {"ms": time_ms(lambda: pa.paged_decode_split_quant(
               q, k8, v8, ks, vs, table, lens, ns)),
           "plain_ms": time_ms(lambda: ref.paged_decode_split_ref(
               q, k8, v8, table, lens, ns, k_scale=ks, v_scale=vs)),
           "library_ms": sdpa}
    rows = [row("flash_paged_decode_quant", PAGED_SOURCE, f"{FLASH}:951",
                compare(pa.flash_paged_decode_quant(q, k8, v8, ks, vs, table,
                                                    lens), want, BF16),
                n_bytes, 4 * h * keys * d, k6a),
            row("paged_decode_split_quant", PAGED_SOURCE, f"{FLASH}:1001",
                compare(pa.flash_paged_decode_quant(q, k8, v8, ks, vs, table,
                                                    lens, num_splits=ns),
                        want, BF16),
                n_bytes + 4 * b * hkv * ns * g * (2 + d), 4 * h * keys * d,
                k6b)]
    print(f"[12 K6 int8 pages] yi-6b decode B=4 H=32 Hkv=4 D=128 psz=16 "
          f"nblk=64 bf16 q, int8 pools, kv_len={kv_len}, device ms (ms per "
          f"call incl. host): K6a {fmt_times(k6a)}, bound "
          f"{rows[0]['bound_ms']:.5f} ms ({rows[0]['bound_by']}); K6b (8 "
          f"splits, phase 1) {fmt_times(k6b)}, bound "
          f"{rows[1]['bound_ms']:.5f} ms ({rows[1]['bound_by']})")

    # prefill timing at the phase-8 timing shape: a chunk of 128 at 384
    h, hkv, d, psz, c, start = 32, 4, 128, 16, 128, 384
    kv = start + c
    q, kp, vp, table, lens = paged_case(1, h, hkv, d, psz, kv // psz, [kv],
                                        BF16, 380, c=c)
    (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
    starts = torch.tensor([start], dtype=torch.int32, device="cuda")
    err = compare(pa.flash_paged_prefill_quant(q, k8, v8, ks, vs, table,
                                               starts, lens),
                  ref.paged_prefill_ref(q, k8, v8, table, starts, lens,
                                        k_scale=ks, v_scale=vs), BF16)
    pairs = sum(start + i + 1 for i in range(c))
    k_dense = ref.gather_pages(k8.to(BF16) * ks[..., None].to(BF16), table)
    v_dense = ref.gather_pages(v8.to(BF16) * vs[..., None].to(BF16), table)
    causal = (torch.arange(kv, device="cuda")[None, :]
              <= start + torch.arange(c, device="cuda")[:, None])
    k6c = {"ms": time_ms(lambda: pa.flash_paged_prefill_quant(
               q, k8, v8, ks, vs, table, starts, lens)),
           "plain_ms": time_ms(lambda: ref.paged_prefill_ref(
               q, k8, v8, table, starts, lens, k_scale=ks, v_scale=vs)),
           "library_ms": time_ms(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k_dense, v_dense, attn_mask=causal, enable_gqa=True))}
    n_bytes = 2 * 2 * q.numel() + 2 * kv * hkv * (d + 4) + 4 * (kv // psz + 2)
    rows.append(row("flash_paged_prefill_quant", PAGED_SOURCE, f"{FLASH}:1186",
                    err, n_bytes, 4 * h * pairs * d, k6c))
    print(f"[12 K6 int8 pages] yi-6b chunk B=1 H=32 Hkv=4 C=128 D=128 psz=16 "
          f"bf16 q, int8 pools, start=384 kv_len=512, device ms (ms per call "
          f"incl. host): K6c {fmt_times(k6c)}, bound "
          f"{rows[2]['bound_ms']:.5f} ms ({rows[2]['bound_by']}); library = "
          f"SDPA on the pre-gathered, pre-dequantized bf16 K/V (gather and "
          f"dequant not timed)")
    return rows


def phase_split_int8_serves(smi: str, paged: dict) -> dict[str, int]:
    """The phase-9 serve with int8 pages and split-KV: (a) int8 with 8
    splits, (b) int8 in one pass, (c) fp with 8 splits.  Returns each new
    kernel's launches from the serve that runs it (K5c from (a))."""
    n_layers = 32
    serves = [("int8, 8 splits", dict(kv_dtype="int8", num_splits=8),
               (pa.flash_paged_prefill_quant, pa.paged_decode_split_quant,
                pa.split_combine)),
              ("int8, one pass", dict(kv_dtype="int8"),
               (pa.flash_paged_prefill_quant, pa.flash_paged_decode_quant)),
              ("fp, 8 splits", dict(num_splits=8),
               (pa.flash_paged_prefill, pa.paged_decode_split,
                pa.split_combine))]
    counts, lines = {}, []
    for label, kw, (prefill, *decode) in serves:
        report, launches = serve_with_counts(cache="paged", page_size=16,
                                             prefill_chunk=128, **kw)
        what = f"the {label} serve"
        only_launched(launches, (prefill, *decode), what)
        check(launches[prefill.__name__]
              == n_layers * report["prefill_chunks"],
              f"{what}: {prefill.__name__} launched "
              f"{launches[prefill.__name__]} times, expected {n_layers} x "
              f"{report['prefill_chunks']} prefill chunks")
        for kernel in decode:
            check(launches[kernel.__name__] == n_layers * report["decode_steps"],
                  f"{what}: {kernel.__name__} launched "
                  f"{launches[kernel.__name__]} times, expected {n_layers} x "
                  f"{report['decode_steps']} decode steps")
        check(report["kv_dtype"] == kw.get("kv_dtype", "fp"), "kv_dtype")
        for name, n in launches.items():
            if n:
                counts.setdefault(name, n)
        cache = report["cache"]
        lines.append(
            f"{label}: {report['tokens_per_s']:.1f} tok/s, p50 ttft "
            f"{report['p50_ttft_s']:.4f}s, p50 itl {report['p50_itl_s']:.4f}s, "
            f"{report['prefill_chunks']} chunks, {report['decode_steps']} "
            f"decode steps, launches "
            f"{ {k: n for k, n in launches.items() if n} }, pool_bytes "
            f"{cache['pool_bytes']} ({cache['kv_bytes_per_token']:.1f} B per "
            f"token) against fp {paged['cache']['pool_bytes']}, kv "
            f"{json.dumps(cache)}, greedy tokens equal to the phase-9 "
            f"serve's {greedy_agreement(report, paged)}")
    print(f"[13 split-KV and int8 serves] yi-6b full, pages of 16, chunks of "
          f"128, on {smi}: " + "; ".join(lines))
    return {k.__name__: counts[k.__name__] for k in
            (pa.paged_decode_split, pa.split_combine,
             pa.flash_paged_decode_quant, pa.paged_decode_split_quant,
             pa.flash_paged_prefill_quant)}


def phase_int8_logits(model, params) -> None:
    plain, kern = paged_logits(model, params, quantized=True,
                               splits=(None, None, 8, 8))
    print(f"[14 int8 paged logits] yi-6b full, int8 pools, 300-token prompt "
          f"as chunks of 128 + 2 decode steps in one pass + 2 with 8 splits: "
          + check_logits(plain, kern, model.cfg.padded_vocab,
                         "int8 paged logits"))


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
    paged, paged_launches = phase_paged_serve(smi, dense)
    launches.update({k: paged_launches[k] for k in
                     ("flash_paged_decode", "flash_paged_prefill")})
    phase_paged_logits(model, params)
    rows += phase_k5() + phase_k6()
    launches.update(phase_split_int8_serves(smi, paged))
    phase_int8_logits(model, params)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

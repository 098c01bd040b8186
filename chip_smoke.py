#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

Phases, one line each (a failed check raises and the script exits
non-zero; nothing falls back to the CPU or to the plain versions):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: nvcc compiles every CUDA source of the port (``csrc/*.cu``),
   all in parallel; the tensor-core prefill kernel's instances
   (``paged_prefill.cu``) with their registers and spills from the
   ``-Xptxas -v`` log, their shared memory and resident blocks per SM;
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
   chunk at 0, at 384, starting mid-page, a ragged last chunk): bf16 on
   the tensor-core kernel, float32 on the SIMT template; timed at the
   main path's chunk and at the verify shape (``num_splits=1``) beside
   the SIMT template's walk of the same work (K5b with one split + K5c),
   the plain version, SDPA and the bound;
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
   times at the phase-7 and phase-8 timing shapes (K6c beside the SIMT
   template's walk, K6d with one split + K5c);
13. serves of the phase-5 requests from the paged pool in chunks of 128:
   int8 pages with 8 splits, int8 pages in one pass, and fp pages with 8
   splits; every request must finish with 32 tokens and each serve's
   counters must show its kernels once per layer per chunk or decode
   step, and no other kernel;
14. int8 paged logits: phase 10's prompt and decode steps (two in one
   pass, two with 8 splits) over int8 pools, kernels against plain;
15. split prefill/verify, K5b (phase 1) + K5c, against the split plain
   version (partials and output) and the one-pass plain version at the
   verify shapes of yi-6b and deepseek-7b (4 lanes with chunks of 5 and
   an idle lane with no key, which must come out exactly 0) and at the
   phase-8 chunk, for 2, 3 and 8 splits; a sweep of the split count at
   both timing shapes (``num_splits=1`` is K4's own launch), phase 1 and
   the combine timed apart;
16. K6d + K5c, the same over pools quantized from the phase-15 cases;
17. serves of yi-6b at full width from the paged pool in chunks of 128:
   (a) speculative, a self-speculative draft of 16 layers proposing 4
   tokens per tick, verify with 8 splits; (b) the same over int8 pages;
   (c) the prefix cache with a shared 256-token system prompt; (d) (c)
   with the cache off; (e) (a) on an engine built here with a draft of
   all 32 layers, which is the target, so its greedy drafts must be
   accepted (near-ties apart).  Every request must finish with 32 tokens
   and the
   counters must show each serve's kernels exactly (K5b or K6d, and K5c,
   once per layer per verify; the draft's K1 and K2 once per draft layer
   per draft prefill and decode step, counted here by wrapping the
   draft's methods), and (c) must save prefill chunks against (d);
18. verify logits: phase 10's prompt, then one speculative verify of 5
   tokens in one pass and with 8 splits, over bf16 and int8 pools,
   kernels against plain, and a one-token verify against the paged
   decode step.
19. K8 ``matmul`` against its plain version: float32 and bfloat16, with
   and without bias, all four epilogues, ragged shapes, every
   instantiated tile; the shared-memory formula of the install-time
   cost model against the kernel's; every bf16 tile timed at yi-6b's MLP
   projection of a 512-token prefill (M=512, K=4096, N=11008), beside
   its bound, its plain version and ``torch.matmul``;
20. K7 ``fdm_stress``, fused and split, against its plain version on a
   ragged 60x50x130 grid and a 256^3 one, over several tiles, and both
   variants timed over those tiles at 256^3 with their bounds;
21. the install path: in a fresh workdir ``register_kernel_regions`` at
   the phase-19 shape and ``run_install_tuning(wall_clock=True)``, whose
   CUDA-event executor times K8 on every candidate tile; the trajectory,
   the winner and the record file (whose fingerprint must name the card);
   ``ops.mm`` must then launch K8 with the winner's tiles, and a second
   session on the workdir must measure nothing; then Sample 8 at both
   levels (``examples/autotune_fdm_torch.py``'s ``main``).  The launch
   counters are zeroed before this phase and read after it (the
   ``SsmChunk`` region, declared beside ``MatmulBlocks``, launches K9
   here too; phase 25 reports it);
22. K9 ``selective_scan`` against its plain version: float32 and
   bfloat16, ragged L and Di, every ``SsmChunk`` candidate, with and
   without the final state, at small widths and at falcon-mamba-7b's
   (Di 8192, N 16, L 512, B 1 and 4); the shared-memory formula of the
   cost model against the kernel's; the chunk sweep timed at the
   prefill shape (B 1, L 512, bf16, with the final state) beside its
   bound and the plain version;
23. serve: ``serve_config`` on falcon-mamba-7b at full width (64 Mamba-1
   layers, d_inner 8192, random weights from a seed), phase 5's 8
   requests over 4 dense lanes; every request must finish with 32
   tokens, and the counters must show K9 exactly once per layer per
   admission and no K1-K8;
24. falcon-mamba logits: a 300-token prompt and 4 decode steps at the
   full config, kernels against plain, and ``forward``'s last-position
   logits against prefill's;
25. the ``SsmChunk`` install run: in a fresh workdir at (seq 512, d_inner
   8192, d_state 16), the CUDA-event executor times K9 at the chunks the
   d-spline samples; the trajectory, the fit beside the measured chunks
   and the winner; ``ops.ssm_scan`` must then launch K9 with the
   winner's chunk, and a second session must measure nothing.

Then the script's run time, one JSON line with every kernel's numbers,
and as the last line
``{"ok": true, "device": {...}}``.  Exits 2 without printing a result
when no CUDA device is present.

Usage::

    python3 chip_smoke.py
"""
from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
import tempfile
import time
from collections.abc import Callable
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import repro_torch.at as at  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed.compression import quantize_int8_rows  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import fdm_stress as fk  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import matmul as mmk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssm_scan as k9  # noqa: E402
from repro_torch.launch.serve import (ServeConfig, draw_prompts,  # noqa: E402
                                      serve_config, serve_engine)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.core.fitting import fit_dspline  # noqa: E402
from repro_torch.tuning import (register_kernel_regions,  # noqa: E402
                                run_install_tuning)
from repro_torch.tuning.install import CHUNK_VALUES  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet, dense): the least
# time a kernel could take is the larger of bytes / HBM rate and
# operations / peak rate for the operands' type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}   # rtol = atol
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
PAGED_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
PREFILL_SOURCE = "src/repro_torch/kernels/csrc/paged_prefill.cu"
TC_KERNEL = "paged_prefill_tc_kernel"
KERNELS = fa.KERNELS + pa.KERNELS + mmk.KERNELS + fk.KERNELS + k9.KERNELS
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
    pa._tc_lib()
    mmk._lib()
    fk._lib()
    k9._lib()
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
    log = paths["paged_prefill"].with_suffix(".log")
    if log.exists():
        lines = []
        for kind, d, regs, spill in tc_instances(log.read_text()):
            info = pa.tc_info(d, kind == "int8", 64)
            lines.append(f"{kind} D={d}: {regs} registers, "
                         f"{spill} B spill stores, {info['smem_bytes']} B "
                         f"shared at 64 table entries, "
                         f"{info['blocks_per_sm']} block(s)/SM")
        check(len(lines) == 8, f"{len(lines)} tensor-core prefill "
              "instances in the ptxas log, expected 8")
        print(f"    {TC_KERNEL} instances (ptxas -v and the card's "
              f"occupancy): " + "; ".join(lines))


def tc_instances(log: str) -> list[tuple[str, int, int, int]]:
    """(pool type, D, registers, spill-store bytes) of every
    instance of the tensor-core prefill kernel in an ``-Xptxas -v`` log."""
    out = []
    for chunk in log.split("Compiling entry function")[1:]:
        m = re.search(TC_KERNEL + r"I(13__nv_bfloat16|a)Li(\d+)EE",
                      chunk.split("\n", 1)[0])
        if not m:
            continue
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        out.append(("int8" if m.group(1) == "a" else "bf16", int(m.group(2)),
                    int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) if spill else 0))
    return out


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


def serve_with_counts(engine: ServingEngine | None = None,
                      **kw) -> tuple[dict, dict[str, int]]:
    """One run of the phase-5 requests, through ``serve_config`` or on
    ``engine`` when one is given, with every kernel's launch counter
    zeroed just before and read just after."""
    for kernel in KERNELS:
        kernel.launches = 0
    pa.flash_paged_prefill.last_kernel = None
    pa.flash_paged_prefill_quant.last_kernel = None
    scfg = ServeConfig(**{**SERVE, **kw})
    report = (serve_config(scfg) if engine is None
              else serve_engine(engine, scfg))
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
        check(pa.flash_paged_prefill.last_kernel
              == (TC_KERNEL if dtype == BF16 else "paged_prefill_kernel"),
              f"K4 {label}: launched {pa.flash_paged_prefill.last_kernel}")
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
    simt = time_ms(lambda: simt_walk(q, kp, vp, table, starts, lens))
    print(f"[8 K4 flash_paged_prefill] yi-6b B=1 H=32 Hkv=4 C=128 D=128 "
          f"psz=16 bf16 start=384 kv_len=512 ({pairs} causal pairs per "
          f"head, 32-row query tiles), device ms (ms "
          f"per call incl. host): "
          + ", ".join(f"{k} {d:.4f} ({c:.4f})" for k, (d, c) in times.items())
          + f", bound {bound_ms:.5f} ms ({bound_by}); before: the SIMT "
          f"template's walk (K5b, one split, + K5c) {simt[0]:.4f} "
          f"({simt[1]:.4f}); library = SDPA with the causal mask on the "
          f"pre-gathered dense K/V (gather not timed)")
    print(f"[8 K4 flash_paged_prefill] verify shape, num_splits=1, device "
          f"ms: " + verify_one_pass(False))
    return {"name": "flash_paged_prefill", "route": "cuda",
            "source": PREFILL_SOURCE,
            "replaces": "src/repro/kernels/flash_attention.py:668",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            **{k: d for k, (d, _) in times.items()}}


def simt_walk(q, k_pool, v_pool, table, start, kv_len, k_scale=None,
              v_scale=None) -> torch.Tensor:
    """The one-pass chunk through the SIMT template that the tensor-core
    kernel replaced for bf16: K5b (K6d) with one split, then K5c."""
    if k_scale is None:
        parts = pa.paged_prefill_split(q, k_pool, v_pool, table, start,
                                       kv_len, 1)
    else:
        parts = pa.paged_prefill_split_quant(q, k_pool, v_pool, k_scale,
                                             v_scale, table, start, kv_len, 1)
    return pa.split_combine(*parts, q.dtype)


def verify_one_pass(quant: bool) -> str:
    """K4 (K6c) at phase 15's verify shape with ``num_splits=1``, beside
    the SIMT template's walk; both checked against plain first."""
    q, pools, table, start, lens = split_case(VERIFY_SHAPE, 650, quant)
    sc = (pools.k_scale, pools.v_scale) if quant else ()
    one_pass = pa.flash_paged_prefill_quant if quant else pa.flash_paged_prefill
    args = (q, pools.k, pools.v, *sc, table, start, lens)
    live = [b for b, v in enumerate(VERIFY_SHAPE[7]) if v]
    want = ref.paged_prefill_ref(q, pools.k, pools.v, table, start, lens,
                                 k_scale=pools.k_scale, v_scale=pools.v_scale)
    walk = (q, pools.k, pools.v, table, start, lens, *sc)
    for got in (one_pass(*args, num_splits=1), simt_walk(*walk)):
        compare(got[live], want[live], BF16)
    new = time_ms(lambda: one_pass(*args, num_splits=1))
    old = time_ms(lambda: simt_walk(*walk))
    return (f"{'K6c' if quant else 'K4'} {new[0]:.4f} ({new[1]:.4f}) against "
            f"the SIMT template's walk {old[0]:.4f} ({old[1]:.4f})")


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
    check(pa.flash_paged_prefill.last_kernel == TC_KERNEL,
          f"the paged serve's K4 ran {pa.flash_paged_prefill.last_kernel}")
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
    """Kernel against plain logits of the same steps (phases 6, 10, 14,
    18).

    Tolerance: both paths take the same bf16 inputs (int8 pages: the same
    codes and scales) and round the attention output to bf16.  The plain
    versions compute in float32; the kernels sum in float32 too, but the
    prefill chunk with a bf16 query (K4, K6c on the tensor cores) also
    rounds P (for int8 pages P times the value scale) to bf16 before P.V,
    which moves an output by at most 2^-9 of the largest |v|.  So they
    differ by about an ulp of bf16 (2^-8 relative) per attention output
    element, and 32 layers of bf16 matmuls carry that into the logits.
    The check allows 5e-2 of the logits' own scale (their max magnitude),
    and reports the argmax agreement beside it."""
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
                 scale_bytes: int = 0, writes_o: bool = True) -> float:
    """Bytes a paged decode must move: every live K/V row (and its scales)
    once, q in and (unless it writes split partials instead) o out, the
    live table entries and kv_len."""
    keys = sum(kv_len)
    live_pages = sum(-(-n // psz) for n in kv_len)
    return (2 * keys * hkv * (d * kv_elem + scale_bytes)
            + (1 + writes_o) * b * h * d * q_elem + 4 * (live_pages + b))


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
                decode_bytes(kv_len, b, h, hkv, d, psz, 2, 2, writes_o=False)
                + partial_bytes,
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
        check(pa.flash_paged_prefill_quant.last_kernel
              == (TC_KERNEL if dtype == BF16 else "paged_prefill_kernel"),
              f"K6c {label}: launched "
              f"{pa.flash_paged_prefill_quant.last_kernel}")
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
                decode_bytes(kv_len, b, h, hkv, d, psz, 1, 2, scale_bytes=4,
                             writes_o=False)
                + 4 * b * hkv * ns * g * (2 + d), 4 * h * keys * d, k6b)]
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
    simt = time_ms(lambda: simt_walk(q, k8, v8, table, starts, lens, ks, vs))
    n_bytes = 2 * 2 * q.numel() + 2 * kv * hkv * (d + 4) + 4 * (kv // psz + 2)
    rows.append(row("flash_paged_prefill_quant", PREFILL_SOURCE,
                    f"{FLASH}:1186", err, n_bytes, 4 * h * pairs * d, k6c))
    print(f"[12 K6 int8 pages] yi-6b chunk B=1 H=32 Hkv=4 C=128 D=128 psz=16 "
          f"bf16 q, int8 pools, start=384 kv_len=512, device ms (ms per call "
          f"incl. host): K6c {fmt_times(k6c)}, bound "
          f"{rows[2]['bound_ms']:.5f} ms ({rows[2]['bound_by']}); before: "
          f"the SIMT template's walk (K6d, one split, + K5c) {simt[0]:.4f} "
          f"({simt[1]:.4f}); library = SDPA on the pre-gathered, "
          f"pre-dequantized bf16 K/V (gather and dequant not timed)")
    print(f"[12 K6 int8 pages] verify shape, num_splits=1, device ms: "
          + verify_one_pass(True))
    return rows


def phase_split_int8_serves(smi: str, paged: dict
                            ) -> tuple[dict[str, int], dict[str, dict]]:
    """The phase-9 serve with int8 pages and split-KV: (a) int8 with 8
    splits, (b) int8 in one pass, (c) fp with 8 splits.  Returns each new
    kernel's launches from the serve that runs it (K5c from (a)), and the
    serves' reports by label."""
    n_layers = 32
    serves = [("int8, 8 splits", dict(kv_dtype="int8", num_splits=8),
               (pa.flash_paged_prefill_quant, pa.paged_decode_split_quant,
                pa.split_combine)),
              ("int8, one pass", dict(kv_dtype="int8"),
               (pa.flash_paged_prefill_quant, pa.flash_paged_decode_quant)),
              ("fp, 8 splits", dict(num_splits=8),
               (pa.flash_paged_prefill, pa.paged_decode_split,
                pa.split_combine))]
    counts, lines, reports = {}, [], {}
    for label, kw, (prefill, *decode) in serves:
        report, launches = serve_with_counts(cache="paged", page_size=16,
                                             prefill_chunk=128, **kw)
        reports[label] = report
        what = f"the {label} serve"
        only_launched(launches, (prefill, *decode), what)
        check(prefill.last_kernel == TC_KERNEL,
              f"{what}: {prefill.__name__} ran {prefill.last_kernel}")
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
             pa.flash_paged_prefill_quant)}, reports


def phase_int8_logits(model, params) -> None:
    plain, kern = paged_logits(model, params, quantized=True,
                               splits=(None, None, 8, 8))
    print(f"[14 int8 paged logits] yi-6b full, int8 pools, 300-token prompt "
          f"as chunks of 128 + 2 decode steps in one pass + 2 with 8 splits: "
          + check_logits(plain, kern, model.cfg.padded_vocab,
                         "int8 paged logits"))


# --------------------------------------------------------------------------
# phases 15-18: split prefill/verify, speculative and prefix-cache serves
# --------------------------------------------------------------------------

# (label, H, Hkv, D, psz, nblk, starts, valid rows, C, dtype): verify
# chunks of k + 1 = 5 rows with an idle lane (no key), and the phase-8
# prefill chunk
SPLIT_CASES = [
    ("yi-6b verify", 32, 4, 128, 16, 64, [839, 720, 190, 544, 0],
     [5, 5, 5, 5, 0], 5, BF16),
    ("deepseek-7b verify", 32, 32, 128, 16, 64, [839, 720, 190, 544, 0],
     [5, 5, 5, 5, 0], 5, BF16),
    ("yi-6b chunk at 384", 32, 4, 128, 16, 32, [384], [128], 128, BF16),
    ("fp32 reduced", 4, 2, 16, 8, 12, [12, 0, 40], [5, 0, 3], 8,
     torch.float32),
]
VERIFY_SHAPE = SPLIT_CASES[0]
CHUNK_SHAPE = SPLIT_CASES[2]


def split_case(case, seed: int, quant: bool):
    """q, pools (fp, or int8 quantized from them), table, start, kv_len."""
    _, h, hkv, d, psz, nblk, starts, valid, c, dtype = case
    kv_len = [s + v for s, v in zip(starts, valid)]
    q, kp, vp, table, lens = paged_case(len(starts), h, hkv, d, psz, nblk,
                                        kv_len, dtype, seed, c=c)
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    if quant:
        (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
        return q, ops.PagedPools(k8, v8, ks, vs), table, start, lens
    return q, ops.PagedPools(kp, vp), table, start, lens


def split_phase(quant: bool) -> tuple[dict, dict]:
    """Checks of K5b (or K6d) + K5c against the plain versions over the
    split cases; returns the verify-shape and chunk-shape timings."""
    kernel = pa.paged_prefill_split_quant if quant else pa.paged_prefill_split
    one_pass = pa.flash_paged_prefill_quant if quant else pa.flash_paged_prefill
    errs = []
    for i, case in enumerate(SPLIT_CASES):
        label, *_, valid, c, dtype = case
        q, pools, table, start, lens = split_case(case, 600 + 10 * i, quant)
        sc = (pools.k_scale, pools.v_scale) if quant else ()
        kw = dict(k_scale=pools.k_scale, v_scale=pools.v_scale)
        args = (q, pools.k, pools.v, *sc, table, start, lens)
        plain = ref.paged_prefill_ref(q, pools.k, pools.v, table, start, lens,
                                      **kw)
        for ns in (2, 3, 8):
            got = one_pass(*args, num_splits=ns)
            want, parts = ref.paged_prefill_split_ref(
                q, pools.k, pools.v, table, start, lens, ns, **kw)
            # the partials are fp32 sums of the same fp32-converted inputs
            # on both sides, so they are held to the fp32 tolerance
            err = max(compare(got_p, want_p, torch.float32)
                      for got_p, want_p in zip(kernel(*args, ns), parts))
            for b, v in enumerate(valid):
                if v == 0:
                    torch.cuda.synchronize()
                    check(bool((got[b] == 0).all()),
                          f"{label} ns={ns}: a lane with no key is not "
                          "exactly 0")
                    continue
                err = max(err, compare(got[b, :, :v], want[b, :, :v], dtype),
                          compare(got[b, :, :v], plain[b, :, :v], dtype))
            errs.append(f"{label} ns={ns} {err:.2e}")
    name = "K6d" if quant else "K5b"
    print(f"[{16 if quant else 15} {name} split {'int8 ' if quant else ''}"
          f"prefill/verify] max abs err vs plain, partials and output (tol "
          f"bf16 {TOL[BF16]}, fp32 {TOL[torch.float32]}): " + "; ".join(errs)
          + "; idle lanes exactly 0; ns=1 equal to the one-pass kernel")

    timings = {}
    sweep_ns = (1, 8) if quant else (1, 2, 4, 8, 16)
    for shape_name, case, seed in (("verify", VERIFY_SHAPE, 650),
                                   ("chunk", CHUNK_SHAPE, 660)):
        q, pools, table, start, lens = split_case(case, seed, quant)
        sc = (pools.k_scale, pools.v_scale) if quant else ()
        args = (q, pools.k, pools.v, *sc, table, start, lens)
        sweep = []
        for ns in sweep_ns:
            if ns == 1:
                t1 = time_ms(lambda: one_pass(*args))
                sweep.append(f"ns=1 (one pass) {t1[0]:.4f}")
                timings[(shape_name, 1)] = (t1, None, None)
                continue
            parts = kernel(*args, ns)
            p1 = time_ms(lambda: kernel(*args, ns))
            p2 = time_ms(lambda: pa.split_combine(*parts, q.dtype))
            whole = time_ms(lambda: one_pass(*args, num_splits=ns))
            sweep.append(f"ns={ns} phase 1 {p1[0]:.4f} + combine "
                         f"{p2[0]:.4f} = {p1[0] + p2[0]:.4f} (one call "
                         f"{whole[0]:.4f})")
            timings[(shape_name, ns)] = (p1, p2, whole)
        print(f"[{16 if quant else 15} {name}] {case[0]} shape, device ms by "
              f"split count: " + "; ".join(sweep))
    return timings


def chunk_work(case, kv_elem: int, scale_bytes: int = 0,
               writes_o: bool = True):
    """(bytes, operations) of one chunk's attention: every committed key
    row (and its scales) read once, q read and (unless it writes split
    partials instead) o written, the live table entries, start and kv_len;
    4 flops per visible (query, key) pair and head dim."""
    _, h, hkv, d, psz, _, starts, valid, c, dtype = case
    keys = sum(s + v for s, v in zip(starts, valid))
    pages = sum(-(-(s + v) // psz) for s, v in zip(starts, valid))
    pairs = sum(s + i + 1 for s, v in zip(starts, valid) for i in range(v))
    q_bytes = len(starts) * h * c * d * torch.finfo(dtype).bits // 8
    n_bytes = (2 * keys * hkv * (d * kv_elem + scale_bytes)
               + (1 + writes_o) * q_bytes
               + 4 * (pages + 2 * len(starts)))
    return n_bytes, 4 * h * pairs * d


def split_rows(quant: bool, timings: dict) -> list[dict]:
    """The K5b (or K6d) row of the kernels line: the verify shape at 8
    splits, phase 1 alone, beside the split plain version and SDPA on the
    pre-gathered (for int8, pre-dequantized bf16) K/V with the causal
    offset mask."""
    ns = 8
    q, pools, table, start, lens = split_case(VERIFY_SHAPE, 650, quant)
    kw = dict(k_scale=pools.k_scale, v_scale=pools.v_scale)
    _, h, hkv, d, psz, nblk, starts, valid, c, _ = VERIFY_SHAPE
    one_pass = pa.flash_paged_prefill_quant if quant else pa.flash_paged_prefill
    sc = (pools.k_scale, pools.v_scale) if quant else ()
    got = one_pass(q, pools.k, pools.v, *sc, table, start, lens,
                   num_splits=ns)
    want = ref.paged_prefill_ref(q, pools.k, pools.v, table, start, lens,
                                 **kw)
    live = [b for b, v in enumerate(valid) if v]
    err = compare(got[live], want[live], BF16)
    k_pool, v_pool = pools.k, pools.v
    if quant:
        k_pool = pools.k.to(BF16) * pools.k_scale[..., None].to(BF16)
        v_pool = pools.v.to(BF16) * pools.v_scale[..., None].to(BF16)
    k_dense = ref.gather_pages(k_pool, table)       # gathered once, untimed
    v_dense = ref.gather_pages(v_pool, table)
    kj = torch.arange(nblk * psz, device="cuda")
    qi = start[:, None] + torch.arange(c, device="cuda")
    mask = ((kj <= qi[..., None]) & (kj < lens[:, None, None]))[:, None]
    times = {"ms": timings[("verify", ns)][0],
             "plain_ms": time_ms(lambda: ref.paged_prefill_split_ref(
                 q, pools.k, pools.v, table, start, lens, ns, **kw)),
             "library_ms": time_ms(
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     q, k_dense, v_dense, attn_mask=mask, enable_gqa=True))}
    # phase 1 writes fp32 partials, not o: the combine writes o
    n_bytes, n_ops = chunk_work(VERIFY_SHAPE, 1 if quant else 2,
                                4 if quant else 0, writes_o=False)
    partial_bytes = 4 * len(starts) * h * ns * c * (2 + d)
    name = "paged_prefill_split_quant" if quant else "paged_prefill_split"
    r = row(name, PAGED_SOURCE, f"{FLASH}:{1239 if quant else 779}", err,
            n_bytes + partial_bytes, n_ops, times)
    combine = timings[("verify", ns)][1][0]
    k4 = timings.get(("verify", 1))
    print(f"[{16 if quant else 15} {'K6d' if quant else 'K5b'}] verify shape "
          f"(yi-6b B=5 H=32 Hkv=4 C=5 D=128 psz=16 nblk=64 starts "
          f"{starts}), 8 splits, device ms (ms per call incl. host): "
          f"phase 1 {fmt_times(times)}, bound {r['bound_ms']:.5f} ms "
          f"({r['bound_by']}); combine {combine:.4f} ms; with the combine "
          f"the whole verify attention is {r['ms'] + combine:.4f} ms"
          + (f" against K4's {k4[0][0]:.4f} ms in one pass" if k4 else "")
          + "; plain = the split plain version (both phases); library = "
          "SDPA with the causal-offset mask on the pre-gathered "
          + ("pre-dequantized bf16 " if quant else "") + "K/V (not timed: "
          "the gather)")
    return [r]


def phase_k5b() -> list[dict]:
    return split_rows(False, split_phase(False))


def phase_k6d() -> list[dict]:
    return split_rows(True, split_phase(True))


def count_draft_calls() -> tuple[dict, Callable[[], None]]:
    """Wrap ``Model.prefill`` and ``Model.decode_step`` to count the calls
    made on a draft model (config name ending in ``-draft``); returns the
    counts and a function that restores the methods."""
    counts = {"prefill": 0, "decode_step": 0}
    originals = {name: getattr(Model, name) for name in counts}

    def wrap(name):
        def method(self, *args, **kw):
            if self.cfg.name.endswith("-draft"):
                counts[name] += 1
            return originals[name](self, *args, **kw)
        return method

    for name in counts:
        setattr(Model, name, wrap(name))

    def restore():
        for name, fn in originals.items():
            setattr(Model, name, fn)
    return counts, restore


def self_draft_engine(model, params) -> ServingEngine:
    """The engine of serve (a) with a draft of all the target's layers."""
    draft = model.draft_model(depth_frac=1.0)
    return ServingEngine(
        model, params, n_lanes=SERVE["n_lanes"], max_len=SERVE["max_len"],
        cache="paged", page_size=16, prefill_chunk=128, draft_model=draft,
        draft_params=model.slice_draft_params(params, draft), spec_k=4,
        num_splits=8)


def phase_spec_prefix_serves(smi: str, paged: dict, int8_reports: dict,
                             model, params) -> dict[str, int]:
    n_layers = 32
    lines, counts = [], {}
    spec = dict(cache="paged", page_size=16, prefill_chunk=128, draft=True,
                spec_k=4, num_splits=8)
    for label, kw, n_draft, verify, prefill in (
            ("(a) speculative, 8 splits", spec, 16,
             pa.paged_prefill_split, pa.flash_paged_prefill),
            ("(b) speculative, int8, 8 splits", dict(spec, kv_dtype="int8"),
             16, pa.paged_prefill_split_quant, pa.flash_paged_prefill_quant),
            ("(e) speculative, 8 splits, a draft of all 32 layers",
             dict(spec, engine=self_draft_engine(model, params)), n_layers,
             pa.paged_prefill_split, pa.flash_paged_prefill)):
        drafts, restore = count_draft_calls()
        try:
            report, launches = serve_with_counts(**kw)
        finally:
            restore()
        spec = report["spec"]
        what, verifies = f"serve {label}", spec["spec_ticks"]
        check(verifies > 0 and verifies == report["decode_steps"],
              f"{what}: {verifies} verify calls, {report['decode_steps']} "
              "ticks")
        for kernel, want in (
                (verify, n_layers * verifies),
                (pa.split_combine, n_layers * verifies),
                (prefill, n_layers * report["prefill_chunks"]),
                (fa.flash_attention, n_draft * drafts["prefill"]),
                (fa.flash_decode, n_draft * drafts["decode_step"])):
            check(launches[kernel.__name__] == want > 0,
                  f"{what}: {kernel.__name__} launched "
                  f"{launches[kernel.__name__]} times, expected {want}")
        only_launched(launches, (verify, pa.split_combine, prefill,
                                 fa.flash_attention, fa.flash_decode), what)
        if n_draft == n_layers:
            check(spec["accepted_tokens"] > 0,
                  f"{what}: the target as its own draft had no draft "
                  "token accepted")
        counts.setdefault(verify.__name__, launches[verify.__name__])
        other = int8_reports["int8, one pass"] if "int8" in label else paged
        emitted = report["generated_tokens"] - SERVE["n_requests"]
        lines.append(
            f"{label}: {report['tokens_per_s']:.1f} tok/s, p50 ttft "
            f"{report['p50_ttft_s']:.4f}s, p50 itl {report['p50_itl_s']:.4f}s,"
            f" {verifies} verify calls emitting {emitted / verifies:.2f} tokens"
            f" each (over the lanes), spec {json.dumps(spec)}, draft "
            f"prefills {drafts['prefill']}, draft decode steps "
            f"{drafts['decode_step']}, {report['prefill_chunks']} chunks, "
            f"launches { {k: n for k, n in launches.items() if n} }, greedy "
            f"tokens equal to the {'13b' if 'int8' in label else 'phase-9'} "
            f"serve's {greedy_agreement(report, other)}")
    reports = {}
    for cache in (True, False):
        report, launches = serve_with_counts(
            cache="paged", page_size=16, prefill_chunk=128,
            prefix_cache=cache, shared_prefix=256)
        what = f"the prefix-cache {'on' if cache else 'off'} serve"
        for kernel, want in ((pa.flash_paged_prefill,
                              n_layers * report["prefill_chunks"]),
                             (pa.flash_paged_decode,
                              n_layers * report["decode_steps"])):
            check(launches[kernel.__name__] == want > 0,
                  f"{what}: {kernel.__name__} launched "
                  f"{launches[kernel.__name__]} times, expected {want}")
        only_launched(launches, (pa.flash_paged_prefill,
                                 pa.flash_paged_decode), what)
        reports[cache] = report
    on, off = reports[True], reports[False]
    prompts = draw_prompts(ServeConfig(**SERVE, shared_prefix=256),
                           model.cfg.vocab_size)
    no_cache = sum(-(-len(p) // 128) for p in prompts)
    check(off["prefill_chunks"] == no_cache,
          f"cache off: {off['prefill_chunks']} chunks, expected {no_cache}")
    check(on["prefix_cache"]["hit_requests"] >= 1
          and on["cache"]["prefix"]["hits"] >= 1, "no prefix-cache hit")
    check(on["prefill_chunks"] < no_cache,
          f"the prefix cache saved no chunk: {on['prefill_chunks']} against "
          f"{no_cache}")
    for label, report in (("(c) prefix cache on", on),
                          ("(d) prefix cache off", off)):
        lines.append(
            f"{label}: {report['tokens_per_s']:.1f} tok/s, p50 ttft "
            f"{report['p50_ttft_s']:.4f}s, mean ttft "
            f"{report['mean_ttft_s']:.4f}s, p50 itl "
            f"{report['p50_itl_s']:.4f}s, {report['prefill_chunks']} chunks, "
            f"{report['decode_steps']} decode steps"
            + (f", prefix {json.dumps(report['cache']['prefix'])}, hit rate "
               f"{report['prefix_cache']['hit_rate']:.3f}, greedy tokens "
               f"equal to (d)'s {greedy_agreement(on, off)}"
               if report is on else ""))
    print(f"[17 speculative and prefix-cache serves] yi-6b full, pages of "
          f"16, chunks of 128, on {smi}: " + "; ".join(lines))
    return counts


def phase_verify_logits(model, params) -> None:
    """Phase 10's prompt, then one verify of a 5-token chunk (the argmax
    continuation and 4 seeded tokens) in one pass and with 8 splits, over
    bf16 and int8 pools, through the kernels and the plain versions; and
    a one-token verify against the paged decode step on the kernels."""
    cfg = model.cfg
    psz, c, plen, max_len = 16, 128, 300, 320
    nblk = max_len // psz
    gen = torch.Generator(device="cuda").manual_seed(8)
    prompt = torch.randint(0, cfg.vocab_size, (1, plen), generator=gen,
                           device="cuda")
    table = (torch.randperm(nblk, generator=gen, device="cuda") + 1)
    table = table.to(torch.int32)[None]
    extra = torch.randint(0, cfg.vocab_size, (4,), generator=gen,
                          device="cuda")
    dev = lambda *x: torch.tensor(x, device="cuda")  # noqa: E731
    lines = []
    for quantized in (False, True):
        runs = {}
        for use_kernel in (False, True):
            caches = model.init_paged_caches(nblk + 1, psz, device="cuda",
                                             quantized=quantized)
            for start in range(0, plen, c):
                end = min(start + c, plen)
                chunk = torch.zeros((1, c), dtype=torch.long, device="cuda")
                chunk[0, :end - start] = prompt[0, start:end]
                logits, caches = model.paged_prefill_step(
                    params, caches, table, chunk, dev(start), dev(end),
                    dev(end - start - 1), use_kernel=use_kernel)
            if not use_kernel:
                first = int(logits[0].argmax())
            tokens = torch.cat([dev(first), extra])[None]
            for ns in (None, 8):
                runs[use_kernel, ns], caches = model.speculative_step(
                    params, caches, table, tokens, dev(plen), dev(plen + 5),
                    num_splits=ns, use_kernel=use_kernel)
            if use_kernel:
                one, caches = model.speculative_step(
                    params, caches, table, tokens[:, :1], dev(plen),
                    dev(plen + 1), num_splits=8, use_kernel=True)
                dec, caches = model.paged_decode_step(
                    params, caches, table, tokens[:, :1], dev(plen),
                    use_kernel=True)
        torch.cuda.synchronize()
        kind = "int8" if quantized else "bf16"
        for ns in (None, 8):
            lines.append(f"{kind} pools, {'8 splits' if ns else 'one pass'}: "
                         + check_logits(runs[False, ns][0, :, None],
                                        runs[True, ns][0, :, None],
                                        cfg.padded_vocab,
                                        f"{kind} verify logits"))
        lines.append(f"{kind} one-token verify vs paged decode step: "
                     + check_logits(dec[:, None], one[:, 0][:, None],
                                    cfg.padded_vocab,
                                    f"{kind} one-token verify"))
    print("[18 verify logits] yi-6b full, 300-token prompt as chunks of 128, "
          "then a verify of 5 tokens: " + "; ".join(lines))


# --------------------------------------------------------------------------
# the install path: K8 matmul, K7 fdm_stress, install-time AT, Sample 8
# --------------------------------------------------------------------------

MM_SOURCE = "src/repro_torch/kernels/csrc/matmul.cu"
FDM_SOURCE = "src/repro_torch/kernels/csrc/fdm_stress.cu"
MM_SHAPE = (512, 4096, 11008)        # yi-6b MLP projection, 512-token prefill
# float32 operations per grid point of the stress update (divisions
# counted as one): fused 54, split 57 (QG formed twice)
FDM_OPS = {"fused": 54, "split": 57}
FDM_ARRAYS = {"fused": 24, "split": 26}   # grid arrays read + written


def phase_k8() -> dict:
    """K8 against its plain version; every bf16 tile timed at MM_SHAPE.
    Returns the row's numbers and the sweep's device ms by tile."""
    gen = torch.Generator(device="cuda").manual_seed(19)

    def operands(m, k, n, dtype):
        x = torch.randn((m, k), generator=gen, device="cuda") * k ** -0.5
        y = torch.randn((k, n), generator=gen, device="cuda")
        b = torch.randn((n,), generator=gen, device="cuda")
        return x.to(dtype), y.to(dtype), b.to(dtype)

    errs = []
    for dtype in (torch.float32, BF16):
        worst = 0.0
        for m, k, n in ((77, 300, 200), (128, 1024, 256), (1, 8, 24)):
            x, y, b = operands(m, k, n, dtype)
            for epilogue in mmk.EPILOGUES:
                for bias in (None, b):
                    worst = max(worst, compare(
                        ops.mm(x, y, bias, epilogue=epilogue),
                        ref.matmul_ref(x, y, bias, epilogue), dtype))
        x, y, b = operands(77, 300, 200, dtype)
        want = ref.matmul_ref(x, y, b, "gelu")
        for tiles in sorted(mmk.TILES):
            worst = max(worst, compare(
                mmk.matmul(x, y, b, block_m=tiles[0], block_n=tiles[1],
                           block_k=tiles[2], epilogue="gelu"), want, dtype))
            elem = 4 if dtype == torch.float32 else 2
            check(mmk.kernel_smem_bytes(dtype, *tiles)
                  == mmk.smem_bytes(*tiles, elem),
                  f"shared-memory formula differs from the kernel's at "
                  f"{tiles} {dtype}")
        errs.append(f"{dtype} {worst:.2e}")
    # float32 at the timing depth (K=4096): the kernel's and torch's fp32
    # sums against a float64 product, the kernel held to the fp32 tolerance
    x, y, _ = operands(512, 4096, 1000, torch.float32)
    exact = (x.double() @ y.double()).float()
    deep = (compare(mmk.matmul(x, y), exact, torch.float32),
            compare(torch.matmul(x, y), exact, torch.float32))
    errs.append(f"fp32 512x4096x1000 against float64: kernel {deep[0]:.2e}, "
                f"torch.matmul {deep[1]:.2e}")
    limit = mmk.smem_per_block_limit("cuda")
    print(f"[19 K8 matmul] max abs err vs plain over 3 shapes (77x300x200, "
          f"128x1024x256, 1x8x24) x 4 epilogues x bias on/off and all "
          f"{len(mmk.TILES)} tiles at 77x300x200 (tol bf16 {TOL[BF16]}, "
          f"fp32 {TOL[torch.float32]}): " + "; ".join(errs)
          + f"; smem formula equal to the kernel's for every tile; "
          f"per-block shared-memory limit {limit} bytes")

    m, k, n = MM_SHAPE
    x, y, _ = operands(m, k, n, BF16)
    sweep = {}
    for tiles in sorted(mmk.TILES):
        kw = dict(block_m=tiles[0], block_n=tiles[1], block_k=tiles[2])
        sweep[tiles] = time_ms(lambda: mmk.matmul(x, y, **kw))[0]
    best = min(sweep, key=sweep.get)
    err = compare(mmk.matmul(x, y, block_m=best[0], block_n=best[1],
                             block_k=best[2]), ref.matmul_ref(x, y), BF16)
    n_bytes = 2 * (m * k + k * n + m * n)
    bound_ms, bound_by = bound(n_bytes, 2 * m * n * k, BF16)
    times = {"plain_ms": time_ms(lambda: ref.matmul_ref(x, y)),
             "library_ms": time_ms(lambda: torch.matmul(x, y))}
    order = sorted(sweep, key=sweep.get)
    print(f"[19 K8 matmul] M={m} K={k} N={n} bf16, device ms by tile "
          f"(bm, bn, bk), fastest first: "
          + ", ".join(f"{t} {sweep[t]:.4f}" for t in order)
          + "; " + ", ".join(f"{k} {d:.4f} ({c:.4f})"
                             for k, (d, c) in times.items())
          + f" (ms per call incl. host in brackets), bound {bound_ms:.4f} ms "
          f"({bound_by}); library = torch.matmul")
    row = {"name": "matmul", "route": "cuda", "source": MM_SOURCE,
           "replaces": "src/repro/kernels/matmul.py:73", "max_abs_err": err,
           "bound_ms": bound_ms, "bound_by": bound_by,
           **{k: d for k, (d, _) in times.items()}}
    return row, sweep


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_k7(sample) -> dict:
    """K7 fused and split against the plain version; both timed at 256^3
    over Sample 8's tiles.  The row carries the fastest fused tile."""
    errs, sweep = [], {}
    for shape in ((60, 50, 130), (256, 256, 256)):
        arrays, state = sample.fdm_grid(shape, "cuda", seed=20)
        want = ref.fdm_stress_ref(arrays, state, 0.1)
        worst = 0.0
        for variant in fk.VARIANTS:
            for tiles in sample.TILES:
                got = fk.fdm_stress(arrays, state, 0.1, variant=variant,
                                    bx=tiles[0], by=tiles[1], bz=tiles[2])
                worst = max(worst, max(compare(got[k], want[k],
                                               torch.float32)
                                       for k in fk.STATE))
        errs.append(f"{'x'.join(map(str, shape))} {worst:.2e}")
    # arrays, state, want are the 256^3 grid's
    points = 256 ** 3
    for variant in fk.VARIANTS:
        for tiles in sample.TILES:
            kw = dict(variant=variant, bx=tiles[0], by=tiles[1], bz=tiles[2])
            sweep[variant, tiles] = time_ms(
                lambda: fk.fdm_stress(arrays, state, 0.1, **kw))[0]
    bounds = {v: bound(4 * (FDM_ARRAYS[v] * points + 3 * 256),
                       FDM_OPS[v] * points, torch.float32)
              for v in fk.VARIANTS}
    plain = time_ms(lambda: ref.fdm_stress_ref(arrays, state, 0.1))
    best = min((key for key in sweep if key[0] == "fused"), key=sweep.get)
    err = max(compare(fk.fdm_stress(arrays, state, 0.1, bx=best[1][0],
                                    by=best[1][1], bz=best[1][2])[k],
                      want[k], torch.float32) for k in fk.STATE)
    print(f"[20 K7 fdm_stress] max abs err vs plain, fused and split over "
          f"tiles {sample.TILES} (tol fp32 {TOL[torch.float32]}): "
          + "; ".join(errs))
    print("[20 K7 fdm_stress] 256^3 float32, device ms by variant and tile: "
          + ", ".join(f"{v} {t} {ms:.4f}" for (v, t), ms in sweep.items())
          + "; bounds " + ", ".join(f"{v} {b:.4f} ms ({by})"
                                    for v, (b, by) in bounds.items())
          + f"; plain {plain[0]:.4f} ({plain[1]:.4f} per call incl. host); "
          f"library none (no one PyTorch call)")
    bound_ms, bound_by = bounds["fused"]
    return {"name": "fdm_stress", "route": "cuda", "source": FDM_SOURCE,
            "replaces": "src/repro/kernels/fdm_stress.py:139",
            "max_abs_err": err, "ms": sweep[best], "plain_ms": plain[0],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_install(smi: str, sample) -> tuple[dict[str, int], tuple]:
    """Install-time AT of K8 on the card, ops.mm with the winner, the warm
    path, and Sample 8 at both levels; returns the launch counts of K8
    and K7 and the winner's tiles."""
    for kernel in KERNELS:
        kernel.launches = 0
    at.clear_published()
    m, k, n = MM_SHAPE
    workdir = tempfile.mkdtemp(prefix="oat_install_")
    timed = at.executors.get("cuda-event")
    trajectory = []

    def logged(region, bp_env):
        measure = timed(region, bp_env)

        def run(assignment):
            cost = measure(assignment)
            trajectory.append((dict(assignment), cost))
            return cost
        return run

    at.executors.register("cuda-event", logged, overwrite=True)
    try:
        session = at.AutoTuner(workdir)
        register_kernel_regions(session, m=m, n=n, k=k, **SSM_SHAPE)
        tuned = run_install_tuning(session, wall_clock=True)
    finally:
        at.executors.register("cuda-event", timed, overwrite=True)
    winner = tuned["MatmulBlocks"]
    tiles = (winner["block_m"], winner["block_n"], winner["block_k"])
    check(tiles in mmk.TILES, f"winner {tiles} is not an instantiated tile")
    check(session.executor_calls == len(trajectory) > 0,
          f"{session.executor_calls} evaluations, {len(trajectory)} timed")
    check(at.tuned("matmul") == winner, "the winner was not published")
    path = at.ATRecordStore(workdir).path
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    card = torch.cuda.get_device_name(0).replace(" ", "-").lower()
    check(any(r["region"] == "MatmulBlocks" and card in r["machine"]
              for r in records), f"no MatmulBlocks record names {card}")
    print(f"[21 install] MatmulBlocks at M={m} N={n} K={k} bf16, CUDA-event "
          f"executor (min of 10 launches), trajectory (bm, bn, bk) -> ms: "
          + ", ".join(f"({a['MatmulBlocks_BM']}, {a['MatmulBlocks_BN']}, "
                      f"{a['MatmulBlocks_BK']}) {c * 1e3:.4f}"
                      for a, c in trajectory if "MatmulBlocks_BM" in a)
          + f"; winner {winner}; record file {path}: {json.dumps(records)}")

    gen = torch.Generator(device="cuda").manual_seed(21)
    x = (torch.randn((m, k), generator=gen, device="cuda") * k ** -0.5).to(BF16)
    y = torch.randn((k, n), generator=gen, device="cuda").to(BF16)
    before = mmk.matmul.launches
    out = ops.mm(x, y, epilogue="silu")
    err = compare(out, ref.matmul_ref(x, y, None, "silu"), BF16)
    check(mmk.matmul.launches == before + 1 and mmk.matmul.last_tiles == tiles,
          f"ops.mm launched {mmk.matmul.launches - before} times with "
          f"{mmk.matmul.last_tiles}, expected once with {tiles}")

    again = at.AutoTuner(workdir)
    register_kernel_regions(again, m=m, n=n, k=k, **SSM_SHAPE)
    check(run_install_tuning(again, wall_clock=True) == tuned,
          "the second session loaded another winner")
    check(again.executor_calls == 0,
          f"the second session measured {again.executor_calls} times")
    print(f"[21 install] ops.mm launched K8 with the winner's tiles {tiles} "
          f"(max abs err vs plain {err:.2e}); a second session on the "
          f"workdir warm-loaded {again.ctx.store.entry('MatmulBlocks_BM').value}"
          f"/{again.ctx.store.entry('MatmulBlocks_BN').value}/"
          f"{again.ctx.store.entry('MatmulBlocks_BK').value} with 0 "
          f"measurements, on {smi}")

    result = sample.main(["--device", "cuda"])
    check(result["level1"]["candidates"] == 8
          and result["level1"]["measured"] == 8, "Sample 8 level 1")
    check(len(result["level2"]["results"]) == 2 * len(sample.TILES),
          "Sample 8 level 2")
    torch.cuda.synchronize()
    launches = {kern.__name__: kern.launches for kern in KERNELS}
    only_launched(launches, (mmk.matmul, fk.fdm_stress, k9.selective_scan),
                  "the install phase")
    check(launches["matmul"] > 0 and launches["fdm_stress"] > 0,
          f"the install phase launched {launches}")
    print(f"[21 install] Sample 8 level 1: winner #{result['level1']['winner'] + 1} "
          f"of 8; level 2 fastest {result['level2']['fastest']}; launches "
          f"{launches}")
    at.clear_published()
    return {k: launches[k] for k in ("matmul", "fdm_stress")}, tiles



# --------------------------------------------------------------------------
# falcon-mamba-7b: K9 selective_scan, the Mamba-1 serve, SsmChunk
# --------------------------------------------------------------------------

SSM_SOURCE = "src/repro_torch/kernels/csrc/ssm_scan.cu"
FM = "falcon-mamba-7b"
FM_LAYERS = 64
# the SsmChunk region at falcon-mamba's prefill shape (phases 21 and 25)
SSM_SHAPE = dict(seq=512, d_inner=8192, d_state=16)


def ssm_case(bsz, length, di, n, seed, dtype):
    """x, dt (softplus, positive), a (-1 .. -N for every channel, as
    falcon-mamba's a_log gives), b, c, d (ones) on the card."""
    x = randn((bsz, length, di), seed, dtype)
    dt = torch.nn.functional.softplus(
        randn((bsz, length, di), seed + 1, torch.float32) - 2.0).to(dtype)
    a = -torch.arange(1, n + 1, dtype=torch.float32,
                      device="cuda").expand(di, n).contiguous()
    return (x, dt, a, randn((bsz, length, n), seed + 2, dtype),
            randn((bsz, length, n), seed + 3, dtype),
            torch.ones((di,), dtype=dtype, device="cuda"))


def ssm_work(bsz, length, di, n, elem: int) -> tuple[float, float]:
    """(bytes, float32 operations) of one scan with the final state: x, dt
    and y (B L Di each) and b, c (B L N each) in the input type, d, a and
    the final state; per (b, t, d, n) the exp, its product, two multiplies,
    an add and the C product and sum (6), per (b, t, d) D x + its add."""
    n_bytes = (elem * (3 * bsz * length * di + 2 * bsz * length * n + di)
               + 4 * di * n + 4 * bsz * di * n)
    return n_bytes, bsz * length * di * (6 * n + 2)


def phase_k9() -> tuple[dict, dict]:
    """K9 against its plain version over dtypes, ragged shapes, every
    chunk and both outputs; the chunk sweep timed at the prefill shape.
    Returns the row's numbers and the sweep's device ms by chunk."""
    # (label, B, L, Di, N, dtype)
    cases = [("fp32 reduced", 2, 96, 128, 8, torch.float32),
             ("fp32 ragged L and Di", 3, 90, 100, 16, torch.float32),
             ("bf16 ragged L", 2, 33, 256, 16, BF16),
             ("fp32 falcon-mamba width", 1, 300, 8192, 16, torch.float32),
             ("falcon-mamba B=1", 1, 512, 8192, 16, BF16),
             ("falcon-mamba B=4", 4, 512, 8192, 16, BF16)]
    errs = []
    for i, (label, b, length, di, n, dtype) in enumerate(cases):
        args = ssm_case(b, length, di, n, 220 + 10 * i, dtype)
        want_y, want_h = ref.selective_scan_ref(*args,
                                                return_final_state=True)
        worst = 0.0
        for chunk in CHUNK_VALUES:
            y, h = k9.selective_scan(*args, chunk=chunk,
                                     return_final_state=True)
            worst = max(worst, compare(y, want_y, dtype),
                        compare(h, want_h, dtype),
                        compare(k9.selective_scan(*args, chunk=chunk),
                                want_y, dtype))
        errs.append(f"{label} {worst:.2e}")
    for n in k9.STATES:
        for chunk in CHUNK_VALUES:
            check(k9.kernel_smem_bytes(n, chunk) == k9.smem_bytes(n, chunk),
                  f"shared-memory formula differs from the kernel's at "
                  f"N={n} chunk={chunk}")
    print(f"[22 K9 selective_scan] max abs err vs plain over chunks "
          f"{CHUNK_VALUES}, y and final state, with and without the state "
          f"(tol bf16 {TOL[BF16]}, fp32 {TOL[torch.float32]}): "
          + "; ".join(errs) + "; smem formula equal to the kernel's")

    # timing at the main path's shape: one falcon-mamba prefill layer of
    # 512 tokens, with the final state
    b, length, di, n = 1, SSM_SHAPE["seq"], SSM_SHAPE["d_inner"], \
        SSM_SHAPE["d_state"]
    args = ssm_case(b, length, di, n, 290, BF16)
    sweep = {chunk: time_ms(lambda: k9.selective_scan(
        *args, chunk=chunk, return_final_state=True))[0]
        for chunk in CHUNK_VALUES}
    best = min(sweep, key=sweep.get)
    want = ref.selective_scan_ref(*args, return_final_state=True)
    got = k9.selective_scan(*args, chunk=best, return_final_state=True)
    err = max(compare(got[0], want[0], BF16), compare(got[1], want[1], BF16))
    n_bytes, n_ops = ssm_work(b, length, di, n, 2)
    bound_ms, bound_by = bound(n_bytes, n_ops, torch.float32)
    plain = time_ms(lambda: ref.selective_scan_ref(*args,
                                                   return_final_state=True))
    args4 = ssm_case(4, length, di, n, 295, BF16)
    b4 = time_ms(lambda: k9.selective_scan(*args4, chunk=best,
                                           return_final_state=True))
    bound4 = bound(*ssm_work(4, length, di, n, 2), torch.float32)
    print(f"[22 K9 selective_scan] falcon-mamba prefill layer B=1 L={length} "
          f"Di={di} N={n} bf16 with the final state, device ms by chunk: "
          + ", ".join(f"{c} {ms:.4f}" for c, ms in sweep.items())
          + f"; bound {bound_ms:.4f} ms ({bound_by}); plain {plain[0]:.4f} "
          f"({plain[1]:.4f} per call incl. host); library none (no one "
          f"PyTorch call); B=4 at chunk {best}: {b4[0]:.4f} ms, bound "
          f"{bound4[0]:.4f} ms ({bound4[1]})")
    return {"name": "selective_scan", "route": "cuda", "source": SSM_SOURCE,
            "replaces": "src/repro/kernels/ssm_scan.py:74",
            "max_abs_err": err, "ms": sweep[best], "plain_ms": plain[0],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}, sweep


def phase_fm_serve(smi: str) -> int:
    """falcon-mamba-7b at full width through ``serve_config`` on dense
    lanes; returns K9's launches."""
    report, launches = serve_with_counts(arch=FM)
    admissions = SERVE["n_requests"] + report["preemptions"]
    check(launches["selective_scan"] == FM_LAYERS * admissions,
          f"K9 launched {launches['selective_scan']} times, expected "
          f"{FM_LAYERS} x {admissions} admissions")
    only_launched(launches, (k9.selective_scan,), "the falcon-mamba serve")
    print(f"[23 serve] falcon-mamba-7b full (64 Mamba-1 layers, d_model "
          f"4096, d_inner 8192, d_state 16), 4 dense lanes: "
          f"{report['finished']}/{SERVE['n_requests']} requests, "
          f"{report['generated_tokens']} tokens in {report['wall_s']:.3f}s = "
          f"{report['tokens_per_s']:.1f} tok/s, ttft p50 "
          f"{report['p50_ttft_s']:.4f}s p99 {report['p99_ttft_s']:.4f}s, itl "
          f"p50 {report['p50_itl_s']:.4f}s p99 {report['p99_itl_s']:.4f}s, "
          f"{report['decode_steps']} decode steps, {admissions} admissions, "
          f"launches {launches}, lane state "
          f"{report['cache']['pool_bytes']} bytes, on {smi}")
    return launches["selective_scan"]


def phase_fm_logits(model, params) -> None:
    """A 300-token prompt, prefill + 4 decode steps at the full config,
    kernels against plain; and ``forward``'s last-position logits (one K9
    launch per layer, without the state) against prefill's."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(24)
    prompt = torch.randint(0, cfg.vocab_size, (1, 300), generator=gen,
                           device="cuda")
    tokens: list[int] = []
    runs = {}
    for use_kernel in (False, True):
        logits, caches = model.prefill(params, prompt, use_kernel=use_kernel)
        steps = [logits]
        for i in range(4):
            if not use_kernel:
                tokens.append(int(steps[-1][0].argmax()))
            logits, caches = model.decode_step(
                params, caches, torch.tensor([[tokens[i]]], device="cuda"),
                torch.tensor([prompt.shape[1] + i], device="cuda"),
                use_kernel=use_kernel)
            steps.append(logits)
        runs[use_kernel] = torch.stack(steps)
    before = k9.selective_scan.launches
    hidden, _ = model.forward(params, prompt)
    full = model.head_logits(params, hidden[:, -1])
    torch.cuda.synchronize()
    check(k9.selective_scan.launches == before + FM_LAYERS,
          f"forward launched K9 {k9.selective_scan.launches - before} times")
    print(f"[24 falcon-mamba logits] prefill 300 + 4 decode steps: "
          + check_logits(runs[False], runs[True], cfg.padded_vocab,
                         "falcon-mamba logits")
          + "; forward's last position against prefill's: "
          + check_logits(runs[True][:1], full[None], cfg.padded_vocab,
                         "forward logits"))


def phase_ssm_install(smi: str, sweep: dict) -> int:
    """Install-time AT of K9's chunk on the card in a fresh workdir; the
    d-spline fit beside the measured chunks; ops.ssm_scan with the winner;
    the warm path.  Returns the winner's chunk."""
    at.clear_published()
    m, k, n = MM_SHAPE
    workdir = tempfile.mkdtemp(prefix="oat_ssm_install_")
    timed = at.executors.get("cuda-event")
    trajectory = []

    def logged(region, bp_env):
        measure = timed(region, bp_env)

        def run(assignment):
            cost = measure(assignment)
            trajectory.append((dict(assignment), cost))
            return cost
        return run

    at.executors.register("cuda-event", logged, overwrite=True)
    try:
        session = at.AutoTuner(workdir)
        register_kernel_regions(session, m=m, n=n, k=k, **SSM_SHAPE)
        tuned = run_install_tuning(session, wall_clock=True)
    finally:
        at.executors.register("cuda-event", timed, overwrite=True)
    winner = tuned["SsmChunk"]["chunk"]
    check(winner in CHUNK_VALUES, f"winner {winner} is not a candidate")
    check(at.tuned("ssm_scan") == {"chunk": winner},
          "the winner was not published")
    measured = [(a["SsmChunk_CHUNK"], c) for a, c in trajectory
                if "SsmChunk_CHUNK" in a]
    check(len(measured) == 8 and all(c < float("inf") for _, c in measured),
          f"SsmChunk measured {measured}")
    xs = [float(x) for x, _ in measured]
    fit = fit_dspline(xs, [c for _, c in measured])(
        np.asarray(CHUNK_VALUES, dtype=np.float64))
    check(CHUNK_VALUES[int(fit.argmin())] == winner,
          "the winner is not the fit's minimum")
    path = at.ATRecordStore(workdir).path
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    card = torch.cuda.get_device_name(0).replace(" ", "-").lower()
    check(any(r["region"] == "SsmChunk" and card in r["machine"]
              for r in records), f"no SsmChunk record names {card}")
    print(f"[25 install] SsmChunk at seq {SSM_SHAPE['seq']} d_inner "
          f"{SSM_SHAPE['d_inner']} d_state {SSM_SHAPE['d_state']} bf16, "
          f"CUDA-event executor (min of 10 launches), measured chunk -> ms: "
          + ", ".join(f"{x} {c * 1e3:.4f}" for x, c in measured)
          + "; d-spline fit at the candidates: "
          + ", ".join(f"{x} {p * 1e3:.4f}" for x, p in zip(CHUNK_VALUES, fit))
          + f"; winner {winner} (phase 22's sweep: {sweep[winner]:.4f} ms "
          f"at the winner, fastest chunk {min(sweep, key=sweep.get)}); "
          f"record file {path}")

    b, length, di, n_state = 1, SSM_SHAPE["seq"], SSM_SHAPE["d_inner"], \
        SSM_SHAPE["d_state"]
    args = ssm_case(b, length, di, n_state, 250, BF16)
    before = k9.selective_scan.launches
    y, h = ops.ssm_scan(*args, return_final_state=True)
    want = ref.selective_scan_ref(*args, return_final_state=True)
    err = max(compare(y, want[0], BF16), compare(h, want[1], BF16))
    check(k9.selective_scan.launches == before + 1
          and k9.selective_scan.last_chunk == min(winner, length),
          f"ops.ssm_scan launched {k9.selective_scan.launches - before} "
          f"times with chunk {k9.selective_scan.last_chunk}, expected once "
          f"with {winner}")
    again = at.AutoTuner(workdir)
    register_kernel_regions(again, m=m, n=n, k=k, **SSM_SHAPE)
    check(run_install_tuning(again, wall_clock=True) == tuned,
          "the second session loaded another winner")
    check(again.executor_calls == 0,
          f"the second session measured {again.executor_calls} times")
    print(f"[25 install] ops.ssm_scan launched K9 with the winner's chunk "
          f"{winner} (max abs err vs plain {err:.2e}); a second session on "
          f"the workdir warm-loaded chunk "
          f"{again.ctx.store.entry('SsmChunk_CHUNK').value} with 0 "
          f"measurements, on {smi}")
    at.clear_published()
    return winner



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
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
    counts, int8_reports = phase_split_int8_serves(smi, paged)
    launches.update(counts)
    phase_int8_logits(model, params)
    rows += phase_k5b() + phase_k6d()
    launches.update(phase_spec_prefix_serves(smi, paged, int8_reports,
                                             model, params))
    phase_verify_logits(model, params)
    del model, params
    torch.cuda.empty_cache()
    sample = load_example("autotune_fdm_torch")
    mm_row, mm_sweep = phase_k8()
    rows += [mm_row, phase_k7(sample)]
    install_launches, winner = phase_install(smi, sample)
    launches.update(install_launches)
    mm_row["ms"] = mm_sweep[winner]     # the tile the install path published
    k9_row, k9_sweep = phase_k9()
    rows.append(k9_row)
    launches["selective_scan"] = phase_fm_serve(smi)
    fm_model = build_model(get_arch(FM))
    fm_params = fm_model.init(0, "cuda")
    phase_fm_logits(fm_model, fm_params)
    del fm_model, fm_params
    torch.cuda.empty_cache()
    chunk = phase_ssm_install(smi, k9_sweep)
    k9_row["ms"] = k9_sweep[chunk]      # the chunk the install path published
    check(len(rows) == 14, f"{len(rows)} kernel rows, expected 14")
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(f"[done] phases 1-25 in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

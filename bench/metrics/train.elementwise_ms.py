"""Device milliseconds a train step in the kernels that are neither
matrix products (cuBLAS' and CUTLASS' GEMM and GEMV kernels) nor the
port's attention kernel: the elementwise kernels, casts and reductions,
where AdamW's update runs, over the traced steps."""
UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "trainer and optimizer (launch/train.py, optim/adamw.py)"
MOVES = "train_tok_s"
PRODUCTS = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "wgmma",
            "splitKreduce", "flash_attention")


def read(rec: dict) -> float | None:
    tr = rec.get("trace")
    if tr is None or not rec.get("trace_steps"):
        return None
    s = sum(sec for name, sec in tr["kernels"]
            if not any(p in name for p in PRODUCTS))
    return 1e3 * s / rec["trace_steps"] if s > 0 else None

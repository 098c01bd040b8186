"""Arithmetic the metric readers (``bench/metrics/*.py``) share, over a
driver's record.  Every reader returns None where its record has nothing
to read (a run without a trace, a CPU run for a device share), and the
harness then leaves that metric out."""
from __future__ import annotations

from roofline import flops as fl
from roofline.peaks import PEAKS

from .trace import kernel_seconds


def window_requests(rec: dict, end_mark: str = "t1") -> list:
    """(due, request) of the requests due in the window (up to the mark
    ``end_mark``)."""
    t0, t1 = rec["marks"]["t0"]["t"], rec["marks"][end_mark]["t"]
    return [(d, r) for d, r in rec["reqs"] if t0 <= d < t1]


def ttfts(rec: dict) -> list[float]:
    """Time to first token of every request due in the window, from the
    moment it was due; one without a first token by the window's end
    counts at its wait so far.  A refused request is a failure, not a
    latency."""
    t0, t1 = rec["window"]
    return [min(r.first_token_t if r.first_token_t is not None else t1, t1)
            - d for d, r in window_requests(rec)] + \
        [t1 - d for d in rec.get("unsent", ()) if t0 <= d < t1]


def token_gaps(rec: dict) -> list[float]:
    """Every gap between consecutive tokens of a request whose later token
    came inside the window."""
    t0, t1 = rec["window"]
    out = []
    for _, r in rec["reqs"]:
        ts = r.token_ts
        out += [b - a for a, b in zip(ts, ts[1:]) if t0 <= b <= t1]
    return out


def window_tokens(rec: dict) -> int:
    t0, t1 = rec["window"]
    return sum(1 for _, r in rec["reqs"] for t in r.token_ts if t0 <= t <= t1)


def peaks(rec: dict):
    return PEAKS.get(rec.get("device_name", ""))


def idle_share(rec: dict) -> float | None:
    tr = rec.get("trace")
    if tr is None or peaks(rec) is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_share(rec: dict, work: list[tuple[int, int]], names) -> \
        float | None:
    """100 x the least time the chip could take for ``work`` ((operations,
    bytes) a launch, each bound by the larger of operations over the bf16
    peak and bytes over the bandwidth) over the device time of the
    kernels named by ``names`` in the traced window."""
    tr, pk = rec.get("trace"), peaks(rec)
    if tr is None or pk is None or not work:
        return None
    seconds = kernel_seconds(tr, names)
    if seconds <= 0:
        return None
    peak, bw = pk[0], pk[1]
    least = sum(max(f / peak, b / bw) for f, b in work)
    return 100.0 * least / seconds


def serve_trace_flops(rec: dict) -> int:
    """Model operations of the traced ticks' useful work: each prompt
    chunk's valid tokens (the LM head for the last chunk's one row) and
    each decoding lane's token."""
    m = rec["dims"]
    total = sum(fl.prefill_chunk_flops(m, s, e, 1 if last else 0)
                for s, e, last in rec.get("trace_chunks", ()))
    total += sum(fl.decode_token_flops(m, pos)
                 for tick in rec.get("trace_decodes", ()) for pos in tick)
    return total


def mfu(rec: dict, model_flops: int, seconds: float) -> float | None:
    pk = peaks(rec)
    if pk is None or seconds <= 0 or model_flops <= 0:
        return None
    return 100.0 * model_flops / seconds / pk[0]

"""Serving metrics: TTFT, inter-token latency, throughput, percentiles.

Collects per-request timing (submit / first token / per-token / finish)
from finished :class:`~repro_torch.serving.scheduler.Request` objects and
aggregates the serving-latency quartet every inference stack reports:

* **queue wait** — submit to first lane occupancy (pure queueing delay;
  ``Request.admit_t`` is stamped by the engine at first admission, and
  the gateway stamps ``submit_t`` at HTTP arrival so network-side
  queueing is visible too);
* **TTFT** — time to first token (queueing + prefill);
* **ITL** — inter-token latency during decode;
* **tokens/s** and **requests/s** over the serving window;
* **prefix cache** — cache-hit tokens and the per-request hit rate
  (``Request.cached_tokens`` is stamped at admission when the engine's
  prefix cache seeds the lane from the hash index).

All timestamps come from ``time.monotonic()`` (stamped by the engine and
``Request``'s default): the quantities here are *durations*, and a
wall-clock adjustment mid-run (NTP slew, DST) must not yield negative
TTFT/ITL samples or a corrupted serving window.

p50/p99 use :func:`percentile` — ``numpy.percentile`` with
``method='linear'`` passed explicitly, so the numbers cannot silently
track a change in numpy's default method.  Interpolation matters on tiny
samples: smoke runs aggregate a handful of requests, and under a
nearest-rank definition p99 of a 5-element series is just the max.  A
copy of the JAX package's metrics layer; the numbers mean device time
only on a run on the card.
"""
from __future__ import annotations

import numpy as np

from .scheduler import Request


def percentile(xs, q: float) -> float | None:
    """The ``q``-th percentile with linear interpolation between the two
    nearest order statistics (``method='linear'`` passed explicitly, so
    the serving gate's numbers do not track numpy's default method).
    None on empty input; q outside [0, 100] raises.
    """
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    arr = [float(x) for x in xs]
    if not arr:
        return None
    return float(np.percentile(arr, q, method="linear"))


def _pcts(xs: list[float]) -> dict:
    if not xs:
        return {"p50": None, "p99": None, "mean": None}
    return {"p50": percentile(xs, 50),
            "p99": percentile(xs, 99),
            "mean": float(np.asarray(xs, np.float64).mean())}


class ServingMetrics:
    """Aggregates finished requests into a serving report."""

    def __init__(self) -> None:
        self.requests: list[Request] = []
        self._t0: float | None = None
        self._t1: float | None = None

    def observe(self, req: Request) -> None:
        self.requests.append(req)
        if req.submit_t is not None:
            self._t0 = req.submit_t if self._t0 is None \
                else min(self._t0, req.submit_t)
        if req.finish_t is not None:
            self._t1 = req.finish_t if self._t1 is None \
                else max(self._t1, req.finish_t)

    # ------------------------------------------------------------------
    def ttfts(self) -> list[float]:
        return [r.first_token_t - r.submit_t for r in self.requests
                if r.first_token_t is not None]

    def queue_waits(self) -> list[float]:
        """Submit-to-first-lane-occupancy per request.  ``submit_t`` is
        stamped where the request *arrives* (the gateway's HTTP handler,
        or ``Request`` construction in direct-engine use) and ``admit_t``
        where the engine first gives it a lane — the gap is pure queueing
        delay, the thing TTFT alone hides under load."""
        return [r.admit_t - r.submit_t for r in self.requests
                if r.admit_t is not None]

    def inter_token_latencies(self) -> list[float]:
        out: list[float] = []
        for r in self.requests:
            out.extend(float(b - a)
                       for a, b in zip(r.token_ts, r.token_ts[1:]))
        return out

    def prefix_cache(self) -> dict:
        """Cache-hit tokens + prefix-hit rate over finished requests
        (zeros when the engine runs without a prefix cache)."""
        cached = [r.cached_tokens for r in self.requests]
        hit_requests = sum(1 for c in cached if c > 0)
        return {
            "hit_tokens": int(sum(cached)),
            "hit_requests": hit_requests,
            "hit_rate": (hit_requests / len(self.requests)
                         if self.requests else 0.0),
        }

    def summary(self) -> dict:
        n_tokens = sum(len(r.out_tokens) for r in self.requests)
        wall = (self._t1 - self._t0) if (self._t0 is not None
                                         and self._t1 is not None) else 0.0
        preempts = sum(r.preemptions for r in self.requests)
        return {
            "requests": len(self.requests),
            "generated_tokens": n_tokens,
            "wall_s": wall,
            "tokens_per_s": n_tokens / wall if wall > 0 else 0.0,
            "requests_per_s": len(self.requests) / wall if wall > 0 else 0.0,
            "queue_wait_s": _pcts(self.queue_waits()),
            "ttft_s": _pcts(self.ttfts()),
            "itl_s": _pcts(self.inter_token_latencies()),
            "preemptions": preempts,
            "prefix_cache": self.prefix_cache(),
        }

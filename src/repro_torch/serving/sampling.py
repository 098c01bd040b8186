"""Per-request sampling for the serving engine: temperature / top-k /
top-p and explicit seeds (numpy, a copy of the JAX package's sampler).

Every request carries a :class:`SamplingParams`; the engine never calls
``argmax`` directly.  Three properties the tests pin down:

* **greedy is exact** — ``temperature == 0`` routes through a literal
  ``argmax``;
* **filtering renormalizes** — after temperature scaling, top-k and
  top-p masking, the distribution sums to 1 and never assigns mass
  outside the kept support;
* **seeding is positional, not positional-in-the-batch** — randomness is
  keyed by ``(request seed, emitted-token index, stream)``, so a fixed
  seed reproduces the same tokens no matter which lane the request lands
  on or what else is batched alongside it, and the same tokens as the
  JAX package's engine for the same logits.

Sampling runs host-side in float64 numpy: the logits are copied to the
host between scheduler ticks anyway.  The speculative accept/reject rule
is not ported yet (ROADMAP queue 1, item 5).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SamplingParams", "filtered_probs", "sample_token",
           "sample_batch"]

# independent deterministic streams per (seed, counter); the draft (1)
# and accept (2) streams of speculative decoding keep their numbers
_STREAM_SAMPLE = 0     # plain (non-speculative) token draws


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.  ``temperature == 0`` is greedy;
    ``top_k == 0`` and ``top_p == 1.0`` disable their filters."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 disables)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def _rng(seed: int, counter: int, stream: int) -> np.random.Generator:
    """Deterministic generator keyed by (request seed, emitted-token
    index, stream) — independent of lane placement and batch layout."""
    return np.random.default_rng((seed % (2 ** 32), counter, stream))


def filtered_probs(logits, sp: SamplingParams) -> np.ndarray:
    """The renormalized sampling distribution for one position.

    Temperature-scaled softmax, then top-k keeps the k highest-probability
    tokens and top-p keeps the smallest prefix (by descending
    probability) whose cumulative mass reaches ``top_p``; the survivors
    renormalize to sum exactly 1.  Greedy returns the argmax one-hot (the
    temperature -> 0 limit).
    """
    logits = np.asarray(logits, np.float64).reshape(-1)
    if sp.greedy:
        p = np.zeros_like(logits)
        p[int(np.argmax(logits))] = 1.0
        return p
    z = logits / sp.temperature
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    if 0 < sp.top_k < p.size:
        keep = np.argsort(-p, kind="stable")[:sp.top_k]
        mask = np.zeros(p.size, bool)
        mask[keep] = True
        p = np.where(mask, p, 0.0)
        p /= p.sum()            # top-p then filters the renormalized mass
    if sp.top_p < 1.0:
        order = np.argsort(-p, kind="stable")
        cut = int(np.searchsorted(np.cumsum(p[order]), sp.top_p)) + 1
        mask = np.zeros(p.size, bool)
        mask[order[:cut]] = True
        p = np.where(mask, p, 0.0)
    return p / p.sum()


def _draw(p: np.ndarray, rng: np.random.Generator) -> int:
    # inverse-CDF draw: tolerant of float64 renormalization residue,
    # never emits a zero-probability token
    u = rng.random() * p.sum()
    return int(np.searchsorted(np.cumsum(p), u, side="right").clip(
        0, p.size - 1))


def sample_token(logits, sp: SamplingParams, counter: int) -> int:
    """One token for the request's ``counter``-th emission (``counter`` =
    ``len(out_tokens)`` — an index into the request's own output stream,
    which is what makes a fixed seed layout-independent)."""
    if sp.greedy:
        return int(np.argmax(np.asarray(logits)))
    p = filtered_probs(logits, sp)
    return _draw(p, _rng(sp.seed, counter, _STREAM_SAMPLE))


def sample_batch(logits, params, counters) -> list[int]:
    """Sample one token per lane.  ``logits`` (B, V); ``params`` and
    ``counters`` are per-lane sequences.  Equivalent to per-lane
    :func:`sample_token` — batching is a layout, not a semantic."""
    logits = np.asarray(logits)
    return [sample_token(logits[i], sp, int(c))
            for i, (sp, c) in enumerate(zip(params, counters))]

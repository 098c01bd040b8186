"""Per-request sampling for the serving engine: temperature / top-k /
top-p, explicit seeds and the speculative accept/reject rule (numpy, a
copy of the JAX package's sampler).

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

Speculative decoding uses the standard accept/reject rule (Leviathan et
al. 2023; Chen et al. 2023): draft token ``d_i`` is accepted with
probability ``min(1, p_i(d_i) / q_i(d_i))``; on rejection the correction
token is drawn from ``norm(max(p_i - q_i, 0))``; if every draft is
accepted a bonus token is drawn from the target's next distribution.  In
the greedy limit it is "accept while the draft equals the target
argmax", so greedy speculative output equals plain greedy decode.

Sampling runs host-side in float64 numpy: the logits are copied to the
host between scheduler ticks anyway.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SamplingParams", "filtered_probs", "sample_token",
           "sample_batch", "draft_rng", "propose_token",
           "speculative_accept"]

# independent deterministic streams per (seed, counter)
_STREAM_SAMPLE = 0     # plain (non-speculative) token draws
_STREAM_DRAFT = 1      # draft proposals within one speculative tick
_STREAM_ACCEPT = 2     # accept/reject coins + correction/bonus draws


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


# --------------------------------------------------------------------------
# speculative decoding
# --------------------------------------------------------------------------


def draft_rng(sp: SamplingParams, counter: int) -> np.random.Generator:
    """The proposal stream for one speculative tick (first emission index
    ``counter``); draw :func:`propose_token` from it k times."""
    return _rng(sp.seed, counter, _STREAM_DRAFT)


def propose_token(logits, sp: SamplingParams,
                  rng: np.random.Generator) -> tuple[int, np.ndarray]:
    """Draft proposal: ``(token, q)`` where ``q`` is the filtered draft
    distribution the accept rule divides by."""
    q = filtered_probs(logits, sp)
    if sp.greedy:
        return int(np.argmax(q)), q
    return _draw(q, rng), q


def speculative_accept(drafts, draft_probs, target_logits,
                       sp: SamplingParams, counter: int
                       ) -> tuple[list[int], int]:
    """The accept/reject rule over one verified chunk.

    ``drafts`` — k proposed tokens; ``draft_probs`` — their filtered draft
    distributions ``q_i``; ``target_logits`` — (k+1, V) target logits
    where row ``i`` scores the position of ``drafts[i]`` and row ``k`` is
    the all-accepted bonus position.  Returns ``(emitted, n_accepted)``
    with ``len(emitted) == n_accepted + 1``: the accepted prefix plus one
    correction (on rejection) or bonus (all accepted) token.
    """
    target_logits = np.asarray(target_logits)
    k = len(drafts)
    if sp.greedy:
        a = 0
        while a < k and drafts[a] == int(np.argmax(target_logits[a])):
            a += 1
        return list(drafts[:a]) + [int(np.argmax(target_logits[a]))], a
    rng = _rng(sp.seed, counter, _STREAM_ACCEPT)
    emitted: list[int] = []
    for i in range(k):
        p = filtered_probs(target_logits[i], sp)
        q = np.asarray(draft_probs[i], np.float64)
        d = int(drafts[i])
        if rng.random() < min(1.0, p[d] / max(q[d], 1e-300)):
            emitted.append(d)
            continue
        resid = np.maximum(p - q, 0.0)
        total = resid.sum()
        resid = resid / total if total > 0.0 else p
        return emitted + [_draw(resid, rng)], i
    p = filtered_probs(target_logits[k], sp)
    return emitted + [_draw(p, rng)], k

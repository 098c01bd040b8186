"""The one traffic generator: every mix is a data file of parameters
beside this module (``bench/traffic/<name>.json``), read here.

Serving mixes (``"kind": "serve"``) give each request a prompt length and
an output length drawn from a lognormal with the given median and sigma
(the median is the linear-scale one: ``median x exp(sigma x z)``),
clipped to ``[min, max]``; open-loop arrivals follow exponential gaps at
the cell's rate (stratified, below).  Training mixes (``"kind":
"train"``) give each step a (batch, seq_len + 1) block of token ids, the
rows shifted by one for the labels.

Every seed draws the same requests and gaps, in another order: a block
of ``BLOCK`` (32) requests holds one request of each of 32 fixed (prompt,
output) pairs, prompt quantile i (at (i + 0.5) / 32 of its distribution)
with output quantile 19 i mod 32 (a fixed pairing, uncorrelated in rank),
and the exponential's 32 quantiles as its gaps; the seed permutes the
pairs and, apart, the gaps within each block, and draws the token ids
uniformly over the vocabulary.  So runs with different seeds do the same
work block by block, each request's prompt and output together: the
K/V a decoding lane reads grows with both, so a pairing drawn anew each
seed would change the work.  The arrivals are stratified, not a Poisson
process: every 32 requests arrive in 32 / rate seconds, so bursts last a
block at most.  Without blocks one seed's window can hold a cluster of
long requests that queues for seconds while another's holds none, and
the tails then differ from seed to seed far more than between two runs
of one seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass(frozen=True)
class ServeRequest:
    index: int
    offset_s: float        # due time after the arrival process starts
    prompt_len: int
    output_len: int


#: requests to a block: each block holds the same sizes and gaps
BLOCK = 32
#: output quantile ``PAIR_STRIDE x i mod BLOCK`` goes with prompt quantile i
PAIR_STRIDE = 19


def _quantiles() -> np.ndarray:
    return (np.arange(BLOCK) + 0.5) / BLOCK


def _blocks(values: np.ndarray, n: int, rng: np.random.Generator
            ) -> np.ndarray:
    """n draws: ``values`` (one block's set) permuted block after block."""
    k = -(-n // len(values))
    return np.concatenate([rng.permutation(values) for _ in range(k)])[:n]


def lognormal_lengths(spec: dict) -> np.ndarray:
    """A block's lengths: the clipped lognormal's quantiles, ascending."""
    z = np.array([NormalDist().inv_cdf(u) for u in _quantiles()])
    x = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def poisson_offsets(rate: float, n: int, rng: np.random.Generator
                    ) -> np.ndarray:
    """n arrival times at ``rate`` a second: the exponential's quantiles
    of a block as gaps, permuted block by block, summed."""
    return np.cumsum(_blocks(-np.log1p(-_quantiles()) / rate, n, rng))


def serve_requests(mix: dict, n: int, seed: int,
                   rate: float | None = None) -> list[ServeRequest]:
    """n requests of a serving mix; with ``rate`` an open loop (offsets
    from the arrival process), else a backlog (every offset 0)."""
    rng = np.random.default_rng([seed, 1])
    prompts = lognormal_lengths(mix["prompt"])
    outputs = lognormal_lengths(mix["output"])[
        PAIR_STRIDE * np.arange(BLOCK) % BLOCK]
    pairs = _blocks(np.arange(BLOCK), n, rng)
    offsets = (poisson_offsets(rate, n, rng) if rate is not None
               else np.zeros(n))
    return [ServeRequest(i, float(offsets[i]), int(prompts[pairs[i]]),
                         int(outputs[pairs[i]])) for i in range(n)]


def prompt_tokens(req: ServeRequest, seed: int, vocab: int) -> list[int]:
    """The request's prompt ids, uniform over the vocabulary, from the
    seed and the request's index alone."""
    rng = np.random.default_rng([seed, 2, req.index])
    return rng.integers(0, vocab, size=req.prompt_len).tolist()


def open_loop_count(rate: float, seconds: float) -> int:
    """Requests to draw so that arrivals last past ``seconds`` (the ramp
    and the window) with room to spare."""
    return int(math.ceil(rate * seconds * 1.2)) + 16


def train_batch(mix: dict, seed: int, step: int, vocab: int, device):
    """Step ``step``'s batch: {"tokens", "labels"} (batch, seq_len) int64
    on ``device``, made there by a generator of the seed and the step."""
    import torch

    gen = torch.Generator(device=device).manual_seed(
        (seed * 1000003 + step * 7919 + 17) & ((1 << 63) - 1))
    x = torch.randint(0, vocab, (mix["batch"], mix["seq_len"] + 1),
                      generator=gen, device=device)
    return {"tokens": x[:, :-1].contiguous(), "labels": x[:, 1:].contiguous()}

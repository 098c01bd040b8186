"""Deterministic sharded synthetic token pipeline, the JAX package's
``data/pipeline.py``.

Every batch is a pure function of (seed, step, shard): a numpy
``Generator`` seeded from the three values draws it, so resuming at step
k regenerates the same remaining stream with no data state to save.  The
tokens follow the same Zipf-style transform of uniforms (low ids are
common) with the same local structure (position p mixed with p - 1), the
labels are the tokens shifted by one, and a frontend arch gets
``frontend_embeds`` drawn from the same generator.  The draws are numpy's,
not ``jax.random``'s, so the tokens differ from the JAX package's for the
same seed (as ``Model.init``'s weights do); the parity tests hand both
packages the same numpy batch.

Batches are CPU tensors (tokens and labels int32, frontend embeddings
float32); the trainer moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_seq: int = 0
    d_model: int = 0


def _generator(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng([seed, step, shard])


def batch_for_step(cfg: DataConfig, step: int, shard: int = 0,
                   n_shards: int = 1) -> dict:
    """One shard's batch: tokens/labels (b_shard, S) int32 (+ frontend)."""
    b = cfg.global_batch // n_shards
    rng = _generator(cfg.seed, step, shard)
    # Zipf-ish: exponential transform of uniforms concentrates low ids
    u = rng.random((b, cfg.seq_len + 1), dtype=np.float32)
    toks = (np.exp(u * np.float32(np.log(cfg.vocab_size))) - 1
            ).astype(np.int32)
    toks = np.clip(toks, 0, cfg.vocab_size - 1)
    # inject local structure: every position p depends weakly on p-1
    toks[:, 1:] = (toks[:, 1:] + toks[:, :-1]) % cfg.vocab_size
    out = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
           "labels": torch.from_numpy(toks[:, 1:].copy())}
    if cfg.frontend_seq:
        out["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.frontend_seq, cfg.d_model), dtype=np.float32))
    return out


class DataIterator:
    """Stateless-resumable iterator: ``DataIterator(cfg, start_step=k)``."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, shard: int = 0,
                 n_shards: int = 1):
        self.cfg = cfg
        self.step = start_step
        self.shard = shard
        self.n_shards = n_shards

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = batch_for_step(self.cfg, self.step, self.shard, self.n_shards)
        self.step += 1
        return b

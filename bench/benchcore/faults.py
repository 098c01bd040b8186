"""Faults planted under the timed path, to show that the check catches
them: the CPU tests plant each in a whole run and see ``correct`` come out
false; ``control.py --fault`` reads them on the card at a cell's size, where
a training cell's limits are held against them.

Each is installed by replacing a function of the port's modules (the
program calls them through their modules, so the running engine or step
picks the replacement up) and returns the callable that undoes it.

* ``token_altered``: every request's third token, as it is sampled, moved
  to the next id (serving).
* ``kv_unwritten``: the K/V rows a step computes never written into the
  pages: the step leaves its state unchanged (serving).
* ``half_lanes``: the upper half of a decode step's lanes given the lower
  half's logits: half the batch left out (serving).
* ``state_unchanged``: AdamW's update leaves the parameters and moments as
  they were (training).
* ``half_batch``: the loss over the first half of the batch's rows, the
  mean taken over them alone (training).
* ``loss_altered``: the loss reported 5% high where it is produced, its
  gradient unchanged (training).
"""
from __future__ import annotations


def _patch(module, name: str, fn):
    real = getattr(module, name)
    setattr(module, name, fn(real))
    return lambda: setattr(module, name, real)


def token_altered():
    import numpy as np
    from repro_torch.serving import sampling

    def wrap(real):
        def sample_batch(logits, params, counters):
            toks = real(logits, params, counters)
            return [(t + 1) % np.asarray(logits).shape[-1] if c == 2 else t
                    for t, c in zip(toks, counters)]
        return sample_batch
    return _patch(sampling, "sample_batch", wrap)


def kv_unwritten():
    from repro_torch.kernels import ops
    from repro_torch.models import attention

    def wrap(real):
        def write_rows(k_pool, v_pool, scales, phys, slot, k, v):
            return ops.PagedPools(k_pool, v_pool)
        return write_rows
    return _patch(attention, "_write_rows", wrap)


def half_lanes():
    import torch
    from repro_torch.models import transformer

    def wrap(real):
        def step(*args, **kwargs):
            logits, caches = real(*args, **kwargs)
            h = logits.shape[0] // 2
            return (torch.cat([logits[:h], logits[:logits.shape[0] - h]]),
                    caches)
        return step
    return _patch(transformer, "paged_decode_step", wrap)


def state_unchanged():
    import torch
    from repro_torch.optim import adamw

    def wrap(real):
        def update(grads, state, params, cfg):
            z = torch.zeros((), dtype=torch.float32,
                            device=adamw.leaves(params)[0].device)
            return params, state, {"grad_norm": z, "lr": z}
        return update
    return _patch(adamw, "update", wrap)


def half_batch():
    from repro_torch.models import transformer

    def wrap(real):
        def train_loss(params, batch, cfg, *a, **k):
            h = batch["tokens"].shape[0] // 2
            return real(params, {key: v[:h] for key, v in batch.items()},
                        cfg, *a, **k)
        return train_loss
    return _patch(transformer, "train_loss", wrap)


def loss_altered():
    from repro_torch.models import transformer

    def wrap(real):
        def train_loss(*a, **k):
            loss = real(*a, **k)
            return loss + 0.05 * loss.detach()
        return train_loss
    return _patch(transformer, "train_loss", wrap)


SERVING = {"token_altered": token_altered, "kv_unwritten": kv_unwritten,
           "half_lanes": half_lanes}
TRAINING = {"state_unchanged": state_unchanged, "half_batch": half_batch,
            "loss_altered": loss_altered}
ALL = {**SERVING, **TRAINING}

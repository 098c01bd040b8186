"""The numbers that decide ``correct``, each held to a limit of its own
from the cell's file (``"limits"``).

Serving: the widest gap by which a served token's logit lies below the
reference's best at that position (0 where the served token is the
reference's argmax).  The control reads, at each position of the same
sequences, the gap of the token that the lower precision puts first.

Training: each step's loss against the reference's (relative), and, leaf
by leaf (the stacked leaves layer by layer), the norm of step 1's
gradient as the optimizer got it and the norm of the parameters' change
after the checked steps: the gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf, the worst leaf taken.  A leaf whose reference gradient
is under a thousandth of the median leaf's is left out of the change (it
moves by round-off alone under Adam).
"""
from __future__ import annotations

import statistics

import torch

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of the parameter-change comparison
IDLE_LEAF = 1e-3


def served_gap(ref_logits: torch.Tensor, served: list[int]) -> float:
    """ref_logits (n, V) float32 at the positions that produced ``served``
    (n tokens)."""
    tok = torch.tensor(served, device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, tok[:, None])[:, 0]
    return float((best - got).max())


def control_gap(ref_logits: torch.Tensor, ctl_logits: torch.Tensor) -> float:
    """The widest gap of the tokens the control puts first."""
    return served_gap(ref_logits, ctl_logits.argmax(dim=-1).tolist())


def norm_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """(worst leaf's gap, its name) between two {leaf: norm} readings."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    worst, where = 0.0, ""
    for n in names:
        g = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if g > worst:
            worst, where = g, n
    return worst, where


def moving_leaves(ref_grad: dict) -> set:
    med = statistics.median(ref_grad.values())
    return {n for n, g in ref_grad.items() if g >= IDLE_LEAF * med}


def loss_gap(prog: list[float], ref: list[float]) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def judge(readings: dict, limits: dict) -> tuple[bool, list]:
    """(every reading within its limit, [(name, value, limit)]).  A
    reading that is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and v == v and abs(v) != float("inf") \
            and v <= limit
        ok = ok and good
        rows.append((name, v, limit))
    return ok, rows

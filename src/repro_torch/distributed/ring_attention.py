"""Ring sequence-parallel attention (the JAX package's
``distributed/ring_attention.py``: ``shard_map`` + ``ppermute`` there,
point-to-point sends over the ``model`` group here).

Each rank of the ring takes one sequence shard of Q, K and V, computes a
flash-style partial attention (running max, sum and accumulator, in
float32 as the reference computes them) against the K/V block it holds,
then passes that block to the next rank: ``n - 1`` transfers of one local
block per rank, never an all-gather of K/V.  Causal masking uses global
positions derived from the ring step, so the result is ``attention_ref``
on the whole sequence.  The output, sharded over the sequence, is then
gathered back to every rank, as GSPMD gathers the reference's
sequence-sharded output for the replicated caller.

With a ``batch_axis`` (default ``"data"`` when the mesh has one) whose
size divides the batch, each rank also takes its batch shard and the
output is gathered over that axis too; a batch it does not divide (one
prompt on a 2x2 mesh) stays whole on every rank.

Wire bytes per rank: ``(n - 1)`` blocks of K and V
(:func:`ring_collective_bytes`), against ``(n - 1) / n`` of the whole
K/V for an all-gather, and one extra block of memory at most.
"""
from __future__ import annotations

import torch

from .collectives import all_gather, ring_shift


def _shard(x: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


def make_ring_attention(mesh, axis_name: str = "model", causal: bool = True,
                        scale: float | None = None,
                        batch_axis: str | None = None):
    """The ring attention over ``mesh``'s ``axis_name``: a function of
    replicated q, k, v (B, H, S, D) (K/V with q's heads; ``S`` divisible
    by the axis) returning the replicated output (B, H, S, D) in q's
    dtype."""
    n = mesh.shape[axis_name]
    group = mesh.group(axis_name)
    if batch_axis is None and "data" in mesh.axis_names:
        batch_axis = "data"

    def ring(q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
        b, h, s, d = q.shape
        if s % n:
            raise ValueError(f"ring attention: sequence {s} does not divide "
                             f"the {axis_name!r} axis of size {n}")
        nb = mesh.shape[batch_axis] if batch_axis else 1
        split_batch = nb > 1 and b % nb == 0
        if split_batch:
            bi = mesh.coords[batch_axis]
            q, k, v = (_shard(t, 0, bi, nb) for t in (q, k, v))
            b = q.shape[0]
        idx = mesh.coords[axis_name]
        s_loc = s // n
        sc = float(scale if scale is not None else d ** -0.5)
        q32 = _shard(q, 2, idx, n).float()
        kv = torch.stack((_shard(k, 2, idx, n), _shard(v, 2, idx, n)))
        kw = dict(dtype=torch.float32, device=q.device)
        m = torch.full((b, h, s_loc), -1e30, **kw)
        l = torch.zeros((b, h, s_loc), **kw)
        acc = torch.zeros((b, h, s_loc, d), **kw)
        rows = torch.arange(s_loc, device=q.device)
        for i in range(n):
            src = (idx - i) % n
            sco = torch.einsum("bhqd,bhkd->bhqk", q32, kv[0].float()) * sc
            if causal:
                qi = idx * s_loc + rows[:, None]
                kj = src * s_loc + rows[None, :]
                sco = torch.where((qi >= kj)[None, None], sco,
                                  torch.tensor(-1e30, **kw))
            m_cur = torch.maximum(m, sco.amax(-1))
            p = torch.exp(sco - m_cur[..., None])
            alpha = torch.exp(m - m_cur)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, kv[1].float())
            m = m_cur
            if i < n - 1:
                kv = ring_shift(kv, group)
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out = all_gather((acc / l[..., None]).to(q.dtype), group, dim=2)
        if split_batch:
            out = all_gather(out, mesh.group(batch_axis), dim=0)
        return out

    return ring


def ring_collective_bytes(b: int, h: int, s: int, d: int, n: int,
                          bytes_per_el: int = 2) -> int:
    """Analytic wire bytes per device: (n-1) permutes of one local KV."""
    return 2 * b * h * (s // n) * d * bytes_per_el * (n - 1)

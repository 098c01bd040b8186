"""The collectives of tensor-parallel serving, over ``torch.distributed``.

* :func:`all_gather` — every member's tensor, concatenated along ``dim`` in
  the group's rank order (the head outputs of the paged attention, the
  ring's sequence shards, ``compressed_psum``'s codes and scales);
* :func:`ring_shift` — one point-to-point step around a ring: send to the
  next member, receive from the previous one (ring attention's K/V);
* :func:`all_reduce` — the sum (or max) over a group (the weights'
  checksum);
* :func:`broadcast_object` — rank 0's Python object on every rank (the
  engine's host decisions: sampled tokens, run-time AT commits).

Which transport carries a tensor is decided up front by the group's
backend and the tensor's device, never by trying: NCCL takes CUDA
tensors as they are; gloo takes host tensors, so a CUDA tensor handed to
a gloo group (several ranks on one card) is staged through the host,
copied out before the collective and back after it.  :data:`STAGED`
counts those bytes by op (both directions), :data:`CALLS` the calls by
op and :data:`SECONDS` the host seconds spent in them (a staged op waits
for the device, so its seconds hold the device's share too; an NCCL op
returns once it is queued); :func:`reset_counts` zeroes all three.
"""
from __future__ import annotations

import collections
import functools
import time

import torch
import torch.distributed as dist

#: bytes copied between a card and the host to stage a collective, by op
STAGED: collections.Counter = collections.Counter()
#: collectives called, by op
CALLS: collections.Counter = collections.Counter()
#: host seconds in the collectives, by op
SECONDS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    STAGED.clear()
    CALLS.clear()
    SECONDS.clear()


def _counted(op: str):
    """Count the calls of a collective and the host seconds in them."""
    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                CALLS[op] += 1
                SECONDS[op] += time.perf_counter() - t0
        return counted
    return wrap


def staged(group, t: torch.Tensor) -> bool:
    """Does ``t`` go through the host to cross ``group``?  (gloo carries
    host tensors only.)"""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(op: str, t: torch.Tensor) -> torch.Tensor:
    STAGED[op] += t.numel() * t.element_size()
    return t.cpu()


def _back(op: str, t: torch.Tensor, device: torch.device) -> torch.Tensor:
    STAGED[op] += t.numel() * t.element_size()
    return t.to(device)


@_counted("all_gather")
def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The members' ``x`` (same shape on each) concatenated along ``dim``
    in group-rank order.  Exact: no arithmetic touches the values."""
    n = dist.get_world_size(group)
    stage = staged(group, x)
    src = _to_host("all_gather", x) if stage else x
    src = src.contiguous()
    if dist.get_backend(group) == "nccl":
        buf = torch.empty((n, *src.shape), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(buf, src, group=group)
        parts = buf.unbind(0)
    else:
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return _back("all_gather", out, x.device) if stage else out


@_counted("all_reduce")
def all_reduce(x: torch.Tensor, group=None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` over the members' ``x``; returns the reduced tensor (``x``
    itself unless it was staged)."""
    if not staged(group, x):
        dist.all_reduce(x, op=op, group=group)
        return x
    host = _to_host("all_reduce", x)
    dist.all_reduce(host, op=op, group=group)
    return _back("all_reduce", host, x.device)


@_counted("ring_send")
def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """One ring step over ``group``: send ``x`` to member ``(i + 1) % n``
    and return what member ``(i - 1) % n`` sent (same shape and type)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (i + 1) % n)
    prv = dist.get_global_rank(group, (i - 1) % n)
    stage = staged(group, x)
    send = (_to_host("ring_send", x) if stage else x).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.isend(send, nxt, group=group),
           dist.irecv(recv, prv, group=group)]
    for w in ops:
        w.wait()
    return _back("ring_send", recv, x.device) if stage else recv


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank of the world (``obj`` itself
    outside a world of more than one rank)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    return _broadcast(obj, src)


@_counted("broadcast_object")
def _broadcast(obj, src: int):
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]

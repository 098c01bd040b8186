"""Per-rank dot FLOPs and collective bytes of a step: the port's
counterpart of the JAX package's ``launch/hlo_analysis.py``.

The JAX dry run reads them off the compiled per-device HLO.  The port
compiles nothing: :class:`OpCounter`, a ``TorchDispatchMode``, watches
the aten operations a step runs on this rank and counts

* the FLOPs of every matrix product, ``2 x`` the output's elements ``x``
  the contracted length: ``mm``, ``addmm``, ``bmm``, ``baddbmm`` (the
  einsums and matmuls of the plain routes, attention's included, reach
  aten as these), and of the convolutions (``2 x`` output elements ``x``
  the taps a output element reads; a ``convolution_backward`` counts
  the products it makes).  The recompute under ``torch.utils.checkpoint``
  runs its products again, so they count again, as the compiled
  program's rematerialised dots do;
* the bytes of every collective's result on this rank, by the JAX kinds
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``) and their ``total``, as
  ``collective_bytes_by_kind`` counts an HLO collective's result shape.

On ``DTensor`` arguments the counter steps aside (it returns
``NotImplemented``), so ``DTensor`` runs the operation below it: the
redistributions it inserts and the operation on this rank's local shards
come back to the counter as plain tensors, and what is counted is this
rank's share, as the JAX record's per-device numbers are.  ``DTensor``
also runs each new operation once on fake tensors of the global shapes,
to learn its output's shape (its sharding propagation,
``_sharding_prop.py``): what runs under that module's frames is neither
counted nor tracked, and neither are fake tensors of another fake mode
than the step's.  The port's layer loop is a Python loop that runs every
layer, so the counts are loop-aware by construction: ``while_trips`` is
empty.
"""
from __future__ import annotations

import math
import sys
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["OpCounter", "analyze_step", "COLLECTIVE_KINDS"]

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_aten = torch.ops.aten
_PRODUCTS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default}


def _collective_ops() -> dict:
    """aten-level collective overloads -> JAX kind: the functional
    collectives ``DTensor`` and ``torch.distributed._functional_collectives``
    issue, and the c10d ops ``torch.distributed``'s calls issue."""
    table = {}
    for ns, names in (
            ("_c10d_functional", {
                "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all"}),
            ("c10d", {
                "allgather_": "all-gather",
                "_allgather_base_": "all-gather",
                "allreduce_": "all-reduce",
                "reduce_scatter_": "reduce-scatter",
                "_reduce_scatter_base_": "reduce-scatter",
                "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
                "send": "collective-permute",
                "recv_": "collective-permute"})):
        space = getattr(torch.ops, ns, None)
        for name, kind in names.items():
            packet = getattr(space, name, None) if space is not None else None
            if packet is not None:
                table[packet] = kind
    return table


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _in_propagation() -> bool:
    """Is the caller inside ``DTensor``'s sharding propagation (its
    module's frames on the stack)?"""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _storage(t: torch.Tensor):
    """The storage of ``t``, or of its local shard for a ``DTensor``."""
    local = getattr(t, "_local_tensor", None)
    return (t if local is None else local).untyped_storage()


def _product_flops(func, args, out) -> float:
    a = args[1] if func in (_aten.addmm.default, _aten.baddbmm.default) \
        else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _conv_flops(out: torch.Tensor, weight: torch.Tensor) -> float:
    """2 x output elements x the taps each reads: the weight's elements
    over its output channels (JAX's count: every kernel dimension but the
    output features)."""
    return 2.0 * out.numel() * (weight.numel() / weight.shape[0])


class OpCounter(TorchDispatchMode):
    """Counts this rank's product FLOPs (``dot_flops``) and collective
    bytes by kind (``collective_bytes``) of the operations run inside it.
    ``fake_mode``: the ``FakeTensorMode`` the counted step's tensors
    belong to, when they are fake (fake tensors of any other mode, which
    ``DTensor`` propagates shapes with, are not counted)."""

    def __init__(self, fake_mode=None, inputs=()):
        super().__init__()
        self.fake_mode = fake_mode
        # storages made inside (live bytes and their peak); the inputs'
        # storages (and DTensor inputs' local shards) are not counted
        self._made = WeakIdKeyDictionary()
        self._given = WeakIdKeyDictionary()
        for t in _tensors(list(inputs)):
            self._given[_storage(t)] = True
        self.live_bytes = 0
        self.peak_bytes = 0
        self.dot_flops = 0.0
        self.collective_bytes = {k: 0.0 for k in COLLECTIVE_KINDS}
        self._kinds = _collective_ops()

    def _ours(self, args) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        return not _in_propagation() and all(
            not isinstance(t, FakeTensor) or t.fake_mode is self.fake_mode
            for t in _tensors(list(args)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor dispatches below us
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if not self._ours(args):
            return out
        if packet in self._kinds or func in _PRODUCTS or packet in (
                _aten.convolution, _aten.convolution_backward):
            self._count(func, packet, args, out)
        for t in _tensors(out):
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = _storage(t)
        if st in self._made or st in self._given:
            return
        nbytes = st.nbytes()
        self._made[st] = nbytes
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, nbytes)

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def _count(self, func, packet, args, out) -> None:
        if func in _PRODUCTS:
            self.dot_flops += _product_flops(func, args, out)
        elif packet is _aten.convolution:
            self.dot_flops += _conv_flops(out, args[1])
        elif packet is _aten.convolution_backward:
            grad_out, weight = args[0], args[2]
            mask = args[-1]
            self.dot_flops += _conv_flops(grad_out, weight) * sum(
                bool(m) for m in mask[:2])
        else:
            self.collective_bytes[self._kinds[packet]] += _nbytes(out)

    def result(self) -> dict:
        """{"dot_flops", "collective_bytes": {kind: bytes, "total"},
        "while_trips": []}, the JAX ``analyze_module``'s keys."""
        coll = dict(self.collective_bytes)
        coll["total"] = math.fsum(coll.values())
        return {"dot_flops": self.dot_flops, "collective_bytes": coll,
                "while_trips": []}


def analyze_step(fn: Callable, *args, fake_mode=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter` (its
    tensor arguments not counted as made); returns (its result, the
    counter's :meth:`~OpCounter.result` and ``peak_bytes``, the most
    bytes the step had made and not yet freed at once)."""
    from ..optim.adamw import leaves
    given = [x for a in args for x in leaves(a) if isinstance(x, torch.Tensor)]
    with OpCounter(fake_mode, given) as counter:
        out = fn(*args, **kwargs)
    return out, {**counter.result(), "peak_bytes": counter.peak_bytes}

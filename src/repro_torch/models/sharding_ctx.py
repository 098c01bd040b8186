"""The layout plan a trainer installs, and the model's only coupling to a
mesh (the JAX package's ``models/sharding_ctx.py``).

:class:`LayoutPlan` carries the activation layouts by role (``specs``,
the port's ``PartitionSpec`` :class:`~repro_torch.distributed.sharding.P`
per role: ``tokens``, ``hidden``, ``heads``, ``kv_heads``,
``logits_hidden``, ``moe_experts``), one layer's parameter layouts
(``layer_specs``) and the train step's knobs (``remat``,
``num_microbatches``, ``loss_chunks``, ``grad_compress``); model code
reads the installed plan through :func:`current_plan`.

On one device there is nothing to shard: the tensors are plain and
:func:`constrain` and :func:`constrain_layer_params` return their input
itself, so every single-device path is unchanged.  Where the parameters
and the batch are ``DTensor`` (the sharded train step and the dry run,
:mod:`repro_torch.launch.steps`), ``constrain(x, role)`` redistributes
``x`` to the plan's layout for ``role`` (``jax.lax.with_sharding_constraint``)
and ``constrain_layer_params`` one layer's weights to ``layer_specs``.

Where the JAX model leaves a layout to GSPMD through an operation that
``DTensor`` has no sharding rule for (an index lookup, the attention
core, the selective scans, the MoE's index dispatch), the model runs
that operation on each rank's local shard: :func:`local` redistributes a
``DTensor`` to a layout and hands out its local tensor (a weight used
whole by ranks that hold different batch shards takes its gradient as a
partial sum over their axes), and :func:`from_local` wraps the result
back.  Both are differentiable.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field

import torch

#: the mesh axes a batch is split over, major first (a JAX plan's ``dpa``)
BATCH_AXES = ("pod", "data")


@dataclass
class LayoutPlan:
    """Named activation layouts and one layer's parameter layouts (used
    where the tensors are ``DTensor``), and the train step's knobs."""

    name: str = "replicated"
    specs: dict = field(default_factory=dict)
    layer_specs: object = None
    remat: str = "none"            # none | dots | full
    num_microbatches: int = 1
    loss_chunks: int = 8           # the cross entropy's token chunks
    grad_compress: bool = False    # int8 gradient all-reduce (unused)

    def spec(self, role: str):
        return self.specs.get(role)


_ACTIVE: contextvars.ContextVar[LayoutPlan | None] = contextvars.ContextVar(
    "layout_plan", default=None)


def current_plan() -> LayoutPlan | None:
    return _ACTIVE.get()


@contextlib.contextmanager
def use_plan(plan: LayoutPlan | None):
    token = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(token)


def is_dtensor(x) -> bool:
    """Is ``x`` a ``DTensor`` (a tensor laid out over a mesh)?"""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _placements(x, spec, shape: tuple | None = None) -> tuple:
    """``spec``'s placements on ``x``'s mesh for a tensor of ``shape``
    (``x``'s own by default), the axes that do not divide their dimension
    dropped."""
    from ..distributed.sharding import dtensor_placements
    dm = x.device_mesh
    names = tuple(dm.mesh_dim_names)
    return dtensor_placements(spec, names, tuple(
        x.shape if shape is None else shape), dict(zip(names, dm.shape)))


def _redistribute(x, spec):
    pl = _placements(x, spec)
    return x if tuple(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)


class _Pin(torch.autograd.Function):
    """A ``DTensor`` redistributed to ``placements``, and its gradient
    pinned to them too before it goes back to the input's layout (a
    partial input's gradient whole): the cotangent of
    ``jax.lax.with_sharding_constraint`` is constrained alike.  Left to
    itself, ``DTensor`` hands a partial sum back, and the products of the
    backward then gather their weights whole to take it."""

    @staticmethod
    def forward(ctx, x, placements):
        from torch.distributed.tensor import Replicate
        ctx.placements = placements
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        g = g.redistribute(g.device_mesh, ctx.placements)
        return g.redistribute(g.device_mesh, ctx.back), None


def _pin(x, spec):
    """``x`` laid out by ``spec``, its gradient pinned there too
    (:class:`_Pin`); without a graph, a plain redistribution."""
    pl = _placements(x, spec)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x if tuple(x.placements) == pl else x.redistribute(
            x.device_mesh, pl)
    return _Pin.apply(x, pl)


def constrain(x: torch.Tensor, role: str) -> torch.Tensor:
    """``x`` laid out as the installed plan's spec for ``role``: a
    ``DTensor`` is redistributed to it; a plain tensor, or a role the plan
    has no spec for, or no plan, gives ``x`` itself."""
    plan = current_plan()
    if plan is None or not is_dtensor(x):
        return x
    spec = plan.spec(role)
    if spec is None:
        return x
    return _pin(x, spec)


def constrain_to(x: torch.Tensor, spec) -> torch.Tensor:
    """A ``DTensor`` ``x`` redistributed to ``spec`` (the axes that do
    not divide their dimension dropped), its gradient pinned there too;
    a plain tensor as it is."""
    return _pin(x, spec) if is_dtensor(x) else x


def constrain_layer_params(lp):
    """One layer's weights (a dict of its per-layer slices) pinned to the
    plan's ``layer_specs``, so that their gradients land on those shards
    (a reduce-scatter over the batch axes), and handed to the layer in the
    layout its products compute in: gathered over the batch axes
    (:func:`for_compute`, the FSDP all-gather GSPMD inserts by itself).
    The input itself without a plan or on plain tensors."""
    plan = current_plan()
    if plan is None or not any(is_dtensor(x) for x in _leaves(lp)):
        return lp

    def one(x, spec):
        if isinstance(x, dict):
            return {k: one(v, None if spec is None else spec[k])
                    for k, v in x.items()}
        return for_compute(x if spec is None else _redistribute(x, spec))

    return one(lp, plan.layer_specs)


def for_compute(w):
    """A ``DTensor`` weight gathered over the mesh's batch axes (its
    model-axis split kept): the layout a product with batch-split
    activations takes it in; its gradient goes back to ``w``'s layout by
    a reduce-scatter.  A plain tensor is returned as it is; a dict of
    weights is mapped."""
    if isinstance(w, dict):
        return {k: for_compute(v) for k, v in w.items()}
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = tuple(w.device_mesh.mesh_dim_names)
    pl = tuple(Replicate() if n in BATCH_AXES else p
               for n, p in zip(names, w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def batch_spec(x, dims: dict | None = None):
    """The layout of an activation ``x`` that a local computation takes:
    its batch (dimension 0) split over the mesh's batch axes, and
    ``dims`` {dimension: axis name or tuple} beside it; every other
    dimension whole."""
    from ..distributed.sharding import P
    names = tuple(x.device_mesh.mesh_dim_names)
    dp = tuple(a for a in BATCH_AXES if a in names)
    entries = [None] * x.dim()
    entries[0] = dp if len(dp) > 1 else (dp[0] if dp else None)
    for d, a in (dims or {}).items():
        entries[d] = a
    return P(*entries)


def local(x, spec, *, partial_over: tuple = ()) -> torch.Tensor:
    """This rank's local tensor of ``DTensor`` ``x`` laid out by ``spec``
    (a :class:`~repro_torch.distributed.sharding.P`; an axis that does not
    divide its dimension is dropped).  Its gradient is taken as laid out
    by ``spec``, except on the mesh axes ``partial_over``, where it is a
    partial sum (a weight used whole by ranks that hold different shards
    of a batch)."""
    from torch.distributed.tensor import Partial
    pl = _placements(x, spec)
    names = tuple(x.device_mesh.mesh_dim_names)
    grad = tuple(Partial() if n in partial_over else p
                 for n, p in zip(names, pl))
    return x.redistribute(x.device_mesh, pl).to_local(grad_placements=grad)


def from_local(t: torch.Tensor, like, spec, shape, *,
               partial_over: tuple = ()):
    """The ``DTensor`` of global ``shape`` on ``like``'s mesh whose local
    tensor on this rank is ``t``: laid out by ``spec`` (as :func:`local`
    drops an axis that does not divide its dimension of ``shape``), and a
    partial sum over the mesh axes ``partial_over`` (each rank holding its
    share of a sum)."""
    from torch.distributed.tensor import DTensor, Partial

    from ..distributed.sharding import contiguous_stride
    dm = like.device_mesh
    names = tuple(dm.mesh_dim_names)
    pl = tuple(Partial() if n in partial_over else p
               for n, p in zip(names, _placements(like, spec, shape)))
    return DTensor.from_local(t.contiguous(), dm, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def split_dims(x, spec) -> set:
    """The dimensions of ``x`` that ``spec`` splits on its mesh (the axes
    that divide them)."""
    return {p.dim for p in _placements(x, spec) if p.is_shard()}


def batch_axes_of(x) -> tuple:
    """The mesh axes ``x``'s batch is split over under :func:`batch_spec`
    (none where they do not divide it)."""
    names = tuple(x.device_mesh.mesh_dim_names)
    spec = batch_spec(x)
    pl = _placements(x, spec)
    return tuple(n for n, p in zip(names, pl) if p.is_shard())


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``.  On a ``DTensor`` table (an embedding laid out over
    a mesh) each rank looks its own batch shard of ``idx`` up in the
    table gathered over the batch axes (its gradient a partial sum over
    the axes that split the batch).  Where the rows stay split over
    ``model``, each rank reads the rows it holds and zeros for the
    others, and the rows are a partial sum over ``model`` (GSPMD's masked
    gather: the rows, not the table, are all-reduced).  The rows keep
    ``idx``'s batch layout."""
    if not is_dtensor(table):
        return table[idx]
    from ..distributed.sharding import P
    if is_dtensor(idx):
        ispec = tuple(batch_spec(idx))
        il, axes = local(idx, ispec), batch_axes_of(idx)
    else:
        ispec, il, axes = (None,) * idx.dim(), idx, ()
    split = "model" in split_dims_by_axis(table).get(0, ())
    rest = (None,) * (table.dim() - 1)
    tl = local(table, P("model" if split else None, *rest),
               partial_over=axes)
    shape = tuple(idx.shape) + tuple(table.shape[1:])
    if not split:
        return from_local(tl[il], table, P(*ispec, *rest), shape)
    n = tl.shape[0]
    rel = il - table.device_mesh.get_local_rank("model") * n
    hit = ((rel >= 0) & (rel < n)).reshape(*il.shape, *(1,) * len(rest))
    rows = torch.where(hit, tl[rel.clamp(0, n - 1)], 0)
    return from_local(rows, table, P(*ispec, *rest), shape,
                      partial_over=("model",))


def split_dims_by_axis(x) -> dict:
    """{dimension: the mesh axes it is split over} of a ``DTensor``."""
    out: dict = {}
    for n, p in zip(tuple(x.device_mesh.mesh_dim_names), x.placements):
        if p.is_shard():
            out[p.dim] = out.get(p.dim, ()) + (n,)
    return out


def whole_if_split_past(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x``, with dimension ``dim`` gathered whole where it is split into
    more parts than ``n`` divides (a projection's ``n`` heads, which a
    reshape must keep whole); ``x`` itself where it is not a ``DTensor``
    or is split so that every part holds whole heads."""
    if not is_dtensor(x):
        return x
    dim = dim % x.dim()
    sizes = x.device_mesh.shape
    parts = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            parts *= sizes[i]
    if n % parts == 0:
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_shard(dim) else p for p in x.placements))


def layout(x: torch.Tensor, role: str):
    """The layout of ``x`` for ``role`` over a mesh: the installed plan's
    spec, else its batch alone (:func:`batch_spec`)."""
    plan = current_plan()
    return (plan.spec(role) if plan is not None else None) or batch_spec(x)


def stack_layers(kvs: list, fn=None):
    """Per-layer ``DTensor`` K or V (B, Hkv, S, D) stacked into one (L, B,
    Hkv, S', D) ``DTensor`` in the ``kv_heads`` layout (:func:`layout`:
    batch and heads split, S' and D whole), each layer's local shard first
    mapped by ``fn`` (a ring's roll, a zero pad to S' slots)."""
    from ..distributed.sharding import P
    spec = layout(kvs[0], "kv_heads")
    locs = [local(t, spec) for t in kvs]
    if fn is not None:
        locs = [fn(t) for t in locs]
    out = torch.stack(locs)
    glob = (len(kvs), *kvs[0].shape[:2], *out.shape[3:])
    return from_local(out, kvs[0], P(None, *spec), glob)


def split_rows(x: torch.Tensor, n: int) -> tuple:
    """``x``'s n equal parts along its first axis.  A ``DTensor`` split
    over the mesh's batch axes is cut rank by rank: part i holds every
    rank's i-th slice of its shard, so no rows move (the parts hold the
    same rows as a plain cut would, in another grouping)."""
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} equal "
                         "parts")
    if not is_dtensor(x):
        return x.reshape(n, x.shape[0] // n, *x.shape[1:]).unbind(0)
    spec = batch_spec(x)
    xl = local(x, spec)
    if xl.shape[0] % n:
        raise ValueError(f"a shard of {xl.shape[0]} rows does not split "
                         f"into {n} equal parts")
    shape = (x.shape[0] // n, *x.shape[1:])
    return tuple(from_local(m, x, spec, shape) for m in
                 xl.reshape(n, xl.shape[0] // n, *xl.shape[1:]).unbind(0))

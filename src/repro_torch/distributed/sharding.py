"""Parameter and activation sharding rules: the layout plans that
before-execute-time AT selects (the JAX package's
``distributed/sharding.py``).

Plans (per arch x shape x mesh):

* ``tp`` — tensor parallel: attention heads, FFN width, experts and vocab
  over the ``model`` axis, FSDP over ``data``;
* ``fsdp`` — fully sharded only: every weight sharded over both axes'
  first dim where possible (the fallback when head counts do not divide
  the model axis: phi4 24 heads, llama4 40);
* ``decode_seq`` — decode-time ``tp`` that shards the KV cache's
  sequence over ``model`` (when the KV heads do not divide it);
* ``decode_resident`` — weights sharded over the model axis only, batch
  over data.

The rules are pure functions of the arch, the shapes and the mesh's
``shape`` and ``axis_names``: they return :class:`P`, the port's
``PartitionSpec``, a tuple of axis names, ``None`` or tuples of names,
one entry a dimension.  The port serves with head-sharded paged
attention on every rank's slice of the pools and whole weights on every
rank (:mod:`repro_torch.kernels.ops`), which is what the JAX engine's
replicated parameters amount to.  The trainer's sharded step and the dry
run place tensors by these rules as PyTorch's ``DTensor``, the
counterpart of a JAX ``NamedSharding``: :func:`dtensor_placements` turns
a :class:`P` into the placements of a ``DeviceMesh`` with the same axis
names (:attr:`Mesh.device_mesh`), :func:`place` puts each leaf of a tree
of real or fake tensors on it (each rank keeps its own shard, without a
collective), and :func:`local_shape` is a shard's shape.

:func:`make_serving_mesh` builds the serving mesh from ``--mesh RxC`` in
the current ``torch.distributed`` world.
"""
from __future__ import annotations

import math
import types

import torch

from ..configs.base import ArchConfig
from ..models.sharding_ctx import LayoutPlan
from .process_mesh import Mesh, make_mesh, world_size

class P(tuple):
    """A ``PartitionSpec``: one entry a dimension, each an axis name, a
    tuple of axis names (the dimension sharded over their product) or
    ``None`` (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis_size(mesh) -> int:
    return mesh.shape["model"] if "model" in mesh.axis_names else 1


def parse_mesh_spec(spec: str | None) -> tuple[int, int] | None:
    """``"RxC"`` as ``(R, C)``; None for no mesh (``None`` or empty);
    ``ValueError`` naming the expected form otherwise."""
    if not spec:
        return None
    parts = [p for p in str(spec).lower().split("x") if p]
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        dims = ()
    if len(dims) != 2 or any(d < 1 for d in dims):
        raise ValueError(
            f"bad --mesh {spec!r}: expected 'RxC' (data x model), "
            f"e.g. '1x4'")
    return dims


def make_serving_mesh(spec: str | None) -> Mesh | None:
    """The serving mesh from an ``"RxC"`` flag value: R ranks on the
    ``data`` axis x C on the tensor-parallel ``model`` axis (``"1x2"`` =
    2-way tensor parallelism).  ``None``/empty means no mesh, the
    unsharded engine.  ``"1x1"`` needs no process group and takes the
    unsharded path exactly (every dispatch site treats a 1-rank model
    axis so), which keeps it bit-identical and lets it reuse unsharded
    tuning winners.  A larger mesh needs a world of exactly R x C ranks
    (:func:`repro_torch.distributed.run_world`)."""
    dims = parse_mesh_spec(spec)
    if dims is None:
        return None
    r, c = dims
    if r * c > world_size():
        raise ValueError(
            f"--mesh {spec} needs {r * c} ranks but the world has "
            f"{world_size()} (launch it through repro_torch.distributed."
            f"run_world({r * c}, ...); serve --mesh does)")
    return make_mesh(dims, ("data", "model"))


def _divisible(n: int, mesh, axis: str = "model") -> bool:
    return axis in mesh.axis_names and n % mesh.shape[axis] == 0


def choose_plan_name(cfg: ArchConfig, kind: str, mesh) -> str:
    """Heuristic default; the static-AT driver *searches* over plans and
    this is only the fallback when no tuning record exists."""
    m = model_axis_size(mesh)
    if kind == "decode" and cfg.ssm_version == 0:
        if not _divisible(cfg.n_kv_heads, mesh):
            return "decode_seq"
    if cfg.n_heads % m and cfg.d_ff and cfg.d_ff % m == 0:
        return "fsdp" if cfg.family in ("dense", "vlm") else "tp"
    return "tp"


def make_plan(cfg: ArchConfig, kind: str, mesh, name: str | None = None, *,
              remat: str = "none", num_microbatches: int = 1) -> LayoutPlan:
    name = name or choose_plan_name(cfg, kind, mesh)
    dp = batch_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    m = model_axis_size(mesh)
    specs: dict[str, P] = {"tokens": P(dpa, None)}
    if name == "tp":
        specs["hidden"] = P(dpa, None, None)
        if cfg.n_heads % m == 0:
            specs["heads"] = P(dpa, "model", None, None)
        if cfg.n_kv_heads % m == 0:
            specs["kv_heads"] = P(dpa, "model", None, None)
        specs["logits_hidden"] = P(dpa, None)
        specs["moe_experts"] = P("model", dpa, None, None)
    elif name in ("fsdp", "decode_seq", "decode_resident"):
        specs["hidden"] = P(dpa, None, None)
        specs["logits_hidden"] = P(dpa, None)
        specs["moe_experts"] = P("model", dpa, None, None)
    return LayoutPlan(name=name, specs=specs, remat=remat,
                      num_microbatches=num_microbatches)


# --------------------------------------------------------------------------
# parameter shardings
# --------------------------------------------------------------------------

def _data(mesh) -> int:
    return mesh.shape["data"] if "data" in mesh.axis_names else 1


def _spec_for_param(path: str, shape: tuple, cfg: ArchConfig, plan: str,
                    mesh) -> P:
    """PartitionSpec for one parameter, by name-path + shape."""
    m = model_axis_size(mesh)

    def ok(dim):
        return dim % m == 0

    stacked = path.startswith(("layers/", "enc_layers/", "dec_layers/"))
    lead = (None,) if stacked else ()
    core = shape[1:] if stacked else shape

    def ps(*axes):
        return P(*(lead + axes))

    last = path.split("/")[-1]
    data = _data(mesh)
    # embeddings / head: vocab over model, d over data
    if last in ("embed", "lm_head", "pos_embed"):
        v, d = shape
        if plan == "decode_resident":
            return P("model" if ok(v) else None, None)
        return P("model" if ok(v) else None, "data" if d % data == 0
                 else None)
    if plan == "decode_resident":
        # model-axis-only residency: shard ONE dim over model, never data
        if len(core) == 3 and "moe" in path:
            return ps("model" if ok(core[0]) else None, None, None)
        if len(core) == 2:
            a, b = core
            if last in ("wo", "w_down", "out_proj") and ok(a):
                return ps("model", None)
            if ok(b):
                return ps(None, "model")
            if ok(a):
                return ps("model", None)
            return ps(None, None)
        return ps(*([None] * len(core)))
    if len(core) == 0:
        return ps()
    # MoE experts (E, d, f) / (E, f, d): experts over model, next over data
    if "moe" in path and last in ("w_gate", "w_up", "w_down") \
            and len(core) == 3:
        e, a, _ = core
        return ps("model" if ok(e) else None,
                  "data" if a % data == 0 else None, None)
    if len(core) == 1:
        return ps(None)
    if len(core) == 2:
        a, b = core
        if plan == "fsdp":
            # shard the larger dim over the flattened (data, model) axes
            if a % (m * data) == 0:
                return ps(("data", "model"), None)
            if b % (m * data) == 0:
                return ps(None, ("data", "model"))
            return ps("data" if a % data == 0 else None, None)
        # tp / decode_seq: column-parallel then row-parallel by name
        if last in ("wo", "w_down", "out_proj"):
            return ps("model" if ok(a) else None,
                      "data" if b % data == 0 else None)
        return ps("data" if a % data == 0 else None,
                  "model" if ok(b) else None)
    # conv weights (K, C) etc.
    return ps(*([None] * len(core)))


def _sanitize(spec: P, shape: tuple, mesh) -> P:
    """Drop the axes that do not divide their dimension; pad to the rank."""
    out = []
    for i, ax in enumerate(spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = math.prod(mesh.shape[a] for a in axes)
        out.append(ax if i < len(shape) and shape[i] % size == 0 else None)
    while len(out) < len(shape):
        out.append(None)
    return P(*out[:len(shape)])


def _tree_map(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict/list/tuple tree, keeping its
    structure; paths join dict keys and sequence indices with ``/``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v, f"{path}/{i}" if path else str(i))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(path, tree)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


def param_shardings(abstract_params, cfg: ArchConfig, plan: LayoutPlan,
                    mesh):
    """A spec tree matching the params tree (leaves need only ``shape``)."""
    return _tree_map(
        lambda path, leaf: _sanitize(
            _spec_for_param(path, _shape(leaf), cfg, plan.name, mesh),
            _shape(leaf), mesh), abstract_params)


def layer_param_specs(abstract_params, cfg: ArchConfig, plan: LayoutPlan,
                      mesh):
    """Per-layer specs (stack axis dropped) for one layer's leaves."""
    if "layers" not in abstract_params:
        return None

    def one(path, leaf):
        shape = _shape(leaf)
        spec = _sanitize(_spec_for_param("layers/" + path, shape, cfg,
                                         plan.name, mesh), shape, mesh)
        return P(*spec[1:])

    return _tree_map(one, abstract_params["layers"])


def cache_shardings(abstract_caches, cfg: ArchConfig, plan: LayoutPlan,
                    mesh):
    """Specs for decode caches (stacked (L, B, Hkv, S, D) KV / SSM)."""
    dp = batch_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    m = model_axis_size(mesh)

    def one(path, leaf):
        shp = _shape(leaf)
        if len(shp) == 5:        # (L, B, Hkv, S, D) KV cache
            if plan.name == "decode_seq":
                spec = P(None, dpa, None, "model", None)
            elif plan.name == "decode_resident":
                spec = P(None, dpa, "model" if shp[2] % m == 0 else None,
                         None if shp[2] % m == 0 else "model", None)
            else:
                spec = P(None, dpa, "model" if shp[2] % m == 0 else None,
                         None, None)
        elif len(shp) == 4:      # (L, B, H, N) / (L, B, d_inner, n) ssm h
            spec = P(None, dpa, "model" if shp[2] % m == 0 else None, None)
        elif len(shp) == 3:      # (L, B, conv...) etc.
            spec = P(None, dpa, None)
        else:
            spec = P(*([None] * len(shp)))
        return _sanitize(spec, shp, mesh)

    return _tree_map(one, abstract_caches)


def _spec_axes(entry) -> tuple:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def dtensor_placements(spec, axis_names: tuple, shape: tuple | None = None,
                       mesh_shape: dict | None = None) -> tuple:
    """The ``DTensor`` placements of ``spec`` on a ``DeviceMesh`` whose
    dimensions are named ``axis_names``: ``Shard(i)`` on every mesh
    dimension that a tensor dimension ``i`` names, ``Replicate()`` on
    the rest.  A dimension named by several axes is split over them in
    mesh order, major first (as JAX splits it over a tuple of names).
    With ``shape`` and ``mesh_shape`` an axis that does not divide its
    dimension is dropped first (:func:`_sanitize`)."""
    from torch.distributed.tensor import Replicate, Shard
    if spec is None:
        spec = P()
    if shape is not None:
        spec = _sanitize(spec, tuple(shape),
                         types.SimpleNamespace(shape=mesh_shape))
    out = [Replicate()] * len(axis_names)
    for dim, entry in enumerate(spec):
        axes = _spec_axes(entry)
        idx = [axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec!r}: the axes of a dimension go in the "
                             f"mesh's order {axis_names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def local_shape(shape: tuple, spec, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor laid out by
    ``spec`` (whose axes divide their dimensions)."""
    out = list(shape)
    for dim, entry in enumerate(spec or ()):
        for a in _spec_axes(entry):
            out[dim] //= mesh.shape[a]
    return tuple(out)


def _local_chunk(t, spec, mesh):
    """This rank's shard of ``t`` under ``spec`` (a copy)."""
    for dim, entry in enumerate(spec or ()):
        axes = _spec_axes(entry)
        if not axes:
            continue
        n = math.prod(mesh.shape[a] for a in axes)
        idx = 0
        for a in axes:                   # major first, as the placements
            idx = idx * mesh.shape[a] + mesh.coords[a]
        size = t.shape[dim] // n
        t = t.narrow(dim, idx * size, size)
    return t.clone(memory_format=torch.contiguous_format)


def place(tree, specs, mesh):
    """Each tensor leaf of ``tree`` as a ``DTensor`` on ``mesh``'s
    ``DeviceMesh``, laid out by the matching :class:`P` of ``specs`` (a
    tree of the same structure, as :func:`param_shardings` makes).  Every
    rank holds the whole tensor (the same seed) and keeps its own shard:
    no collective runs.  A leaf that already is a ``DTensor`` is
    redistributed.  Fake tensors place as real ones."""
    from torch.distributed.tensor import DTensor
    dm = mesh.device_mesh
    axes = tuple(dm.mesh_dim_names)

    def one(t, spec):
        pl = dtensor_placements(spec, axes)
        if isinstance(t, DTensor):
            return t.redistribute(dm, pl)
        return DTensor.from_local(_local_chunk(t, spec, mesh), dm, pl,
                                  run_check=False, shape=t.shape,
                                  stride=contiguous_stride(t.shape))

    return _zip_map(one, tree, specs)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def spec_leaves(tree) -> list:
    """The :class:`P` leaves of a spec tree (dicts, lists), in the order
    of ``adamw.leaves`` over the matching tensor tree."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in spec_leaves(v)]
    return [tree]


def _zip_map(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_zip_map(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def batch_shardings(specs: dict, mesh):
    """Specs for the input batch dict (tokens/labels/frontend/...)."""
    dp = batch_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]

    def one(path, leaf):
        shape = _shape(leaf)
        spec = P(*((dpa,) + (None,) * (len(shape) - 1))) if shape else P()
        return _sanitize(spec, shape, mesh)

    return _tree_map(one, specs)

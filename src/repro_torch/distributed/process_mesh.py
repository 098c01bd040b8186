"""Process meshes: the port's counterpart of a JAX ``Mesh``.

JAX drives every device of a mesh from one controller; the port runs one
process per mesh position (SPMD) over ``torch.distributed``.  A
:class:`Mesh` is this rank's view of that world: the axis sizes
(``mesh.shape["model"]``, as in JAX), the axis names, this rank's
coordinate on each axis and one process group per axis, holding the
ranks that differ only along it.  Ranks are laid out row-major over the
axes, so with ``("data", "model")`` rank ``r * C + c`` sits at data ``r``,
model ``c``, and a group's rank is the member's coordinate on its axis.
A mesh whose axes are all 1 needs no process group: it is the unsharded
path.

:func:`run_world` starts such a world: one spawned process per rank, a
``file://`` rendezvous in a temporary directory, a ``timeout`` on every
process group (a rank that falls out of step fails the run instead of
hanging it) and a deadline on the join.  Each rank's return value comes
back to the caller, in rank order; a rank that raises fails the run with
its traceback.

Backends: NCCL when every rank has a card of its own, gloo otherwise (the
CPU, or several ranks on one card: NCCL refuses two ranks on one
device).  What a backend cannot carry is staged through the host by
:mod:`.collectives`.

A mesh also carries a ``torch.distributed.device_mesh.DeviceMesh`` over
the same ranks and axis names (:attr:`Mesh.device_mesh`, built on first
use), on which the layout plans place ``DTensor`` parameters, batches
and caches (:mod:`.sharding`).  :func:`fake_world` starts a world of
hundreds of ranks in this one process over PyTorch's fake process group
(its collectives move nothing), which is what the dry run
(:mod:`repro_torch.launch.dryrun`) builds the production meshes in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import math
import os
import pickle
import tempfile
import time
import traceback
from collections.abc import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: seconds a collective may wait for the other ranks before it fails
GROUP_TIMEOUT_S = 300.0

#: the collective timeout of the world this process joined through
#: :func:`run_world` (:data:`GROUP_TIMEOUT_S` in any other world)
_world_timeout_s = GROUP_TIMEOUT_S


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a process mesh.

    ``shape`` maps each axis name to its size and ``axis_names`` orders
    them (a JAX ``Mesh`` has both); ``coords`` maps each axis to this
    rank's position on it; ``groups`` maps each axis of size > 1 to the
    process group along it (None for an axis of size 1); ``rank`` is
    this rank's in the world; ``timeout_s`` the seconds its collectives
    wait for the other ranks before they fail (the world's timeout)."""

    shape: dict
    axis_names: tuple
    coords: dict
    groups: dict
    rank: int = 0
    timeout_s: float = GROUP_TIMEOUT_S

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        """The process group along ``axis`` (None on a 1-rank axis)."""
        return self.groups.get(axis)

    @functools.cached_property
    def device_mesh(self):
        """The ``DeviceMesh`` of this mesh's ranks, with its axis names:
        built on first use (every rank of the world must build it, in the
        same order, as it makes a process group per axis).  It needs a
        world (:func:`run_world`, :func:`fake_world`).  Its device type is
        ``cuda`` over NCCL, else ``cpu``."""
        from torch.distributed.device_mesh import DeviceMesh
        if not dist.is_initialized():
            raise RuntimeError(f"{self!r}: a DeviceMesh needs a world of "
                               f"{self.size} ranks (run_world, fake_world)")
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        grid = np.arange(self.size).reshape(
            [self.shape[a] for a in self.axis_names])
        with unset_fake_temporarily():   # its rank grid is a real tensor
            return DeviceMesh(device, grid, mesh_dim_names=self.axis_names)

    def head_slice(self, n: int, axis: str = "model") -> slice:
        """This rank's contiguous share of ``n`` heads along ``axis``."""
        m = self.shape.get(axis, 1)
        if n % m:
            raise ValueError(f"{n} heads do not divide the mesh's {axis!r} "
                             f"axis of size {m}")
        per = n // m
        c = self.coords.get(axis, 0)
        return slice(c * per, (c + 1) * per)

    def __repr__(self) -> str:
        dims = "x".join(str(self.shape[a]) for a in self.axis_names)
        return (f"Mesh({dims} {self.axis_names}, rank {self.rank} at "
                f"{self.coords})")


def world_size() -> int:
    """Ranks in the current process group's world (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@contextlib.contextmanager
def fake_world(world: int):
    """A world of ``world`` ranks in this process, over PyTorch's fake
    process group: this process is rank 0, and every collective returns
    at once without moving a byte (tensors keep what they held).
    Meshes of the world's size build in it, the production meshes too
    (:func:`repro_torch.launch.mesh.make_production_mesh`).  The world is
    destroyed on exit, whatever happens inside, so it never outlives the
    block; a world already up raises ``RuntimeError``."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already up "
                           f"({dist.get_world_size()} ranks)")
    # PyTorch's own test module: the fake backend and its store
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over ``axes`` in the current world.  A mesh of
    one rank needs no world; a larger one needs exactly ``prod(shape)``
    ranks (started by :func:`run_world`) and builds one process group
    along each axis of size > 1, on every rank in the same order, as
    ``torch.distributed.new_group`` requires."""
    dims = tuple(int(d) for d in shape)
    axes = tuple(axes)
    if len(dims) != len(axes) or any(d < 1 for d in dims):
        raise ValueError(f"bad mesh shape {dims} for axes {axes}")
    n = math.prod(dims)
    world = world_size()
    if n == 1:
        return Mesh(dict(zip(axes, dims)), axes, {a: 0 for a in axes},
                    {a: None for a in axes}, rank())
    if world != n:
        raise ValueError(
            f"a {'x'.join(map(str, dims))} mesh needs a world of {n} "
            f"ranks, but the world has {world} (start it with "
            f"repro_torch.distributed.run_world({n}, ...), or serve "
            f"--mesh from the command line, which does)")
    me = dist.get_rank()
    grid = np.arange(n).reshape(dims)
    groups = {}
    for i, a in enumerate(axes):
        groups[a] = None
        if dims[i] == 1:
            continue
        # every row of ranks that differ only along axis i
        for ranks in np.moveaxis(grid, i, -1).reshape(-1, dims[i]).tolist():
            g = dist.new_group(ranks, timeout=datetime.timedelta(
                seconds=_world_timeout_s))
            if me in ranks:
                groups[a] = g
    coords = {a: int(c) for a, c in zip(axes, np.unravel_index(me, dims))}
    return Mesh(dict(zip(axes, dims)), axes, coords, groups, me,
                _world_timeout_s)


# --------------------------------------------------------------------------
# the world launcher
# --------------------------------------------------------------------------

def default_backend(world: int, device: str | torch.device) -> str:
    """NCCL when every rank can have a card of its own, else gloo."""
    dev = torch.device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _write(path: str, result: tuple) -> None:
    with open(path, "wb") as f:
        pickle.dump(result, f)


def _rank_main(fn, rank_: int, world: int, backend: str, device: str,
               init: str, outdir: str, args: tuple,
               timeout_s: float = GROUP_TIMEOUT_S) -> None:
    global _world_timeout_s
    _world_timeout_s = timeout_s
    out = os.path.join(outdir, f"rank{rank_}.pkl")
    try:
        torch.set_num_threads(1)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank_ % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init, world_size=world, rank=rank_,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        _write(out, ("error", traceback.format_exc()))
        raise
    _write(out, ("ok", result))


def run_world(fn: Callable, world: int, *, device: str | torch.device = "cpu",
              args: tuple = (), join_timeout_s: float = 900.0,
              group_timeout_s: float = GROUP_TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``world`` spawned ranks and return their
    results in rank order.

    ``fn`` must be a module-level function (the ranks are spawned, not
    forked, and import it by name).  Each rank runs one torch thread, sits
    on ``device`` (rank ``r`` of a CUDA world on card ``r % count``) and
    joins a :func:`default_backend` world whose collectives time out after
    ``group_timeout_s`` (:data:`GROUP_TIMEOUT_S`).  The call fails with every failing rank's
    traceback, or when the ranks have not all ended within
    ``join_timeout_s`` (every rank still alive is then killed)."""
    backend = default_backend(world, device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_world_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, str(device), init,
                                   tmp, args, group_timeout_s))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_timeout_s
        try:
            # a failed rank ends the run at once: the others would wait in
            # their next collective until the group timeout
            while (any(p.is_alive() for p in procs)
                   and not any(p.exitcode for p in procs)
                   and time.monotonic() < deadline):
                procs[0].join(0.05)
        finally:
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
            for p in alive:
                p.join()
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: no result (exit code "
                              f"{p.exitcode}"
                              + (", killed at the join deadline"
                                 if p in alive else "") + ")")
                results.append(None)
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "error":
                errors.append(f"rank {r} raised:\n{value}")
            results.append(value)
    if errors:
        raise RuntimeError(f"run_world({world}, backend={backend!r}) "
                           "failed:\n" + "\n".join(errors))
    return results

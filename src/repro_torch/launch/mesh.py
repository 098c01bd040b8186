"""Mesh construction (the JAX package's ``launch/mesh.py``).

Functions, not module-level constants, so importing this module touches
no process group.  A mesh of more than one rank lives in a
``torch.distributed`` world of exactly its size
(:func:`repro_torch.distributed.run_world` starts one of real ranks,
:func:`repro_torch.distributed.process_mesh.fake_world` one of fake
ranks in this process, where the dry run builds the production meshes).
"""
from __future__ import annotations

import math

from ..distributed.process_mesh import Mesh, make_mesh, world_size

__all__ = ["make_production_mesh", "make_mesh", "make_host_mesh", "chips"]

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 ("data", "model") single pod; 2x16x16 ("pod", "data",
    "model") for the 2-pod, 512-rank layout, in a world of exactly that
    many ranks: a ``fake_world(256)`` or ``fake_world(512)``, as the dry
    run starts.  Raises ``ValueError`` naming the world size it needs in a
    smaller world."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    need = math.prod(shape)
    if world_size() < need:
        raise ValueError(
            f"the production mesh {'x'.join(map(str, shape))} {axes} needs "
            f"a world of {need} ranks, but the world has {world_size()} "
            f"(the dry run builds it in fake_world({need}): python -m "
            "repro_torch.launch.dryrun)")
    return make_mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """The 1x1 ("data", "model") mesh: no process group, the unsharded
    path."""
    return make_mesh((1, 1), ("data", "model"))


def chips(mesh: Mesh) -> int:
    """The ranks of the mesh (one device each)."""
    return mesh.size

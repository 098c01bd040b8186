"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the JAX package's, for every arch, every layout plan (``tp``,
``fsdp``, ``decode_seq``, ``decode_resident``) and the meshes (16, 16),
(2, 16, 16) and (1, 2).  The rules read only a mesh's ``shape`` and
``axis_names``: the JAX side gets an ``AbstractMesh``, the port a
stand-in, and both the same abstract parameter and cache trees (the JAX
model's, through ``jax.eval_shape``).  Specs compare as tuples.
"""
import types

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JAX_ARCHS
from repro.distributed import sharding as jsh
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as tsh

PLANS = ("tp", "fsdp", "decode_seq", "decode_resident")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x2": ((1, 2), ("data", "model"))}
ARCH_IDS = sorted(JAX_ARCHS)


def meshes(name):
    shape, axes = MESHES[name]
    return (AbstractMesh(shape, axes),
            types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                  axis_names=axes))


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch(request):
    """(JAX cfg, port cfg, abstract params, abstract caches)."""
    jcfg = JAX_ARCHS[request.param]
    model = jax_build_model(jcfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    caches = jax.eval_shape(lambda: model.init_caches(4, 256))
    return jcfg, get_arch(request.param), params, caches


def specs(tree):
    """The JAX NamedSharding tree's specs as tuples."""
    return jax.tree.map(lambda s: tuple(s.spec), tree)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("plan", PLANS)
def test_param_specs_equal_jax(arch, plan, mesh):
    jcfg, tcfg, params, _ = arch
    jmesh, tmesh = meshes(mesh)
    jplan = jsh.make_plan(jcfg, "train", jmesh, plan)
    tplan = tsh.make_plan(tcfg, "train", tmesh, plan)
    got = tsh.param_shardings(params, tcfg, tplan, tmesh)
    assert got == specs(jsh.param_shardings(params, jcfg, jplan, jmesh))
    for path, leaf in jsh._tree_paths(params)[0]:
        raw = tsh._spec_for_param(path, leaf.shape, tcfg, plan, tmesh)
        assert raw == tuple(jsh._spec_for_param(path, leaf.shape, jcfg,
                                                plan, jmesh))
        assert tsh._sanitize(raw, leaf.shape, tmesh) == tuple(
            jsh._sanitize(jax.sharding.PartitionSpec(*raw), leaf.shape,
                          jmesh))
    want = jsh.layer_param_specs(params, jcfg, jplan, jmesh)
    got = tsh.layer_param_specs(params, tcfg, tplan, tmesh)
    assert (got is None) == (want is None)
    if want is not None:
        assert got == specs(want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_plans_caches_and_batches_equal_jax(arch, kind, mesh):
    jcfg, tcfg, _, caches = arch
    jmesh, tmesh = meshes(mesh)
    assert tsh.choose_plan_name(tcfg, kind, tmesh) \
        == jsh.choose_plan_name(jcfg, kind, jmesh)
    for plan in (None, *PLANS):
        jplan = jsh.make_plan(jcfg, kind, jmesh, plan, remat="dots",
                              num_microbatches=2)
        tplan = tsh.make_plan(tcfg, kind, tmesh, plan, remat="dots",
                              num_microbatches=2)
        assert (tplan.name, tplan.remat, tplan.num_microbatches) \
            == (jplan.name, jplan.remat, jplan.num_microbatches)
        assert tplan.specs == {k: tuple(v) for k, v in jplan.specs.items()}
        assert tsh.cache_shardings(caches, tcfg, tplan, tmesh) \
            == specs(jsh.cache_shardings(caches, jcfg, jplan, jmesh))
    batch = {"tokens": jax.ShapeDtypeStruct((32, 1024), "int32"),
             "labels": jax.ShapeDtypeStruct((32, 1024), "int32"),
             "frontend_embeds": jax.ShapeDtypeStruct((6, 64, 128),
                                                     "float32"),
             "scalar": jax.ShapeDtypeStruct((), "float32")}
    assert tsh.batch_shardings(batch, tmesh) \
        == specs(jsh.batch_shardings(batch, jmesh))

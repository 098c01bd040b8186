"""The port's tensor-parallel paged serving on the CPU, against the JAX
package's unsharded engine (mirrors ``test_mesh_serving.py``).

* in-process: ``make_serving_mesh("1x1")`` is bit-identical to no mesh
  for decode, chunked prefill (8), speculative (k 3) and int8 pages, and
  its greedy tokens equal the JAX unsharded engine's; region names with
  and without a mesh suffix equal the JAX package's ``region_key``; the
  spec is validated;
* a 1x2 world (two spawned ranks over gloo, float32 on the CPU): the same
  four variants and int8 pages with 8 splits give the JAX unsharded
  engine's greedy tokens, the first decode step's (verify's) logits are
  bit-equal to the port's unsharded ones on both ranks, and each rank's
  pools hold Hkv / 2 heads, half the bytes;
* a 2x2 world (4 ranks) for decode and chunked prefill, as the JAX test;
* 1x4 on reduced yi-6b (kv_heads 2) refuses with a ``ValueError`` naming
  ``kv_heads=2`` and "not divisible";
* ``serve --mesh 1x2`` (the CLI's world) equals the unsharded serve, and
  with ``--autotune`` keys its regions ``_mesh1x2``, rank 0 deciding, a
  second serve warm-loading every region; the gateway over a multi-rank
  mesh equals the unsharded gateway, and dense lanes refuse one.
"""
import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.tuning.dynamic import region_key as jax_region_key
from repro_torch.distributed import Mesh, run_world
from repro_torch.distributed.sharding import make_serving_mesh
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.serve import ServeConfig, serve_config, serve_mesh
from repro_torch.serving import ServingEngine
from repro_torch.tuning.dynamic import region_key

import torch_mesh_workers as workers

JAX_KW = {"decode": {}, "chunked": {"prefill_chunk": 8},
          "spec": {"spec": 3}, "int8": {"kv_dtype": "int8"},
          # splits leave the plain routes unchanged on the CPU
          "int8_split8": {"kv_dtype": "int8"}}


@pytest.fixture(scope="module")
def jax_pair():
    jmodel = jax_build_model(JAX_ARCHS["yi-6b"].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def jax_tokens(jax_pair):
    """The JAX unsharded engine's greedy tokens for every variant."""
    jmodel, jparams, _ = jax_pair
    out = {}
    for name, kw in JAX_KW.items():
        kw = dict(kw)
        k = kw.pop("spec", None)
        if k is not None:
            draft = jmodel.draft_model()
            kw.update(draft_model=draft, spec_k=k,
                      draft_params=jmodel.slice_draft_params(jparams, draft))
        eng = JaxEngine(jmodel, jparams, n_lanes=2, max_len=64,
                        cache="paged", page_size=8, **kw)
        for rid, prompt, max_new in workers.requests(jmodel.cfg.vocab_size):
            eng.submit(JaxRequest(rid=rid, prompt=prompt,
                                  max_new_tokens=max_new))
        out[name] = {r.rid: list(r.out_tokens) for r in eng.run(max_steps=40)}
    return out


@pytest.fixture(scope="module")
def unsharded(jax_pair):
    return workers.serve_variants(jax_pair[2], list(workers.VARIANTS), None)


@pytest.fixture(scope="module")
def world_1x2(jax_pair):
    return run_world(workers.serve_variants, 2,
                     args=(jax_pair[2], list(workers.VARIANTS), "1x2"))


@pytest.mark.parametrize("variant", ["decode", "chunked", "spec", "int8"])
def test_one_rank_mesh_bit_identical(variant, jax_pair, unsharded,
                                     jax_tokens):
    got = workers.serve_variant(jax_pair[2], variant, "1x1")
    want = unsharded[variant]
    assert got["tokens"] == want["tokens"] == jax_tokens[variant]
    np.testing.assert_array_equal(got["logits"], want["logits"])
    assert got["pool_heads"] == want["pool_heads"] == 2


def test_region_names_with_and_without_a_mesh_equal_jax():
    cases = [("decode", 128, None, "1x1"), ("decode", 128, None, None),
             ("decode", 128, None, "2x2"), ("prefill", 128, 8, "1x4"),
             ("spec", 512, None, "1x2"), ("prefix", None, None, "1x2")]
    for kind, bucket, chunk, mesh in cases:
        assert region_key(kind, bucket, chunk=chunk, mesh_shape=mesh) \
            == jax_region_key(kind, bucket, chunk=chunk, mesh_shape=mesh)
    assert region_key("decode", 128, mesh_shape="1x1") == "DecodeBucket_128"
    assert region_key("prefill", 128, chunk=8, mesh_shape="1x2") \
        == "PrefillBucket_128_c8_mesh1x2"


def test_mesh_spec_validation():
    assert make_serving_mesh(None) is None
    assert make_serving_mesh("") is None
    with pytest.raises(ValueError, match="expected 'RxC'"):
        make_serving_mesh("four")
    with pytest.raises(ValueError, match="expected 'RxC'"):
        make_serving_mesh("2x0")
    with pytest.raises(ValueError, match="needs 64 ranks but the world "
                                         "has 1"):
        make_serving_mesh("8x8")
    mesh = make_serving_mesh("1x1")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.group("model") is None
    host = launch_mesh.make_host_mesh()
    assert host.axis_names == ("data", "model") and launch_mesh.chips(host) == 1
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs a world of {need} "
                                             f"ranks.*fake_world\\({need}\\)"
                                             ".*launch.dryrun"):
            launch_mesh.make_production_mesh(multi_pod=multi_pod)


@pytest.mark.parametrize("variant", list(workers.VARIANTS))
def test_two_rank_mesh_matches_jax_and_the_unsharded_port(
        variant, world_1x2, unsharded, jax_tokens):
    """Greedy tokens equal the JAX unsharded engine's on both ranks, the
    first decode step's logits bit-equal to the port's unsharded ones,
    and each rank's pools hold half the KV heads."""
    want = unsharded[variant]
    for rank, got in enumerate(world_1x2):
        got = got[variant]
        assert got["rank"] == rank
        assert got["tokens"] == jax_tokens[variant] == want["tokens"]
        np.testing.assert_array_equal(got["logits"], want["logits"])
        assert got["pool_heads"] == want["pool_heads"] // 2 == 1
        assert got["pool_bytes"] * 2 == want["pool_bytes"]


def test_four_rank_2x2_mesh_greedy_agreement(jax_pair, unsharded,
                                              jax_tokens):
    """2x2: the data axis replicates, the model axis shards the heads."""
    ranks = run_world(workers.serve_variants, 4,
                      args=(jax_pair[2], ["decode", "chunked"], "2x2"))
    for got in ranks:
        for variant in ("decode", "chunked"):
            assert got[variant]["tokens"] == jax_tokens[variant]
            np.testing.assert_array_equal(got[variant]["logits"],
                                          unsharded[variant]["logits"])
            assert got[variant]["pool_heads"] == 1


def test_indivisible_heads_clear_error(jax_pair):
    """kv_heads=2 cannot shard 4 ways: the engine refuses with a message
    naming the head counts, not a shape error in a kernel.  (Rank 0's view
    of a 1x4 mesh, built here: the engine raises before any collective.)"""
    mesh = Mesh({"data": 1, "model": 4}, ("data", "model"),
                {"data": 0, "model": 0}, {"data": None, "model": None})
    model, params = workers.yi_model(jax_pair[2])
    with pytest.raises(ValueError, match="kv_heads=2") as e:
        ServingEngine(model, params, n_lanes=2, max_len=64, cache="paged",
                      page_size=8, mesh=mesh)
    assert "not divisible" in str(e.value)


def test_serve_mesh_cli_path_and_its_tuning(tmp_path):
    """serve --mesh 1x2 (the world the CLI starts) against the unsharded
    serve; tuned, its regions are mesh-suffixed and committed by rank 0,
    and a second serve in the workdir measures nothing."""
    base = dict(device="cpu", cache="paged", page_size=8, max_len=64,
                n_requests=4, max_new=6, prefill_chunk=8)
    want = serve_config(ServeConfig(**base))
    got = serve_mesh(ServeConfig(**base, mesh="1x2"))
    assert got["outputs"] == want["outputs"] and got["mesh"] == "1x2"
    assert got["cache"]["pool_bytes"] * 2 == want["cache"]["pool_bytes"]
    tuned = [serve_mesh(ServeConfig(**base, mesh="1x2", autotune=True,
                                    workdir=str(tmp_path)))
             for _ in range(2)]
    cold, warm = (t["autotune"] for t in tuned)
    assert cold["measurements"] > 0 and cold["measured_regions"]
    assert all(n.endswith("_mesh1x2") for n in cold["measured_regions"])
    assert warm["measurements"] == 0
    assert set(warm["warm_regions"]) >= set(cold["measured_regions"])
    assert all(t["outputs"] == want["outputs"] for t in tuned)


def test_multi_rank_mesh_refuses_the_gateway_and_dense_lanes():
    """The gateway is served over a multi-rank mesh (rank 0 leads, the
    other ranks follow it) and equals the unsharded gateway; dense lanes
    stay refused."""
    base = dict(device="cpu", cache="paged", page_size=8, max_len=64,
                n_requests=4, max_new=6, prefill_chunk=8, gateway=True)
    want = serve_config(ServeConfig(**base))
    got = serve_mesh(ServeConfig(**base, mesh="1x2"))
    assert got["outputs"] == want["outputs"] and got["mesh"] == "1x2"
    assert got["gateway"]["streams"] == {"done": 4}
    assert got["gateway"]["syncs"] > 0
    with pytest.raises(ValueError, match="--cache paged with --mesh"):
        serve_mesh(ServeConfig(device="cpu", mesh="1x2"))

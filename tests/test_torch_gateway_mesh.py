"""The gateway over a multi-rank mesh: rank 0 runs the HTTP/SSE gateway,
its clients and its queue, and broadcasts each tick's admissions and
cancellations; ranks 1.. follow it (``PipelinedEngine.follow``).

On 1x2 and 2x2 worlds of spawned gloo ranks (``run_world``; rank
functions in ``torch_mesh_workers``), reduced yi-6b with the JAX model's
weights, paged (chunks of 8), int8 pages at 8 splits and speculative
(k 2):

* every client's greedy tokens equal the JAX unsharded engine's and the
  port's unsharded gateway's, and every rank's engine finished the same
  requests with the same tokens;
* a client that hangs up mid-stream, and clients bounced with 429 at
  ``queue_limit`` 1, leave the ranks in step (the same tokens, the same
  cancelled request, the same free pages on every rank);
* an idle gateway outlives a group timeout shorter than its idle time
  (its heartbeats);
* ``serve --gateway --mesh 1x2 --autotune`` commits rank 0's
  ``GatewayPolicy`` winner, and a second serve in its workdir measures
  nothing.
"""
import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.distributed import run_world
from repro_torch.launch.serve import ServeConfig, serve_mesh

import torch_mesh_workers as workers

VARIANTS = list(workers.GATEWAY_VARIANTS)
JAX_KW = {"paged": {"prefill_chunk": 8},
          "int8_split8": {"kv_dtype": "int8", "prefill_chunk": 8},
          "spec": {"spec": 2, "prefill_chunk": 8}}


@pytest.fixture(scope="module")
def jax_pair():
    jmodel = jax_build_model(JAX_ARCHS["yi-6b"].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def jax_tokens(jax_pair):
    """The JAX unsharded engine's greedy tokens, by request."""
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
    return workers.gateway_serve(jax_pair[2], VARIANTS, None)


@pytest.fixture(scope="module", params=["1x2", "2x2"])
def world(request, jax_pair):
    spec = request.param
    n = int(spec[0]) * int(spec[2])
    return spec, run_world(workers.gateway_serve, n,
                           args=(jax_pair[2], VARIANTS, spec))


@pytest.mark.parametrize("variant", VARIANTS)
def test_gateway_over_a_mesh_matches_jax_and_the_unsharded_gateway(
        variant, world, unsharded, jax_tokens):
    spec, ranks = world
    want = jax_tokens[variant]
    lead = ranks[0][variant]
    assert {i: t for i, (t, kind, _) in lead["tokens"].items()} == want
    assert all(kind == "done" for _, kind, _ in lead["tokens"].values())
    assert {i: t for i, (t, _, _) in
            unsharded[variant]["tokens"].items()} == want
    for rank, got in enumerate(ranks):
        got = got[variant]
        assert got["rank"] == rank
        assert got["by_rid"] == lead["by_rid"]
        assert got["syncs"] == lead["syncs"] > 0


@pytest.fixture(scope="module")
def scenarios(jax_pair):
    # a group timeout of 3 s; the idle gateway waits 4 s for its clients
    return run_world(workers.gateway_scenarios, 2,
                     args=(jax_pair[2], "1x2", 4.0), group_timeout_s=3.0)


def test_a_hang_up_keeps_the_ranks_in_step(scenarios):
    lead, follower = (r["cancel"] for r in scenarios)
    assert lead["cancelled"] == follower["cancelled"] == [0]
    assert lead["clients"][0][1] == "hung_up"
    assert lead["by_rid"] == follower["by_rid"] and len(lead["by_rid"]) == 3
    assert lead["free_pages"] == follower["free_pages"]


def test_429_bounces_keep_the_ranks_in_step(scenarios):
    lead, follower = (r["queue_limit_1"] for r in scenarios)
    assert lead["rejected"] > 0
    assert sum(b for _, _, b in lead["clients"].values()) == lead["rejected"]
    assert all(kind == "done" for _, kind, _ in lead["clients"].values())
    assert lead["by_rid"] == follower["by_rid"] and len(lead["by_rid"]) == 4
    assert lead["syncs"] == follower["syncs"]


def test_an_idle_gateway_outlives_the_group_timeout(scenarios):
    lead, follower = (r["idle"] for r in scenarios)
    assert all(kind == "done" for _, kind, _ in lead["clients"].values())
    assert lead["by_rid"] == follower["by_rid"] and len(lead["by_rid"]) == 4
    # 4 s idle at a heartbeat every 0.3 s (a tenth of the world's 3 s
    # group timeout), then the ticks
    assert lead["heartbeat_s"] == follower["heartbeat_s"] == pytest.approx(
        0.3)
    assert lead["syncs"] == follower["syncs"] > 8


def test_the_autotuned_gateway_is_warm_on_the_second_run(tmp_path):
    base = dict(device="cpu", cache="paged", page_size=8, max_len=64,
                n_requests=12, max_new=4, prefill_chunk=8, gateway=True,
                policy_window=1, mesh="1x2", autotune=True,
                workdir=str(tmp_path))
    cold, warm = (serve_mesh(ServeConfig(**base)) for _ in range(2))
    assert cold["autotune"]["measurements"] > 0
    assert "GatewayPolicy_mesh1x2" in cold["autotune"]["measured_regions"]
    assert warm["autotune"]["measurements"] == 0
    assert "GatewayPolicy_mesh1x2" in warm["autotune"]["warm_regions"]
    winner = cold["autotune"]["committed"]["gateway"]
    assert winner is not None
    assert warm["autotune"]["committed"]["gateway"] == winner
    assert warm["gateway"]["policy"]["max_inflight"] == winner["max_inflight"]
    assert cold["outputs"] == warm["outputs"]


def test_an_unsharded_serve_reads_the_mesh_serves_winners(tmp_path):
    """A tuner of the mesh's region names (``_mesh1x2``) that binds no
    mesh warm-loads the winners a ``--mesh 1x2 --autotune`` serve
    committed, so ``serve_model(..., tuner=)`` serves unsharded at the
    same tiles and splits, measuring nothing, with the mesh serve's
    tokens (``chip_smoke.py`` phase 38b's like-for-like yardstick)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import make_autotuner, serve_model
    from repro_torch.models import build_model
    base = ServeConfig(device="cpu", cache="paged", page_size=8, max_len=64,
                       n_requests=8, max_new=4, prefill_chunk=8,
                       gateway=True, policy_window=1, mesh="1x2",
                       autotune=True, workdir=str(tmp_path))
    mesh = serve_mesh(base)
    assert mesh["autotune"]["measurements"] > 0
    model = build_model(get_arch(base.arch).reduced())
    params = model.init(base.seed, "cpu")
    tuner = make_autotuner(model, base, None)
    like = serve_model(model, params, ServeConfig(**{**base.to_dict(),
                                                     "mesh": None}),
                       None, tuner)
    a = like["autotune"]
    assert like["mesh"] is None and a["measurements"] == 0
    assert set(mesh["autotune"]["measured_regions"]) <= set(a["warm_regions"])
    assert all(n.endswith("_mesh1x2") for n in a["warm_regions"])
    assert a["committed"] == mesh["autotune"]["committed"]
    assert like["outputs"] == mesh["outputs"]

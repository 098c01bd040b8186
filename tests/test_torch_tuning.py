"""Run-time AT in the port against the JAX package's, on the CPU.

``repro_torch.tuning.dynamic`` is a copy of ``repro.tuning.dynamic``
(``test_torch_at.py`` holds the copy to the source), the CLI ``python -m
repro_torch.at`` a copy of ``python -m repro.at``, and the serve's
``--autotune`` the JAX serve's over the port's tile ladders.  Mirrored
from the JAX package's tuner tests (``test_serving_tuning.py``,
``test_split_kv.py``, ``test_chunked_prefill.py``, ``test_speculative.py``,
``test_quant_kv.py``, ``test_prefix_cache.py``, ``test_gateway.py``,
``test_record_backends.py``):

* the same table of costs gives the same winners in both packages, for
  every region family (``DecodeBucket`` with ``num_splits``,
  ``PrefillBucket``, ``SpecBucket``, ``KVPrecision``, ``PrefixPolicy``,
  ``GatewayPolicy``).  A candidate's cost is what it adds to a fake clock
  that stands in for ``time.perf_counter`` in both packages' runtimes, or
  the metric it reports where the region commits on one;
* a second session in the same workdir makes zero measurements and runs
  only the winners;
* ``region_key``, ``parse_region``, ``describe_region`` and
  ``resolve_region`` agree between the packages for every family;
* the port's ``serve --autotune`` (the JAX model's weights carried across
  by ``repro_torch.bridge``) gives greedy tokens identical to its untuned
  serve and to the JAX ``serve --autotune`` on dense lanes, the paged
  pool, int8 pages, speculation and the prefix cache, and a warm restart
  reports zero measurements; ``--kv-dtype auto`` resolves a pool dtype
  and serves it; the gateway's ``GatewayPolicy`` windows commit and warm
  load (zero windows);
* the CLI lists, exports, merges, promotes and finds stale regions.

On the CPU the plain attention runs and reads no tile, as the JAX
package's does, so the tokens are the same under every candidate.
"""
import asyncio
import json
import os
import time as real_time

import jax
import numpy as np
import pytest

import repro.at as jat
import repro.core.runtime as jruntime
import repro.tuning.dynamic as jdyn
import repro_torch.at as tat
import repro_torch.core.runtime as truntime
import repro_torch.tuning.dynamic as tdyn
from repro.configs import ARCHS as JAX_ARCHS
from repro.launch.serve import serve as jax_serve
from repro.models import build_model as jax_build_model
from repro_torch.at import cli as tcli
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch.serve import (ServeConfig, serve_model,
                                      tile_ladders)
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.gateway import PipelinedEngine

PACKAGES = {"jax": (jat, jdyn, jruntime), "torch": (tat, tdyn, truntime)}
BUCKETS = (128, 512)


@pytest.fixture(autouse=True)
def _isolate_published():
    for at, _, _ in PACKAGES.values():
        at.clear_published()
    yield
    for at, _, _ in PACKAGES.values():
        at.clear_published()


class FakeClock:
    """``time`` for the runtimes: ``perf_counter`` reads a counter the
    candidates advance by their table cost; the rest is the real module."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(real_time, name)


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    for _, _, runtime in PACKAGES.values():
        monkeypatch.setattr(runtime, "time", fake)
    return fake


# one table of costs per family: a candidate's seconds on the fake clock,
# or the metric its region commits on
DECODE_COST = {(bk, ns): 1.0 + abs(bk - 64) / 64 + abs(ns - 2) / 10
               for bk in (32, 64, 128) for ns in (1, 2, 4)}
PREFILL_COST = {(bq, bk): 1.0 + abs(bq - 4) + (bk == 64)
                for bq in (2, 4, 8) for bk in (64, 128)}
SPEC_TPT = {(k, bk): 1.0 / k + (bk == 128) for k in (1, 2, 4)
            for bk in (64, 128)}
KV_TPT = {("fp", 64): 1.0, ("fp", 128): 1.1, ("int8", 64): 0.6,
          ("int8", 128): 0.5}
KV_AGREE = {128: {"fp": 1.0, "int8": 1.0}, 512: {"fp": 1.0, "int8": 0.5}}
MISS = {(1, "lru"): 0.3, (1, "fifo"): 0.2, (2, "lru"): 0.5, (2, "fifo"): 0.4}
GATEWAY_TPGT = {(1, 2): 0.4, (1, 8): 0.3, (2, 2): 0.2, (2, 8): 0.25}
FAMILIES = ("decode", "prefill", "spec", "kv_precision", "prefix", "gateway")
WINNERS = {
    "decode": {b: {"block_k": 64, "num_splits": 2} for b in BUCKETS},
    "prefill": {(b, 8): {"block_q": 4, "block_k": 128} for b in BUCKETS},
    "spec": {b: {"k": 4, "block_q": 8, "block_k": 64} for b in BUCKETS},
    "kv_precision": {128: {"kv_dtype": "int8", "block_k": 128},
                     512: {"kv_dtype": "fp", "block_k": 64}},
    "prefix": {"min_match": 1, "eviction": "fifo"},
    "gateway": {"max_inflight": 2, "admit_batch": 2},
}


def build(package: str, workdir, clock: FakeClock, calls: list):
    """A tuner of ``package`` with every region family over the tables."""
    at, dyn, _ = PACKAGES[package]
    session = at.AutoTuner(str(workdir))

    def timed(cost, label, out=None):
        def fn(*args, **kwargs):
            clock.t += cost
            calls.append(label)
            return label if out is None else out
        return fn

    tuner = dyn.DecodeAutoTuner(
        session, lambda bk, ns: timed(DECODE_COST[bk, ns], (bk, ns)),
        buckets=BUCKETS, block_ks=(32, 64, 128), num_splits=(2, 4))
    tuner.add_prefill(lambda bq, bk: timed(PREFILL_COST[bq, bk], (bq, bk)),
                      chunk_sizes=(8,), buckets=BUCKETS, block_qs=(2, 4, 8),
                      block_ks=(64, 128))
    tuner.add_spec(lambda k, bq, bk: timed(0.0, (k, bq, bk), {
        "k": k, "time_per_token": SPEC_TPT[k, bk]}),
        ks=(1, 2, 4), buckets=BUCKETS, block_qs=(8,), block_ks=(64, 128))
    tuner.add_kv_precision(lambda b, dt, bk: timed(0.0, (b, dt, bk), {
        "kv_dtype": dt, "block_k": bk, "time_per_token": KV_TPT[dt, bk],
        "agreement": KV_AGREE[b][dt]}), block_ks=(64, 128), buckets=BUCKETS,
        agreement_floor=0.95)
    tuner.add_prefix_policy(lambda g, ev: timed(0.0, (g, ev), {
        "cached": 8, "miss_fraction": MISS[g, ev]}))
    tuner.add_gateway(max_inflights=(1, 2), admit_batches=(2, 8))
    return session, tuner


def drive(tuner, family: str) -> None:
    """Every region of ``family`` until it commits (one call a candidate)."""
    if family == "decode":
        for kv in (100, 300):
            for _ in tuner.variants:
                tuner.decode(kv)
    elif family == "prefill":
        for plen in (100, 300):
            for _ in tuner.prefill_variants:
                tuner.prefill(plen, 8)
    elif family == "spec":
        for kv in (100, 300):
            while not tuner.spec_committed(kv):
                tuner.spec(kv, measure=True)
    elif family == "kv_precision":
        for b in BUCKETS:
            while not tuner.kv_precision_committed(b):
                tuner.kv_precision(b)
    elif family == "prefix":
        for _ in tuner.prefix_variants:
            tuner.prefix_policy()
    else:
        while tuner.committed_gateway() is None:
            knobs = tuner.gateway_variants[tuner.gateway_candidate()]
            tuner.gateway_policy({"time_per_good_token": GATEWAY_TPGT[knobs]})


def committed(tuner, family: str):
    return {"decode": tuner.committed_params,
            "prefill": tuner.committed_prefill_params,
            "spec": tuner.committed_spec_params,
            "kv_precision": tuner.committed_kv_precision_params,
            "prefix": tuner.committed_prefix_params,
            "gateway": tuner.committed_gateway_params}[family]()


def region_names(tuner, family: str) -> list[str]:
    regions = {"decode": tuner.regions, "prefill": tuner.prefill_regions,
               "spec": tuner.spec_regions, "kv_precision": tuner.kv_regions,
               "prefix": {0: tuner.prefix_region},
               "gateway": {0: tuner.gateway_region}}[family]
    return sorted(r.name for r in regions.values())


@pytest.mark.parametrize("family", FAMILIES)
def test_same_table_costs_give_same_winners_in_both_packages(
        family, clock, tmp_path):
    got = {}
    for package in PACKAGES:
        _, tuner = build(package, tmp_path / package, clock, [])
        drive(tuner, family)
        got[package] = (committed(tuner, family), region_names(tuner, family))
    assert got["jax"] == got["torch"]
    assert got["torch"][0] == WINNERS[family]


@pytest.mark.parametrize("family", FAMILIES)
def test_warm_restart_makes_zero_measurements(family, clock, tmp_path):
    """A second session in the workdir starts every region of the family
    committed from the record file: no executor call, the regions among
    its warm hits, and a routed call runs the winner alone."""
    _, t1 = build("torch", tmp_path, clock, [])
    drive(t1, family)
    calls: list = []
    s2, t2 = build("torch", tmp_path, clock, calls)
    assert committed(t2, family) == committed(t1, family)
    assert s2.executor_calls == 0
    assert set(region_names(t2, family)) <= {n for _, n in s2.warm_hits}
    drive(t2, family)
    assert committed(t2, family) == WINNERS[family]
    assert all(st.tried == {} for st in t2.ctx.dynamic_state.values())
    if family == "decode":
        assert set(calls) == {(64, 2)}
    elif family == "spec":
        assert calls == []                 # committed: nothing to drive
        assert t2.spec(100, measure=False)["k"] == 4
        assert calls == [(4, 8, 64)]
        assert t2.spec_draft_k(100, 4) == 4 and t2.spec_draft_k(100, 2) == 2
    elif family == "kv_precision":
        assert calls == [] and t2.resolve_kv_dtype() == "int8"


def test_spec_region_commits_on_time_per_token_and_caps_drafting(clock,
                                                                  tmp_path):
    """k = 1 is the cheapest call but the dearest token: the region
    commits on the reported time_per_token, and ``spec_draft_k`` drafts
    no more than the winner's window (the full width while measuring)."""
    _, tuner = build("torch", tmp_path, clock, [])
    assert tuner.spec_draft_k(100, 4) == 4
    drive(tuner, "spec")
    assert tuner.committed_spec_params()[128]["k"] == 4
    assert tuner.spec_draft_k(100, 2) == 2


def test_grown_decode_space_re_measures(clock, tmp_path):
    """OAT_NUMALT: a winner recorded over (block_k) alone does not
    warm-load into the grown (block_k x num_splits) region."""
    s1 = tat.AutoTuner(str(tmp_path))
    t1 = tdyn.DecodeAutoTuner(s1, lambda bk: (lambda: bk), buckets=(512,),
                              block_ks=(64, 128))
    for _ in range(2):
        t1.decode(300)
    assert t1.committed()[512] is not None
    s2 = tat.AutoTuner(str(tmp_path))
    t2 = tdyn.DecodeAutoTuner(s2, lambda bk, ns: (lambda: (bk, ns)),
                              buckets=(512,), block_ks=(64, 128),
                              num_splits=(2, 4))
    assert t2.committed()[512] is None
    assert ("dynamic", "DecodeBucket_512") not in s2.warm_hits


# --------------------------------------------------------------------------
# region names
# --------------------------------------------------------------------------

REGIONS = [("decode", 512, None, None), ("prefill", 512, 8, None),
           ("spec", 2048, None, None), ("kv_precision", 128, None, None),
           ("prefix", None, None, None), ("gateway", None, None, None),
           ("decode", 128, None, "2x2"), ("prefill", 128, 64, (1, 4)),
           ("spec", 512, None, "1x1"), ("gateway", None, None, 4)]


@pytest.mark.parametrize("kind,bucket,chunk,mesh", REGIONS)
def test_region_names_agree_across_packages(kind, bucket, chunk, mesh):
    names = [dyn.region_key(kind, bucket, chunk=chunk, mesh_shape=mesh)
             for _, dyn, _ in PACKAGES.values()]
    assert names[0] == names[1]
    name = names[0]
    for _, dyn, _ in PACKAGES.values():
        k, b, c, shape = dyn.parse_region(name)
        assert (k, b, c) == (kind, bucket, chunk)
        assert dyn.resolve_region(name) == name
    assert jdyn.parse_region(name) == tdyn.parse_region(name)
    assert jdyn.describe_region(name) == tdyn.describe_region(name)
    assert tdyn.LEGACY_REGION_ALIASES == jdyn.LEGACY_REGION_ALIASES


def test_describe_region_parses_every_family_and_rejects_kernel_regions():
    for kind, bucket, chunk, mesh in REGIONS:
        name = tdyn.region_key(kind, bucket, chunk=chunk, mesh_shape=mesh)
        d = tdyn.describe_region(name)
        assert d is not None and d["kind"] == kind
        assert d["mesh"] == ("2x2" if mesh == "2x2" else "1x4"
                             if mesh == (1, 4) else "4" if mesh == 4 else "")
    assert tdyn.describe_region("MatmulBlocks") is None
    with pytest.raises(ValueError, match="unknown region kind"):
        tdyn.region_key("nope", 1)


@pytest.mark.parametrize("page_size,tiles,want", [
    (16, (32, 64, 128), (32, 64, 128)), (64, (32, 64, 128), (64, 128)),
    (48, (32, 64, 128), (128,)), (256, (32, 64, 128), (128,)),
    (8, (64, 64, 128), (64, 128))])
def test_page_block_ks_keeps_the_whole_page_tiles(page_size, tiles, want):
    """The Hopper counterpart of ``divisor_block_ks``: the instantiated
    tiles that are whole pages, in order, without repeats; the largest
    tile when none is."""
    assert tdyn.page_block_ks(page_size, tiles) == want


def test_serve_ladders_are_the_kernels_instances():
    """The serve's ladders at yi-6b's widths in bf16 (G 8, D 128, pages of
    16) are the instances of the decode and prefill kernels; the reduced
    config (float32 here) has the SIMT templates' one tile each."""
    full = build_model(get_arch("yi-6b"))
    assert tile_ladders(full, 16) == {
        "dense_block_k": pa.DECODE_BLOCK_KS, "block_k": pa.DECODE_BLOCK_KS,
        "block_q": (2, 4, 8), "prefill_block_k": pa.TC_BLOCK_KS,
        "kv_block_k": (64,)}
    reduced = build_model(get_arch("yi-6b").reduced())
    assert reduced.cfg.compute_dtype == "float32"
    assert tile_ladders(reduced, 8) == {
        "dense_block_k": (32,), "block_k": (32,), "block_q": (64,),
        "prefill_block_k": (32,), "kv_block_k": (32,)}


# --------------------------------------------------------------------------
# the serve: greedy tokens under run-time AT
# --------------------------------------------------------------------------

SERVE = dict(arch="yi-6b", n_requests=3, n_lanes=2, max_len=48,
             prompt_len=8, max_new=5)
CASES = {
    "dense": {},
    "paged": dict(cache="paged", page_size=8, prefill_chunk=8),
    "int8": dict(cache="paged", page_size=8, prefill_chunk=8,
                 kv_dtype="int8"),
    "spec": dict(cache="paged", page_size=8, prefill_chunk=8, draft=True,
                 spec_k=2),
    # four admissions: one for each PrefixPolicy candidate
    "prefix": dict(cache="paged", page_size=8, prefill_chunk=8,
                   prefix_cache=True, shared_prefix=16, n_requests=4),
}


@pytest.fixture(scope="module")
def yi_pair():
    """The reduced yi-6b in both packages, the JAX serve's weights (seed
    0) carried into the port."""
    jparams = jax_build_model(JAX_ARCHS["yi-6b"].reduced()).init(
        jax.random.PRNGKey(0))
    model = build_model(get_arch("yi-6b").reduced())
    return model, params_from_jax(jax.tree.map(np.asarray, jparams),
                                  model.cfg, device="cpu")


def port_serve(yi_pair, workdir, **kw) -> dict:
    model, params = yi_pair
    tat.clear_published()
    return serve_model(model, params, ServeConfig(device="cpu",
                                                  workdir=str(workdir),
                                                  **{**SERVE, **kw}))


@pytest.mark.parametrize("case", list(CASES))
def test_tuned_serve_equals_untuned_and_the_jax_tuned_serve(case, yi_pair,
                                                            tmp_path):
    kw = CASES[case]
    tuned = port_serve(yi_pair, tmp_path / "torch", autotune=True, **kw)
    plain = port_serve(yi_pair, tmp_path / "plain", **kw)
    jat.clear_published()
    jax_tuned = jax_serve(workdir=str(tmp_path / "jax"), autotune=True,
                          **{**SERVE, **kw})
    assert tuned["finished"] == {**SERVE, **kw}["n_requests"]
    assert tuned["outputs"] == plain["outputs"] == jax_tuned["outputs"]
    a = tuned["autotune"]
    assert a["measurements"] > 0 and a["executor_calls"] == 0
    assert a["measured_regions"] and not a["warm_regions"]
    assert set(a["costs"]) == set(a["measured_regions"])
    assert plain["autotune"] is None and plain["tuning_db"] is None
    assert tuned["tuning_db"]["backend"] == "jsonl"
    # the regions the JAX serve measured, the port measured too
    assert a["measured_regions"] == jax_tuned["autotune"]["measured_regions"]
    families = {"dense": {"decode"}, "paged": {"decode", "prefill"},
                "int8": {"decode", "prefill"}, "spec": {"prefill", "spec"},
                "prefix": {"decode", "prefill", "prefix"}}[case]
    assert {tdyn.describe_region(n)["kind"]
            for n in a["measured_regions"]} == families
    assert a["waits"] and set(a["waits"]) <= set(a["measured_regions"])
    # a warm restart in the same workdir: zero measurements
    warm = port_serve(yi_pair, tmp_path / "torch", autotune=True, **kw)
    w = warm["autotune"]
    assert w["measurements"] == 0 and w["executor_calls"] == 0
    assert w["measured_regions"] == [] and w["waits"] == {}
    assert set(a["measured_regions"]) <= set(w["warm_regions"])
    assert warm["outputs"] == plain["outputs"]


def test_kv_dtype_auto_resolves_a_pool_and_warm_loads(yi_pair, tmp_path):
    """``--kv-dtype auto``: every KVPrecision bucket commits, the pool is
    built in the majority winner, the tokens are the untuned serve's at
    that dtype; a warm restart measures nothing."""
    kw = dict(cache="paged", page_size=8, prefill_chunk=8)
    cold = port_serve(yi_pair, tmp_path, autotune=True, kv_dtype="auto",
                      **kw)
    kv = cold["autotune"]["committed"]["kv_precision"]
    assert set(kv) == {128, 512, 2048} and all(v is not None
                                               for v in kv.values())
    assert cold["kv_dtype"] in ("fp", "int8")
    plain = port_serve(yi_pair, tmp_path / "plain", kv_dtype=cold["kv_dtype"],
                       **kw)
    assert cold["outputs"] == plain["outputs"]
    warm = port_serve(yi_pair, tmp_path, autotune=True, kv_dtype="auto", **kw)
    assert warm["autotune"]["measurements"] == 0
    assert warm["kv_dtype"] == cold["kv_dtype"]


def test_engine_routes_every_family_through_its_region(yi_pair, tmp_path):
    """The engine calls the tuner's routes where the JAX engine does: a
    decode step with the bucket of the lanes' largest position + 1 from
    the host, each prefill chunk with its prompt's length and the chunk,
    each verify with ``measure`` until its bucket commits, and each
    prefix-cache admission."""
    model, params = yi_pair
    seen = {"decode": [], "prefill": [], "spec": [], "prefix": 0}

    class Recorder:
        prefill_regions = spec_regions = {"declared": True}
        prefix_region = object()

        def decode(self, kv_len, *args):
            seen["decode"].append(kv_len)
            return model.paged_decode_step(*args)

        def prefill(self, plen, chunk, *args):
            seen["prefill"].append((plen, chunk))
            return model.paged_prefill_step(*args)

        def spec(self, seq, *args, measure):
            seen["spec"].append((seq, measure))
            return model.speculative_step(*args)

        def spec_committed(self, seq):
            return len(seen["spec"]) >= 2

        def spec_draft_k(self, seq, default):
            return default

        def prefix_policy(self, kv, lane_id, prompt):
            seen["prefix"] += 1
            return {"cached": kv.seed_prefix(lane_id, prompt)}

    def run(engine):
        for rid in range(3):
            engine.submit(Request(rid=rid, prompt=[3 + rid, 1, 4, 1, 5, 9],
                                  max_new_tokens=4))
        return engine.run(max_steps=40)

    draft = model.draft_model()
    engine = ServingEngine(model, params, n_lanes=2, max_len=48,
                           cache="paged", page_size=8, prefill_chunk=8,
                           prefix_cache=True, autotuner=Recorder())
    assert len(run(engine)) == 3 and seen["prefix"] == 3
    assert len(seen["decode"]) == engine.steps > 0
    assert all(7 <= kv <= 48 for kv in seen["decode"])
    assert len(seen["prefill"]) == engine.prefill_chunks
    assert all(c == 8 for _, c in seen["prefill"])
    spec_engine = ServingEngine(
        model, params, n_lanes=2, max_len=48, cache="paged", page_size=8,
        prefill_chunk=8, draft_model=draft,
        draft_params=model.slice_draft_params(params, draft), spec_k=2,
        autotuner=Recorder())
    assert len(run(spec_engine)) == 3
    assert [m for _, m in seen["spec"][:3]] == [True, True, False]


# --------------------------------------------------------------------------
# the gateway's GatewayPolicy windows
# --------------------------------------------------------------------------


def _gateway(yi_pair, tuner, n_requests: int, seed: int):
    model, params = yi_pair
    prompts = [np.random.default_rng(seed + i).integers(
        0, model.cfg.vocab_size, size=6).tolist() for i in range(n_requests)]

    async def go():
        engine = ServingEngine(model, params, n_lanes=2, max_len=48,
                               cache="paged", page_size=8, prefill_chunk=8)
        pipe = PipelinedEngine(engine, queue_limit=32, tuner=tuner,
                               policy_window=1)
        for p in prompts:
            pipe.submit(p, max_new_tokens=4)
        pipe.start()
        await pipe.drain()
        return pipe

    return asyncio.run(go())


def test_gateway_policy_commits_and_warm_loads(yi_pair, tmp_path):
    def tuner():
        t = tdyn.DecodeAutoTuner(tat.AutoTuner(str(tmp_path)),
                                 lambda bk: (lambda: bk), buckets=(512,),
                                 block_ks=(64,))
        t.add_gateway(max_inflights=(1, 2), admit_batches=(2, 8))
        return t

    t1 = tuner()
    pipe = _gateway(yi_pair, t1, 8, 11)
    assert pipe.policy_windows >= 4
    won = t1.committed_gateway_params()
    assert won is not None and set(won) == {"max_inflight", "admit_batch"}
    assert os.path.exists(tmp_path / "OAT_DynamicParamGatewayPolicy.dat")
    assert pipe.knobs.max_inflight == won["max_inflight"]
    assert pipe.stats()["policy"]["committed"] == won
    t2 = tuner()
    pipe2 = _gateway(yi_pair, t2, 4, 12)
    assert pipe2.policy_windows == 0
    assert (pipe2.knobs.max_inflight, pipe2.knobs.admit_batch) == (
        won["max_inflight"], won["admit_batch"])


def test_serve_gateway_autotune_commits_the_policy(tmp_path):
    """``serve --gateway --autotune`` on the CPU: the GatewayPolicy region
    commits over its windows and the report carries the winner."""
    out = port_serve_config(tmp_path, gateway=True, n_requests=10,
                            cache="paged", page_size=8, prefill_chunk=8)
    g = out["gateway"]
    assert g["streams"] == {"done": 10}
    assert g["policy"]["committed"] == out["autotune"]["committed"]["gateway"]
    assert g["policy"]["committed"] is not None


def port_serve_config(workdir, **kw):
    from repro_torch.launch.serve import serve_config
    tat.clear_published()
    base = dict(SERVE, **kw)
    return serve_config(ServeConfig(device="cpu", autotune=True,
                                    workdir=str(workdir), **base))


# --------------------------------------------------------------------------
# python -m repro_torch.at
# --------------------------------------------------------------------------


def _seed(workdir):
    store = tat.open_record_store(str(workdir))
    store.put("dynamic", "DecodeBucket_128", None, {"variant": 1}, cost=1.0)
    store.put("dynamic", "PrefillBucket_512_c8", None, {"variant": 0},
              cost=2.0)
    store.put("dynamic", "SpecBucket_512_mesh2x2", None, {"variant": 2},
              cost=3.0)
    store.put("install", "MatmulBlocks", {"n": 1024}, {"bm": 256}, cost=2.0)
    return store


def test_cli_lists_exports_merges_promotes_and_finds_stale(tmp_path, capsys):
    src = tmp_path / "src"
    _seed(src)
    assert tcli.main(["list", "--workdir", str(src)]) == 0
    listed = capsys.readouterr().out
    for line in ("DecodeBucket_128 kind=decode", "PrefillBucket_512_c8 "
                 "kind=prefill", "· mesh 2x2", "MatmulBlocks bp=",
                 "4 record(s) total"):
        assert line in listed
    golden = tmp_path / "golden.jsonl"
    assert tcli.main(["export", "--workdir", str(src), "--out",
                      str(golden)]) == 0
    assert "exported 4 record(s)" in capsys.readouterr().out
    dst = tmp_path / "dst"
    assert tcli.main(["merge", "--workdir", str(dst), "--db",
                      str(golden)]) == 0
    assert "4 added" in capsys.readouterr().out
    assert tat.open_record_store(str(dst)).lookup(
        "dynamic", "DecodeBucket_128").pp == {"variant": 1}
    # records of another machine are stale for this one
    foreign = [json.loads(line) for line in golden.read_text().splitlines()]
    for rec in foreign:
        rec["machine"] = "elsewhere"
    other = tmp_path / "other.jsonl"
    other.write_text("".join(json.dumps(r) + "\n" for r in foreign))
    assert tcli.main(["stale", "--workdir", str(dst), "--db", str(other),
                      "--fail-on-stale"]) == 1
    assert "4 stale region(s)" in capsys.readouterr().out
    assert tcli.main(["promote", "--workdir", str(src), "--db",
                      str(golden)]) == 0
    assert "0 added, 0 updated, 4 kept" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["list"], ["stale"]])
def test_cli_main_module_runs(argv, tmp_path):
    """``python -m repro_torch.at`` runs the CLI (``__main__``)."""
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH="src")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-m", "repro_torch.at", *argv,
                          "--workdir", str(tmp_path)], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert ("no records" in res.stdout) or ("stale region" in res.stdout)
    assert "jax" not in res.stderr


def test_serve_lm_torch_example_warm_restart(capsys):
    """``examples/serve_lm_torch.py`` on the CPU: a cold and a warm tuned
    serve (the warm one makes no measurement) and the simulated decode
    region committing its fastest variant."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "serve_lm_torch.py")
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main("cpu")
    out = capsys.readouterr().out
    assert "warm restart made 0 measurements — OK" in out
    assert "committed block_k=64 (fastest) — OK" in out

"""The port's HTTP/SSE gateway on the CPU, at the reduced yi-6b (float32
compute), against its own engine and against the JAX package's gateway.

Mirrors ``test_gateway.py``:

* SSE streams identical to ``ServingEngine.run()`` under preemption,
  chunked prefill and the prefix cache, at ``max_inflight`` 1 and 2;
* the split tick (schedule / dispatch / block / emit) equal to ``step``;
* admission backpressure: ``QueueFull`` on the direct path, 429 with
  ``Retry-After`` over HTTP, 503 while draining;
* a mid-stream disconnect releases the lane's pages (the three-state pool
  sum exact, no cancelled request in ``metrics``);
* queue-wait metrics; the ``/healthz``, ``/v1/stats`` and 404 routes;
* ``cancel_request`` of a queued, a preempted (``timeslice``) and a
  running request, and of an arrival the loop has not drained yet.

Beyond it: parity with the JAX package.  The same seeded prompts, with
the JAX model's weights carried across by ``repro_torch.bridge``, go
through the JAX ``PipelinedEngine``/``GatewayServer`` and through the
port's; greedy tokens must be equal on fp pages, int8 pages, the prefix
cache and speculation (``spec_k`` 2), at ``max_inflight`` 1 and 2, and
a client that disconnects after two token frames must leave the same
tokens on the other requests.  ``PipelinedEngine(tuner=...)`` takes the
GatewayPolicy region (run-time tuning, item 11; its windows and warm
load are mirrored in ``test_torch_tuning.py``).  One ``gpu`` test runs the paged gateway on the
card at this reduced size and counts its kernel launches.

Not mirrored here: ``test_gateway_policy_commits_and_warm_loads``
(``test_torch_tuning.py`` mirrors it) and the ``test_compare_*`` tests (they cover ``benchmarks/
compare.py``, which is not ported).

JAX is imported inside the ``jx`` fixture, not at the top: the card's
machine has no JAX, and the ``gpu`` test must import this file there.
Every server binds an ephemeral port of 127.0.0.1; the clients speak
real HTTP/1.1 over TCP.
"""
import asyncio
import types

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.launch.serve import ServeConfig, main, serve_config
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import gateway as port_gw
from repro_torch.serving.gateway import (GatewayPolicyKnobs, GatewayServer,
                                         PipelinedEngine, get_json,
                                         sse_generate)
from repro_torch.serving.gateway.pipeline import (Draining, QueueFull,
                                                  goodput_stats)
from repro_torch.serving.scheduler import ResumeEntry

torch.set_num_threads(1)

ARCH = "yi-6b"
ENGINE = dict(n_lanes=2, max_len=96, cache="paged", page_size=8,
              prefill_chunk=8)


@pytest.fixture(scope="module")
def port_mp():
    """The port's reduced yi-6b with its own seeded weights."""
    model = build_model(get_arch(ARCH).reduced())
    return model.cfg, model, model.init(0, "cpu")


def make_engine(mp, **kw):
    _, model, params = mp
    return ServingEngine(model, params, **{**ENGINE, **kw})


def make_prompts(cfg, n, seed=0, prefix=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, size=prefix).tolist()
    return [shared + rng.integers(0, cfg.vocab_size,
                                  size=int(rng.integers(4, 12))).tolist()
            for _ in range(n)]


def run_engine(eng, prompts, max_new):
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    return {r.rid: list(r.out_tokens) for r in eng.run()}


def pool_is_exact(eng) -> bool:
    s = eng.kv.stats()
    return s["used_pages"] == 0 and (
        s["used_pages"] + s["free_pages"] + s["cached_pages"]
        == s["n_pages"] - 1)


def serve_gateway(gw, eng, prompts, max_new, *, max_inflight=None,
                  disconnect=None, queue_limit=16):
    """Stream ``prompts`` through ``gw``'s (either package's gateway
    module) server on ``eng``, all clients at once; the client numbered
    ``disconnect`` closes its socket after two token frames.  Returns the
    pipeline, the tokens each client received and each final event."""
    async def go():
        kw = ({} if max_inflight is None else
              {"knobs": gw.GatewayPolicyKnobs(max_inflight=max_inflight)})
        pipe = gw.PipelinedEngine(eng, queue_limit=queue_limit, **kw)
        srv = gw.GatewayServer(pipe)
        await srv.start()

        async def one(i, p):
            toks, final = [], None
            async for kind, payload in gw.sse_generate(
                    "127.0.0.1", srv.port, p, max_new_tokens=max_new,
                    disconnect_after=2 if i == disconnect else None):
                if kind == "tokens":
                    toks.extend(payload)
                else:
                    final = (kind, payload)
            return toks, final

        results = await asyncio.gather(*[one(i, p)
                                         for i, p in enumerate(prompts)])
        await srv.drain()
        return pipe, results

    pipe, results = asyncio.run(go())
    return (pipe, {i: r[0] for i, r in enumerate(results)},
            {i: r[1] for i, r in enumerate(results)})


# -- streaming identity -------------------------------------------------------

@pytest.mark.parametrize("max_inflight", [1, 2])
def test_sse_stream_bit_identical_to_sync_engine(port_mp, max_inflight):
    """Tokens streamed over SSE match ``Engine.run()`` exactly — same
    content, same order — under preemption, chunked prefill and the
    prefix cache; overlapped ticks only at ``max_inflight`` 2."""
    cfg = port_mp[0]
    prompts = make_prompts(cfg, 6)
    ref = run_engine(make_engine(port_mp, timeslice=4, prefix_cache=True),
                     prompts, 7)
    eng = make_engine(port_mp, timeslice=4, prefix_cache=True)
    pipe, outs, finals = serve_gateway(port_gw, eng, prompts, 7,
                                       max_inflight=max_inflight)
    assert outs == ref            # content AND per-request order
    assert eng.scheduler.preemptions > 0
    assert (pipe.overlapped_ticks > 0) == (max_inflight == 2)
    assert pipe.ticks >= pipe.overlapped_ticks
    host = pipe.stats()["host_ms"]
    assert host["schedule_dispatch"] > 0 and host["emit"] > 0
    assert (host["wait"] > 0) == (max_inflight == 2)
    for i in range(len(prompts)):  # exactly one terminal frame, with stats
        kind, info = finals[i]
        assert kind == "done"
        assert info["n_tokens"] == len(ref[i])
        assert info["queue_wait_s"] is not None
        assert info["ttft_s"] is not None and info["ttft_s"] >= 0
    assert pool_is_exact(eng)


def test_pipelined_step_split_matches_step(port_mp):
    """schedule/dispatch/block/emit driven by hand is the same machine as
    ``step()`` — the overlap window moves host work, never device math."""
    prompts = make_prompts(port_mp[0], 4, seed=3)
    ref = run_engine(make_engine(port_mp), prompts, 6)
    eng = make_engine(port_mp)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    for _ in range(200):
        if not (eng.active or eng.scheduler.has_queued):
            break
        eng.schedule()
        work = eng.dispatch()
        if work is not None:
            work.block()
        eng.emit(work)
    assert {r.rid: list(r.out_tokens) for r in eng.finished} == ref


# -- backpressure ---------------------------------------------------------------

def test_admission_queue_backpressure(port_mp):
    async def go():
        eng = make_engine(port_mp)
        pipe = PipelinedEngine(eng, queue_limit=2)
        # direct-path bound: third submit bounces before the loop runs
        pipe.submit([1, 2, 3, 4], max_new_tokens=2)
        pipe.submit([1, 2, 3, 5], max_new_tokens=2)
        with pytest.raises(QueueFull):
            pipe.submit([1, 2, 3, 6], max_new_tokens=2)
        assert pipe.rejected == 1

        # HTTP path: a zero-capacity gateway answers 429 + Retry-After
        srv = GatewayServer(PipelinedEngine(make_engine(port_mp),
                                            queue_limit=0),
                            retry_after_s=7)
        await srv.start()
        bounced = [e async for e in sse_generate(
            "127.0.0.1", srv.port, [1, 2, 3, 4], max_new_tokens=2)]
        await srv.drain()

        # a draining gateway still listening answers 503
        pipe3 = PipelinedEngine(make_engine(port_mp), queue_limit=4)
        srv3 = GatewayServer(pipe3)
        await srv3.start()
        first = pipe3.submit([1, 2, 3, 4], max_new_tokens=4)
        draining = asyncio.ensure_future(pipe3.drain())
        await asyncio.sleep(0)
        refused = [e async for e in sse_generate(
            "127.0.0.1", srv3.port, [5, 6, 7, 8], max_new_tokens=2)]
        with pytest.raises(Draining):
            pipe3.submit([1, 2, 3], max_new_tokens=2)
        await draining
        await srv3.drain()
        return bounced, refused, first

    bounced, refused, first = asyncio.run(go())
    assert len(bounced) == 1
    kind, info = bounced[0]
    assert kind == "http_error" and info["status"] == 429
    assert info["retry_after"] == "7"
    assert refused == [("http_error", {"status": 503, "body": {
        "error": "gateway draining"}, "retry_after": None})]
    assert first.req.done and len(first.req.out_tokens) == 4


# -- disconnect / cancellation ------------------------------------------------

def test_mid_stream_disconnect_releases_pages(port_mp):
    """A client that vanishes mid-stream must leave the page pool's
    three-state accounting exact, and later traffic still serves."""
    prompts = make_prompts(port_mp[0], 3, seed=5)
    ref = run_engine(make_engine(port_mp, prefix_cache=True), prompts, 6)

    async def go():
        eng = make_engine(port_mp, prefix_cache=True)
        pipe = PipelinedEngine(eng, queue_limit=8)
        srv = GatewayServer(pipe)
        await srv.start()
        # read two token frames, then close the socket without consuming
        # the rest of the stream
        async for _ in sse_generate("127.0.0.1", srv.port, prompts[0],
                                    max_new_tokens=40, disconnect_after=2):
            pass

        async def full(p):
            return [e async for e in sse_generate(
                "127.0.0.1", srv.port, p, max_new_tokens=6)]

        done = await asyncio.gather(full(prompts[1]), full(prompts[2]))
        await srv.drain()
        return eng, pipe, done

    eng, pipe, done = asyncio.run(go())
    assert pipe.cancels == 1 and pipe.stats()["cancels"] == 1
    assert len(eng.cancelled) == 1
    cancelled = eng.cancelled[0]
    assert cancelled.cancelled and len(cancelled.out_tokens) < 40
    for i, events in zip((1, 2), done):
        assert events[-1][0] == "done"
        assert [t for k, p in events if k == "tokens" for t in p] == ref[i]
    assert pool_is_exact(eng)
    # cancelled requests are not serving metrics
    assert all(not r.cancelled for r in eng.metrics.requests)
    assert cancelled not in eng.finished


def _step_until(eng, cond, limit=200):
    for _ in range(limit):
        if cond():
            return
        eng.step()
    raise AssertionError("condition never held")


@pytest.mark.parametrize("where", ["queued", "preempted", "running"])
def test_cancel_request_releases_and_leaves_the_others(port_mp, where):
    """``cancel_request`` of a never-run, a preempted and a running
    request: it leaves the queue or its lane, the pool stays exact, it
    stays out of ``finished`` and ``metrics``, and the other requests get
    the tokens of a run without the cancel."""
    prompts = make_prompts(port_mp[0], 3, seed=9, prefix=8)
    kw = dict(timeslice=2, prefix_cache=True)
    ref = run_engine(make_engine(port_mp, **kw), prompts, 8)
    eng = make_engine(port_mp, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
    assert [r.rid for r in eng.queue] == [0, 1, 2]      # compat views
    assert eng.lanes is eng.scheduler.lanes
    assert eng.caches is eng.kv.caches
    if where == "queued":
        victim = 2
    elif where == "preempted":
        _step_until(eng, lambda: any(isinstance(e, ResumeEntry)
                                     for e in eng.scheduler.ready))
        victim = next(e.req.rid for e in eng.scheduler.ready
                      if isinstance(e, ResumeEntry))
    else:
        _step_until(eng, lambda: any(len(r.out_tokens) >= 2
                                     for r in eng.active.values()))
        victim = next(rid for rid, r in eng.active.items()
                      if len(r.out_tokens) >= 2)
        used = eng.kv.stats()["used_pages"]
    assert eng.cancel_request(victim)
    assert victim not in eng.active
    assert all(lane.rid != victim for lane in eng.lanes)
    assert eng.scheduler.remove_queued(victim) is None
    if where == "running":
        assert eng.kv.stats()["used_pages"] < used
    out = {r.rid: list(r.out_tokens) for r in eng.run()}
    assert out == {i: t for i, t in ref.items() if i != victim}
    [req] = eng.cancelled
    assert req.rid == victim and req.cancelled and req.done
    assert victim not in {r.rid for r in eng.metrics.requests}
    assert pool_is_exact(eng)
    assert not eng.cancel_request(victim)       # already gone
    assert not eng.cancel_request(0 if victim else 1)   # finished


def test_cancel_before_admission_drops_the_arrival(port_mp):
    async def go():
        eng = make_engine(port_mp)
        pipe = PipelinedEngine(eng)
        kept = pipe.submit([1, 2, 3, 4], max_new_tokens=3)
        gone = pipe.submit([5, 6, 7, 8], max_new_tokens=3)
        pipe.cancel(gone.req.rid)
        pipe.start()
        await pipe.drain()
        return eng, pipe, kept, gone

    eng, pipe, kept, gone = asyncio.run(go())
    assert pipe.cancels == 1 and eng.cancelled == [gone.req]
    assert gone.req.out_tokens == [] and gone.queue.get_nowait() == (
        "cancelled", {"rid": gone.req.rid})
    assert kept.req.done and len(kept.req.out_tokens) == 3
    assert pool_is_exact(eng)


# -- queue-wait metrics, routes, the tuner ------------------------------------

def test_queue_wait_metrics(port_mp):
    eng = make_engine(port_mp, n_lanes=1)
    prompts = make_prompts(port_mp[0], 4, seed=7)
    run_engine(eng, prompts, 4)
    waits = eng.metrics.queue_waits()
    assert len(waits) == len(prompts)
    assert all(w >= 0 for w in waits)
    s = eng.metrics.summary()
    assert s["queue_wait_s"]["p50"] is not None
    assert s["queue_wait_s"]["p99"] >= s["queue_wait_s"]["p50"]
    # single lane: later requests wait strictly longer than the first
    reqs = sorted(eng.metrics.requests, key=lambda r: r.rid)
    assert reqs[-1].admit_t - reqs[-1].submit_t \
        >= reqs[0].admit_t - reqs[0].submit_t


def test_stats_and_healthz_routes(port_mp):
    async def go():
        pipe = PipelinedEngine(make_engine(port_mp), queue_limit=4)
        srv = GatewayServer(pipe)
        await srv.start()
        s_health = await get_json("127.0.0.1", srv.port, "/healthz")
        s_stats = await get_json("127.0.0.1", srv.port, "/v1/stats")
        s_404 = await get_json("127.0.0.1", srv.port, "/nope")
        await srv.drain()
        return s_health, s_stats, s_404

    (hs, health), (ss, stats), (ns, _) = asyncio.run(go())
    assert hs == 200 and health["ok"] and not health["draining"]
    assert ss == 200
    assert {"ticks", "backlog", "policy", "host_ms", "kv"} <= set(stats)
    assert stats["policy"] == {"max_inflight": 2, "admit_batch": 4}
    assert set(stats["host_ms"]) == {"schedule_dispatch", "wait", "emit"}
    assert ns == 404


def test_tuner_raises_and_names_item_11(port_mp, tmp_path):
    """Run-time tuning (item 11) is ported: a tuner with a GatewayPolicy
    region sets the knobs to its first candidate, and stats() reports the
    windows and the (not yet) committed winner; without one the default
    knobs stand."""
    from repro_torch import at
    from repro_torch.tuning import DecodeAutoTuner
    tuner = DecodeAutoTuner(at.AutoTuner(str(tmp_path)), lambda bk: None,
                            buckets=(128,), block_ks=(64,))
    tuner.add_gateway(max_inflights=(1, 2), admit_batches=(2, 8))
    pipe = PipelinedEngine(make_engine(port_mp), tuner=tuner)
    assert pipe.knobs == GatewayPolicyKnobs(max_inflight=1, admit_batch=2)
    assert pipe.stats()["policy"] == {"max_inflight": 1, "admit_batch": 2,
                                      "windows": 0, "committed": None}
    assert GatewayPolicyKnobs() == GatewayPolicyKnobs(max_inflight=2,
                                                      admit_batch=4)


def test_serve_config_gateway_equals_the_synchronous_serve(capsys):
    """``serve --gateway`` on the CPU: the clients' tokens equal the
    synchronous serve's, keyed alike; bounced clients retry; the report
    and the printout carry the gateway's numbers."""
    kw = dict(device="cpu", cache="paged", prefill_chunk=8)
    sync = serve_config(ServeConfig(**kw))
    out = serve_config(ServeConfig(**kw, gateway=True, queue_limit=4))
    assert out["outputs"] == sync["outputs"]
    g = out["gateway"]
    assert g["streams"] == {"done": 8} and g["finished"] == 8
    assert g["rejected_429"] == g["client_retries_429"] > 0
    assert g["overlapped_ticks"] > 0 and g["slo_attainment"] == 1.0
    assert sync["gateway"] is None
    main(["--device", "cpu", "--cache", "paged", "--prefill-chunk", "8",
          "--gateway", "--requests", "3", "--max-new", "4"])
    printed = capsys.readouterr().out
    assert "[serve] 3/3 requests, 12 tokens" in printed
    assert "[serve] gateway:" in printed and "{'done': 3}" in printed


# -- parity with the JAX package's gateway ----------------------------------

@pytest.fixture(scope="module")
def jx():
    """The JAX reduced yi-6b and its self-speculative draft, the port's
    models on the same weights (bridged), and the JAX gateway."""
    jax = pytest.importorskip("jax")
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.models import build_model as jax_build_model
    from repro.serving import ServingEngine as JaxEngine
    from repro.serving import gateway as jax_gw

    jmodel = jax_build_model(JAX_ARCHS[ARCH].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_arch(ARCH).reduced())
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    jdraft, draft = jmodel.draft_model(), model.draft_model()
    return types.SimpleNamespace(
        gw=jax_gw, Engine=JaxEngine, model=jmodel, params=jparams,
        draft=(jdraft, jmodel.slice_draft_params(jparams, jdraft)),
        port=(model, params),
        port_draft=(draft, model.slice_draft_params(params, draft)),
        runs={})


VARIANTS = {"fp": ({}, 0), "int8": ({"kv_dtype": "int8"}, 0),
            "prefix": ({"prefix_cache": True}, 16),
            "spec": ({"spec_k": 2}, 0)}


def _engines(jx, variant):
    """(JAX engine, port engine) of one variant on the same weights."""
    kw, _ = VARIANTS[variant]
    jkw, pkw = dict(ENGINE, **kw), dict(ENGINE, **kw)
    if "spec_k" in kw:
        jkw.update(draft_model=jx.draft[0], draft_params=jx.draft[1])
        pkw.update(draft_model=jx.port_draft[0],
                   draft_params=jx.port_draft[1])
    return (jx.Engine(jx.model, jx.params, **jkw),
            ServingEngine(*jx.port, **pkw))


def _jax_gateway(jx, variant, prompts, max_new):
    """The JAX gateway's tokens for one variant and workload, served once
    a module."""
    key = (variant, tuple(map(tuple, prompts)), max_new)
    if key not in jx.runs:
        jeng, _ = _engines(jx, variant)
        jx.runs[key] = serve_gateway(jx.gw, jeng, prompts, max_new)[1]
    return jx.runs[key]


def test_goodput_stats_match_jax(jx):
    """The SLO rule and goodput on the same timestamps: a request within
    both SLOs, one late to its first token, one with a slow p95 gap, one
    cancelled."""
    from repro.serving import Request as JaxRequest
    stamps = [(0.0, 0.5, [0.5, 0.6, 0.7]), (0.0, 3.0, [3.0, 3.1]),
              (1.0, 1.2, [1.2, 1.3, 2.4]), (0.0, 0.1, [0.1])]
    reqs = {}
    for name, cls in (("jax", JaxRequest), ("port", Request)):
        reqs[name] = []
        for i, (sub, first, ts) in enumerate(stamps):
            r = cls(rid=i, prompt=[1], submit_t=sub)
            r.first_token_t, r.token_ts = first, list(ts)
            r.out_tokens = list(range(len(ts)))
            r.cancelled = i == 3
            reqs[name].append(r)
    want = jx.gw.pipeline.goodput_stats(reqs["jax"], 4.0, 2.0, 0.5)
    got = goodput_stats(reqs["port"], 4.0, 2.0, 0.5)
    assert got == want and got["slo_ok"] == 1


@pytest.mark.parametrize("max_inflight", [1, 2])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gateway_streams_match_jax_gateway(jx, variant, max_inflight):
    prompts = make_prompts(jx.port[0].cfg, 5, seed=21,
                           prefix=VARIANTS[variant][1])
    want = _jax_gateway(jx, variant, prompts, 6)
    _, eng = _engines(jx, variant)
    pipe, got, finals = serve_gateway(port_gw, eng, prompts, 6,
                                      max_inflight=max_inflight)
    assert got == want
    assert all(kind == "done" for kind, _ in finals.values())
    assert all(len(t) == 6 for t in got.values())
    assert pool_is_exact(eng)
    if variant == "prefix":
        assert eng.kv.stats()["prefix"]["hits"] > 0
    if variant == "spec":
        assert eng.spec_ticks > 0
    _, ref_eng = _engines(jx, variant)
    assert run_engine(ref_eng, prompts, 6) == got


def test_disconnect_leaves_the_jax_gateways_tokens_on_the_others(jx):
    """One client of five closes its socket after two token frames on
    both gateways: every other request gets the same tokens from both,
    the abandoned one received a prefix of them, and both pools are
    exact."""
    prompts = make_prompts(jx.port[0].cfg, 5, seed=23)
    want = _jax_gateway(jx, "fp", prompts, 12)
    outs = {}
    for name, gw, eng in zip(("jax", "port"), (jx.gw, port_gw),
                             _engines(jx, "fp")):
        pipe, got, finals = serve_gateway(gw, eng, prompts, 12,
                                          disconnect=0)
        assert pipe.cancels == 1 and len(eng.cancelled) == 1, name
        assert finals[0] is None, name          # the client hung up
        assert got[0] == want[0][:len(got[0])] and len(got[0]) >= 2, name
        assert all(finals[i][0] == "done" for i in range(1, 5)), name
        stats = eng.kv.stats()
        assert stats["used_pages"] == 0 and (
            stats["used_pages"] + stats["free_pages"]
            + stats["cached_pages"]) == stats["n_pages"] - 1, name
        outs[name] = {i: got[i] for i in range(1, 5)}
    assert outs["port"] == outs["jax"] == {i: want[i] for i in range(1, 5)}


# -- on the card ------------------------------------------------------------

@pytest.mark.gpu
def test_gateway_on_the_card_matches_the_engine_and_its_kernels():
    """Phase 26 (a)'s check at the reduced size: the paged gateway's
    tokens equal ``engine.run()``'s on the card, K4 launches once per
    layer per chunk and K3 once per layer per decode step, nothing else,
    and some ticks overlap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only there)")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    model = build_model(get_arch(ARCH).reduced())
    mp = (model.cfg, model, model.init(0, "cuda"))
    prompts = make_prompts(model.cfg, 6, seed=31)
    ref = run_engine(make_engine(mp), prompts, 8)
    kernels = fa.KERNELS + pa.KERNELS
    for kernel in kernels:
        kernel.launches = 0
    eng = make_engine(mp)
    pipe, got, finals = serve_gateway(port_gw, eng, prompts, 8)
    torch.cuda.synchronize()
    assert got == ref
    assert all(kind == "done" for kind, _ in finals.values())
    n_layers = model.cfg.n_layers
    launches = {k.__name__: k.launches for k in kernels}
    assert launches.pop("flash_paged_prefill") == \
        n_layers * eng.prefill_chunks > 0
    assert launches.pop("flash_paged_decode") == n_layers * eng.steps > 0
    assert not any(launches.values()), launches
    assert pipe.overlapped_ticks > 0
    assert pool_is_exact(eng)

"""Rank functions of the port's tensor-parallel tests.

``repro_torch.distributed.run_world`` spawns its ranks, which import the
function they run by name: so these live at module level in a module
that imports neither JAX nor the JAX package (each rank would pay for the
import).  Each returns plain Python and numpy values, pickled back to the
test.
"""
import numpy as np
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.distributed import collectives, compressed_psum
from repro_torch.distributed.ring_attention import make_ring_attention
from repro_torch.distributed.sharding import make_serving_mesh
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine

#: the engine keywords of each serving variant (the JAX test's four, and
#: int8 pages with split-KV)
VARIANTS = {"decode": {},
            "chunked": {"prefill_chunk": 8},
            "spec": {"spec": 3},
            "int8": {"kv_dtype": "int8"},
            "int8_split8": {"kv_dtype": "int8", "prefill_chunk": 8,
                            "num_splits": 8}}


def requests(vocab: int, n: int = 3, max_new: int = 4) -> list:
    """The JAX mesh test's requests: prompts of 4-11 tokens from seed 0."""
    rng = np.random.default_rng(0)
    return [(rid, rng.integers(0, vocab, size=int(rng.integers(4, 12)))
             .tolist(), max_new) for rid in range(n)]


def yi_model(np_params):
    model = build_model(get_arch("yi-6b").reduced())
    return model, params_from_jax(np_params, model.cfg, device="cpu")


def serve_variant(np_params, variant: str, mesh_spec: str | None) -> dict:
    """One variant's serve of :func:`requests` on reduced yi-6b (2 lanes,
    pages of 8, max_len 64): the greedy tokens, the first decode step's
    (or, speculative, the first verify's) logits, and this rank's pools."""
    mesh = make_serving_mesh(mesh_spec)
    model, params = yi_model(np_params)
    kw = dict(VARIANTS[variant])
    k = kw.pop("spec", None)
    if k is not None:
        draft = model.draft_model()
        kw.update(draft_model=draft, spec_k=k,
                  draft_params=model.slice_draft_params(params, draft))
    eng = ServingEngine(model, params, n_lanes=2, max_len=64, cache="paged",
                        page_size=8, mesh=mesh, **kw)
    first = []
    step = "_verify" if k is not None else "_decode"
    inner = getattr(eng, step)

    def recorded(*args, **kwargs):
        logits, caches = inner(*args, **kwargs)
        if not first:
            first.append(logits.numpy().copy())
        return logits, caches

    setattr(eng, step, recorded)
    for rid, prompt, max_new in requests(model.cfg.vocab_size):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))
    done = eng.run(max_steps=40)
    return {"tokens": {r.rid: list(r.out_tokens) for r in done},
            "logits": first[0], "pool_heads": eng.kv.caches["kv"][0].shape[2],
            "pool_bytes": eng.kv.pool_bytes(),
            "rank": 0 if mesh is None else mesh.rank}


def serve_variants(np_params, variants, mesh_spec: str | None) -> dict:
    return {v: serve_variant(np_params, v, mesh_spec) for v in variants}


def ring(cases, mesh_specs) -> dict:
    """Ring attention of each numpy (q, k, v, causal) case on this rank,
    over each mesh of ``mesh_specs`` (one world may hold several), with
    the calls of each collective every case made."""
    out = {}
    for spec in mesh_specs:
        mesh = make_serving_mesh(spec)
        for i, (q, k, v, causal) in enumerate(cases):
            collectives.reset_counts()
            o = make_ring_attention(mesh, causal=causal)(
                torch.from_numpy(q), torch.from_numpy(k),
                torch.from_numpy(v))
            out[spec, i] = {"out": o.numpy(),
                            "calls": dict(collectives.CALLS)}
    return out


def routed_attention(cases, mesh_spec: str) -> list:
    """``ops.attention`` on each (q, k, v, causal, window) case: the
    output and the ring sends it made."""
    mesh = make_serving_mesh(mesh_spec)
    out = []
    for q, k, v, causal, window in cases:
        collectives.reset_counts()
        o = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window,
                          mesh=mesh)
        out.append((o.numpy(), collectives.CALLS["ring_send"]))
    return out


def long_prefill(np_params, tokens, mesh_spec: str | None) -> dict:
    """Reduced yi-6b's prefill of ``tokens`` (1, S): last logits and the
    layer-0 K cache, with the ring sends made."""
    mesh = make_serving_mesh(mesh_spec)
    model, params = yi_model(np_params)
    collectives.reset_counts()
    logits, caches = model.prefill(params, torch.tensor(tokens), mesh=mesh)
    return {"logits": logits.numpy(), "k0": caches["kv"][0][0].numpy(),
            "ring_sends": collectives.CALLS["ring_send"]}


def psum(xs, mesh_spec: str) -> np.ndarray:
    """``compressed_psum`` of this rank's ``xs[rank]`` over the model axis."""
    mesh = make_serving_mesh(mesh_spec)
    x = torch.from_numpy(xs[mesh.coords["model"]])
    return compressed_psum(x, mesh.group("model")).numpy()


def several(calls) -> list:
    """Run each ``(name, args)`` of this module in turn, in one world."""
    return [globals()[name](*args) for name, args in calls]


# --------------------------------------------------------------------------
# the gateway over a multi-rank mesh
# --------------------------------------------------------------------------

#: the engine keywords of the gateway variants over a mesh
GATEWAY_VARIANTS = {"paged": {"prefill_chunk": 8},
                    "int8_split8": {"kv_dtype": "int8", "prefill_chunk": 8,
                                    "num_splits": 8},
                    "spec": {"spec": 2, "prefill_chunk": 8}}


def gateway_engine(np_params, variant: str, mesh, autotuner=None):
    """Reduced yi-6b (JAX weights) on the paged pool, 2 lanes, pages of 8,
    in the variant's mode, on ``mesh``."""
    model, params = yi_model(np_params)
    kw = dict(GATEWAY_VARIANTS[variant])
    k = kw.pop("spec", None)
    if k is not None:
        draft = model.draft_model()
        kw.update(draft_model=draft, spec_k=k,
                  draft_params=model.slice_draft_params(params, draft))
    return ServingEngine(model, params, n_lanes=2, max_len=64, cache="paged",
                         page_size=8, mesh=mesh, autotuner=autotuner, **kw)


def gateway_serve(np_params, variants, mesh_spec: str | None,
                  max_inflight: int = 2) -> dict:
    """Each variant's gateway serve of :func:`requests` (one TCP client a
    request on rank 0; ranks 1.. follow): {variant: {"tokens" by client,
    "by_rid" (this rank's engine), "syncs", "rank"}}."""
    from repro_torch.serving.gateway import GatewayServer, PipelinedEngine
    from repro_torch.serving.gateway.pipeline import GatewayPolicyKnobs
    mesh = make_serving_mesh(mesh_spec)
    out = {}
    for variant in variants:
        eng = gateway_engine(np_params, variant, mesh)
        pipe = PipelinedEngine(eng, mesh=mesh, knobs=GatewayPolicyKnobs(
            max_inflight=max_inflight, admit_batch=4))
        reqs = requests(eng.model.cfg.vocab_size)
        tokens = None
        if pipe.mesh is not None and pipe.mesh.rank != 0:
            pipe.follow()
        else:
            tokens = _drive(pipe, [(p, n) for _, p, n in reqs])
        out[variant] = {"tokens": tokens, "syncs": pipe.syncs,
                        "rank": 0 if mesh is None else mesh.rank,
                        "by_rid": {r.rid: list(r.out_tokens)
                                   for r in eng.finished}}
    return out


def _drive(pipe, prompts, *, cancel_after: int | None = None,
           delay_s: float = 0.0, retry_429: bool = True) -> dict:
    """Rank 0: serve ``prompts`` [(prompt, max_new)] through a
    GatewayServer, one client each; the client of index ``cancel_after``
    hangs up after its first token frame.  Returns {client: (tokens,
    final event kind, 429 bounces)}."""
    import asyncio

    from repro_torch.serving.gateway import GatewayServer, sse_generate

    async def one(port, i, prompt, max_new):
        tokens, bounced = [], 0
        while True:
            final = None
            async for kind, payload in sse_generate("127.0.0.1", port, prompt,
                                                    max_new_tokens=max_new):
                if kind == "tokens":
                    tokens.extend(payload)
                    if i == cancel_after:
                        return tokens, "hung_up", bounced
                else:
                    final = (kind, payload)
            if retry_429 and final and final[0] == "http_error" \
                    and final[1]["status"] == 429:
                bounced += 1
                await asyncio.sleep(0.05)
                continue
            return tokens, final[0] if final else "closed", bounced

    async def go():
        srv = GatewayServer(pipe)
        await srv.start()
        await asyncio.sleep(delay_s)
        got = await asyncio.gather(*[one(srv.port, i, p, n)
                                     for i, (p, n) in enumerate(prompts)])
        await srv.drain()
        return dict(enumerate(got))

    return asyncio.run(go())


def gateway_scenarios(np_params, mesh_spec: str, idle_s: float) -> dict:
    """Rank 0 hangs one client up mid-stream, bounces clients with 429 at
    ``queue_limit`` 1, then idles ``idle_s`` before its clients connect
    (longer than the world's group timeout; heartbeats keep the followers'
    broadcasts alive).  Every rank returns its engine's tokens by rid,
    its cancelled rids and its pool's free pages."""
    from repro_torch.serving.gateway import PipelinedEngine
    mesh = make_serving_mesh(mesh_spec)
    reqs = [(p, n) for _, p, n in requests(256, n=4, max_new=6)]
    out = {}
    for name, kw, drive in (
            ("cancel", {}, {"cancel_after": 0}),
            ("queue_limit_1", {"queue_limit": 1}, {}),
            ("idle", {}, {"delay_s": idle_s})):
        eng = gateway_engine(np_params, "paged", mesh)
        pipe = PipelinedEngine(eng, mesh=mesh, **kw)
        seen = None
        if mesh.rank != 0:
            pipe.follow()
        else:
            seen = _drive(pipe, reqs, **drive)
        out[name] = {"by_rid": {r.rid: list(r.out_tokens)
                                for r in eng.finished},
                     "cancelled": sorted(r.rid for r in eng.cancelled),
                     "free_pages": eng.kv.stats().get("free_pages"),
                     "clients": seen, "rejected": pipe.rejected,
                     "syncs": pipe.syncs, "heartbeat_s": pipe.heartbeat_s}
    return out


# --------------------------------------------------------------------------
# the sharded train step
# --------------------------------------------------------------------------

def sharded_grads(cases, mesh_spec: str) -> dict:
    """For each (arch, numpy params, numpy batch) case: the loss and
    every gradient of the train step with ``param_shardings`` on this
    world's mesh (gathered whole), whether each gradient kept its
    parameter's placements, and the unsharded port step's loss and
    gradients on this rank."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.process_mesh import make_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.sharding_ctx import LayoutPlan
    from repro_torch.optim import adamw

    dims = tuple(int(x) for x in mesh_spec.split("x"))
    mesh = make_mesh(dims, ("data", "model"))
    out = {}
    for arch, np_params, np_batch in cases:
        model = build_model(get_arch(arch).reduced())
        params = params_from_jax(np_params, model.cfg, device="cpu",
                                 dtype=torch.float32)
        batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
        captured = {}

        def grab(grads, state, ps, cfg, into):
            into["grads"] = [g.clone() for g in grads]
            return ps, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}

        # the step's gradients, taken where AdamW would consume them
        real = adamw.update
        try:
            adamw.update = lambda g, s, p, c: grab(g, s, p, c, captured)
            step = build_train_step(model, LayoutPlan(), adamw.AdamWConfig())
            _, _, m0 = step(params, adamw.init(params), batch)
            g0 = [g.numpy() for g in captured["grads"]]
            plan = sh.make_plan(model.cfg, "train", mesh, "tp")
            specs = sh.param_shardings(params, model.cfg, plan, mesh)
            plan.layer_specs = sh.layer_param_specs(params, model.cfg, plan,
                                                    mesh)
            dparams = adamw.tree_map(lambda t: t.detach(),
                                     sh.place(params, specs, mesh))
            dbatch = sh.place(batch, sh.batch_shardings(batch, mesh), mesh)
            step = build_train_step(model, plan, adamw.AdamWConfig(),
                                    param_shardings=specs)
            _, _, m1 = step(dparams, adamw.init(dparams), dbatch)
            ps = adamw.leaves(dparams)
            kept = all(tuple(g.placements) == tuple(p.placements)
                       for g, p in zip(captured["grads"], ps))
            g1 = [g.full_tensor().numpy() for g in captured["grads"]]
        finally:
            adamw.update = real
        out[arch] = {"loss": float(m1["loss"]), "grads": g1, "kept": kept,
                     "loss_unsharded": float(m0["loss"]),
                     "grads_unsharded": g0,
                     "decode": sharded_decode(model, params, batch, mesh)}
    return out


DECODE_PLANS = ("tp", "decode_seq", "decode_resident")


def sharded_decodes(cases, mesh_spec: str) -> dict:
    """:func:`sharded_decode` for each (arch, numpy params, numpy batch)
    case on this world's mesh."""
    from repro_torch.distributed.process_mesh import make_mesh
    dims = tuple(int(x) for x in mesh_spec.split("x"))
    mesh = make_mesh(dims, ("data", "model"))
    out = {}
    for arch, np_params, np_batch in cases:
        model = build_model(get_arch(arch).reduced())
        params = params_from_jax(np_params, model.cfg, device="cpu",
                                 dtype=torch.float32)
        batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
        out[arch] = sharded_decode(model, params, batch, mesh)
    return out


def sharded_decode(model, params, batch, mesh) -> dict:
    """One decode step after an 8-token prefill (caches of 16 slots):
    the unsharded step's logits and caches, and each decode plan's (its
    parameters, caches and token placed by the plan's rules), gathered
    whole."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.steps import build_decode_step
    from repro_torch.models.sharding_ctx import LayoutPlan
    from repro_torch.optim import adamw

    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(clone(v) for v in tree)
        return tree.clone()

    cfg = model.cfg
    toks = batch["tokens"][:, :8]
    with torch.no_grad():
        logits, caches = model.prefill(
            params, toks, max_len=16,
            frontend_embeds=batch.get("frontend_embeds"))
    inputs = {"token": logits.argmax(-1, keepdim=True).to(torch.int32),
              "pos": torch.full((toks.shape[0],), toks.shape[1],
                                dtype=torch.int32)}
    ref, ref_caches = build_decode_step(model, LayoutPlan())(
        params, clone(caches), inputs["token"], inputs["pos"])
    out = {"unsharded": (ref.numpy(), [c.numpy() for c in
                                       adamw.leaves(ref_caches)])}
    for name in DECODE_PLANS:
        plan = sh.make_plan(cfg, "decode", mesh, name)
        specs = sh.param_shardings(params, cfg, plan, mesh)
        plan.layer_specs = sh.layer_param_specs(params, cfg, plan, mesh)
        dcaches = sh.place(clone(caches),
                           sh.cache_shardings(caches, cfg, plan, mesh), mesh)
        dtok = sh.place(inputs, sh.batch_shardings(inputs, mesh), mesh)
        got, new = build_decode_step(model, plan)(
            sh.place(params, specs, mesh), dcaches, dtok["token"],
            dtok["pos"])
        out[name] = (got.full_tensor().numpy(),
                     [c.full_tensor().numpy() for c in adamw.leaves(new)])
    return out

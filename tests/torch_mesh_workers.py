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

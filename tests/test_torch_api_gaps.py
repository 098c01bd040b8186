"""The last public names of the JAX package that the port had no copy
of, held against the JAX package on the CPU:

* ``ServingEngine``'s ``decode_fn``, ``prefill_fn`` and ``greedy``
  (``repro.serving.engine``): injected steps with the JAX engine's call
  convention give the JAX engine's greedy tokens, as
  ``tests/test_paged_serving.py``'s EOS guard drives it;
* ``launch.serve.serve(**kwargs)``: ``serve_config(ServeConfig(**kwargs))``
  and the JAX ``serve``'s tokens on the JAX weights;
* ``distributed.compression.compress_roundtrip_error_rows``;
* ``launch.mesh.make_mesh(shape, axes)``;
* ``kernels.ops.tuned`` and ``ops.set_tuned``.

``ops.on_cpu`` (a global backend query) has no copy: the port's entry
points take each tensor's own device (ROADMAP, "Where the port stands").
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.at as jat
import repro_torch.at as tat
from repro.configs import ARCHS as JAX_ARCHS
from repro.distributed import compression as jcomp
from repro.kernels import ops as jops
from repro.launch import mesh as jmesh
from repro.launch.serve import serve as jax_serve
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed.process_mesh import fake_world
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.model import Model
from repro_torch.serving import Request, ServingEngine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def yi_pair():
    """The reduced yi-6b in both packages on the JAX weights (seed 0)."""
    jmodel = jax_build_model(JAX_ARCHS["yi-6b"].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_arch("yi-6b").reduced())
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    return jmodel, jparams, model, params


def _requests(cls, n: int = 3, max_new: int = 6):
    return [cls(rid=i, prompt=[1 + i] + list(range(2, 2 + 3 + 2 * i)),
                max_new_tokens=max_new) for i in range(n)]


def _run(engine, cls, **kw) -> dict:
    for req in _requests(cls, **kw):
        engine.submit(req)
    return {r.rid: [int(t) for t in r.out_tokens]
            for r in engine.run(max_steps=100)}


# --------------------------------------------------------------------------
# ServingEngine(decode_fn=, prefill_fn=, greedy=)
# --------------------------------------------------------------------------


def _counted(fn, counts: dict, name: str):
    def wrapped(*args):
        counts[name] += 1
        return fn(*args)
    return wrapped


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_injected_steps_give_the_jax_engines_tokens(yi_pair, cache):
    """Pass-through steps with the JAX engine's call convention
    (``prefill_fn(params, tokens, frontend_embeds, max_len)``,
    ``decode_fn(params, caches, *extra, token, pos)``) are the engine's
    steps: each is called, and the greedy tokens equal the JAX engine's
    with its own injected steps and the port's default engine's."""
    jmodel, jparams, model, params = yi_pair
    jstep = jmodel.paged_decode_step if cache == "paged" \
        else jmodel.decode_step
    tstep = model.paged_decode_step if cache == "paged" \
        else model.decode_step
    jcounts = {"prefill": 0, "decode": 0}
    tcounts = {"prefill": 0, "decode": 0}
    kw = dict(n_lanes=2, max_len=48, cache=cache, page_size=8)
    jeng = JaxEngine(
        jmodel, jparams, **kw,
        decode_fn=_counted(jax.jit(jstep), jcounts, "decode"),
        prefill_fn=_counted(jax.jit(jmodel.prefill, static_argnums=(3,)),
                            jcounts, "prefill"))

    def tprefill(p, tokens, fe, max_len):
        return model.prefill(p, tokens, max_len, frontend_embeds=fe)

    eng = ServingEngine(model, params, **kw,
                        decode_fn=_counted(tstep, tcounts, "decode"),
                        prefill_fn=_counted(tprefill, tcounts, "prefill"))
    plain = ServingEngine(model, params, **kw)
    want = _run(jeng, JaxRequest)
    got = _run(eng, Request)
    assert got == want == _run(plain, Request)
    assert all(len(t) == 6 for t in got.values())
    assert tcounts == jcounts and tcounts["prefill"] == 3
    assert tcounts["decode"] == eng.steps == jeng.steps > 0


def _zero_logit_engines(yi_pair, eos_id):
    """Both packages' engines whose steps always emit token 0, as
    ``tests/test_paged_serving.py``'s EOS guard builds the JAX one."""
    jmodel, jparams, model, params = yi_pair

    def jprefill(p, tokens, fe, max_len):
        logits, caches = jmodel.prefill(p, tokens, fe, max_len)
        return jnp.zeros_like(logits).at[:, 0].set(1.0), caches

    def jdecode(p, caches, token, pos):
        logits, caches = jmodel.decode_step(p, caches, token, pos)
        return jnp.zeros_like(logits).at[:, 0].set(1.0), caches

    def one_hot(logits):
        out = torch.zeros_like(logits)
        out[:, 0] = 1.0
        return out

    def tprefill(p, tokens, fe, max_len):
        logits, caches = model.prefill(p, tokens, max_len,
                                       frontend_embeds=fe)
        return one_hot(logits), caches

    def tdecode(p, caches, token, pos):
        logits, caches = model.decode_step(p, caches, token, pos)
        return one_hot(logits), caches

    return (JaxEngine(jmodel, jparams, n_lanes=1, max_len=48, eos_id=eos_id,
                      decode_fn=jdecode, prefill_fn=jprefill),
            ServingEngine(model, params, n_lanes=1, max_len=48,
                          eos_id=eos_id, decode_fn=tdecode,
                          prefill_fn=tprefill))


@pytest.mark.parametrize("eos_id", [0, None])
def test_injected_steps_drive_the_eos_guard_as_in_jax(yi_pair, eos_id):
    jeng, eng = _zero_logit_engines(yi_pair, eos_id)
    for e, cls in ((jeng, JaxRequest), (eng, Request)):
        e.submit(cls(rid=0, prompt=[1, 2, 3], max_new_tokens=10))
    want = [int(t) for t in jeng.run(max_steps=40)[0].out_tokens]
    got = [int(t) for t in eng.run(max_steps=40)[0].out_tokens]
    assert got == want == ([0] if eos_id == 0 else [0] * 10)


@pytest.mark.parametrize("greedy", [True, False])
def test_greedy_is_taken_and_changes_nothing(yi_pair, greedy):
    """As in the JAX engine, ``greedy`` is only taken: sampling follows
    each request's ``SamplingParams`` (greedy by default) in both."""
    jmodel, jparams, model, params = yi_pair
    want = _run(JaxEngine(jmodel, jparams, n_lanes=2, max_len=48,
                          greedy=greedy), JaxRequest)
    got = _run(ServingEngine(model, params, n_lanes=2, max_len=48,
                             greedy=greedy), Request)
    assert got == want == _run(ServingEngine(model, params, n_lanes=2,
                                             max_len=48), Request)


def test_speculative_steps_are_the_engines_attributes(yi_pair):
    """The draft's prefill and decode and the prompt chunk go through the
    engine's ``_draft_prefill``, ``_draft_decode`` and ``_prefill_step``,
    as in the JAX engine: wrapped, they are called, and the tokens stay
    the JAX engine's."""
    jmodel, jparams, model, params = yi_pair
    kw = dict(n_lanes=2, max_len=48, cache="paged", page_size=8,
              prefill_chunk=8, spec_k=2)
    jdraft = jmodel.draft_model()
    jeng = JaxEngine(jmodel, jparams, draft_model=jdraft,
                     draft_params=jmodel.slice_draft_params(jparams, jdraft),
                     **kw)
    draft = model.draft_model()
    eng = ServingEngine(model, params, draft_model=draft,
                        draft_params=model.slice_draft_params(params, draft),
                        **kw)
    counts = {n: 0 for n in ("_draft_prefill", "_draft_decode",
                             "_prefill_step")}
    for name in counts:
        setattr(eng, name, _counted(getattr(eng, name), counts, name))
    assert _run(eng, Request) == _run(jeng, JaxRequest)
    assert all(n > 0 for n in counts.values()), counts


# --------------------------------------------------------------------------
# launch.serve.serve(**kwargs)
# --------------------------------------------------------------------------


SERVE_KW = dict(n_requests=3, n_lanes=2, max_len=48, prompt_len=10,
                max_new=5)


@pytest.fixture
def jax_weights(yi_pair, monkeypatch):
    """The port's ``Model.init`` returns the JAX serve's weights (seed 0
    of the reduced yi-6b, carried across by the bridge)."""
    jmodel, jparams, model, params = yi_pair
    monkeypatch.setattr(Model, "init", lambda self, seed=0, device="cpu",
                        dtype=None: params)


@pytest.mark.parametrize("kw", [{}, dict(cache="paged", page_size=8,
                                         prefill_chunk=8)],
                         ids=["dense", "paged"])
def test_serve_kwargs_is_serve_config(jax_weights, kw):
    kw = {**SERVE_KW, **kw}
    got = tserve.serve(device="cpu", **kw)
    want = tserve.serve_config(tserve.ServeConfig(device="cpu", **kw))
    assert got["outputs"] == want["outputs"]
    assert set(got) == set(want)
    assert got["config"] == want["config"]
    assert got["finished"] == kw["n_requests"]
    assert got["outputs"] == jax_serve(**kw)["outputs"]


def test_serve_kwargs_refuses_an_unknown_keyword():
    with pytest.raises(TypeError):
        tserve.serve(no_such_field=1)


# --------------------------------------------------------------------------
# distributed.compression.compress_roundtrip_error_rows
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((4, 64), 1.0), ((2, 3, 128), 7.5),
                                         ((5, 16), 1e-3)])
def test_roundtrip_error_rows_equals_jax(shape, scale):
    """The eager quantizers give equal codes, so equal errors; the error
    stays under half a step of each row's scale (amax / 254)."""
    x = (np.random.default_rng(len(shape)).standard_normal(shape)
         * scale).astype(np.float32)
    x[0, ...] = 0.0                             # a zero row: codes 0
    got = float(tcomp.compress_roundtrip_error_rows(torch.from_numpy(x)))
    want = float(jcomp.compress_roundtrip_error_rows(jnp.asarray(x)))
    assert got == pytest.approx(want, rel=1e-6, abs=0.0)
    assert got <= np.abs(x).max() / 254 * (1 + 1e-6)
    assert got <= float(tcomp.compress_roundtrip_error(
        torch.from_numpy(x))) * (1 + 1e-6)


# --------------------------------------------------------------------------
# launch.mesh.make_mesh(shape, axes)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axes", [((1, 1), ("data", "model")),
                                        ((1,), ("model",)),
                                        ((1, 1, 1), ("pod", "data", "model"))])
def test_make_mesh_has_the_axes_and_shape_of_jax(shape, axes):
    got, want = tmesh.make_mesh(shape, axes), jmesh.make_mesh(shape, axes)
    assert got.axis_names == tuple(want.axis_names) == axes
    assert got.shape == dict(want.shape)
    assert tmesh.chips(got) == jmesh.chips(want) == 1


@pytest.mark.parametrize("shape,axes", [((2, 4), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))])
def test_make_mesh_in_a_world_of_its_size(shape, axes):
    with fake_world(8):
        mesh = tmesh.make_mesh(shape, axes)
        assert mesh.axis_names == axes
        assert mesh.shape == dict(zip(axes, shape))
        assert tmesh.chips(mesh) == 8
        assert all(mesh.group(a) is not None for a in axes)
    with pytest.raises(ValueError, match="needs a world of 8"):
        tmesh.make_mesh(shape, axes)


# --------------------------------------------------------------------------
# kernels.ops.tuned and ops.set_tuned
# --------------------------------------------------------------------------


@pytest.fixture
def clean_published():
    tat.clear_published()
    jat.clear_published()
    yield
    tat.clear_published()
    jat.clear_published()


def test_ops_set_tuned_round_trips_as_in_jax(clean_published):
    for ops, at in ((jops, jat), (tops, tat)):
        ops.set_tuned("shim_kernel", block_m=64)
        assert at.tuned("shim_kernel") == {"block_m": 64}
        assert ops.tuned("shim_kernel") == {"block_m": 64}
        ops.set_tuned("shim_kernel", block_n=32)
        assert ops.tuned("shim_kernel") == {"block_m": 64, "block_n": 32}
    assert tops.tuned("unknown") == jops.tuned("unknown") == {}


def test_ops_tuned_overlays_a_problem_size_as_in_jax(clean_published):
    for ops, at in ((jops, jat), (tops, tat)):
        at.publish("matmul", block_m=128)
        at.publish_for_bp("matmul", {"OAT_PROBSIZE": 2048}, block_m=256)
        assert ops.tuned("matmul") == {"block_m": 128}
        assert ops.tuned("matmul", OAT_PROBSIZE=2048) == {"block_m": 256}
        assert ops.tuned("matmul", OAT_PROBSIZE=512) == {"block_m": 128}


@pytest.mark.parametrize("kw", [dict(cache="dense"),
                                dict(cache="paged", page_size=8,
                                     prefill_chunk=8, spec_k=2)],
                         ids=["dense", "paged_spec"])
def test_the_engine_is_freed_without_the_cycle_collector(yi_pair, kw):
    """The step attributes close over the model, never over the engine,
    so dropping the last reference frees the engine and its KV pools at
    once (a serve after a serve on the card must not hold both)."""
    import gc
    import weakref
    _, _, model, params = yi_pair
    if "spec_k" in kw:
        draft = model.draft_model()
        kw = dict(kw, draft_model=draft,
                  draft_params=model.slice_draft_params(params, draft))
    gc.disable()
    try:
        eng = ServingEngine(model, params, n_lanes=2, max_len=48, **kw)
        _run(eng, Request, n=2, max_new=3)
        freed = weakref.ref(eng)
        del eng
        assert freed() is None
    finally:
        gc.enable()

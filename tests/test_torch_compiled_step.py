"""The compiled serving steps (``repro_torch.serving.compiled``): each
step the engine calls every tick captured once per shape as a CUDA graph
and replayed, the port's counterpart of the JAX engine's ``jax.jit``.

On the CPU: ``compile_step`` calls the step through, the engine's
default steps are compiled wrappers whose greedy tokens equal the JAX
engine's (reduced yi-6b: dense, paged, int8 split, speculative), and the
bookkeeping (the key, per-tick against persistent inputs, recaptures,
replay accounting, a failed capture) runs through the module's capture
seam with a stand-in backend that "replays" by calling the step with its
counters held.  The ``gpu`` cases need the card (the kernels build with
nvcc for sm_90a) and skip here: a graph's replay bit-equal to the eager
step for K2, K3, the split decode, the verify and the chunk, a newly
published tile and a moved pool recapturing, a capture failure raising,
the arrival counters zero after replays.  JAX is imported only in a
fixture, so the ``gpu`` cases run where JAX is not installed::

    PYTHONPATH=src python -m pytest -q tests/test_torch_compiled_step.py
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_compiled_step.py
"""
import collections
import functools

import numpy as np
import pytest
import torch

import repro_torch.at as at
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import compiled
from repro_torch.serving.compiled import CompiledStep, CudaGraphs, compile_step

torch.set_num_threads(1)


class StandIn(CudaGraphs):
    """The capture seam on the CPU: "capture" runs the step once (its
    counts are taken back by the compiled step, as a real capture's are)
    and "replay" runs it again on the captured inputs with every counter
    held, copying its result into the captured outputs."""

    def __init__(self, fail: bool = False, held=()):
        self.fail = fail
        self.held = held          # tallies outside EXTRA_TALLIES to hold
        self.replayed = 0

    def takes(self, device):
        return True

    def stream(self, device):
        return None

    def warm_up(self, call, stream, device):
        return call()

    def capture(self, call, stream, device):
        if self.fail:
            raise ValueError("operation not permitted when stream is "
                             "capturing")
        out = call()
        return (call, out), out

    def replay(self, graph):
        call, out = graph
        held = compiled._snapshot()
        others = [collections.Counter(c) for c in self.held]
        new = call()
        compiled._restore(held)
        for c, was in zip(self.held, others):
            c.clear()
            c.update(was)
        out[0].copy_(new[0])
        self.replayed += 1


def toy_step(params, caches, token, pos, *, scale=1):
    """A step with the engine's shape of call: writes slot ``pos`` of the
    cache (in place, the same value for the same inputs) and returns
    (logits, caches); counts one K2 launch at the default tile, as the
    kernel wrapper would."""
    caches["kv"][pos] = params["w"] * token * scale
    fa.flash_decode.launches += 1
    fa.flash_decode.by_tile[64] += 1
    fa.flash_decode.last_kernel = "toy"
    return (caches["kv"].sum(0, keepdim=True) * token, caches)


def toy_args(token=2.0, pos=1, n=4):
    params = {"w": torch.arange(1.0, 4.0)}
    caches = {"kv": torch.zeros(n, 3)}
    return params, caches, torch.tensor([[token]]), torch.tensor(pos)


@pytest.fixture(autouse=True)
def _clean():
    at.clear_published()
    launches = fa.flash_decode.launches
    tiles = collections.Counter(fa.flash_decode.by_tile)
    last = fa.flash_decode.last_kernel
    yield
    at.clear_published()
    fa.flash_decode.launches = launches
    fa.flash_decode.by_tile.clear()
    fa.flash_decode.by_tile.update(tiles)
    fa.flash_decode.last_kernel = last


# --------------------------------------------------------------------------
# the CPU route
# --------------------------------------------------------------------------


def test_cpu_tensors_call_the_step_through():
    step = compile_step(toy_step, "toy")
    params, caches, token, pos = toy_args()
    want, _ = toy_step(params, {"kv": torch.zeros(4, 3)}, token, pos)
    before = fa.flash_decode.launches
    got, out_caches = step(params, caches, token, pos)
    assert torch.equal(got, want) and out_caches is caches
    assert (step.captures, step.replays, step.graphs) == (0, 0, {})
    assert fa.flash_decode.launches == before + 1
    assert step.fn is toy_step and step.name == "toy"


def test_a_step_without_tensors_calls_through():
    step = compile_step(lambda n: n + 1, "plain")
    assert step(3) == 4 and step.captures == 0


@pytest.fixture(scope="module")
def jax_yi():
    """The reduced yi-6b in both packages on the JAX weights (seed 0)."""
    jax = pytest.importorskip("jax")
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.models import build_model as jax_build_model
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine
    from repro_torch.bridge import params_from_jax
    jmodel = jax_build_model(JAX_ARCHS["yi-6b"].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_arch("yi-6b").reduced())
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    return jmodel, jparams, model, params, JaxEngine, JaxRequest


MODES = {
    "dense": dict(cache="dense"),
    "paged": dict(cache="paged", page_size=8, prefill_chunk=8),
    "int8 split": dict(cache="paged", page_size=8, prefill_chunk=8,
                       kv_dtype="int8", num_splits=2),
    "speculative": dict(cache="paged", page_size=8, prefill_chunk=8,
                        spec_k=2),
}


def _serve(engine, cls) -> dict:
    for i in range(3):
        engine.submit(cls(rid=i, prompt=[1 + i] + list(range(2, 5 + 2 * i)),
                          max_new_tokens=6))
    return {r.rid: [int(t) for t in r.out_tokens]
            for r in engine.run(max_steps=100)}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_defaults_are_compiled_and_give_the_jax_tokens(jax_yi, mode):
    jmodel, jparams, model, params, JaxEngine, JaxRequest = jax_yi
    kw = dict(n_lanes=2, max_len=48, **MODES[mode])
    jkw, tkw = dict(kw), dict(kw)
    # the JAX engine takes no num_splits: the plain versions ignore it on
    # the CPU in both packages
    jkw.pop("num_splits", None)
    if "spec_k" in kw:
        jdraft, draft = jmodel.draft_model(), model.draft_model()
        jkw.update(draft_model=jdraft,
                   draft_params=jmodel.slice_draft_params(jparams, jdraft))
        tkw.update(draft_model=draft,
                   draft_params=model.slice_draft_params(params, draft))
    eng = ServingEngine(model, params, **tkw)
    steps = ["_decode", "_prefill_step"] + (
        ["_verify", "_draft_decode"] if "spec_k" in kw else [])
    for name in steps:
        assert isinstance(getattr(eng, name), CompiledStep), name
    # the monolithic prefills stay eager, by decision
    assert not isinstance(eng._prefill, CompiledStep)
    want = _serve(JaxEngine(jmodel, jparams, **jkw), JaxRequest)
    assert _serve(eng, Request) == want
    assert all(len(t) == 6 for t in want.values())
    # the CPU route captures nothing
    assert eng.graph_stats() == {"captures": 0, "replays": 0,
                                 "recaptures": 0, "graphs": {}}


def test_decode_fn_is_called_as_given(jax_yi):
    _, _, model, params, _, _ = jax_yi
    calls = []

    def decode_fn(*args):
        calls.append(1)
        return model.decode_step(*args)

    eng = ServingEngine(model, params, n_lanes=2, max_len=48,
                        decode_fn=decode_fn)
    assert eng._decode is decode_fn
    _serve(eng, Request)
    assert len(calls) == eng.steps > 0


def test_an_engine_with_a_sharded_mesh_keeps_eager_steps(monkeypatch):
    """The decision is the constructor's (``self.mesh``), not a caught
    capture error: with a sharded mesh no step is compiled."""
    from repro_torch.serving import engine as engine_mod
    model = build_model(get_arch("yi-6b").reduced())
    params = model.init(0, "cpu")
    monkeypatch.setattr(engine_mod, "mesh_model_axis", lambda mesh: 2)
    monkeypatch.setattr(engine_mod, "make_kv_cache",
                        lambda *a, **kw: type("KV", (), {"kind": "paged"})())
    eng = ServingEngine(model, params, n_lanes=2, max_len=48, cache="paged",
                        prefill_chunk=8, mesh=object())
    assert not isinstance(eng._decode, CompiledStep)
    assert not isinstance(eng._prefill_step, CompiledStep)
    assert eng.graph_stats()["captures"] == 0


# --------------------------------------------------------------------------
# the key, per-tick and persistent inputs, recaptures, through the seam
# --------------------------------------------------------------------------


def test_equal_calls_share_a_graph_and_replay_the_eager_result():
    backend = StandIn()
    step = compile_step(toy_step, "toy", backend)
    params, caches, token, pos = toy_args()
    first, _ = step(params, caches, token, pos)
    ref_caches = {"kv": torch.zeros(4, 3)}
    for t, p in ((2.0, 1), (5.0, 2), (3.0, 1)):
        got, _ = step(params, caches, torch.tensor([[t]]), torch.tensor(p))
        want, _ = toy_step(params, ref_caches, torch.tensor([[t]]),
                           torch.tensor(p))
        assert torch.equal(got, want)
        assert torch.equal(caches["kv"], ref_caches["kv"])
    assert (step.captures, step.replays, len(step.graphs)) == (1, 3, 1)
    assert backend.replayed == 3


def _key_after(call) -> tuple:
    step = compile_step(toy_step, "toy", StandIn())
    params, caches, token, pos = toy_args()
    step(params, caches, token, pos)
    call(step, params, caches, token, pos)
    return step.captures, step.replays


def test_the_key_tells_shapes_dtypes_arguments_and_tiles_apart():
    assert _key_after(lambda s, p, c, t, q: s(p, c, t, q)) == (1, 1)
    assert _key_after(lambda s, p, c, t, q: s(
        p, c, torch.tensor([2.0]), q)) == (2, 0)                 # shape
    assert _key_after(lambda s, p, c, t, q: s(
        p, c, t.double(), q)) == (2, 0)                          # dtype
    assert _key_after(lambda s, p, c, t, q: s(
        p, c, t, q, scale=2)) == (2, 0)                          # argument
    assert _key_after(lambda s, p, c, t, q: (
        at.publish("flash_paged_decode", block_k=32),
        s(p, c, t, q))) == (2, 0)                                # tile
    assert _key_after(lambda s, p, c, t, q: (
        at.publish("flash_paged_decode", num_splits=4),
        s(p, c, t, q))) == (2, 0)                                # splits
    assert _key_after(lambda s, p, c, t, q: (
        at.publish("some_other_kernel", block_k=32),
        s(p, c, t, q))) == (1, 1)             # not a kernel a step reads


def test_a_published_tile_gets_its_own_graph_and_the_old_one_stays():
    step = compile_step(toy_step, "toy", StandIn())
    args = toy_args()
    step(*args)
    at.publish("flash_paged_decode", block_k=32)
    step(*args)
    at.clear_published()
    step(*args)
    assert (step.captures, step.replays, len(step.graphs)) == (2, 1, 2)


def test_per_tick_inputs_are_copied_and_persistent_ones_taken_in_place():
    per_tick, persistent = [], []
    params, caches, token, pos = toy_args()
    for a in (params, caches, token, pos):
        compiled._spec(a, True, per_tick, persistent)
    assert per_tick[0] is token and per_tick[1] is pos
    assert persistent[0] is params["w"] and persistent[1] is caches["kv"]
    step = compile_step(toy_step, "toy", StandIn())
    step(params, caches, token, pos)
    (graph,) = step.graphs.values()
    # the graph's own copies of the per-tick inputs, the caller's untouched
    assert graph.inputs[0] is not token and torch.equal(graph.inputs[0],
                                                        token)
    step(params, caches, torch.tensor([[7.0]]), torch.tensor(3))
    assert graph.inputs[0].item() == 7.0 and token.item() == 2.0
    assert graph.addrs == (params["w"].data_ptr(), caches["kv"].data_ptr())
    # the caches written in place: the persistent tensor itself
    assert torch.equal(caches["kv"][3], params["w"] * 7.0)


def test_a_moved_persistent_tensor_is_recaptured_and_counted():
    step = compile_step(toy_step, "toy", StandIn())
    params, caches, token, pos = toy_args()
    step(params, caches, token, pos)
    step(params, caches, token, pos)
    moved = {"kv": caches["kv"].clone()}
    got, _ = step(params, moved, token, pos)
    assert (step.captures, step.recaptures, step.replays) == (2, 1, 1)
    assert len(step.graphs) == 1
    (graph,) = step.graphs.values()
    assert graph.addrs[1] == moved["kv"].data_ptr()
    step(params, moved, torch.tensor([[4.0]]), torch.tensor(2))
    assert torch.equal(moved["kv"][2], params["w"] * 4.0)
    assert not torch.equal(caches["kv"][2], params["w"] * 4.0)


def test_replays_count_the_launches_the_capture_recorded():
    """A first call counts its warm-up (the call), the capture counts
    nothing, every replay adds what the capture counted: the kernels'
    launches, their tiles, ``last_kernel``, and a tally kept outside the
    kernels while it is in ``EXTRA_TALLIES``."""
    outside = collections.Counter()

    def counted(*args, **kw):
        outside["toy"] += 1
        return toy_step(*args, **kw)

    step = compile_step(counted, "toy", StandIn(held=[outside]))
    fa.flash_decode.launches = 0
    fa.flash_decode.by_tile.clear()
    fa.flash_decode.last_kernel = None
    compiled.EXTRA_TALLIES.append(outside)
    try:
        args = toy_args()
        for n in range(1, 5):
            step(*args)
            assert fa.flash_decode.launches == n
            assert fa.flash_decode.by_tile == {64: n}
            assert outside == {"toy": n}
            assert fa.flash_decode.last_kernel == "toy"
            fa.flash_decode.last_kernel = None
    finally:
        compiled.EXTRA_TALLIES.remove(outside)
    step(*args)
    assert outside == {"toy": 4} and fa.flash_decode.launches == 5


def test_a_failed_capture_raises_naming_the_step_and_counts_nothing():
    step = compile_step(toy_step, "decode", StandIn(fail=True))
    args = toy_args()
    before = fa.flash_decode.launches
    with pytest.raises(RuntimeError, match="'decode'.*not permitted"):
        step(*args)
    # the warm-up (the call) counted, the failed capture did not
    assert fa.flash_decode.launches == before + 1
    assert step.graphs == {} and step.captures == 0


def test_graph_stats_sum_the_steps():
    a, b = (compile_step(toy_step, n, StandIn()) for n in ("decode", "v"))
    args = toy_args()
    for _ in range(3):
        a(*args)
    b(*args)
    assert compiled.graph_stats([a, b, None, toy_step]) == {
        "captures": 2, "replays": 2, "recaptures": 0,
        "graphs": {"decode": 1, "v": 1}}


def test_the_serves_tuning_variants_are_compiled_per_candidate(tmp_path):
    """Each candidate of the serve's run-time AT has its own compiled
    step, which the tuner holds (``compiled_steps``)."""
    from repro_torch.launch.serve import ServeConfig, make_autotuner
    model = build_model(get_arch("yi-6b").reduced())
    scfg = ServeConfig(cache="paged", prefill_chunk=8, draft=True,
                       autotune=True, workdir=str(tmp_path), device="cpu")
    tuner = make_autotuner(model, scfg)
    steps = tuner.compiled_steps
    assert steps and all(isinstance(s, CompiledStep) for s in steps)
    assert len({id(s) for s in steps}) == len(steps)
    assert {s.name for s in steps} == {"decode", "prefill_step", "verify"}


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only there)")
    return torch.device("cuda")


def _small_model(device):
    model = build_model(get_arch("yi-6b").reduced())
    return model, model.init(0, device)


def _paged_case(model, device, quantized=False, lanes=2, blocks=4, psz=16):
    caches = model.init_paged_caches(lanes * blocks + 1, psz, device,
                                     quantized=quantized)
    table = (torch.arange(lanes * blocks, device=device,
                          dtype=torch.int32).view(lanes, blocks) + 1)
    return caches, table


def _prime(model, params, caches, table, device, plen=20):
    """A prompt of ``plen`` tokens per lane in the pages, eagerly."""
    lanes = table.shape[0]
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, model.cfg.vocab_size, (lanes, plen),
                           generator=g).to(device)
    start = torch.zeros(lanes, dtype=torch.long, device=device)
    kv_len = torch.full((lanes,), plen, dtype=torch.long, device=device)
    model.paged_prefill_step(params, caches, table, prompt, start, kv_len,
                             kv_len - 1)
    return kv_len


def _same_twice(step, eager, make_args, n=3):
    """Call the compiled step ``n`` times and the eager one on a copy of
    the state each time; every output bit-equal."""
    for i in range(n):
        args_c, args_e = make_args(i)
        got, _ = step(*args_c)
        want, _ = eager(*args_e)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (step.name, i)
    return step


def _clone_caches(caches):
    return {k: tuple(t.clone() for t in v) for k, v in caches.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["K2 dense decode", "K3 paged decode",
                                  "split decode", "int8 split decode",
                                  "verify", "chunk"])
def test_a_replay_is_bit_equal_to_the_eager_step(cuda_device, what):
    model, params = _small_model(cuda_device)
    lanes = 2
    if what == "K2 dense decode":
        caches_c = model.init_caches(lanes, 64, device=cuda_device)
        caches_e = model.init_caches(lanes, 64, device=cuda_device)
        step = compile_step(model.decode_step, "decode")

        def make_args(i):
            tok = torch.tensor([[3 + i], [5 + i]], device=cuda_device)
            pos = torch.tensor([i, 2 * i], device=cuda_device)
            return ((params, caches_c, tok, pos),
                    (params, caches_e, tok.clone(), pos.clone()))
        _same_twice(step, model.decode_step, make_args)
        for a, b in zip(caches_c["kv"], caches_e["kv"]):
            assert torch.equal(a, b)
        return
    quant = what.startswith("int8")
    caches_c, table = _paged_case(model, cuda_device, quantized=quant)
    kv_len = _prime(model, params, caches_c, table, cuda_device)
    caches_e = _clone_caches(caches_c)
    splits = 4 if "split" in what or what == "verify" else None
    if what == "verify":
        fn = functools.partial(model.speculative_step, num_splits=splits)
    elif what == "chunk":
        fn = model.paged_prefill_step
    else:
        fn = functools.partial(model.paged_decode_step, num_splits=splits)
    step = compile_step(fn, what)

    def make_args(i):
        if what in ("verify", "chunk"):
            c = 5 if what == "verify" else 16
            toks = torch.arange(c * lanes, device=cuda_device).view(lanes, c)
            start = kv_len + i
            end = start + c
            # the chunk's row whose logits come back: its last
            extra = ((torch.full_like(start, c - 1),) if what == "chunk"
                     else ())
            a = (toks + i, start, end, *extra)
        else:
            a = (torch.tensor([[7 + i]] * lanes, device=cuda_device),
                 kv_len + i)
        return ((params, caches_c, table, *a),
                (params, caches_e, table.clone(), *(x.clone() for x in a)))
    _same_twice(step, fn, make_args)
    assert step.captures == 1 and step.replays == 2
    for a, b in zip(caches_c["kv"], caches_e["kv"]):
        assert torch.equal(a, b)
    assert all(int(c.abs().sum()) == 0 for c in pa.arrival_counters())


@pytest.mark.gpu
def test_a_new_tile_and_a_moved_pool_recapture(cuda_device):
    model, params = _small_model(cuda_device)
    caches, table = _paged_case(model, cuda_device)
    kv_len = _prime(model, params, caches, table, cuda_device)
    step = compile_step(model.paged_decode_step, "decode")
    tok = torch.tensor([[7]] * 2, device=cuda_device)
    step(params, caches, table, tok, kv_len)
    step(params, caches, table, tok, kv_len)
    before = pa.flash_paged_decode.by_tile.copy()
    at.publish("flash_paged_decode", block_k=32)
    got, _ = step(params, caches, table, tok, kv_len)
    step(params, caches, table, tok, kv_len)
    # one capture and one replay at each tile
    assert (step.captures, step.replays) == (2, 2)
    assert pa.flash_paged_decode.by_tile[32] - before[32] == \
        2 * model.cfg.n_layers
    at.clear_published()
    moved = _clone_caches(caches)
    step(params, moved, table, tok, kv_len)
    assert step.recaptures == 1 and step.captures == 3
    got, _ = step(params, moved, table, tok, kv_len)
    want, _ = model.paged_decode_step(params, _clone_caches(moved), table,
                                      tok, kv_len)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_a_capture_failure_raises_naming_the_step(cuda_device):
    def syncs(x):
        return x * float(x.sum().item())     # a host read: not capturable

    step = compile_step(syncs, "syncs")
    with pytest.raises(RuntimeError, match="'syncs'"):
        step(torch.ones(4, device=cuda_device))


@pytest.mark.gpu
def test_the_engine_serves_graphed_as_it_serves_eager(cuda_device):
    """A paged split serve and a speculative one, graphed (the default)
    and eager (``decode_fn=`` and the step attributes): the same tokens,
    every arrival counter zero, the launches counted alike."""
    model, params = _small_model(cuda_device)
    draft = model.draft_model()
    kw = dict(n_lanes=2, max_len=64, cache="paged", page_size=16,
              prefill_chunk=16, num_splits=4, draft_model=draft,
              draft_params=model.slice_draft_params(params, draft), spec_k=2)
    out, launches = {}, {}
    for mode in ("graphed", "eager"):
        eng = ServingEngine(model, params, **kw)
        if mode == "eager":
            for name in ("_decode", "_prefill_step", "_verify",
                         "_draft_decode"):
                setattr(eng, name, getattr(eng, name).fn)
        for k in fa.KERNELS + pa.KERNELS:
            k.launches = 0
        out[mode] = _serve(eng, Request)
        torch.cuda.synchronize()
        launches[mode] = {k.__name__: k.launches
                          for k in fa.KERNELS + pa.KERNELS}
        if mode == "graphed":
            assert eng.graph_stats()["replays"] > 0
    assert out["graphed"] == out["eager"]
    assert launches["graphed"] == launches["eager"]
    assert all(int(c.abs().sum()) == 0 for c in pa.arrival_counters())

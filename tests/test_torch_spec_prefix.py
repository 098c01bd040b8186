"""The port's speculative decoding and prefix cache against the JAX package
on the CPU, at the reduced configs (float32 compute).

Mirrors ``test_speculative.py``, ``test_prefix_cache.py`` and the split
prefill/verify part of ``test_split_kv.py``:

* ``draft_config`` field by field against the JAX package's, width
  reduced too; ``slice_draft_params`` returns views and rejects a width
  mismatch;
* ``paged_prefill_split_ref`` (the plain version of K5b/K6d) and the
  plain ``ops.paged_verify`` against the JAX split Pallas kernels in
  interpret mode and the JAX oracle, fp and int8, at 1e-5;
* ``speculative_step`` logits against the JAX model's at 1e-4, and a
  one-token verify against the paged decode step;
* the speculative sampler (``draft_rng``, ``propose_token``,
  ``speculative_accept``) and ``chain_hash`` equal to the JAX package's;
* the prefix-cache pool (hash index, refcounts, LRU/FIFO eviction, COW,
  ``truncate_to``, swaps with shared pages) driven by the same calls as
  the JAX cache, with table, refcounts, free list, cached count and
  index keys compared after every call;
* engines: speculative greedy tokens equal the port's plain engine and
  the JAX speculative engine for k in {1, 2, 4}, with chunked prefill,
  with eos and under swaps; sampled speculation equal to JAX's tokens;
  prefix cache on equal to off and to the JAX prefix-cache engine;
  pressure swaps with shared pages; speculation with the prefix cache;
  the required-argument errors; the serve CLI with the new flags.

Inputs are made with numpy from seeds and handed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.distributed.compression import quantize_int8_rows as jax_quantize
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import \
    flash_paged_prefill as jax_paged_prefill
from repro.kernels.flash_attention import \
    flash_paged_prefill_quant as jax_paged_prefill_quant
from repro.models import build_model as jax_build_model
from repro.serving import PagedKVCache as JaxPagedKVCache
from repro.serving import Request as JaxRequest
from repro.serving import SamplingParams as JaxSamplingParams
from repro.serving import ServingEngine as JaxEngine
from repro.serving import sampling as jax_sampling
from repro.serving.kvcache import chain_hash as jax_chain_hash
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import ServeConfig, serve_config, serve_engine
from repro_torch.models import build_model
from repro_torch.serving import (PagedKVCache, Request, SamplingParams,
                                 ServingEngine, sampling)
from repro_torch.serving.kvcache import DenseKVCache, chain_hash

torch.set_num_threads(1)

ARCH_IDS = ["yi-6b", "deepseek-7b"]
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.from_numpy(np.array(x))        # a writable copy


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# --------------------------------------------------------------------------
# draft config and draft weights
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("depth,width", [(0.5, 1.0), (0.5, 0.5), (0.25, 1.0)])
def test_draft_config_matches_jax_field_by_field(arch, reduced, depth, width):
    cfg, jcfg = get_arch(arch), JAX_ARCHS[arch]
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got = dataclasses.asdict(cfg.draft_config(depth, width))
    assert got == dataclasses.asdict(jcfg.draft_config(depth, width))
    assert got["name"] == f"{arch}-draft"
    assert 1 <= got["n_layers"] < max(2, cfg.n_layers)


@pytest.fixture(scope="module", params=ARCH_IDS)
def pair(request):
    """(jax model, jax params, port model, port params) for one arch."""
    jmodel = jax_build_model(JAX_ARCHS[request.param].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_arch(request.param).reduced())
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def yi():
    """The yi-6b pair plus both packages' self-speculative drafts."""
    jmodel = jax_build_model(JAX_ARCHS["yi-6b"].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_arch("yi-6b").reduced())
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    jdraft = jmodel.draft_model()
    draft = model.draft_model()
    return dict(jmodel=jmodel, jparams=jparams, model=model, params=params,
                jdraft=jdraft,
                jdparams=jmodel.slice_draft_params(jparams, jdraft),
                draft=draft, dparams=model.slice_draft_params(params, draft))


def test_slice_draft_params_are_views_and_reject_a_width_mismatch(pair):
    _, _, model, params = pair
    draft = model.draft_model()
    dparams = model.slice_draft_params(params, draft)
    n = draft.cfg.n_layers
    assert n == model.cfg.n_layers // 2
    for name in ("wq", "wk", "wv", "wo"):
        full, sliced = params["layers"]["attn"][name], \
            dparams["layers"]["attn"][name]
        assert sliced.shape == (n,) + full.shape[1:]
        assert sliced.data_ptr() == full.data_ptr()       # a view, no copy
        assert sliced._base is full
    assert dparams["embed"] is params["embed"]            # shared
    assert dparams["final_norm_w"] is params["final_norm_w"]
    narrow = build_model(model.cfg.draft_config(width_frac=0.5))
    with pytest.raises(ValueError, match="width"):
        model.slice_draft_params(params, narrow)
    deep = build_model(dataclasses.replace(model.cfg, n_layers=4))
    with pytest.raises(ValueError, match="deeper"):
        model.slice_draft_params(params, deep)


# --------------------------------------------------------------------------
# the split prefill/verify plain version against the JAX split kernels
# --------------------------------------------------------------------------


def _case():
    """The JAX suite's split-prefill case: 2 lanes, GQA 4/2, a chunk of 5
    at 16 (kv_len 21) and at 3 (kv_len 5), shuffled pages."""
    q = rand((2, 4, 5, 16), 0, 0.3)
    kp = rand((10, 2, 8, 16), 1, 0.3)
    vp = rand((10, 2, 8, 16), 2, 0.3)
    table = np.array([[3, 7, 1], [5, 0, 0]], np.int32)
    return q, kp, vp, table, np.array([16, 3], np.int32), \
        np.array([21, 5], np.int32)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("ns", [2, 4, 8])
@pytest.mark.parametrize("block_q,block_k", [(64, 32), (2, 4)])
def test_split_prefill_ref_matches_jax_kernel_and_oracle(quant, ns, block_q,
                                                         block_k):
    """Its output equals the JAX split kernel's (interpret mode) and the
    JAX oracle's at 1e-5, with the port's tile cut (64 x 32) and with the
    JAX suite's (2 x 4); the plain ops.paged_verify gives the same."""
    q, kp, vp, table, start, kv_len = _case()
    scales = {}
    if quant:
        (kp, ks), (vp, vs) = (tuple(np.asarray(a) for a in jax_quantize(x))
                              for x in (kp, vp))
        scales = dict(k_scale=ks, v_scale=vs)
        want_kernel = jax_paged_prefill_quant(
            q, kp, vp, ks, vs, jnp.asarray(table), jnp.asarray(start),
            jnp.asarray(kv_len), block_q=2, block_k=4, num_splits=ns,
            interpret=True)
    else:
        want_kernel = jax_paged_prefill(
            q, kp, vp, jnp.asarray(table), jnp.asarray(start),
            jnp.asarray(kv_len), block_q=2, block_k=4, num_splits=ns,
            interpret=True)
    tscales = {k: t(v) for k, v in scales.items()}
    got, (m, l, acc) = ref.paged_prefill_split_ref(
        t(q), t(kp), t(vp), t(table), t(start), t(kv_len), ns,
        block_q=block_q, block_k=block_k, **tscales)
    assert m.shape == l.shape == (2, 4, ns, 5)
    assert acc.shape == (2, 4, ns, 5, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                               **KERNEL_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_ref.paged_prefill_ref(
            q, kp, vp, table, start, kv_len, **scales)), **KERNEL_TOL)
    plain = ops.paged_verify(t(q), ops.PagedPools(t(kp), t(vp), **{
        k[0] + "_scale": v for k, v in tscales.items()}), t(table),
        t(start), t(kv_len), num_splits=ns)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), **KERNEL_TOL)
    # a split that sees no key of a row is exactly (-1e30, 0, 0) there
    empty = l == 0
    assert bool(empty.any())
    assert torch.all(m[empty] == ref.NEG_INF)
    assert torch.all(acc[empty] == 0)


def test_split_prefill_ref_cuts_the_live_tiles_and_zero_rows():
    """The cut follows each q tile's live key tiles, not the table width:
    a lane of 40 keys in a 128-key table at block_k 8 has 5 live tiles,
    which 4 splits take as 2 + 2 + 1 + 0; an idle lane (kv_len 0) is all
    empty and gives exactly 0, never NaN."""
    q = rand((2, 2, 3, 8), 3)
    kp, vp = rand((20, 1, 8, 8), 4), rand((20, 1, 8, 8), 5)
    table = np.arange(1, 33, dtype=np.int32).reshape(2, 16) % 20
    start, kv_len = np.array([37, 0], np.int32), np.array([40, 0], np.int32)
    out, (m, l, acc) = ref.paged_prefill_split_ref(
        t(q), t(kp), t(vp), t(table), t(start), t(kv_len), 4,
        block_q=64, block_k=8)
    live = (l[0, 0] > 0).numpy()                     # (ns, C)
    assert live.tolist() == [[True] * 3] * 3 + [[False] * 3]
    assert torch.all(out[1] == 0) and torch.all(l[1] == 0)
    np.testing.assert_allclose(
        out[0].numpy(), ref.paged_prefill_ref(t(q), t(kp), t(vp), t(table),
                                              t(start), t(kv_len))[0].numpy(),
        **KERNEL_TOL)


def test_paged_verify_dispatch_on_cpu_and_what_it_rejects():
    q, kp, vp, table, start, kv_len = (t(a) for a in _case())
    pools = ops.PagedPools(kp, vp)
    want = ref.paged_prefill_ref(q, kp, vp, table, start, kv_len)
    for ns in (None, 1, 3):
        assert torch.equal(ops.paged_verify(q, pools, table, start, kv_len,
                                            num_splits=ns), want)
        assert torch.equal(ops.paged_prefill(q, pools, table, start, kv_len,
                                             num_splits=ns), want)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_verify(q, pools, table, start, kv_len, use_kernel=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        ops.paged_verify(q, pools, table, start, kv_len, mesh=object())


# --------------------------------------------------------------------------
# speculative_step against the JAX model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ns", [None, 4])
def test_speculative_step_matches_jax(pair, ns):
    """A 13-token prompt prefilled in chunks of 8, then one verify chunk
    of 5 (the last row padding past kv_len) and a one-token verify:
    logits (B, C, V) at 1e-4 against the JAX model; the one-token verify
    equals the paged decode step of the same token."""
    jmodel, jparams, model, params = pair
    n_pages, psz = 10, 8
    jcaches = jmodel.init_paged_caches(n_pages, psz)
    caches = model.init_paged_caches(n_pages, psz, device="cpu")
    table = np.array([[7, 3, 5]], np.int32)
    prompt = [(5 * j) % 200 + 3 for j in range(13)]
    for start in (0, 8):
        end = min(start + 8, len(prompt))
        args = (table, np.array([prompt[start:end]
                                 + [0] * (8 - (end - start))], np.int32),
                np.array([start], np.int32), np.array([end], np.int32),
                np.array([end - start - 1], np.int32))
        jlogits, jcaches = jmodel.paged_prefill_step(jparams, jcaches, *args)
        logits, caches = model.paged_prefill_step(params, caches,
                                                  *(t(a) for a in args))
    tok = int(np.argmax(np.asarray(jlogits)[0]))
    chunk = np.array([[tok, 11, 12, 13, 0]], np.int32)
    start, kv_len = np.array([13], np.int32), np.array([17], np.int32)
    jlogits, _ = jmodel.speculative_step(jparams, jcaches, table, chunk,
                                         start, kv_len)
    logits, caches = model.speculative_step(
        params, caches, t(table), t(chunk), t(start), t(kv_len),
        num_splits=ns)
    assert logits.shape == (1, 5, model.cfg.padded_vocab)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy()[:, :4],
                               np.asarray(jlogits)[:, :4], **TOL)
    # C = 1 is a decode step: on fresh copies of the pools, same logits
    pools = {k: tuple(x.clone() for x in v) for k, v in caches.items()}
    one, _ = model.speculative_step(params, caches, t(table),
                                    t(chunk[:, :1]), t(start), t(start + 1),
                                    num_splits=ns)
    dec, _ = model.paged_decode_step(params, pools, t(table), t(chunk[:, :1]),
                                     t(start), num_splits=ns)
    np.testing.assert_allclose(one[:, 0].numpy(), dec.numpy(), **TOL)


# --------------------------------------------------------------------------
# the speculative sampler and the page hash
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sp", [
    dict(), dict(temperature=0.8, top_k=20, seed=3),
    dict(temperature=1.0, top_p=0.9, seed=11),
    dict(temperature=0.6, top_k=5, top_p=0.8, seed=42)])
@pytest.mark.parametrize("seed", [0, 1])
def test_speculative_sampler_matches_jax(sp, seed):
    rng = np.random.default_rng(seed)
    k, v = 4, 40
    draft_logits = rng.normal(size=(k, v)) * 2.0
    target_logits = rng.normal(size=(k + 1, v)) * 2.0
    target_logits[:2] += draft_logits[:2]          # agree on a prefix
    ps, js = SamplingParams(**sp), JaxSamplingParams(**sp)
    r, jr = sampling.draft_rng(ps, 7), jax_sampling.draft_rng(js, 7)
    drafts, probs = [], []
    for row in draft_logits:
        tok, q = sampling.propose_token(row, ps, r)
        jtok, jq = jax_sampling.propose_token(row, js, jr)
        assert tok == jtok
        np.testing.assert_array_equal(q, jq)
        drafts.append(tok)
        probs.append(q)
    for n in range(k + 1):
        got = sampling.speculative_accept(drafts[:n], probs[:n],
                                          target_logits[:n + 1], ps, 7)
        want = jax_sampling.speculative_accept(drafts[:n], probs[:n],
                                               target_logits[:n + 1], js, 7)
        assert got == want
        emitted, n_acc = got
        assert len(emitted) == n_acc + 1 <= n + 1


def test_greedy_accept_rule_and_chain_hash_match_jax():
    tl = np.zeros((3, 8))
    tl[0, 2] = tl[1, 5] = tl[2, 6] = 1.0
    sp = SamplingParams()
    assert sampling.speculative_accept([2, 5], [None] * 2, tl, sp, 0) == \
        ([2, 5, 6], 2)
    assert sampling.speculative_accept([2, 4], [None] * 2, tl, sp, 0) == \
        ([2, 5], 1)
    assert sampling.speculative_accept([0, 4], [None] * 2, tl, sp, 0) == \
        ([2], 0)
    key = ""
    for page in ([1, 2, 3, 4], [5, 6, 7, 8], list(range(90, 106))):
        assert chain_hash(key, page) == jax_chain_hash(key, page)
        key = chain_hash(key, np.asarray(page))
    assert chain_hash("", [1, 2]) != chain_hash(chain_hash("", [0]), [1, 2])


# --------------------------------------------------------------------------
# the prefix-cache pool against the JAX cache under the same calls
# --------------------------------------------------------------------------


def _pool_state(kv):
    return dict(table=np.asarray(kv.table).tolist(),
                n_blocks=list(kv.n_blocks),
                refcount=np.asarray(kv.refcount).tolist(),
                free=[int(p) for p in kv._free],
                cached=kv.cached_pages, used=kv.used_pages,
                index=sorted(kv._index.items()),
                page_key=sorted(kv._page_key.items()),
                chain=list(kv._chain),
                counters=(kv.prefix_lookups, kv.prefix_hits, kv.hit_tokens,
                          kv.pages_saved, kv.cow_copies, kv.index_evictions))


def _zero_leak(kv):
    assert kv.used_pages == 0
    assert kv.used_pages + kv.cached_pages + kv.free_pages == kv.n_pages - 1
    assert int(np.asarray(kv.refcount).sum()) == 0
    assert np.all(np.asarray(kv.table) == 0)
    assert kv.cached_pages == sum(1 for p in kv._page_key
                                  if kv.refcount[p] == 0)


A = list(range(1, 17))                  # 4 pages of 4
B = list(range(31, 47))
SCRIPTS = {
    # publish, share, release: shared pages count once, indexed pages stay
    # cached; a page-aligned full hit copies on write
    "share-and-cow": [
        ("ensure_tokens", 0, 18), ("publish_prefix", 0, A + [0, 0], 18),
        ("seed_prefix", 1, A), ("cow_writable", 1, 15),
        ("cow_writable", 1, 15), ("ensure_tokens", 1, 20),
        ("truncate_to", 1, 9), ("truncate_to", 1, 3), ("release", 0),
        ("seed_prefix", 0, A[:8] + [99]), ("release", 1), ("release", 0)],
    # a tight pool: both prefixes cached, a hit refreshes A, then an
    # allocation under pressure evicts by the policy
    "evict": [
        ("ensure_tokens", 0, 8), ("publish_prefix", 0, A[:8], 8),
        ("release", 0), ("ensure_tokens", 0, 8),
        ("publish_prefix", 0, B[:8], 8), ("release", 0),
        ("seed_prefix", 1, A[:8]), ("release", 1), ("ensure_tokens", 0, 12),
        ("ensure_tokens", 1, 8), ("release", 0), ("release", 1)],
    # swap out a lane holding shared pages, resume into private ones
    "swap": [
        ("ensure_tokens", 0, 16), ("publish_prefix", 0, A, 16),
        ("seed_prefix", 1, A + [5]), ("ensure_tokens", 1, 17),
        ("swap", 1), ("release", 1), ("set_prefix_policy", 3),
        ("seed_prefix", 1, A[:8]),
        ("set_prefix_policy", 1), ("seed_prefix", 1, A[:12]),
        ("release", 0), ("release", 1)],
}


@pytest.mark.parametrize("eviction", ["lru", "fifo"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_prefix_pool_state_matches_jax_under_the_same_calls(
        pair, script, eviction, kv_dtype):
    jmodel, _, model, _ = pair
    n_pages = 7 if script == "evict" else 13
    kw = dict(prefix_cache=True, prefix_eviction=eviction, kv_dtype=kv_dtype)
    jkv = JaxPagedKVCache(jmodel, 2, 32, n_pages, 4, **kw)
    kv = PagedKVCache(model, 2, 32, n_pages, 4, "cpu", **kw)
    for leaf in kv._leaves():              # distinct content per page
        leaf.copy_(t(rand(tuple(leaf.shape), 9)).to(leaf.dtype))
    for step in SCRIPTS[script]:
        op, *args = step
        if op == "swap":
            before = [leaf[:, kv.table[args[0], :kv.n_blocks[args[0]]]]
                      .clone() for leaf in kv._leaves()]
            jkv.swap_in(args[0], jkv.swap_out(args[0]))
            assert kv.swap_in(args[0], kv.swap_out(args[0]))
            pages = kv.table[args[0], :kv.n_blocks[args[0]]]
            for leaf, want in zip(kv._leaves(), before):
                assert torch.equal(leaf[:, pages], want)
        elif op == "cow_writable":
            lane, pos = args
            old = int(kv.table[lane, pos // 4])
            assert jkv.cow_writable(*args) == kv.cow_writable(*args)
            new = int(kv.table[lane, pos // 4])
            for leaf in kv._leaves():      # k, v and int8 scales copied
                assert torch.equal(leaf[:, new], leaf[:, old])
        elif op == "set_prefix_policy":
            jkv.set_prefix_policy(min_match=args[0])
            kv.set_prefix_policy(min_match=args[0])
        else:
            assert getattr(jkv, op)(*args) == getattr(kv, op)(*args), step
        assert _pool_state(kv) == _pool_state(jkv), step
    assert kv.stats()["prefix"] == jkv.stats()["prefix"]
    if script == "evict":
        assert kv.index_evictions > 0
    _zero_leak(kv)


def test_prefix_policy_and_dense_rejects():
    model = build_model(get_arch("yi-6b").reduced())
    kv = PagedKVCache(model, 1, 32, 5, 4, "cpu", prefix_cache=True)
    with pytest.raises(ValueError, match="eviction"):
        kv.set_prefix_policy(eviction="random")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, model.init(0, "cpu"), n_lanes=1, max_len=32,
                      prefix_cache=True)
    assert not DenseKVCache(model, 1, 32, "cpu").prefix_cache


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------


def _requests(n=3, max_new=6, plen=11, sp=None):
    return [(i, [1 + i] + [(3 * i + j) % 90 + 2 for j in range(plen - 1)],
             max_new, sp and dict(sp, seed=sp["seed"] + i))
            for i in range(n)]


def _run(engine_cls, request_cls, sp_cls, eng_kw, reqs, max_steps=400):
    eng = engine_cls(**eng_kw)
    for rid, prompt, max_new, sp in reqs:
        kw = {} if sp is None else dict(sampling=sp_cls(**sp))
        eng.submit(request_cls(rid=rid, prompt=list(prompt),
                               max_new_tokens=max_new, **kw))
    done = eng.run(max_steps=max_steps)
    return {r.rid: r.out_tokens for r in done}, eng


def _both(yi, reqs, spec_k=None, max_steps=400, **kw):
    """The same requests through the port's engine and the JAX one, each
    with its own package's draft when ``spec_k`` is set."""
    port, jax_ = dict(kw), dict(kw)
    if spec_k is not None:
        port.update(draft_model=yi["draft"], draft_params=yi["dparams"],
                    spec_k=spec_k)
        jax_.update(draft_model=yi["jdraft"], draft_params=yi["jdparams"],
                    spec_k=spec_k)
    got, eng = _run(ServingEngine, Request, SamplingParams,
                    dict(model=yi["model"], params=yi["params"], **port),
                    reqs, max_steps)
    want, jeng = _run(JaxEngine, JaxRequest, JaxSamplingParams,
                      dict(model=yi["jmodel"], params=yi["jparams"], **jax_),
                      reqs, max_steps)
    return got, want, eng, jeng


def _plain(yi, reqs, **kw):
    return _run(ServingEngine, Request, SamplingParams,
                dict(model=yi["model"], params=yi["params"], **kw), reqs)[0]


SPEC = dict(n_lanes=2, max_len=48, cache="paged", page_size=8)


@pytest.fixture(scope="module")
def plain_tokens(yi):
    """The port's non-speculative greedy tokens of ``_requests()``."""
    return _plain(yi, _requests(), n_lanes=2, max_len=48)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_greedy_equals_plain_and_jax(yi, plain_tokens, k):
    got, want, eng, jeng = _both(yi, _requests(), spec_k=k, **SPEC)
    assert got == want == plain_tokens
    assert eng.spec_stats() == jeng.spec_stats()
    assert eng.steps == jeng.steps and eng.spec_ticks > 0
    assert eng.drafted_tokens >= eng.accepted_tokens
    _zero_leak(eng.kv)


@pytest.mark.parametrize("case", ["chunked", "eos", "swap"])
def test_spec_greedy_chunked_eos_and_swaps_equal_plain_and_jax(
        yi, plain_tokens, case):
    kw, reqs = dict(SPEC), _requests()
    if case == "chunked":
        kw.update(max_len=64, prefill_chunk=4)
        reqs = [(0, list(range(1, 25)), 6, None), (1, [5, 6, 7], 6, None)]
    elif case == "eos":
        kw.update(eos_id=plain_tokens[0][2])
    else:
        kw.update(n_pages=9, timeslice=3)
        reqs = _requests(5)
    plain_kw = {k: v for k, v in kw.items()
                if k in ("n_lanes", "max_len", "eos_id")}
    want_plain = _plain(yi, reqs, **plain_kw)
    got, want, eng, jeng = _both(yi, reqs, spec_k=2 if case == "swap" else 4,
                                 **kw)
    assert got == want == want_plain
    assert eng.spec_stats() == jeng.spec_stats()
    if case == "eos":
        assert want_plain != plain_tokens            # eos fired
    if case == "chunked":
        assert eng.prefill_chunks == jeng.prefill_chunks > 0
    if case == "swap":
        assert eng.scheduler.preemptions == jeng.scheduler.preemptions > 0
        assert eng.kv.swap_outs == eng.kv.swap_ins > 0
    _zero_leak(eng.kv)


def test_sampled_spec_equals_jax_tokens(yi):
    """Sampled speculation on stated seeds: the JAX engine's tokens (the
    draws are keyed by (seed, emission index, stream) in both)."""
    reqs = [(i, [3 + i, 1, 4, 1], 6, dict(temperature=0.8, top_k=50,
                                          seed=7 + i)) for i in range(3)]
    got, want, eng, jeng = _both(yi, reqs, spec_k=2, **SPEC)
    assert got == want
    assert all(len(toks) == 6 for toks in got.values())
    assert eng.spec_stats() == jeng.spec_stats()


PSZ = 8
SHARED = [50 + i for i in range(2 * PSZ)]       # 2 exact pages


def _shared_requests(n=3, max_new=5):
    """Requests behind a 16-token (2-page) system prompt; the last one is
    the prefix alone (a page-aligned full hit: the COW path)."""
    reqs = [(i, SHARED + [70 + 3 * i, 71 + 3 * i, 72 + 3 * i], max_new, None)
            for i in range(n)]
    return reqs + [(n, list(SHARED), max_new, None)]


@pytest.fixture(scope="module")
def shared_tokens(yi):
    return _plain(yi, _shared_requests(), n_lanes=2, max_len=64)


PREFIX = dict(n_lanes=2, max_len=64, cache="paged", page_size=PSZ)


@pytest.mark.parametrize("chunk", [4, 8])
def test_prefix_cache_on_equals_off_and_jax(yi, shared_tokens, chunk):
    off = _plain(yi, _shared_requests(), prefill_chunk=chunk, **PREFIX)
    got, want, eng, jeng = _both(yi, _shared_requests(), prefill_chunk=chunk,
                                 prefix_cache=True, **PREFIX)
    assert got == want == off == shared_tokens
    st = eng.kv.stats()["prefix"]
    assert st == jeng.kv.stats()["prefix"]
    assert st["hits"] >= 2 and st["hit_tokens"] > 0 and st["cow_copies"] >= 1
    assert eng.prefill_chunks == jeng.prefill_chunks
    _zero_leak(eng.kv)


def test_repeated_prompt_skips_prefill_chunks(yi):
    reqs = [(i, SHARED + [80, 81, 82], 4, None) for i in range(2)]
    kw = dict(PREFIX, n_lanes=1, prefill_chunk=4)
    cold, cold_eng = _run(ServingEngine, Request, SamplingParams,
                          dict(model=yi["model"], params=yi["params"], **kw),
                          reqs)
    got, want, warm, jwarm = _both(yi, reqs, prefix_cache=True, **kw)
    assert got == want == cold
    assert warm.prefill_chunks < cold_eng.prefill_chunks
    assert warm.prefill_chunks == jwarm.prefill_chunks
    by_rid = {r.rid: r for r in warm.finished}
    assert (by_rid[0].cached_tokens, by_rid[1].cached_tokens) == (0, 16)
    m = warm.metrics.summary()["prefix_cache"]
    assert m["hit_tokens"] == 16 and m["hit_rate"] == 0.5


@pytest.mark.parametrize("case", ["pressure-swaps", "speculative"])
def test_prefix_cache_under_swaps_and_speculation(yi, shared_tokens, case):
    if case == "pressure-swaps":
        reqs = _shared_requests(4)
        kw = dict(PREFIX, n_pages=13, prefill_chunk=8, timeslice=3,
                  prefix_cache=True)
        got, want, eng, jeng = _both(yi, reqs, max_steps=600, **kw)
        assert got == want == _plain(yi, reqs, n_lanes=2, max_len=64)
        assert eng.scheduler.preemptions == jeng.scheduler.preemptions > 0
        assert eng.kv.swap_outs == eng.kv.swap_ins > 0
    else:
        reqs = _shared_requests()
        got, want, eng, jeng = _both(yi, reqs, spec_k=2, prefill_chunk=8,
                                     prefix_cache=True, **PREFIX)
        assert got == want == shared_tokens
        assert eng.spec_ticks > 0
    assert eng.kv.stats()["prefix"] == jeng.kv.stats()["prefix"]
    assert eng.kv.stats()["prefix"]["hits"] > 0
    st = eng.kv.stats()
    assert st["free_pages"] + st["cached_pages"] == eng.kv.n_pages - 1
    _zero_leak(eng.kv)


def test_engine_required_arguments(yi):
    model, params = yi["model"], yi["params"]
    draft = dict(draft_model=yi["draft"], draft_params=yi["dparams"])
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, params, n_lanes=1, max_len=32, spec_k=2, **draft)
    with pytest.raises(ValueError, match="draft"):
        ServingEngine(model, params, n_lanes=1, max_len=32, cache="paged",
                      spec_k=2)
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(model, params, n_lanes=1, max_len=32, cache="paged",
                      spec_k=0, **draft)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(model, params, n_lanes=1, max_len=32, cache="paged",
                      prefix_cache=True)
    eng = ServingEngine(model, params, n_lanes=1, max_len=32)
    st = eng.spec_stats()
    assert st["spec_k"] is None and st["accept_rate"] == 0.0


# --------------------------------------------------------------------------
# the serve entry point
# --------------------------------------------------------------------------


def test_serve_draft_and_prefix_cache_on_cpu():
    base = dict(n_requests=4, n_lanes=2, max_new=4, cache="paged",
                prefill_chunk=8, device="cpu")
    spec = serve_config(ServeConfig(draft=True, spec_k=2, num_splits=4,
                                    **base))
    plain = serve_config(ServeConfig(**base))
    assert spec["finished"] == 4 and spec["spec"]["spec_k"] == 2
    assert spec["spec"]["spec_ticks"] == spec["decode_steps"] > 0
    assert spec["outputs"] == plain["outputs"]
    # the target as its own draft: its greedy drafts are accepted
    model = build_model(get_arch("yi-6b").reduced())
    params = model.init(0, "cpu")
    self_draft = model.draft_model(depth_frac=1.0)
    engine = ServingEngine(
        model, params, n_lanes=2, max_len=ServeConfig.max_len, cache="paged",
        prefill_chunk=8, draft_model=self_draft,
        draft_params=model.slice_draft_params(params, self_draft), spec_k=2)
    full = serve_engine(engine, ServeConfig(draft=True, spec_k=2, **base))
    assert full["outputs"] == plain["outputs"]
    assert full["spec"]["accept_rate"] > 0.9
    assert full["decode_steps"] < plain["decode_steps"]
    assert plain["spec"] is None and plain["prefix_cache"] is None
    reports = [serve_config(ServeConfig(prefix_cache=cache, shared_prefix=16,
                                        **base)) for cache in (True, False)]
    on, off = reports
    assert on["outputs"] == off["outputs"]
    assert on["prefix_cache"]["hit_requests"] >= 1
    assert on["prefix_cache"]["pages_saved"] >= 2
    assert on["prefill_chunks"] < off["prefill_chunks"]
    assert on["config"]["shared_prefix"] == 16

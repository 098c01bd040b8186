"""The port's paged KV serving against the JAX package on the CPU, at the
reduced configs (float32 compute and cache).

Mirrors ``test_paged_serving.py`` and ``test_chunked_prefill.py``:

* the plain paged attention (``paged_decode_ref``, ``paged_prefill_ref``)
  against the JAX oracles and the JAX Pallas kernels in interpret mode,
  on shuffled page tables with page 0 past ``kv_len``, GQA groupings, a
  chunk starting mid-page and a ragged last chunk, at 1e-5;
* the paged decode and prefill-chunk steps against the JAX model on the
  same weights (``params_from_jax``), live rows only, at 1e-4;
* the page pool's accounting, growth, swap and masking;
* greedy tokens through the two engines, identical, without chunking and
  with chunks of 4, 8 and 64 (64 runs past the page table's last block),
  and under page pressure that forces swap-out and swap-in, mid-prefill
  too.

Idle and masked lanes write the null page 0 at colliding indices, where
which write wins is undefined on both sides; those rows are never
compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_paged_decode as jax_paged_decode
from repro.kernels.flash_attention import flash_paged_prefill as jax_paged_prefill
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model
from repro_torch.serving import (NULL_PAGE, PagedKVCache, Request,
                                 ServingEngine, make_kv_cache)

torch.set_num_threads(1)

ARCH_IDS = ["yi-6b", "deepseek-7b"]
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def shuffled_table(b, nblk, n_pages, kv_len, psz, seed):
    """Distinct physical pages per sequence, in shuffled order; entries
    past ceil(kv_len / psz) point at the null page."""
    pages = np.random.default_rng(seed).permutation(
        np.arange(1, n_pages))[:b * nblk].reshape(b, nblk).astype(np.int32)
    for i, n in enumerate(kv_len):
        pages[i, -(-int(n) // psz):] = NULL_PAGE
    return pages


# --------------------------------------------------------------------------
# plain paged attention against the JAX oracles and Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 1), (4, 4)])
def test_paged_decode_matches_jax_ref_and_kernel(h, hkv):
    b, d, psz, n_pages, nblk = 3, 16, 8, 16, 4
    kv_len = np.array([20, 13, 32], np.int32)
    q = rand((b, h, 1, d), 1, 0.4)
    kp = rand((n_pages, hkv, psz, d), 2, 0.4)
    vp = rand((n_pages, hkv, psz, d), 3)
    table = shuffled_table(b, nblk, n_pages, kv_len, psz, 4)
    got = ops.paged_decode(t(q), ops.PagedPools(t(kp), t(vp)), t(table),
                           t(kv_len)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_ref.paged_decode_ref(q, kp, vp, table, kv_len)),
        **KERNEL_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_paged_decode(q, kp, vp, jnp.asarray(table),
                                         jnp.asarray(kv_len),
                                         interpret=True)), **KERNEL_TOL)


@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 1)])
@pytest.mark.parametrize("case", ["first-chunk", "mid-page", "ragged"])
def test_paged_prefill_matches_jax_ref_and_kernel(h, hkv, case):
    """Two sequences, one chunk of C=8 each: lane 1 always starts at 0
    with a full chunk; lane 0 starts at 0, mid-page (12) or at 16 with
    only 5 valid rows (the ragged last chunk of a prompt)."""
    b, c, d, psz, n_pages, nblk = 2, 8, 16, 8, 12, 4
    start = np.array({"first-chunk": [0, 0], "mid-page": [12, 0],
                      "ragged": [16, 0]}[case], np.int32)
    kv_len = start + np.array([5 if case == "ragged" else c, c], np.int32)
    q = rand((b, h, c, d), 5, 0.4)
    kp = rand((n_pages, hkv, psz, d), 6, 0.4)
    vp = rand((n_pages, hkv, psz, d), 7)
    table = shuffled_table(b, nblk, n_pages, kv_len, psz, 8)
    got = ops.paged_prefill(t(q), ops.PagedPools(t(kp), t(vp)), t(table),
                            t(start), t(kv_len)).numpy()
    want_ref = np.asarray(jax_ref.paged_prefill_ref(q, kp, vp, table, start,
                                                    kv_len))
    np.testing.assert_allclose(got, want_ref, **KERNEL_TOL)
    want = np.asarray(jax_paged_prefill(
        q, kp, vp, jnp.asarray(table), jnp.asarray(start),
        jnp.asarray(kv_len), interpret=True))
    for i in range(b):          # rows at positions >= kv_len are padding
        rows = int(kv_len[i] - start[i])
        np.testing.assert_allclose(got[i, :, :rows], want[i, :, :rows],
                                   **KERNEL_TOL)


def test_paged_refs_equal_the_dense_refs_on_gathered_pages():
    """A paged pool seen through its table is the dense cache it holds."""
    b, h, hkv, d, psz, nblk = 2, 4, 2, 16, 8, 3
    kd = rand((b, hkv, nblk * psz, d), 9)
    vd = rand((b, hkv, nblk * psz, d), 10)
    table = np.array([[3, 7, 1], [5, 2, 6]], np.int32)
    kp = np.zeros((9, hkv, psz, d), np.float32)
    vp = np.zeros_like(kp)
    for i in range(b):
        for blk in range(nblk):
            kp[table[i, blk]] = kd[i, :, blk * psz:(blk + 1) * psz]
            vp[table[i, blk]] = vd[i, :, blk * psz:(blk + 1) * psz]
    kv_len = t(np.array([20, 13], np.int32))
    q = t(rand((b, h, 1, d), 11))
    np.testing.assert_allclose(
        ref.paged_decode_ref(q, t(kp), t(vp), t(table), kv_len).numpy(),
        ref.decode_ref(q, t(kd), t(vd), kv_len).numpy(), **KERNEL_TOL)
    qc = t(rand((1, h, 6, d), 12))
    got = ref.paged_prefill_ref(qc, t(kp), t(vp), t(table[:1]),
                                t(np.array([10])), t(np.array([16])))
    want = ref.attention_ref(qc, t(kd[:1, :, :16]), t(vd[:1, :, :16]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **KERNEL_TOL)


def test_paged_dispatch_on_cpu_and_what_it_rejects():
    q = t(rand((1, 2, 1, 8), 13))
    pools = ops.PagedPools(t(rand((5, 1, 4, 8), 14)), t(rand((5, 1, 4, 8), 15)))
    table, kv_len = t(np.array([[1, 2]], np.int32)), t(np.array([6]))
    np.testing.assert_array_equal(
        ops.paged_decode(q, pools, table, kv_len).numpy(),
        ref.paged_decode_ref(q, pools.k, pools.v, table, kv_len).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode(q, pools, table, kv_len, use_kernel=True)
    # split-KV decode is the same function: the plain version ignores it
    np.testing.assert_array_equal(
        ops.paged_decode(q, pools, table, kv_len, num_splits=2).numpy(),
        ref.paged_decode_ref(q, pools.k, pools.v, table, kv_len).numpy())
    with pytest.raises(NotImplementedError, match="item 5"):
        ops.paged_prefill(q, pools, table, kv_len - 1, kv_len, num_splits=2)
    with pytest.raises(NotImplementedError, match="item 10"):
        ops.paged_prefill(q, pools, table, kv_len - 1, kv_len, mesh=object())
    with pytest.raises(ValueError, match="k_scale without v_scale"):
        ops.paged_decode(q, ops.PagedPools(pools.k, pools.v,
                                           pools.k[..., 0]), table, kv_len)


# --------------------------------------------------------------------------
# model steps against the JAX model on the same weights
# --------------------------------------------------------------------------


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
def jax_steps(pair):
    """The JAX engine's jitted monolithic prefill and paged decode step,
    shared by every JAX engine of one arch."""
    jmodel = pair[0]
    return dict(decode_fn=jax.jit(jmodel.paged_decode_step),
                prefill_fn=jax.jit(jmodel.prefill, static_argnums=(3,)))


def _assert_pages_equal(caches, jcaches, pages):
    for got, want in zip(caches["kv"], jcaches["kv"]):
        np.testing.assert_allclose(got[:, pages].numpy(),
                                   np.asarray(want)[:, pages], **TOL)


def test_paged_prefill_chunks_then_decode_match_jax(pair):
    """A 13-token prompt as chunks of 8 (the second ragged) into a 2-block
    table, then decode steps: the second chunk's padded positions run past
    the table's last block (the clamp before the lookup), and the decode
    crosses into a page allocated on the way."""
    jmodel, jparams, model, params = pair
    n_pages, psz = 10, 8
    jcaches = jmodel.init_paged_caches(n_pages, psz)
    caches = model.init_paged_caches(n_pages, psz, device="cpu")
    table = np.array([[7, 3]], np.int32)
    prompt = [(5 * j) % 200 + 3 for j in range(13)]
    for start in (0, 8):
        end = min(start + 8, len(prompt))
        chunk = np.array([prompt[start:end] + [0] * (8 - (end - start))],
                         np.int32)
        args = (table, chunk, np.array([start], np.int32),
                np.array([end], np.int32),
                np.array([end - start - 1], np.int32))
        jlogits, jcaches = jmodel.paged_prefill_step(jparams, jcaches, *args)
        logits, caches = model.paged_prefill_step(
            params, caches, *(t(a) for a in args))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _assert_pages_equal(caches, jcaches, [7, 3])
    table = np.array([[7, 3, 5]], np.int32)
    tok = int(np.argmax(np.asarray(jlogits)[0]))
    for pos in range(13, 18):
        args = (table, np.array([[tok]], np.int32), np.array([pos], np.int32))
        jlogits, jcaches = jmodel.paged_decode_step(jparams, jcaches, *args)
        logits, caches = model.paged_decode_step(
            params, caches, *(t(a) for a in args))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        tok = int(np.argmax(np.asarray(jlogits)[0]))
    _assert_pages_equal(caches, jcaches, [7, 3, 5])


def test_batched_paged_decode_with_idle_lane_matches_jax(pair):
    """Lane 0 decodes from its own pages while lane 1 idles at pos 0 with
    a zeroed table row (writing the null page): lane 0's logits and pages
    agree, and lane 1 leaves them untouched."""
    jmodel, jparams, model, params = pair
    jcaches = jmodel.init_paged_caches(6, 4)
    caches = model.init_paged_caches(6, 4, device="cpu")
    table = np.array([[4, 2, 5], [0, 0, 0]], np.int32)
    for step in range(7):
        args = (table, np.array([[3 + step], [9]], np.int32),
                np.array([step, 0], np.int32))
        jlogits, jcaches = jmodel.paged_decode_step(jparams, jcaches, *args)
        logits, caches = model.paged_decode_step(
            params, caches, *(t(a) for a in args))
        np.testing.assert_allclose(logits[0].numpy(),
                                   np.asarray(jlogits)[0], **TOL)
    _assert_pages_equal(caches, jcaches, [4, 2])


# --------------------------------------------------------------------------
# the page pool
# --------------------------------------------------------------------------


def _pool(pair, **kw):
    model = pair[2]
    return model, PagedKVCache(model, device="cpu", **kw)


def test_paged_cache_accounting_and_null_page(pair):
    model, kv = _pool(pair, n_lanes=2, max_len=64, n_pages=17, page_size=8)
    params = pair[3]
    assert kv.free_pages == 16                  # page 0 reserved
    _, c1 = model.prefill(params, torch.tensor([[1, 2, 3]]),
                          kv.prefill_len(3))
    assert kv.prefill_len(3) == 8
    assert kv.admit(0, c1, 3)
    assert kv.used_pages == 1 and kv.cache_tokens() == 8
    assert NULL_PAGE not in kv.table[0, :kv.n_blocks[0]]
    page = int(kv.table[0, 0])
    for got, dense in zip(kv.caches["kv"], c1["kv"]):
        torch.testing.assert_close(got[:, page], dense[:, 0, :, :8])
    assert kv.ensure_capacity(0, 7) and kv.used_pages == 1
    assert kv.ensure_capacity(0, 8) and kv.used_pages == 2
    assert not kv.ensure_capacity(0, 64)        # past max_len
    assert kv.truncate_to(0, 8) == 1 and kv.used_pages == 1
    kv.release(0)
    assert kv.used_pages == 0 and kv.free_pages == 16
    stats = kv.stats()
    assert stats["kind"] == "paged" and stats["capacity_tokens"] == 128
    assert stats["pool_bytes"] == 2 * kv.caches["kv"][0].numel() * 4


def test_ensure_tokens_growth_and_partial_failure(pair):
    _, kv = _pool(pair, n_lanes=2, max_len=64, n_pages=9, page_size=8)
    assert kv.ensure_tokens(0, 6) and kv.used_pages == 1
    assert kv.ensure_tokens(0, 8) and kv.used_pages == 1
    assert kv.ensure_tokens(0, 20) and kv.used_pages == 3
    assert not kv.ensure_tokens(0, 65)          # beyond max_len
    kv.release(0)
    _, kv = _pool(pair, n_lanes=1, max_len=64, n_pages=3, page_size=8)
    assert not kv.can_admit(24)
    assert not kv.ensure_tokens(0, 24)          # needs 3, pool has 2
    assert kv.n_blocks[0] == 2                  # the pages taken stay
    assert kv.ensure_tokens(0, 16)              # a retry within them: ok


def test_swap_out_in_round_trips_onto_another_lane(pair):
    model, kv = _pool(pair, n_lanes=2, max_len=32, n_pages=9, page_size=8)
    _, c1 = model.prefill(pair[3], torch.tensor([[5, 6, 7, 8, 9, 10, 11, 12,
                                                  13]]), kv.prefill_len(9))
    kv.admit(0, c1, 9)
    pages = list(kv.table[0, :2])
    before = [pool[:, pages].clone() for pool in kv.caches["kv"]]
    handle = kv.swap_out(0)
    assert kv.used_pages == 0 and handle.n_blocks == 2
    assert [c.shape for c in handle.chunks] == [b.shape for b in before]
    for pool in kv.caches["kv"]:                # a later admission reuses
        pool[:, pages] = -1.0                   # the freed pages
    assert kv.swap_in(1, handle)
    assert kv.n_blocks[1] == 2 and kv.swap_outs == kv.swap_ins == 1
    for pool, want in zip(kv.caches["kv"], before):
        assert torch.equal(pool[:, list(kv.table[1, :2])], want)


def test_decode_extra_masks_prefill_lanes(pair):
    _, kv = _pool(pair, n_lanes=2, max_len=32, n_pages=9, page_size=8)
    kv.ensure_tokens(0, 8)
    kv.ensure_tokens(1, 8)
    (tbl,) = kv.decode_extra(mask_lanes=[0])
    assert tbl.dtype == torch.int32 and tbl.shape == (2, 4)
    assert int(tbl[0, 0]) == NULL_PAGE and int(tbl[1, 0]) != NULL_PAGE
    assert kv.table[0, 0] != NULL_PAGE          # backing table untouched
    assert make_kv_cache(pair[2], "paged", 4, 100, "cpu",
                         page_size=16).n_pages == 4 * 7 + 1


# --------------------------------------------------------------------------
# engines: greedy tokens identical to the JAX engine's
# --------------------------------------------------------------------------


def _run_both(pair, jax_steps, reqs, max_steps=400, **kw):
    jmodel, jparams, model, params = pair
    steps = jax_steps if kw.get("prefill_chunk") is None \
        else {"decode_fn": jax_steps["decode_fn"]}
    jeng = JaxEngine(jmodel, jparams, cache="paged", **steps, **kw)
    eng = ServingEngine(model, params, cache="paged", **kw)
    for rid, prompt, max_new in reqs:
        jeng.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=max_new))
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))
    want = {r.rid: r.out_tokens for r in jeng.run(max_steps=max_steps)}
    got = {r.rid: r.out_tokens for r in eng.run(max_steps=max_steps)}
    assert got == want
    assert all(len(got[rid]) == max_new for rid, _, max_new in reqs)
    assert eng.steps == jeng.steps
    assert eng.prefill_chunks == jeng.prefill_chunks
    assert eng.scheduler.preemptions == jeng.scheduler.preemptions
    return eng


def _requests(n=3, plen=11, max_new=6):
    return [(i, [1 + i] + [(3 * i + j) % 90 + 2 for j in range(plen - 1)],
             max_new) for i in range(n)]


@pytest.mark.parametrize("chunk", [None, 4, 8, 64])
def test_paged_engine_greedy_tokens_identical_to_jax(pair, jax_steps, chunk):
    """11-token prompts: chunk 4 leaves a ragged last chunk, chunk 64 is
    longer than the prompt and than max_len (its padded positions run
    past the 6-block table)."""
    eng = _run_both(pair, jax_steps, _requests(), n_lanes=2, max_len=48,
                    page_size=8, prefill_chunk=chunk)
    if chunk is not None:
        assert eng.prefill_chunks == 3 * -(-11 // chunk)


def test_paged_engine_swaps_under_page_pressure(pair, jax_steps):
    """Four requests on two lanes with time slices of 3 ticks and a pool of
    4 usable 8-token pages: sequences swap out and back in, by time
    slice and by page pressure, and still give the JAX engine's tokens."""
    reqs = [(i, [2 + i] + [(5 * i + j) % 80 + 3 for j in range(5 + 2 * i)],
             10) for i in range(4)]
    eng = _run_both(pair, jax_steps, reqs, n_lanes=2, max_len=48,
                    page_size=8, n_pages=5, timeslice=3)
    assert eng.scheduler.preemptions > 0
    assert eng.kv.swap_outs == eng.kv.swap_ins > 0
    assert eng.kv.used_pages == 0


def test_paged_engine_swaps_out_mid_prefill_then_resumes(pair, jax_steps,
                                                         monkeypatch):
    """Two 24-token prompts streamed in 8-token chunks into 5 usable pages:
    one lane is evicted while its prompt is still streaming in (partial
    pages go to the host), resumes mid-prefill and still gives the JAX
    engine's tokens."""
    phases = []
    preempt = ServingEngine._preempt_lane

    def spy(self, lane_id, priority=False):
        phases.append(self.scheduler.lanes[lane_id].phase)
        preempt(self, lane_id, priority)

    monkeypatch.setattr(ServingEngine, "_preempt_lane", spy)
    reqs = [(i, [(7 * i + j) % 100 + 1 for j in range(24)], 4)
            for i in range(2)]
    eng = _run_both(pair, jax_steps, reqs, n_lanes=2, max_len=64,
                    page_size=8, n_pages=6, prefill_chunk=8)
    assert eng.scheduler.preemptions > 0
    assert "prefill" in phases


@pytest.mark.parametrize("chunk", [None, 8])
def test_page_pool_too_small_raises(pair, chunk):
    """One sequence that outgrows the whole pool: nothing to evict."""
    model, params = pair[2], pair[3]
    eng = ServingEngine(model, params, n_lanes=1, max_len=64, cache="paged",
                        page_size=8, n_pages=3, prefill_chunk=chunk)
    eng.submit(Request(rid=0, prompt=list(range(1, 13)), max_new_tokens=10))
    with pytest.raises(RuntimeError, match="page pool too small"):
        eng.run(max_steps=50)

"""The port's int8 KV pages and split-KV decode against the JAX package on
the CPU, at the reduced configs (float32 compute).

Mirrors ``test_quant_kv.py`` and ``test_split_kv.py``:

* the int8 quantizers: codes and scales equal to the JAX package's, zero
  rows to 0, round-trip error within half a step;
* the split-KV plain versions (``combine_split_states``,
  ``paged_decode_split_ref``) against the JAX oracles and the JAX Pallas
  kernels in interpret mode, over split counts and GQA groupings, an
  all-empty row giving exactly 0, at 1e-5;
* the int8 plain paged decode and prefill against the JAX quantized
  Pallas kernels in interpret mode, at 1e-5;
* the int8 paged prefill-chunk and decode steps against the JAX model on
  the same weights, logits at 1e-4, int8 codes within one step on a
  stated count (the JAX steps run jitted, where XLA turns ``amax / 127``
  into a multiply by the reciprocal, so a scale may differ in its last
  bit and a code on a rounding boundary may flip);
* the int8 pool's bytes, swaps and the fp swap compression;
* greedy tokens of the int8 engines identical to the JAX int8 engine's,
  without and with chunked prefill and under swaps; int8 against fp
  agreement; greedy tokens the same for every ``num_splits``.

Inputs are made with numpy from seeds and handed to both packages.  Rows
of the null page 0, which idle and masked lanes write at colliding
indices, are never compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.distributed import compression as jax_compression
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_paged_decode as jax_paged_decode
from repro.kernels.flash_attention import \
    flash_paged_decode_quant as jax_paged_decode_quant
from repro.kernels.flash_attention import \
    flash_paged_prefill_quant as jax_paged_prefill_quant
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.distributed import compression
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import ServeConfig, serve_config
from repro_torch.models import build_model
from repro_torch.serving import (NULL_PAGE, PagedKVCache, Request,
                                 ServingEngine, make_kv_cache)
from repro_torch.serving.kvcache import DenseKVCache, PackedTree

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


def quantized_pools(n_pages, hkv, psz, d, seed):
    """int8 k/v pools and their scales from seeded fp32 pools, through the
    port's quantizer (whose codes equal the JAX package's, tested below)."""
    out = []
    for i, scale in enumerate((0.4, 1.0)):
        codes, s = compression.quantize_int8_rows(
            t(rand((n_pages, hkv, psz, d), seed + i, scale)))
        out.append((codes.numpy(), s.numpy()))
    (k8, ks), (v8, vs) = out
    return k8, v8, ks, vs


# --------------------------------------------------------------------------
# the int8 quantizers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_quantize_matches_jax_codes_and_scales(seed):
    x = rand((6, 5, 32), seed, 10.0 ** (seed - 1))
    x[1, 2] = 0.0                                  # a zero row
    x[4] *= 1e3                                    # a skewed row
    codes, scale = compression.quantize_int8_rows(t(x))
    jcodes, jscale = jax_compression.quantize_int8_rows(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    assert not codes[1, 2].any()
    back = compression.dequantize_int8_rows(codes, scale).numpy()
    assert not back[1, 2].any()                    # a zero row stays 0
    half_step = np.abs(x).max(-1, keepdims=True) / 254
    assert np.all(np.abs(back - x) <= half_step * (1 + 1e-5) + 1e-30)
    np.testing.assert_array_equal(
        back, np.asarray(jax_compression.dequantize_int8_rows(jcodes, jscale)))


@pytest.mark.parametrize("seed", [0, 1])
def test_tensor_quantize_matches_jax_codes_and_scale(seed):
    x = rand((7, 33), seed + 10, 3.0)
    codes, scale = compression.quantize_int8(t(x))
    jcodes, jscale = jax_compression.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert float(scale) == float(jscale)
    back = compression.dequantize_int8(codes, scale).numpy()
    assert np.all(np.abs(back - x) <= np.abs(x).max() / 254 * (1 + 1e-5))
    zero_codes, _ = compression.quantize_int8(torch.zeros(4, 4))
    assert not zero_codes.any()


# --------------------------------------------------------------------------
# the split-KV combine and the split decode
# --------------------------------------------------------------------------


def _segment_states(scores, values):
    """(m, l, acc) of one segment; an empty one is (-1e30, 0, 0)."""
    if scores.shape[-1] == 0:
        rows, d = scores.shape[0], values.shape[-1]
        return (np.full(rows, -1e30, np.float32), np.zeros(rows, np.float32),
                np.zeros((rows, d), np.float32))
    m = scores.max(axis=-1)
    p = np.exp(scores - m[..., None])
    return (m.astype(np.float32), p.sum(-1).astype(np.float32),
            (p @ values).astype(np.float32))


@pytest.mark.parametrize("seed,n,bounds", [
    (0, 16, [0, 4, 8, 16]),
    (1, 16, [0, 0, 16, 16]),          # leading and trailing empty segments
    (2, 7, [0, 2, 3, 5, 7]),          # ragged cuts
    (3, 1, [0, 1]),                   # one key, one segment
])
def test_combine_split_states_matches_jax_and_unsegmented(seed, n, bounds):
    rng = np.random.default_rng(seed)
    scores = (rng.normal(size=(2, n)) * 3.0).astype(np.float32)
    values = rng.normal(size=(n, 4)).astype(np.float32)
    states = [_segment_states(scores[:, a:b], values[a:b])
              for a, b in zip(bounds, bounds[1:])]
    m, l, acc = (np.stack([s[i] for s in states]) for i in range(3))
    got = ref.combine_split_states(t(m), t(l), t(acc))
    want = jax_ref.combine_split_states(jnp.asarray(m), jnp.asarray(l),
                                        jnp.asarray(acc))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    out = ref.finalize_split_states(got[1], got[2]).numpy()
    p = np.exp(scores - scores.max(-1, keepdims=True))
    np.testing.assert_allclose(out, (p / p.sum(-1, keepdims=True)) @ values,
                               rtol=1e-5, atol=1e-6)


def test_all_empty_splits_give_exactly_zero():
    empty = _segment_states(np.zeros((2, 0), np.float32),
                            np.zeros((0, 4), np.float32))
    m, l, acc = (t(np.stack([empty[i]] * 3)) for i in range(3))
    _, l_star, acc_star = ref.combine_split_states(m, l, acc)
    out = ref.finalize_split_states(l_star, acc_star)
    assert torch.equal(out, torch.zeros(2, 4))


@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 1), (4, 4)])
@pytest.mark.parametrize("ns", [1, 2, 3, 8])
def test_paged_decode_split_matches_jax_refs_and_kernel(h, hkv, ns):
    """Lanes of 20, 13, 32 (the whole table) and 0 keys; the JAX kernel
    clamps ns to its 4-page walk, the oracles split the table width."""
    b, d, psz, n_pages, nblk = 4, 16, 8, 20, 4
    kv_len = np.array([20, 13, 32, 0], np.int32)
    q = rand((b, h, 1, d), 1, 0.4)
    kp = rand((n_pages, hkv, psz, d), 2, 0.4)
    vp = rand((n_pages, hkv, psz, d), 3)
    table = shuffled_table(b, nblk, n_pages, kv_len, psz, 4)
    got = ref.paged_decode_split_ref(t(q), t(kp), t(vp), t(table),
                                     t(kv_len), ns).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_ref.paged_decode_split_ref(q, kp, vp, table,
                                                       kv_len, ns)),
        **KERNEL_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_paged_decode(q, kp, vp, jnp.asarray(table),
                                         jnp.asarray(kv_len), num_splits=ns,
                                         interpret=True)), **KERNEL_TOL)
    assert not got[3].any()                       # no key: exactly 0
    # the plain dispatch ignores num_splits on the CPU, like the JAX ops
    plain = ops.paged_decode(t(q), ops.PagedPools(t(kp), t(vp)), t(table),
                             t(kv_len), num_splits=ns).numpy()
    np.testing.assert_allclose(plain[:3], got[:3], **KERNEL_TOL)


# --------------------------------------------------------------------------
# int8 plain paged attention against the JAX quantized kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 1)])
@pytest.mark.parametrize("ns", [1, 2])
def test_int8_paged_decode_matches_jax_quant_kernel(h, hkv, ns):
    b, d, psz, n_pages, nblk = 3, 16, 8, 16, 4
    kv_len = np.array([20, 13, 32], np.int32)
    q = rand((b, h, 1, d), 5, 0.4)
    k8, v8, ks, vs = quantized_pools(n_pages, hkv, psz, d, 6)
    table = shuffled_table(b, nblk, n_pages, kv_len, psz, 8)
    pools = ops.PagedPools(t(k8), t(v8), t(ks), t(vs))
    assert pools.quantized
    got = ops.paged_decode(t(q), pools, t(table), t(kv_len),
                           num_splits=ns).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_ref.paged_decode_ref(q, k8, v8, table, kv_len,
                                                 k_scale=ks, v_scale=vs)),
        **KERNEL_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax_paged_decode_quant(
            q, k8, v8, ks, vs, jnp.asarray(table), jnp.asarray(kv_len),
            num_splits=ns, interpret=True)), **KERNEL_TOL)
    np.testing.assert_allclose(
        ref.paged_decode_split_ref(t(q), t(k8), t(v8), t(table), t(kv_len),
                                   ns, k_scale=t(ks), v_scale=t(vs)).numpy(),
        got, **KERNEL_TOL)


@pytest.mark.parametrize("case", ["first-chunk", "mid-page", "ragged"])
def test_int8_paged_prefill_matches_jax_quant_kernel(case):
    b, h, hkv, c, d, psz, n_pages, nblk = 2, 8, 2, 8, 16, 8, 12, 4
    start = np.array({"first-chunk": [0, 0], "mid-page": [12, 0],
                      "ragged": [16, 0]}[case], np.int32)
    kv_len = start + np.array([5 if case == "ragged" else c, c], np.int32)
    q = rand((b, h, c, d), 9, 0.4)
    k8, v8, ks, vs = quantized_pools(n_pages, hkv, psz, d, 10)
    table = shuffled_table(b, nblk, n_pages, kv_len, psz, 12)
    got = ops.paged_prefill(t(q), ops.PagedPools(t(k8), t(v8), t(ks), t(vs)),
                            t(table), t(start), t(kv_len)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_ref.paged_prefill_ref(
            q, k8, v8, table, start, kv_len, k_scale=ks, v_scale=vs)),
        **KERNEL_TOL)
    want = np.asarray(jax_paged_prefill_quant(
        q, k8, v8, ks, vs, jnp.asarray(table), jnp.asarray(start),
        jnp.asarray(kv_len), interpret=True))
    for i in range(b):          # rows at positions >= kv_len are padding
        rows = int(kv_len[i] - start[i])
        np.testing.assert_allclose(got[i, :, :rows], want[i, :, :rows],
                                   **KERNEL_TOL)


def test_int8_dispatch_on_cpu_and_what_it_rejects():
    q = t(rand((1, 2, 1, 8), 13))
    k8, v8, ks, vs = (t(a) for a in quantized_pools(5, 1, 4, 8, 14))
    table, kv_len = t(np.array([[1, 2]], np.int32)), t(np.array([6]))
    with pytest.raises(ValueError, match="k_scale without v_scale"):
        ops.paged_decode(q, ops.PagedPools(k8, v8, ks, None), table, kv_len)
    pools = ops.PagedPools(k8, v8, ks, vs)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode(q, pools, table, kv_len, use_kernel=True)
    np.testing.assert_array_equal(
        ops.paged_prefill(q, pools, table, kv_len - 1, kv_len,
                          num_splits=2).numpy(),
        ref.paged_prefill_ref(q, k8, v8, table, kv_len - 1, kv_len,
                              k_scale=ks, v_scale=vs).numpy())
    np.testing.assert_array_equal(
        ops.paged_decode(q, pools, table, kv_len, num_splits=4).numpy(),
        ref.paged_decode_ref(q, k8, v8, table, kv_len, k_scale=ks,
                             v_scale=vs).numpy())


# --------------------------------------------------------------------------
# int8 model steps against the JAX model on the same weights
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


def _assert_int8_pages_close(caches, jcaches, pages, label):
    """Codes within one step (count printed), scales and dequantized rows
    within float32 rounding."""
    flipped = 0
    for got, want in zip(caches["kv"], jcaches["kv"]):
        diff = np.abs(got[:, pages].numpy().astype(np.int32)
                      - np.asarray(want)[:, pages].astype(np.int32))
        assert diff.max() <= 1, label
        flipped += int((diff > 0).sum())
    for got, want in zip(caches["kv_scale"], jcaches["kv_scale"]):
        np.testing.assert_allclose(got[:, pages].numpy(),
                                   np.asarray(want)[:, pages], rtol=1e-6)
    total = sum(c[:, pages].numel() for c in caches["kv"])
    print(f"{label}: {flipped} of {total} int8 codes differ by one step")
    assert flipped <= total // 1000


def test_int8_paged_prefill_chunks_then_decode_match_jax(pair):
    """A 13-token prompt as chunks of 8 (the second ragged, past the
    table's last block) into int8 pools, then decode steps across a page
    boundary, both packages' steps jitted or eager as their engines run
    them: logits at 1e-4, codes within one step."""
    jmodel, jparams, model, params = pair
    n_pages, psz = 10, 8
    jcaches = jmodel.init_paged_caches(n_pages, psz, quantized=True)
    caches = model.init_paged_caches(n_pages, psz, device="cpu",
                                     quantized=True)
    assert caches["kv"][0].dtype == torch.int8
    assert caches["kv_scale"][0].shape == (model.cfg.n_layers, n_pages,
                                           model.cfg.n_kv_heads, psz)
    jprefill = jax.jit(jmodel.paged_prefill_step)
    jdecode = jax.jit(jmodel.paged_decode_step)
    table = np.array([[7, 3]], np.int32)
    prompt = [(5 * j) % 200 + 3 for j in range(13)]
    for start in (0, 8):
        end = min(start + 8, len(prompt))
        chunk = np.array([prompt[start:end] + [0] * (8 - (end - start))],
                         np.int32)
        args = (table, chunk, np.array([start], np.int32),
                np.array([end], np.int32),
                np.array([end - start - 1], np.int32))
        jlogits, jcaches = jprefill(jparams, jcaches, *args)
        logits, caches = model.paged_prefill_step(
            params, caches, *(t(a) for a in args))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _assert_int8_pages_close(caches, jcaches, [7, 3], "prefill")
    table = np.array([[7, 3, 5]], np.int32)
    tok = int(np.argmax(np.asarray(jlogits)[0]))
    for pos in range(13, 18):
        args = (table, np.array([[tok]], np.int32), np.array([pos], np.int32))
        jlogits, jcaches = jdecode(jparams, jcaches, *args)
        logits, caches = model.paged_decode_step(
            params, caches, *(t(a) for a in args), num_splits=2)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        tok = int(np.argmax(np.asarray(jlogits)[0]))
    _assert_int8_pages_close(caches, jcaches, [7, 3, 5], "decode")


# --------------------------------------------------------------------------
# the int8 page pool: bytes, admission, swaps
# --------------------------------------------------------------------------


def test_int8_pool_bytes_and_what_it_rejects(pair):
    model = pair[2]
    fp = PagedKVCache(model, 2, 64, 9, 8, "cpu")
    q8 = PagedKVCache(model, 2, 64, 9, 8, "cpu", kv_dtype="int8")
    sf, s8 = fp.stats(), q8.stats()
    assert (sf["kv_dtype"], s8["kv_dtype"]) == ("fp", "int8")
    assert s8["pool_bytes"] < sf["pool_bytes"] / 2
    assert s8["kv_bytes_per_token"] < sf["kv_bytes_per_token"] / 2
    assert s8["capacity_tokens"] == sf["capacity_tokens"]
    assert s8["pool_bytes"] == sum(
        x.numel() * x.element_size()
        for x in q8.caches["kv"] + q8.caches["kv_scale"])
    with pytest.raises(ValueError, match="paged"):
        make_kv_cache(model, "dense", 1, 32, "cpu", kv_dtype="int8")
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedKVCache(model, 1, 32, 5, 8, "cpu", kv_dtype="int4")


def test_int8_admit_quantizes_the_prefill_caches(pair):
    model, params = pair[2], pair[3]
    kv = PagedKVCache(model, 2, 32, 9, 8, "cpu", kv_dtype="int8")
    _, c1 = model.prefill(params, torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8, 9]]),
                          kv.prefill_len(9))
    assert kv.admit(0, c1, 9)
    pages = list(kv.table[0, :2])
    for pool, scale, dense in zip(kv.caches["kv"], kv.caches["kv_scale"],
                                  c1["kv"]):
        l, _, hkv, _, d = dense.shape
        rows = dense[:, 0].reshape(l, hkv, 2, 8, d).transpose(1, 2)
        codes, s = compression.quantize_int8_rows(rows)
        assert torch.equal(pool[:, pages], codes)
        assert torch.equal(scale[:, pages], s)
    # the rest of the pool is untouched: zero codes, zero scales
    assert not kv.caches["kv_scale"][0][:, [p for p in range(9)
                                            if p not in pages]].any()


def test_int8_swap_round_trip_is_bit_exact_and_compact(pair):
    model, params = pair[2], pair[3]
    _, pre = model.prefill(params, torch.tensor([[1, 2, 3, 4, 5]]), 8)
    sizes = {}
    for kd in ("fp", "int8"):
        kv = PagedKVCache(model, 2, 32, 9, 8, "cpu", kv_dtype=kd)
        assert kv.admit(0, pre, 5)
        pages = list(kv.table[0, :kv.n_blocks[0]])
        before = [leaf[:, pages].clone() for leaf in kv._leaves()]
        handle = kv.swap_out(0)
        sizes[kd] = handle.host_bytes()
        if kd == "int8":
            assert handle.packed is None
            assert [c.dtype for c in handle.chunks] == [np.int8, np.int8,
                                                        np.float32, np.float32]
        for leaf in kv._leaves():                 # a later admission
            leaf[:, pages] = 1                    # reuses the freed pages
        assert kv.swap_in(1, handle)
        fresh = list(kv.table[1, :kv.n_blocks[1]])
        for leaf, want in zip(kv._leaves(), before):
            assert torch.equal(leaf[:, fresh], want)
        assert kv.swap_outs == kv.swap_ins == 1
    assert sizes["int8"] < sizes["fp"] / 2


@pytest.mark.parametrize("cache", ["paged", "dense"])
def test_fp_swap_compress_packs_and_round_trips(pair, cache):
    """Opt-in fp swap compression: an int8 PackedTree under a third of
    the float32 bytes, back within amax / 120 (not bit-exact)."""
    model, params = pair[2], pair[3]
    kv = make_kv_cache(model, cache, 1, 32, "cpu", n_pages=5, page_size=8,
                       swap_compress=True)
    _, pre = model.prefill(params, torch.tensor([[1, 2, 3, 4, 5]]),
                           kv.prefill_len(5))
    assert kv.admit(0, pre, 5)
    if cache == "paged":
        pages = list(kv.table[0, :kv.n_blocks[0]])
        read = lambda: [p[:, pages].clone() for p in kv.caches["kv"]]  # noqa: E731
    else:
        read = lambda: [c[:, 0].clone() for c in kv.caches["kv"]]  # noqa: E731
    before = read()
    raw = sum(x.numel() * 4 for x in before)
    handle = kv.swap_out(0)
    packed = handle if cache == "dense" else handle.packed
    assert isinstance(packed, PackedTree)
    assert packed.host_bytes() < raw / 3
    assert kv.swap_in(0, handle)
    if cache == "paged":
        pages = list(kv.table[0, :kv.n_blocks[0]])
    for b, a in zip(before, read()):
        bound = max(float(b.abs().max()) / 120.0, 1e-6)
        assert float((a - b).abs().max()) <= bound


def test_int8_pool_ignores_swap_compress(pair):
    model = pair[2]
    kv = make_kv_cache(model, "paged", 1, 32, "cpu", n_pages=5, page_size=8,
                       kv_dtype="int8", swap_compress=True)
    assert kv.swap_compress is False
    assert isinstance(DenseKVCache(model, 1, 8, "cpu", swap_compress=True),
                      DenseKVCache)


# --------------------------------------------------------------------------
# engines: greedy tokens identical to the JAX int8 engine's
# --------------------------------------------------------------------------


def _requests(n=3, plen=11, max_new=6):
    return [(i, [1 + i] + [(3 * i + j) % 90 + 2 for j in range(plen - 1)],
             max_new) for i in range(n)]


def _run_both(pair, jax_steps, reqs, max_steps=400, **kw):
    jmodel, jparams, model, params = pair
    steps = jax_steps if kw.get("prefill_chunk") is None \
        else {"decode_fn": jax_steps["decode_fn"]}
    jeng = JaxEngine(jmodel, jparams, cache="paged", kv_dtype="int8",
                     **steps, **kw)
    eng = ServingEngine(model, params, cache="paged", kv_dtype="int8", **kw)
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
    assert eng.kv.stats()["kv_dtype"] == "int8"
    return eng


@pytest.mark.parametrize("chunk", [None, 4, 8])
def test_int8_engine_greedy_tokens_identical_to_jax(pair, jax_steps, chunk):
    eng = _run_both(pair, jax_steps, _requests(), n_lanes=2, max_len=48,
                    page_size=8, prefill_chunk=chunk)
    if chunk is not None:
        assert eng.prefill_chunks == 3 * -(-11 // chunk)


def test_int8_engine_swaps_identical_to_jax(pair, jax_steps):
    """Four requests on two lanes, time slices of 3 ticks, 4 usable pages:
    int8 pages and scales swap out and back in, by time slice and by page
    pressure, and the tokens stay the JAX engine's."""
    reqs = [(i, [2 + i] + [(5 * i + j) % 80 + 3 for j in range(5 + 2 * i)],
             10) for i in range(4)]
    eng = _run_both(pair, jax_steps, reqs, n_lanes=2, max_len=48,
                    page_size=8, n_pages=5, timeslice=3)
    assert eng.scheduler.preemptions > 0
    assert eng.kv.swap_outs == eng.kv.swap_ins > 0
    assert eng.kv.used_pages == 0


def test_int8_engine_agrees_with_fp_engine(pair):
    """The quality floor of the JAX package's KVPrecision guard: int8
    greedy tokens agree with fp ones on at least 95%."""
    model, params = pair[2], pair[3]
    outs = {}
    for kd in ("fp", "int8"):
        eng = ServingEngine(model, params, n_lanes=2, max_len=48,
                            cache="paged", page_size=8, kv_dtype=kd)
        for rid in range(3):
            eng.submit(Request(rid=rid, prompt=[1 + rid, 2, 3, 4],
                               max_new_tokens=6))
        outs[kd] = {r.rid: r.out_tokens for r in eng.run(max_steps=60)}
    match = sum(a == b for rid, toks in outs["fp"].items()
                for a, b in zip(toks, outs["int8"][rid]))
    assert match / 18 >= 0.95


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_greedy_tokens_identical_across_num_splits(pair, kv_dtype):
    """Split-KV changes the schedule of the decode, never its tokens."""
    model, params = pair[2], pair[3]
    outs = []
    for ns in (None, 1, 2, 4):
        eng = ServingEngine(model, params, n_lanes=2, max_len=48,
                            cache="paged", page_size=8, prefill_chunk=4,
                            kv_dtype=kv_dtype, num_splits=ns)
        for rid, prompt, max_new in _requests():
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))
        outs.append({r.rid: r.out_tokens for r in eng.run(max_steps=100)})
    assert outs[0] == outs[1] == outs[2] == outs[3]
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, params, n_lanes=2, max_len=48, num_splits=2)


def test_serve_int8_split_on_cpu_and_kv_dtype_auto_raises():
    out = serve_config(ServeConfig(n_requests=3, n_lanes=2, max_new=4,
                                   cache="paged", prefill_chunk=8,
                                   kv_dtype="int8", num_splits=8,
                                   device="cpu"))
    assert out["finished"] == 3 and out["kv_dtype"] == "int8"
    assert out["cache"]["kv_dtype"] == "int8"
    assert out["config"]["num_splits"] == 8
    # auto is run-time tuning's choice: it needs the tuner, as in JAX
    with pytest.raises(ValueError, match="autotune"):
        serve_config(ServeConfig(cache="paged", kv_dtype="auto",
                                 device="cpu"))
    with pytest.raises(ValueError, match="kv_dtype"):
        serve_config(ServeConfig(cache="paged", kv_dtype="int4",
                                 device="cpu"))

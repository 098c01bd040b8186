"""The port's ring attention, ``ops.attention``'s ring route and
``compressed_psum`` over ``torch.distributed`` worlds on the CPU (gloo),
against the JAX package.

* worlds of 2 and 4 ranks (1x2, 1x4, and 2x2 with the batch split over
  ``data``): the ring's output against the JAX ``ref.attention_ref`` on
  the same numpy inputs, causal and not, within rtol and atol 2e-4 (the
  JAX test's); per rank ``n - 1`` block sends and one all-gather, of the
  output (no K/V all-gather);
* ``ring_collective_bytes`` equal to the JAX package's;
* ``ops.attention``'s routing: the reference's conditions (a model axis
  of more than one rank, causal, no window, self-attention, a length the
  axis divides, above ``CHUNKED_THRESHOLD``), and on a 1x2 world a GQA
  attention of 2064 queries through the ring against the plain route,
  and reduced yi-6b's prefill of 2064 tokens against the unsharded
  port's logits within 2e-4;
* ``compressed_psum`` on a world of 2: within ``2 * amax / 127`` of the
  exact sum, and within 1e-6 of the sum of the JAX package's per-rank
  ``dequantize_int8(quantize_int8(x_r))``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.distributed.compression import (compress_roundtrip_error,
                                           dequantize_int8, quantize_int8)
from repro.distributed.ring_attention import \
    ring_collective_bytes as jax_ring_bytes
from repro.kernels import ref as jax_ref
from repro.models import build_model as jax_build_model
from repro_torch.distributed import Mesh, compression, run_world
from repro_torch.distributed.ring_attention import ring_collective_bytes
from repro_torch.kernels import ops

import torch_mesh_workers as workers

TOL = dict(rtol=2e-4, atol=2e-4)


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


RING_CASES = [(rand((2, 3, 32, 16), 1), rand((2, 3, 32, 16), 2),
               rand((2, 3, 32, 16), 3), causal) for causal in (True, False)]


def _gqa(n_q, seed, s=2064):
    return (rand((1, 4, n_q, 16), seed), rand((1, 2, s, 16), seed + 1),
            rand((1, 2, s, 16), seed + 2))


#: ops.attention cases on a 1x2 world: (q, k, v, causal, window) and
#: whether the ring takes it
ROUTED = [(*_gqa(2064, 10), True, None, True),
          (*_gqa(2048, 20, 2048), True, None, False),   # at the threshold
          (*_gqa(2064, 30), True, 512, False),          # a window
          (*_gqa(2064, 40), False, None, False),        # not causal
          (*_gqa(2065, 50, 2065), True, None, False)]   # odd length
PSUM = [rand((6, 5), 60) * 3.0, rand((6, 5), 61)]


@pytest.fixture(scope="module")
def np_params():
    jmodel = jax_build_model(JAX_ARCHS["yi-6b"].reduced())
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(7).integers(0, 256, size=(1, 2064))


@pytest.fixture(scope="module")
def world_2(np_params, prompt):
    return run_world(workers.several, 2, args=([
        ("ring", (RING_CASES, ["1x2"])),
        ("routed_attention", ([c[:5] for c in ROUTED], "1x2")),
        ("long_prefill", (np_params, prompt, "1x2")),
        ("psum", (PSUM, "1x2"))],))


@pytest.fixture(scope="module")
def world_4():
    return run_world(workers.ring, 4, args=(RING_CASES, ["1x4", "2x2"]))


def _want(case):
    q, k, v, causal = case
    return np.asarray(jax_ref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal=causal))


@pytest.mark.parametrize("spec,n", [("1x2", 2), ("1x4", 4), ("2x2", 2)])
@pytest.mark.parametrize("i", range(len(RING_CASES)))
def test_ring_matches_attention_ref_with_n_minus_1_sends(spec, n, i,
                                                         world_2, world_4):
    ranks = [r[0] for r in world_2] if spec == "1x2" else world_4
    want = _want(RING_CASES[i])
    for got in ranks:
        got = got[spec, i]
        np.testing.assert_allclose(got["out"], want, **TOL)
        assert got["calls"]["ring_send"] == n - 1
        # the output's gather over the sequence, and over the batch on 2x2
        assert got["calls"]["all_gather"] == (2 if spec == "2x2" else 1)


@pytest.mark.parametrize("shape", [(1, 32, 4096, 128, 2), (2, 8, 8192, 64, 4),
                                   (4, 4, 1024, 16, 8)])
@pytest.mark.parametrize("bytes_per_el", [2, 4])
def test_ring_collective_bytes_equal_jax(shape, bytes_per_el):
    assert ring_collective_bytes(*shape, bytes_per_el=bytes_per_el) \
        == jax_ring_bytes(*shape, bytes_per_el=bytes_per_el)


def test_routing_conditions():
    """On rank 0's view of a 1x2 mesh and of a 2x1 one (built here: the
    routing reads the shape alone)."""
    axes = ("data", "model")
    mesh = Mesh({"data": 1, "model": 2}, axes, {"data": 0, "model": 0}, {})
    one = Mesh({"data": 2, "model": 1}, axes, {"data": 0, "model": 0}, {})
    for q, k, v, causal, window, ring in ROUTED:
        q, k = np.empty(q.shape), np.empty(k.shape)
        assert ops.takes_ring(q, k, causal, window, mesh) == ring
        assert not ops.takes_ring(q, k, causal, window, one)
        assert not ops.takes_ring(q, k, causal, window, None)
    q = np.empty((1, 4, 2064, 16))
    assert not ops.takes_ring(q, np.empty((1, 2, 1500, 16)), False, None,
                              mesh)                     # cross attention
    with pytest.raises(NotImplementedError, match="item 10b"):
        ops.takes_ring(q, q, True, None, object())


@pytest.mark.parametrize("i", range(len(ROUTED)))
def test_ops_attention_takes_the_ring_where_the_reference_does(i, world_2):
    q, k, v, causal, window, ring = ROUTED[i]
    want = np.asarray(jax_ref.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window) if q.shape[2] > 2048 else jax_ref.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    for r in world_2:
        out, sends = r[1][i]
        assert sends == (1 if ring else 0)
        np.testing.assert_allclose(out, want, **TOL)


def test_gqa_prefill_of_2064_tokens_through_the_ring(np_params, prompt,
                                                     world_2):
    want = workers.long_prefill(np_params, prompt, None)
    assert want["ring_sends"] == 0
    for r in world_2:
        got = r[2]
        assert got["ring_sends"] == 2          # one a layer: n - 1 = 1
        np.testing.assert_allclose(got["logits"], want["logits"], **TOL)
        np.testing.assert_array_equal(got["k0"], want["k0"])


def test_compressed_psum_within_int8_error(world_2):
    exact = PSUM[0] + PSUM[1]
    jax_sum = sum(np.asarray(dequantize_int8(*quantize_int8(jnp.asarray(x))))
                  for x in PSUM)
    bound = 2 * max(np.abs(x).max() for x in PSUM) / 127
    for r in world_2:
        got = r[3]
        assert got.dtype == np.float32 and got.shape == exact.shape
        assert np.abs(got - exact).max() <= bound
        np.testing.assert_allclose(got, jax_sum, rtol=0, atol=1e-6)


def test_stochastic_rounding_and_the_roundtrip_error():
    """``quantize_int8``'s stochastic rounding (a generator in place of
    the JAX key) stays within one step and moves some codes off the
    nearest; ``compress_roundtrip_error`` equals the JAX package's."""
    x = torch.from_numpy(PSUM[0])
    near, scale = compression.quantize_int8(x)
    noisy, same = compression.quantize_int8(
        x, torch.Generator().manual_seed(0))
    assert float(same) == float(scale)
    assert (noisy.int() - near.int()).abs().max() <= 1
    assert not torch.equal(noisy, near)
    assert float(compression.compress_roundtrip_error(x)) == pytest.approx(
        float(compress_roundtrip_error(jnp.asarray(PSUM[0]))), abs=1e-7)

"""Attention kernels of the port against the JAX Pallas kernels
(interpret mode), on the CPU: the port's plain path there.  The CUDA
kernels are held against the plain versions on a card in
``test_torch_cuda_kernels.py``.

Inputs are made with numpy from fixed seeds and handed to both sides.
The sweep follows the JAX package's kernel suite: GQA groupings, causal
on and off, sliding windows, a sequence length no tile divides, ragged
``kv_len``.  Tolerance 2e-4 in float32, as there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention import flash_decode as jax_flash_decode
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def t(x):
    return torch.from_numpy(x)


# --------------------------------------------------------------------------
# plain path (CPU) against the JAX Pallas kernels in interpret mode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_gqa_matches_jax_kernel(h, hkv, causal):
    q = rand((2, h, 128, 32), 1, 0.3)
    k = rand((2, hkv, 128, 32), 2, 0.3)
    v = rand((2, hkv, 128, 32), 3)
    want = jax_flash_attention(q, k, v, causal=causal, block_q=64,
                               block_k=64, interpret=True)
    got = ops.attention(t(q), t(k), t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [16, 64])
def test_attention_sliding_window_matches_jax_kernel(window):
    q = rand((1, 2, 192, 32), 4, 0.3)
    want = jax_flash_attention(q, q, q, causal=True, window=window,
                               block_q=64, block_k=64, interpret=True)
    got = ops.attention(t(q), t(q), t(q), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_nondivisible_seq_matches_jax_kernel():
    q = rand((1, 2, 100, 32), 5, 0.3)
    want = jax_flash_attention(q, q, q, block_q=64, block_k=64,
                               interpret=True)
    got = ops.attention(t(q), t(q), t(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 2), (4, 1)])
def test_decode_ragged_kv_len_matches_jax_kernel(h, hkv):
    q = rand((2, h, 1, 32), 7, 0.4)
    k = rand((2, hkv, 256, 32), 8, 0.4)
    v = rand((2, hkv, 256, 32), 9)
    kv_len = np.array([100, 256], np.int32)
    want = jax_flash_decode(q, k, v, jnp.asarray(kv_len), block_k=64,
                            interpret=True)
    got = ops.decode_attention(t(q), t(k), t(v), t(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_versions_match_jax_oracles():
    q = rand((2, 4, 9, 16), 10, 0.5)
    k = rand((2, 2, 9, 16), 11, 0.5)
    v = rand((2, 2, 9, 16), 12)
    np.testing.assert_allclose(
        ref.attention_ref(t(q), t(k), t(v), causal=True, window=4).numpy(),
        np.asarray(jax_ref.attention_ref(q, k, v, causal=True, window=4)),
        **TOL)
    kv_len = np.array([3, 9], np.int32)
    np.testing.assert_allclose(
        ref.decode_ref(t(q[:, :, :1]), t(k), t(v), t(kv_len)).numpy(),
        np.asarray(jax_ref.decode_ref(q[:, :, :1], k, v, kv_len)), **TOL)


def test_kv_len_zero_row_kernel_gives_zero_plain_gives_mean_of_v():
    """A row with no visible key: the TPU kernel (and the port's CUDA
    kernel) returns exactly 0 (the l == 0 guard); both plain versions
    softmax over all -1e30 scores, i.e. return the mean of v.  The engine
    never sends kv_len == 0 (an idle lane decodes at pos 0, kv_len 1)."""
    q = rand((2, 4, 1, 16), 13, 0.4)
    k = rand((2, 2, 64, 16), 14, 0.4)
    v = rand((2, 2, 64, 16), 15)
    kv_len = np.array([0, 20], np.int32)
    kernel = np.asarray(jax_flash_decode(q, k, v, jnp.asarray(kv_len),
                                         block_k=32, interpret=True))
    plain = ops.decode_attention(t(q), t(k), t(v), t(kv_len)).numpy()
    assert np.all(kernel[0] == 0.0)
    mean_v = np.repeat(v[0].mean(axis=1), 2, axis=0)       # (H, D)
    np.testing.assert_allclose(plain[0, :, 0], mean_v, **TOL)
    np.testing.assert_allclose(
        plain[0, :, 0],
        np.asarray(jax_ref.decode_ref(q, k, v, kv_len))[0, :, 0], **TOL)
    np.testing.assert_allclose(plain[1], kernel[1], **TOL)


# --------------------------------------------------------------------------
# dispatch and wrapper checks (CPU)
# --------------------------------------------------------------------------


def test_ops_refuses_the_kernel_on_cpu_tensors():
    q = t(rand((1, 2, 8, 16), 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, q, q, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q[:, :, :1], q, q, use_kernel=True)


def test_wrappers_refuse_cpu_tensors_and_count_nothing():
    q = t(rand((1, 2, 8, 16), 17))
    before = (fa.flash_attention.launches, fa.flash_decode.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_decode(q[:, :, :1], q, q)
    assert (fa.flash_attention.launches, fa.flash_decode.launches) == before


def test_plain_path_on_cpu_launches_no_kernel():
    q = t(rand((1, 2, 8, 16), 18))
    before = (fa.flash_attention.launches, fa.flash_decode.launches)
    ops.attention(q, q, q)
    ops.decode_attention(q[:, :, :1], q, q)
    assert (fa.flash_attention.launches, fa.flash_decode.launches) == before

"""The partition and arithmetic of K9's time-parallel chunked scan
(``csrc/ssm_scan.cu``), on the CPU.

The kernel cannot run here, so a plain-torch emulation of it stands in:
the sequence in tiles of ``chunk`` steps (a tile longer than 512 steps in
passes of 512), lane j of a channel's warp owning ``I =
items_per_lane(chunk)`` consecutive steps of the pass (steps past the
tile are zeros, dt = 0 the identity map); per state n each lane composes
its steps' maps ``h -> a h + b`` (``a = exp2(dt A log2(e))``, ``b = dt x
B``) into ``(P, S)``, with ``P = exp2(A log2(e) sum_i dt_i)``; a
Hillis-Steele scan over the 32 lanes (the kernel's 5 ``__shfl_up_sync``
steps) composes the pairs; the carry from the previous pass gives each
lane its ``h_in`` (lane 0 the carry, lane j lane j-1's end state); each
lane replays its steps from ``h_in`` and adds ``C h`` to its steps' y,
which starts at ``D x``; the carry for the next pass is lane 31's end
state, and after the last tile it is the final state.  Only the order of
float32 sums and the exp's last bits (the card's ``ex2.approx``, relative
error ~2^-22) differ from the card.

The emulation is held to

* the plain scan ``ref.selective_scan_ref`` (y and the final state) at
  every ``SsmChunk`` candidate, L 1, 33, 300 and 512, Di 100 (not a
  multiple of the 16-channel block), N 1, 8, 16 and 32, float32 and
  bfloat16 inputs: y within 2e-4 (rtol = atol) in float32, as the JAX
  package's kernel test, and 2e-2 in bfloat16 (one rounding of a float32
  sum to bf16); the final state, float32 from the same inputs on both
  sides, within 2e-4 for either input type;
* the JAX package's Pallas ``selective_scan`` in interpret mode (y) and
  its plain scan ``repro.kernels.ref.selective_scan_ref`` (y and the
  final state), float32, within 2e-4.

Inputs come from numpy with a seed: dt positive (softplus), A negative.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.ssm_scan import selective_scan as jax_selective_scan
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as k9
from repro_torch.tuning.install import CHUNK_VALUES

torch.set_num_threads(1)

SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LOG2E = np.float32(math.log2(math.e))
LANES = 32
H100_SMEM_PER_BLOCK = 232_448    # cudaDevAttrMaxSharedMemoryPerBlockOptin


def scan_inputs(bsz, length, di, n, seed):
    """x, dt (positive), a (negative), b, c, d as float32 numpy."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x, dt = draw(bsz, length, di), np.log1p(np.exp(draw(bsz, length, di)))
    return (x, dt.astype(np.float32), -np.exp(draw(di, n)),
            draw(bsz, length, n), draw(bsz, length, n), draw(di))


def _torch(inputs, dtype):
    """The inputs as torch tensors: A float32, the rest of ``dtype``."""
    x, dt, a, b, c, d = (torch.from_numpy(v) for v in inputs)
    return (x.to(dtype), dt.to(dtype), a, b.to(dtype), c.to(dtype),
            d.to(dtype))


def _lanes(t, items):
    """(Bt, steps, W) -> (Bt, 32, items, W), zero steps past the pass."""
    bsz, steps, w = t.shape
    pad = LANES * items - steps
    return torch.nn.functional.pad(t, (0, 0, 0, pad)).reshape(
        bsz, LANES, items, w)


def emulate_scan(x, dt, a, b, c, d, chunk):
    """K9's partition and arithmetic in plain torch: (y, the final state
    (Bt, Di, N)), both float32."""
    bsz, length, di = x.shape
    chunk = min(chunk, length)
    items = k9.items_per_lane(chunk)
    w_max = min(chunk, LANES * k9.ITEMS_MAX)
    x, dt, b, c = (t.float() for t in (x, dt, b, c))
    a2 = a.float() * LOG2E                                  # (Di, N)
    dd = d.float()
    h = torch.zeros(bsz, di, a.shape[1])
    y = torch.empty(bsz, length, di)
    lane = torch.arange(LANES)[None, :, None, None]
    for t0 in range(0, length, chunk):
        steps = min(chunk, length - t0)
        for p0 in range(t0, t0 + steps, w_max):
            sp = min(w_max, t0 + steps - p0)
            seg = slice(p0, p0 + sp)
            xl, dtl = _lanes(x[:, seg], items), _lanes(dt[:, seg], items)
            bl, cl = _lanes(b[:, seg], items), _lanes(c[:, seg], items)
            dtx = dtl * xl                                  # (Bt, 32, I, Di)
            av = torch.exp2(dtl[..., None] * a2)            # (.., Di, N)
            bv = dtx[..., None] * bl[:, :, :, None, :]
            s_acc = torch.zeros(bsz, LANES, di, a.shape[1])
            for i in range(items):                          # the lane's steps
                s_acc = av[:, :, i] * s_acc + bv[:, :, i]
            p_acc = torch.exp2(dtl.sum(2)[..., None] * a2)
            for off in (1, 2, 4, 8, 16):                    # the warp scan
                pp = torch.roll(p_acc, off, dims=1)
                sp_ = torch.roll(s_acc, off, dims=1)
                later = lane >= off
                s_acc = torch.where(later, p_acc * sp_ + s_acc, s_acc)
                p_acc = torch.where(later, p_acc * pp, p_acc)
            h_end = p_acc * h[:, None] + s_acc              # (Bt, 32, Di, N)
            h_cur = torch.cat([h[:, None], h_end[:, :-1]], dim=1)
            yl = dd * xl
            for i in range(items):                          # the replay
                h_cur = av[:, :, i] * h_cur + bv[:, :, i]
                yl[:, :, i] += (cl[:, :, i, None, :] * h_cur).sum(-1)
            y[:, seg] = yl.reshape(bsz, LANES * items, di)[:, :sp]
            h = h_end[:, -1]
    return y, h


def emulate(inputs, dtype, chunk):
    x, dt, a, b, c, d = _torch(inputs, dtype)
    y, h = emulate_scan(x, dt, a, b, c, d, chunk)
    return y.to(dtype), h


# --------------------------------------------------------------------------
# the partition rules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("chunk,items", [
    (1, 1), (32, 1), (33, 2), (64, 2), (65, 4), (128, 4), (129, 8),
    (256, 8), (257, 16), (300, 16), (512, 16), (700, 16), (4096, 16)])
def test_items_per_lane(chunk, items):
    """ceil(chunk / 32) rounded up to a power of two, at most 16: a tile
    longer than 512 steps runs in passes of 512."""
    assert k9.items_per_lane(chunk) == items


def test_lane_major_rows_are_bank_conflict_free():
    """For I >= 4 the 16-byte reads of 8 lanes at a time cover 8 distinct
    4-bank quads; every row is 16-byte aligned and 4 mod 32 floats long,
    so the 16 rows of a transposing write fall in 8 banks; the rows hold
    every lane that owns a step."""
    for items in (4, 8, 16):
        stride = k9.lane_stride(items)
        assert stride % 4 == 0 and stride >= items
        quads = {(j * stride // 4) % 8 for j in range(8)}
        assert len(quads) == 8
    for chunk in (*CHUNK_VALUES, 1, 33, 300, 700):
        items = k9.items_per_lane(chunk)
        rowf = k9.row_floats(chunk)
        assert rowf % 32 == 4
        lanes = -(-min(chunk, 512) // items)
        assert rowf >= (lanes - 1) * k9.lane_stride(items) + items


def test_smem_formula_and_the_card_limit():
    """The footprint at falcon-mamba's d_state 16: every candidate fits an
    H100 block in bf16 (512: 230,400 bytes); float32 staging doubles the
    raw tile, so chunk 512 does not fit there, while 300 (the longest
    float32 tile the card's checks run) does."""
    for chunk in CHUNK_VALUES:
        assert k9.smem_bytes(16, chunk) <= H100_SMEM_PER_BLOCK
    assert k9.smem_bytes(16, 512) == 230_400
    assert k9.smem_bytes(16, 300, 4) <= H100_SMEM_PER_BLOCK
    assert k9.smem_bytes(16, 512, 4) > H100_SMEM_PER_BLOCK


# --------------------------------------------------------------------------
# the emulated kernel against the plain scan and the JAX kernel
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", [1, 8, 16, 32])
@pytest.mark.parametrize("length", [1, 33, 300, 512])
@pytest.mark.parametrize("chunk", CHUNK_VALUES)
def test_emulated_scan_against_plain(chunk, length, n, dtype):
    inputs = scan_inputs(2, length, 100, n, seed=chunk + 7 * length + n)
    y, h = emulate(inputs, dtype, chunk)
    want_y, want_h = ref.selective_scan_ref(*_torch(inputs, dtype),
                                            return_final_state=True)
    assert y.dtype == dtype and y.shape == (2, length, 100)
    assert h.dtype == torch.float32 and h.shape == (2, 100, n)
    tol = SCAN_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(y.float().numpy(), want_y.float().numpy(),
                               **tol)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), **SCAN_TOL)


@pytest.mark.parametrize("length,chunk", [(700, 700), (1030, 600),
                                          (1100, 1024)])
def test_emulated_scan_in_passes_against_plain(length, chunk):
    """Tiles longer than 512 steps, scanned as passes of 512 with the
    carry between them (and a ragged last pass and tile)."""
    inputs = scan_inputs(1, length, 20, 8, seed=length)
    y, h = emulate(inputs, torch.float32, chunk)
    want_y, want_h = ref.selective_scan_ref(*_torch(inputs, torch.float32),
                                            return_final_state=True)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), **SCAN_TOL)


@pytest.mark.parametrize("length", [33, 300])
@pytest.mark.parametrize("chunk", CHUNK_VALUES)
def test_emulated_scan_against_jax_kernel_in_interpret_mode(chunk, length):
    """y against the JAX Pallas kernel at the same chunk (interpret mode)
    and the JAX plain scan; the final state against the JAX plain scan."""
    inputs = scan_inputs(2, length, 100, 16, seed=3 * chunk + length)
    y, h = emulate(inputs, torch.float32, chunk)
    want = np.asarray(jax_selective_scan(
        *(jnp.asarray(v) for v in inputs), chunk=chunk, interpret=True))
    jy, jh = jax_ref.selective_scan_ref(*inputs, return_final_state=True)
    np.testing.assert_allclose(y.numpy(), want, **SCAN_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)


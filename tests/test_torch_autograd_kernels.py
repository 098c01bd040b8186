"""Gradients through the kernel routes: K1's and K9's
``torch.autograd.Function``s and the guard on every other entry point.

On the CPU the Functions run their kernels' plain forwards, so what is
tested here is their closed-form backwards:

* ``FlashAttentionFn`` (``kernels/autograd.py``) against ``torch.autograd``
  through ``ref.attention_ref`` and against ``jax.grad`` through the JAX
  package's ``repro.kernels.ref.attention_ref``: causal and not, a
  window, cross attention (Sk != Sq), G 1, 4, 8, D 64, 80, 128, float32
  and bf16, with q, k, v handed in transposed (not contiguous) as the
  projections make them;
* ``SelectiveScanFn`` against ``torch.autograd`` through
  ``ref.selective_scan_ref`` and ``jax.grad`` through the JAX package's;
* ``ops.attention`` and ``ops.ssm_scan`` take the Functions whenever a
  gradient is asked for (``use_kernel=False``: the plain ops' autograd),
  and every other entry point (``ops.mm``, ``ops.decode_attention``,
  ``ops.paged_decode``, ``ops.paged_prefill``, ``ops.paged_verify``,
  ``fdm_stress``, and ``ops.ssm_scan`` with the final state) raises
  ``RuntimeError`` naming ROADMAP item 9a: no route returns a tensor
  without a ``grad_fn`` where a gradient was asked for.

The ``gpu`` cases run the Functions with the kernels' forwards on the
card against the plain autograd (the machine with the card has no JAX:
this file imports it in a fixture).

Tolerances: float32 rtol 1e-4 with atol 1e-5 of each gradient's scale
(its largest |value|; sums in other orders); bf16 2e-2 of the scale (the
inputs' rounding, and the closed form reads the bf16-rounded output in
rowsum(dO o O)).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fdm_stress as fk
from repro_torch.kernels import ops, ref
from repro_torch.kernels.autograd import (GRAD_ITEM, FlashAttentionFn,
                                          SelectiveScanFn,
                                          attention_backward, visible_keys)

torch.set_num_threads(1)

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
# (causal, window, Sq, Sk, G, D)
ATTN_CASES = {
    "causal-G1-D64": (True, None, 40, 40, 1, 64),
    "causal-G4-D80": (True, None, 40, 40, 4, 80),
    "causal-G8-D128": (True, None, 33, 33, 8, 128),
    "window16-G4-D64": (True, 16, 48, 48, 4, 64),
    "window8-G8-D80": (True, 8, 40, 40, 8, 80),
    "noncausal-G4-D128": (False, None, 40, 40, 4, 128),
    "cross-G1-D64": (False, None, 24, 56, 1, 64),
    "cross-G8-D80": (False, None, 17, 90, 8, 80),
}
# (B, L, Di, N)
SCAN_CASES = {"small": (2, 9, 6, 4), "ragged": (1, 33, 20, 8)}


def rand(shape, seed, dtype=torch.float32, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def attn_inputs(case, dtype, seed=0):
    """q, k, v as the projections make them: (B, S, H, D) tensors
    transposed to (B, H, S, D) views (not contiguous), and dO."""
    causal, window, sq, sk, g, d = case
    b, hkv = 2, 2
    q = rand((b, sq, hkv * g, d), seed, dtype).transpose(1, 2)
    k = rand((b, sk, hkv, d), seed + 1, dtype).transpose(1, 2)
    v = rand((b, sk, hkv, d), seed + 2, dtype).transpose(1, 2)
    do = rand((b, hkv * g, sq, d), seed + 3, dtype)
    return [t.requires_grad_(True) for t in (q, k, v)], do


def assert_scaled(got, want, dtype, what=""):
    rtol, atol = TOL[dtype]
    got, want = got.float().detach().numpy(), want.float().detach().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("dtype", DTYPES, ids=list(DTYPES))
@pytest.mark.parametrize("case", ATTN_CASES, ids=list(ATTN_CASES))
def test_flash_attention_fn_matches_torch_autograd(case, dtype):
    dtype = DTYPES[dtype]
    causal, window = ATTN_CASES[case][:2]
    (q, k, v), do = attn_inputs(ATTN_CASES[case], dtype)
    out = FlashAttentionFn.apply(q, k, v, causal, window, {})
    got = torch.autograd.grad(out, (q, k, v), do)
    want_out = ref.attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad(want_out, (q, k, v), do)
    assert torch.equal(out, want_out)
    for name, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert_scaled(g, w, dtype, f"d{name}")


@pytest.fixture(scope="module")
def jref():
    """The JAX package's plain versions (imported here: the machine with
    the card has no JAX)."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jax_ref
    return jax, jax_ref


@pytest.mark.parametrize("case", ATTN_CASES, ids=list(ATTN_CASES))
def test_flash_attention_fn_matches_jax_grad(case, jref):
    jax, jax_ref = jref
    causal, window = ATTN_CASES[case][:2]
    (q, k, v), do = attn_inputs(ATTN_CASES[case], torch.float32, seed=10)
    out = FlashAttentionFn.apply(q, k, v, causal, window, {})
    got = torch.autograd.grad(out, (q, k, v), do)
    args = [t.detach().contiguous().numpy() for t in (q, k, v)]
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_ref.attention_ref(
        q_, k_, v_, causal=causal, window=window), *args)
    want = vjp(do.numpy())
    for name, g, w in zip("qkv", got, want):
        assert_scaled(g, torch.from_numpy(np.asarray(w)), torch.float32,
                      f"d{name}")


def test_attention_backward_zeroes_a_row_without_keys():
    """K1 gives 0 for a query row that sees no key (the plain version a
    uniform mean); the closed form takes K1's rule, so no gradient flows
    through such a row.  No mask ``ops.attention`` takes has one (causal
    and windowed rows keep their diagonal), so the rule is checked on the
    backward itself: 4 causal rows over 2 keys, the first 2 rows blind."""
    q, k, v = (rand((1, 2, n, 16), s).requires_grad_(True)
               for s, n in ((0, 4), (1, 2), (2, 2)))
    do = rand((1, 2, 4, 16), 3)
    seen = visible_keys(4, 2, True, None, "cpu").any(dim=-1)
    assert seen.tolist() == [False, False, True, True]
    want_out = ref.attention_ref(q, k, v, causal=True) * seen[:, None]
    want = torch.autograd.grad(want_out, (q, k, v), do)
    got = attention_backward(q.detach(), k.detach(), v.detach(),
                             want_out.detach(), do, causal=True,
                             window=None)
    assert not got[0][:, :, :2].any()
    for g, w in zip(got, want):
        assert_scaled(g, w, torch.float32)


def scan_inputs(case, dtype, seed=0):
    bsz, length, di, n = case
    x = rand((bsz, length, di), seed, dtype)
    dt = torch.nn.functional.softplus(rand((bsz, length, di), seed + 1)
                                      - 1.0).to(dtype)
    a = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n) \
        * (0.5 + torch.rand(di, 1, generator=torch.Generator().manual_seed(
            seed)))
    b = rand((bsz, length, n), seed + 2, dtype)
    c = rand((bsz, length, n), seed + 3, dtype)
    d = rand((di,), seed + 4, dtype)
    gy = rand((bsz, length, di), seed + 5, dtype)
    return [t.contiguous().requires_grad_(True)
            for t in (x, dt, a, b, c, d)], gy


@pytest.mark.parametrize("dtype", DTYPES, ids=list(DTYPES))
@pytest.mark.parametrize("case", SCAN_CASES, ids=list(SCAN_CASES))
def test_selective_scan_fn_matches_torch_autograd(case, dtype):
    dtype = DTYPES[dtype]
    args, gy = scan_inputs(SCAN_CASES[case], dtype)
    y = SelectiveScanFn.apply(*args, {})
    got = torch.autograd.grad(y, args, gy)
    want_y = ref.selective_scan_ref(*args)
    want = torch.autograd.grad(want_y, args, gy)
    assert torch.equal(y, want_y)
    for name, g, w, x in zip(("x", "dt", "a", "b", "c", "d"), got, want,
                             args):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert_scaled(g, w, dtype, f"d{name}")


@pytest.mark.parametrize("case", SCAN_CASES, ids=list(SCAN_CASES))
def test_selective_scan_fn_matches_jax_grad(case, jref):
    jax, jax_ref = jref
    args, gy = scan_inputs(SCAN_CASES[case], torch.float32, seed=20)
    y = SelectiveScanFn.apply(*args, {})
    got = torch.autograd.grad(y, args, gy)
    _, vjp = jax.vjp(jax_ref.selective_scan_ref,
                     *[t.detach().numpy() for t in args])
    want = vjp(gy.numpy())
    for name, g, w in zip(("x", "dt", "a", "b", "c", "d"), got, want):
        assert_scaled(g, torch.from_numpy(np.asarray(w)), torch.float32,
                      f"d{name}")


# -- the routes: a Function, the plain ops' autograd, or a RuntimeError --

def _paged_inputs():
    q = rand((1, 4, 1, 16), 30).requires_grad_(True)
    kp, vp = rand((3, 2, 4, 16), 31), rand((3, 2, 4, 16), 32)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    return q, ops.PagedPools(kp, vp), table


def _fdm_inputs():
    n = 4
    arrays = {name: rand((n,) if name.startswith("abs") else (n, n, n), i)
              for i, name in enumerate(fk.ARRAYS)}
    state = {name: rand((n, n, n), 40 + i) for i, name in
             enumerate(fk.STATE)}
    arrays["rig"].requires_grad_(True)
    return arrays, state


def _scan_final_state():
    args, _ = scan_inputs(SCAN_CASES["small"], torch.float32)
    return ops.ssm_scan(*args, return_final_state=True)


GUARDED = {
    "mm": lambda: ops.mm(rand((4, 8), 1).requires_grad_(True),
                         rand((8, 4), 2)),
    "decode_attention": lambda: ops.decode_attention(
        rand((1, 4, 1, 16), 3).requires_grad_(True), rand((1, 2, 8, 16), 4),
        rand((1, 2, 8, 16), 5)),
    "paged_decode": lambda: ops.paged_decode(
        *_paged_inputs(), torch.tensor([6])),
    "paged_prefill": lambda: ops.paged_prefill(
        *_paged_inputs(), torch.tensor([5]), torch.tensor([6])),
    "paged_verify": lambda: ops.paged_verify(
        *_paged_inputs(), torch.tensor([5]), torch.tensor([6])),
    "fdm_stress": lambda: fk.fdm_stress(*_fdm_inputs(), 0.1),
    "ssm_scan_final_state": _scan_final_state,
}


@pytest.mark.parametrize("name", GUARDED, ids=list(GUARDED))
def test_entry_points_without_a_backward_raise_under_grad(name):
    with pytest.raises(RuntimeError, match=f"no backward.*{GRAD_ITEM}"):
        GUARDED[name]()


@pytest.mark.parametrize("name", [n for n in GUARDED if n != "fdm_stress"])
def test_guarded_entry_points_run_without_grad(name):
    """The guard costs the no-grad callers (serving) nothing but the
    check: under ``torch.no_grad`` every entry point runs its plain
    version here."""
    with torch.no_grad():
        out = GUARDED[name]()
    outs = out if isinstance(out, tuple) else (out,)
    assert all(torch.isfinite(t).all() and t.grad_fn is None for t in outs)


def test_fdm_stress_checks_grad_before_the_device():
    """K7 has no plain route in its wrapper: without grad a CPU tensor is
    refused as before (``ValueError``); with grad the guard comes first."""
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fk.fdm_stress(*_fdm_inputs(), 0.1)


def test_every_route_either_carries_the_gradient_or_raises():
    """``ops.attention`` and ``ops.ssm_scan`` reach q, k, v and x, dt, A,
    B, C, D through their Functions (or the plain ops' own autograd with
    ``use_kernel=False``); the guarded entry points raise.  No call hands
    back a tensor without a ``grad_fn`` while a gradient is asked for."""
    (q, k, v), do = attn_inputs(ATTN_CASES["causal-G4-D80"], torch.float32)
    out = ops.attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert all(g is not None and g.abs().sum() > 0 for g in
               torch.autograd.grad(out, (q, k, v), do))
    plain = ops.attention(q, k, v, causal=True, use_kernel=False)
    assert plain.grad_fn is not None
    assert "FlashAttention" not in type(plain.grad_fn).__name__
    args, gy = scan_inputs(SCAN_CASES["small"], torch.float32)
    y = ops.ssm_scan(*args)
    assert type(y.grad_fn).__name__ == "SelectiveScanFnBackward"
    assert all(g is not None and g.abs().sum() > 0 for g in
               torch.autograd.grad(y, args, gy))
    assert ops.ssm_scan(*args, use_kernel=False).grad_fn is not None
    with torch.no_grad():
        assert ops.attention(q, k, v).grad_fn is None
        assert ops.ssm_scan(*args).grad_fn is None
    for name, call in GUARDED.items():
        with pytest.raises(RuntimeError):
            call()


# -- on the card: the kernels' forwards inside the Functions ------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for "
                    "sm_90a and run only there)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ATTN_CASES, ids=list(ATTN_CASES))
def test_flash_attention_fn_on_the_card(case, cuda_device):
    causal, window = ATTN_CASES[case][:2]
    (q, k, v), do = attn_inputs(ATTN_CASES[case], torch.bfloat16)
    q, k, v = (t.detach().to(cuda_device).requires_grad_(True)
               for t in (q, k, v))
    do = do.to(cuda_device)
    n = FlashAttentionFn.launches
    out = ops.attention(q, k, v, causal=causal, window=window)
    assert FlashAttentionFn.launches == n + 1
    got = (out, *torch.autograd.grad(out, (q, k, v), do))
    want_out = ref.attention_ref(q, k, v, causal=causal, window=window)
    want = (want_out, *torch.autograd.grad(want_out, (q, k, v), do))
    for g, w in zip(got, want):
        assert_scaled(g.cpu(), w.cpu(), torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=list(DTYPES))
def test_selective_scan_fn_on_the_card(dtype, cuda_device):
    dtype = DTYPES[dtype]
    args, gy = scan_inputs((2, 70, 48, 16), dtype)
    args = [t.detach().to(cuda_device).requires_grad_(True) for t in args]
    gy = gy.to(cuda_device)
    n = SelectiveScanFn.launches
    y = ops.ssm_scan(*args)
    assert SelectiveScanFn.launches == n + 1
    got = (y, *torch.autograd.grad(y, args, gy))
    want_y = ref.selective_scan_ref(*args)
    want = (want_y, *torch.autograd.grad(want_y, args, gy))
    tol = dtype if dtype == torch.bfloat16 else torch.bfloat16
    for g, w in zip(got, want):       # K9's float32 sums run in another
        assert_scaled(g.cpu(), w.cpu(), tol)   # order: the bf16 bound

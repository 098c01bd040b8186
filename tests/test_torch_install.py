"""The port's install-time AT path on the CPU: the plain versions of K8
(``ops.mm``, ``ref.matmul_ref``) and K7 (``ref.fdm_stress_ref``) against
the JAX package's Pallas kernels in interpret mode, and the install-time
tuning of ``MatmulBlocks`` and ``FlashBlocks`` (K1's tile) through
``repro_torch.tuning``, beside the JAX package's install pass.

Tolerances: float32 1e-4 relative (and absolute, for values near 0);
bfloat16 inputs give bfloat16 outputs rounded from float32 sums taken in
different orders, so one bf16 rounding step (2**-7 relative) and the
same absolute floor; the stress update 2e-5, as the JAX package's own
test of its kernel.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.at as jat
import repro_torch.at as at
from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels import ops as jax_ops
from repro.kernels.fdm_stress import fdm_stress as jax_fdm_stress
from repro.kernels.matmul import matmul as jax_matmul
from repro.models import build_model as jax_build_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.tuning.install import \
    register_kernel_regions as jax_register_kernel_regions
from repro.tuning.install import run_install_tuning as jax_run_install_tuning
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_arch
from repro_torch.core.executor import WallClockExecutor
from repro_torch.kernels import flash_attention as k1
from repro_torch.kernels import ops, ref
from repro_torch.kernels.matmul import TILE_VALUES, TILES, smem_bytes
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine
from repro_torch.tuning import (flash_blocks_cost, matmul_blocks_cost,
                                register_kernel_regions, run_install_tuning)

H100_SMEM_PER_BLOCK = 232_448    # cudaDevAttrMaxSharedMemoryPerBlockOptin
TOL = {np.float32: dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}


@pytest.fixture(autouse=True)
def _isolate_published():
    at.clear_published()
    jat.clear_published()
    yield
    at.clear_published()
    jat.clear_published()


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32) / math.sqrt(k)
    y = rng.standard_normal((k, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return x, y, bias


@pytest.mark.parametrize("epilogue", ["none", "gelu", "silu", "relu"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(77, 300, 200), (64, 96, 128)])
def test_mm_plain_matches_jax_kernel(m, k, n, dtype, with_bias, epilogue):
    x, y, bias = _operands(m, k, n, seed=m + k + n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx, jy = jnp.asarray(x, jdt), jnp.asarray(y, jdt)
    jb = jnp.asarray(bias, jdt) if with_bias else None
    want = np.asarray(jax_matmul(jx, jy, jb, block_m=32, block_n=64,
                                 block_k=128, epilogue=epilogue,
                                 interpret=True).astype(jnp.float32))
    tx, ty = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
    tb = torch.from_numpy(bias).to(tdt) if with_bias else None
    got = ops.mm(tx, ty, tb, epilogue=epilogue)
    assert got.dtype == tdt and got.shape == (m, n)
    also = ref.matmul_ref(tx, ty, tb, epilogue)
    assert torch.equal(got, also)
    tol = TOL[np.float32 if dtype == "float32" else "bfloat16"]
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_mm_out_dtype_and_use_kernel_on_cpu():
    x, y, _ = _operands(8, 16, 4, seed=1)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ty = torch.from_numpy(y).to(torch.bfloat16)
    out = ref.matmul_ref(tx, ty, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
        ops.mm(tx, ty, use_kernel=True)
    with pytest.raises(ValueError, match="unknown epilogue"):
        ops.mm(tx, ty, epilogue="tanh")


def _fdm_inputs(nx, ny, nz, seed=0):
    rng = np.random.default_rng(seed)
    arrays = dict(
        lam=rng.normal(size=(nx, ny, nz)),
        rig=rng.uniform(0.5, 2.0, size=(nx, ny, nz)),
        q=rng.normal(size=(nx, ny, nz)), absx=rng.normal(size=nx),
        absy=rng.normal(size=ny), absz=rng.normal(size=nz),
        **{k: rng.normal(size=(nx, ny, nz))
           for k in ("dxvx", "dyvy", "dzvz", "dxvy", "dyvx", "dxvz",
                     "dzvx", "dyvz", "dzvy")})
    state = {k: rng.normal(size=(nx, ny, nz))
             for k in ("sxx", "syy", "szz", "sxy", "sxz", "syz")}
    return ({k: v.astype(np.float32) for k, v in arrays.items()},
            {k: v.astype(np.float32) for k, v in state.items()})


@pytest.mark.parametrize("variant", ["fused", "split"])
@pytest.mark.parametrize("blocks", [(8, 8, 8), (4, 16, 8)])
def test_fdm_stress_plain_matches_jax_kernel(variant, blocks):
    arrays, state = _fdm_inputs(12, 10, 16)
    bx, by, bz = blocks
    want = jax_fdm_stress({k: jnp.asarray(v) for k, v in arrays.items()},
                          {k: jnp.asarray(v) for k, v in state.items()}, 0.1,
                          variant=variant, bx=bx, by=by, bz=bz,
                          interpret=True)
    got = ref.fdm_stress_ref(
        {k: torch.from_numpy(v) for k, v in arrays.items()},
        {k: torch.from_numpy(v) for k, v in state.items()}, 0.1)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-5, atol=2e-5,
                                   err_msg=f"{variant}:{k}")


def test_fdm_stress_plain_clamps_the_far_edges():
    """At the last plane of each axis the i+1 / j+1 / k+1 neighbour is the
    point itself, so a grid of constant rig gives rmaxy = rmaxz = rmayz =
    rig there as everywhere."""
    arrays, state = _fdm_inputs(3, 4, 5)
    arrays["rig"][:] = 1.5
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    s = {k: torch.from_numpy(v) for k, v in state.items()}
    out = ref.fdm_stress_ref(t, s, 0.1)
    qg = (t["absx"][:, None, None] * t["absy"][None, :, None]
          * t["absz"][None, None, :] * t["q"])
    want = (s["sxy"] + 1.5 * (t["dxvy"] + t["dyvx"]) * 0.1) * qg
    np.testing.assert_allclose(out["sxy"].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_smem_cost_marks_tiles_the_card_cannot_launch():
    shape = dict(m=512, n=11008, k=4096)
    assert smem_bytes(256, 256, 256) > H100_SMEM_PER_BLOCK
    assert matmul_blocks_cost(256, 256, 256, smem_limit=H100_SMEM_PER_BLOCK,
                              **shape) == math.inf
    costs = {t: matmul_blocks_cost(*t, smem_limit=H100_SMEM_PER_BLOCK,
                                   **shape) for t in TILES}
    assert all(math.isfinite(c) and c > 0 for c in costs.values())
    # a limit between the candidates' footprints rules out the larger ones
    limit = smem_bytes(64, 64, 64)
    for t in TILES:
        over = smem_bytes(*t) > limit
        assert math.isinf(matmul_blocks_cost(*t, smem_limit=limit,
                                             **shape)) == over
    assert sorted(TILE_VALUES) == [32, 64, 128]
    assert len(TILES) == 27


def test_analytic_install_tuning_publishes_a_feasible_tile(tmp_path):
    session = at.AutoTuner(str(tmp_path))
    register_kernel_regions(session, m=512, n=11008, k=4096,
                            smem_limit=H100_SMEM_PER_BLOCK)
    tuned = run_install_tuning(session)
    tiles = tuned["MatmulBlocks"]
    assert set(tiles) == {"block_m", "block_n", "block_k"}
    assert (tiles["block_m"], tiles["block_n"], tiles["block_k"]) in TILES
    assert smem_bytes(*tiles.values()) <= H100_SMEM_PER_BLOCK
    assert at.tuned("matmul") == tiles
    # MatmulBlocks ad-hoc: 3 axes x 3 values; FlashBlocks ad-hoc: 2 axes
    # x 2 values; SsmChunk: its d-spline's 8 sample points
    assert session.executor_calls == 9 + 4 + 8
    record = session.records.lookup("install", "MatmulBlocks", {})
    assert record is not None and record.machine == at.machine_fingerprint()
    # a second session on the workdir warm-loads: no measurement
    again = at.AutoTuner(str(tmp_path))
    register_kernel_regions(again, m=512, n=11008, k=4096,
                            smem_limit=H100_SMEM_PER_BLOCK)
    assert run_install_tuning(again) == tuned
    assert again.executor_calls == 0


def test_infeasible_tiles_are_never_chosen(tmp_path):
    session = at.AutoTuner(str(tmp_path))
    limit = smem_bytes(64, 64, 64)
    register_kernel_regions(session, m=512, n=512, k=512, smem_limit=limit)
    tiles = run_install_tuning(session)["MatmulBlocks"]
    assert smem_bytes(*tiles.values()) <= limit


def test_wall_clock_install_tuning_on_cpu_times_the_plain_version(tmp_path):
    session = at.AutoTuner(str(tmp_path))
    register_kernel_regions(session, m=48, n=80, k=64, seq=24, d_inner=32,
                            d_state=8, smem_limit=H100_SMEM_PER_BLOCK)
    tuned = run_install_tuning(session, wall_clock=True, device="cpu")
    region = session.ctx.registry.get("MatmulBlocks")
    assert region.metadata["executor"] == "cuda-event"
    assert tuple(tuned["MatmulBlocks"].values()) in TILES
    # MatmulBlocks + FlashBlocks + SsmChunk
    assert session.executor_calls == 9 + 4 + 8
    assert tuple(tuned["FlashBlocks"].values()) in k1.attention_tiles(
        torch.bfloat16, 128)
    # a second session on the workdir warm-loads every region: no
    # measurement, the same winners
    again = at.AutoTuner(str(tmp_path))
    register_kernel_regions(again, m=48, n=80, k=64, seq=24, d_inner=32,
                            d_state=8, smem_limit=H100_SMEM_PER_BLOCK)
    assert run_install_tuning(again, wall_clock=True, device="cpu") == tuned
    assert again.executor_calls == 0
    # the analytic setting is restored by the next call
    run_install_tuning(session)
    assert region.metadata["executor"] == "analytic-cost"


def test_install_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    session = at.AutoTuner(str(tmp_path))
    with pytest.raises(RuntimeError, match="is_available"):
        register_kernel_regions(session, m=64, n=64, k=64)
    register_kernel_regions(session, m=64, n=64, k=64,
                            smem_limit=H100_SMEM_PER_BLOCK)
    with pytest.raises(RuntimeError, match="is_available"):
        run_install_tuning(session, wall_clock=True)


def test_wall_clock_executor_reraises_a_variants_error():
    def make_variant(assignment):
        def run():
            raise ValueError(f"variant {assignment} failed")
        return run

    with pytest.raises(ValueError, match="failed"):
        WallClockExecutor(make_variant, repeats=1, warmup=0)({"A_X": 1})
    with pytest.raises(ValueError, match="failed"):
        WallClockExecutor(make_variant, repeats=1, warmup=1)({"A_X": 1})


def test_wall_clock_executor_blocks_on_nested_results():
    calls = []

    def make_variant(assignment):
        return lambda: calls.append(1) or {"out": [torch.zeros(2), (1,)]}

    cost = WallClockExecutor(make_variant, repeats=2, warmup=1)({})
    assert cost >= 0 and len(calls) == 3


def test_sample_8_example_runs_both_levels_on_cpu(capsys):
    """Level 1: the annotated loop nest's 8 candidates and an install-time
    winner; level 2 on the CPU: the plain version of K7."""
    spec = importlib.util.spec_from_file_location(
        "autotune_fdm_torch",
        Path(__file__).resolve().parents[1] / "examples"
        / "autotune_fdm_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out = module.main(["--device", "cpu"])
    assert out["level1"]["candidates"] == 8
    assert out["level1"]["measured"] == 8
    assert 0 <= out["level1"]["winner"] < 8
    assert out["level2"] == {"device": "cpu", "grid": 16}
    assert "reproduced at loop-nest AND kernel level" in capsys.readouterr().out


# --------------------------------------------------------------------------
# FlashBlocks: K1's tile (block_q, block_k)
# --------------------------------------------------------------------------


def test_flash_blocks_is_declared_and_publishes_an_instance(tmp_path):
    session = at.AutoTuner(str(tmp_path))
    register_kernel_regions(session, seq=512, d_head=128,
                            smem_limit=H100_SMEM_PER_BLOCK)
    region = session.ctx.registry.get("FlashBlocks")
    assert region.metadata["shape"] == (512, 128)
    assert region.metadata["smem_limit"] == H100_SMEM_PER_BLOCK
    assert session._publish_maps["FlashBlocks"] == (
        "flash_attention", {"block_q": "block_q", "block_k": "block_k"})
    tuned = run_install_tuning(session)
    assert set(tuned) == {"MatmulBlocks", "FlashBlocks", "SsmChunk"}
    tile = tuned["FlashBlocks"]
    assert set(tile) == {"block_q", "block_k"}
    assert (tile["block_q"], tile["block_k"]) in k1.attention_tiles(
        torch.bfloat16, 128)
    assert at.tuned("flash_attention") == tile
    # the analytic cost at S 512: 128 x 64 walks 20 live tile pairs, the
    # fewest of the tiles whose shared memory leaves room for two blocks
    assert tile == {"block_q": 128, "block_k": 64}


def test_flash_blocks_cost_counts_the_kernels_walk():
    """Finite and positive on every D = 128 instance; the live tile pairs
    of the causal walk (query tile i sees the key tiles up to its last
    row); ``inf`` above the shared-memory limit and for tiles without an
    instance at the head dim."""
    costs = {t: flash_blocks_cost(*t, seq=512, d_head=128,
                                  smem_limit=H100_SMEM_PER_BLOCK)
             for t in k1.attention_tiles(torch.bfloat16, 128)}
    assert len(costs) == 4
    assert all(math.isfinite(c) and c > 0 for c in costs.values())
    # 64 x 64 at S 512: 1 + 2 + ... + 8 pairs, one block fits twice
    assert costs[(64, 64)] == 36
    assert costs[(128, 64)] == 2 + 4 + 6 + 8
    # the 128-key tiles fit once: their pairs times the penalty
    assert costs[(64, 128)] > 1 + 1 + 2 + 2 + 3 + 3 + 4 + 4
    limit = k1.smem_bytes(64, 64, 128)
    for t in costs:
        over = k1.smem_bytes(*t, 128) > limit
        assert math.isinf(flash_blocks_cost(*t, seq=512, d_head=128,
                                            smem_limit=limit)) == over
    assert math.isinf(flash_blocks_cost(128, 128, seq=512, d_head=64,
                                        smem_limit=H100_SMEM_PER_BLOCK))
    assert math.isfinite(flash_blocks_cost(64, 64, seq=512, d_head=64,
                                           smem_limit=H100_SMEM_PER_BLOCK))
    assert k1.smem_bytes(64, 64, 128) == 87_040
    assert k1.smem_bytes(128, 128, 128) == 174_080


def test_port_and_jax_install_passes_publish_the_same_regions(tmp_path):
    session = at.AutoTuner(str(tmp_path / "torch"))
    register_kernel_regions(session, smem_limit=H100_SMEM_PER_BLOCK)
    ours = run_install_tuning(session)
    ctx = jat.AutoTuner(str(tmp_path / "jax"))
    jax_register_kernel_regions(ctx)
    theirs = jax_run_install_tuning(ctx)
    assert set(ours) == set(theirs) == {"MatmulBlocks", "FlashBlocks",
                                        "SsmChunk"}
    for name in ours:
        assert set(ours[name]) == set(theirs[name])
    assert set(at.tuned("flash_attention")) == set(
        jax_ops.tuned("flash_attention")) == {"block_q", "block_k"}


def _greedy(engine_cls, request_cls, model, params, **kw):
    eng = engine_cls(model, params, n_lanes=2, max_len=48, **kw)
    for i in range(3):
        eng.submit(request_cls(rid=i, prompt=[1 + i] + [(3 * i + j) % 90 + 2
                                                       for j in range(10)],
                               max_new_tokens=5))
    return {r.rid: r.out_tokens for r in eng.run(max_steps=200)}


def test_dense_serve_after_install_equals_untuned_and_jax_tuned(tmp_path):
    """Reduced yi-6b on dense lanes: greedy tokens with FlashBlocks' tile
    published (the plain route on the CPU takes no tile) equal the
    untuned serve's and the JAX package's after its own install pass."""
    jmodel = jax_build_model(JAX_ARCHS["yi-6b"].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(get_arch("yi-6b").reduced())
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg,
                             device="cpu")
    untuned = _greedy(ServingEngine, Request, model, params)
    session = at.AutoTuner(str(tmp_path / "torch"))
    register_kernel_regions(session, smem_limit=H100_SMEM_PER_BLOCK)
    run_install_tuning(session)
    assert at.tuned("flash_attention")
    tuned = _greedy(ServingEngine, Request, model, params)
    ctx = jat.AutoTuner(str(tmp_path / "jax"))
    jax_register_kernel_regions(ctx)
    jax_run_install_tuning(ctx)
    assert jax_ops.tuned("flash_attention")
    jax_tuned = _greedy(JaxEngine, JaxRequest, jmodel, jparams)
    assert tuned == untuned == jax_tuned
    assert all(len(t) == 5 for t in tuned.values())

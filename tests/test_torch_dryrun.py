"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, and its op counter (``repro_torch.launch.op_analysis``)
against the JAX HLO analysis's tests (``test_infra.py``).

Both dry runs run in child processes, side by side: the port's in a fake
world of 8 ranks (``fake_world``) on a 2x4 ("data", "model") mesh, the
JAX package's with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
on a 2x4 mesh of Auto axes.  In each child (and only there)
``make_production_mesh`` gives that mesh, ``get_arch`` the arch's
``reduced()`` and ``get_shape`` a small shape of the cell's kind, for one
arch a family (dense, MoE, Mamba-1, encoder-decoder, hybrid) at train (2
microbatches), prefill and decode, at ``remat="none"``:

* ``mesh``, ``axes``, ``chips``, ``plan``, ``remat``, ``num_microbatches``,
  ``loss_chunks``, ``kind``, ``model_params`` and ``active_params`` equal;
* ``memory.argument_bytes`` equal, but for the arguments JAX's ``jit``
  prunes because the step never reads them (``keep_unused=False``; the
  port counts every argument it is handed), each named in ``PRUNED``;
* per-rank dot FLOPs within 10% for train, prefill and decode where
  both partition alike (dense, MoE, encoder-decoder, the Mamba-1
  prefill and decode: the decode step runs on the weights' and caches'
  shards as the plan lays them out, as the JAX one does).  Four cells
  partition otherwise, and their bounds say how: GSPMD's Mamba-1
  backward makes more products than the port's, which keeps ``x_proj``
  row-parallel and the channels split through the scan (the port's
  count is 0.7-1.0 of JAX's); the hybrid's shared block runs under
  ``lax.cond``, whose branches the JAX HLO walker does not descend into
  (``hlo_analysis._CALL_RE`` follows fusions and calls only), so the
  port counts products JAX does not (1.0-2.5 of JAX's, train, prefill
  and decode);
* the fake world is gone after each cell, and the fake process group's
  module is loaded by the dry run alone (not by importing the port).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.cost import HBM_BW, ICI_BW, PEAK_FLOPS_BF16
from repro_torch.launch import op_analysis

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("yi-6b", "moonshot-v1-16b-a3b", "falcon-mamba-7b",
            "whisper-tiny", "zamba2-7b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
CELLS = [(a, s) for a in FAMILIES for s in SHAPES]
KEYS = ("mesh", "axes", "chips", "plan", "remat", "num_microbatches",
        "loss_chunks", "kind", "model_params", "active_params")
#: (arch, shape) -> the bytes a rank holds of arguments the JAX step
#: prunes as unread
PRUNED = {
    # whisper's prefill: its cross attention's q/k/v biases (the cross
    # path projects without them), 2 layers x (64 + 32 + 32) float32
    ("whisper-tiny", "prefill_32k"): 1024,
    # whisper's decode: the encoder's weights and the cross attention's
    # k/v projections and q/k/v biases (the cross caches hold their work)
    ("whisper-tiny", "decode_32k"): 39424,
    # falcon-mamba's decode: ``pos`` (8 lanes of int32 over 2 data
    # ranks), which Mamba-1 layers do not read
    ("falcon-mamba-7b", "decode_32k"): 16,
}
#: (arch, shape) -> (least, most) of the port's FLOPs over JAX's
FLOP_RATIO = {("falcon-mamba-7b", "train_4k"): (0.7, 1.0),
              ("zamba2-7b", "train_4k"): (1.0, 2.5),
              ("zamba2-7b", "prefill_32k"): (1.0, 2.5),
              ("zamba2-7b", "decode_32k"): (1.0, 2.5)}
#: (arch, shape) -> (the port's plan, the JAX package's) where static AT
#: by the dry run picks otherwise (ROADMAP queue 3): the port gathers
#: split weights where GSPMD all-reduces partial products, so its "fsdp"
#: train bound is 1.8-2.6x the JAX package's and its "tp" decode bound
#: 1.3-16x, while its "decode_resident" bound is 0.04-0.06x JAX's
OTHER_PICK = {(arch, shape): pick for arch in
              ("yi-6b", "moonshot-v1-16b-a3b", "whisper-tiny")
              for shape, pick in (("train_4k", ("tp", "fsdp")),
                                  ("decode_32k", ("decode_resident", "tp")))}

_SMALL = '''
SMALL = {"train_4k": ShapeConfig("train_4k", 64, 16, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 128, 8, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 128, 8, "decode")}
'''

#: static AT by the dry run, in each child after its records: every
#: candidate plan of a cell costs ``from_artifact(record).bound_s`` (the
#: cell's own record for its plan, ``compiled_plan_cost`` for the others;
#: the roofline and static AT read the child's configs), and
#: ``tune_layout`` picks among them in a temporary workdir
_PLANS = '''
import tempfile
for mod in (rl, st):
    mod.get_arch, mod.get_shape = dr.get_arch, dr.get_shape
plans = {}
for arch, shape in json.loads(sys.argv[1]):
    rec = out[arch + "/" + shape]
    known = {rec["plan"]: rl.from_artifact(rec).bound_s}

    def cost(plan):
        if plan not in known:
            with world():
                known[plan] = st.compiled_plan_cost(
                    arch, shape, plan, remat="none",
                    num_microbatches=2 if shape == "train_4k" else None)
        return known[plan]

    with tempfile.TemporaryDirectory() as workdir:
        won = st.tune_layout(at.AutoTuner(workdir), arch, shape,
                             cost_fn=cost)
    plans[arch + "/" + shape] = {"costs": known, "won": won}
'''

_JAX_CHILD = '''
import contextlib, json, sys
import jax
jax.devices()                  # 8 host devices, before the module's flag
from jax.sharding import AxisType
from repro.configs import ARCHS, ShapeConfig
import repro.at as at
import repro.launch.dryrun as dr
import repro.launch.roofline as rl
import repro.tuning.static as st
''' + _SMALL + '''
dr.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
dr.get_arch = lambda n: ARCHS[n].reduced()
dr.get_shape = lambda n: SMALL[n]
out = {}
for arch, shape in json.loads(sys.argv[1]):
    out[arch + "/" + shape] = dr.dryrun_cell(
        arch, shape, remat="none", verbose=False,
        num_microbatches=2 if shape == "train_4k" else None)
# the port's rates (its default card's row), so that a plan's cost
# differs between the packages by the partition alone
rl.PEAK_FLOPS, rl.HBM_BW, rl.ICI_BW = json.loads(sys.argv[2])
world = contextlib.nullcontext
''' + _PLANS + '''
print("RECORDS" + json.dumps({"records": out, "plans": plans}))
'''

_PORT_CHILD = '''
import json, sys
import repro_torch, pkgutil, importlib
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
FAKE = "torch.testing._internal.distributed.fake_pg"
before = FAKE in sys.modules
import torch.distributed as dist
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.distributed.process_mesh import fake_world, make_mesh
import repro_torch.at as at
import repro_torch.launch.dryrun as dr
import repro_torch.launch.roofline as rl
import repro_torch.tuning.static as st
''' + _SMALL + '''
dr.get_arch = lambda n: get_arch(n).reduced()
dr.get_shape = lambda n: SMALL[n]
dr.make_production_mesh = lambda multi_pod=False: make_mesh(
    (2, 4), ("data", "model"))
out, left_up = {}, False
for arch, shape in json.loads(sys.argv[1]):
    with fake_world(8):
        out[arch + "/" + shape] = dr.dryrun_cell(
            arch, shape, remat="none", verbose=False,
            num_microbatches=2 if shape == "train_4k" else None)
    left_up |= dist.is_initialized()
world = lambda: fake_world(8)
''' + _PLANS + '''
left_up |= dist.is_initialized()
print("RECORDS" + json.dumps({"records": out, "plans": plans,
                              "fake_pg_at_import": before,
                              "fake_pg_after": FAKE in sys.modules,
                              "world_left_up": left_up}))
'''


def _child(code: str, env: dict) -> subprocess.Popen:
    rates = [PEAK_FLOPS_BF16, HBM_BW, ICI_BW]
    return subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(CELLS), json.dumps(rates)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **env},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _records(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    line = next(x for x in out.splitlines() if x.startswith("RECORDS"))
    return json.loads(line[len("RECORDS"):])


@pytest.fixture(scope="module")
def both():
    """(the JAX records, the port's child output), run side by side."""
    jax_proc = _child(_JAX_CHILD, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "JAX_PLATFORMS": "cpu"})
    port_proc = _child(_PORT_CHILD, {})
    return _records(jax_proc), _records(port_proc)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_record_matches_the_jax_dry_run(arch, shape, both):
    jax_recs, port = both
    want = jax_recs["records"][f"{arch}/{shape}"]
    got = port["records"][f"{arch}/{shape}"]
    assert set(got) == set(want)
    assert set(got["memory"]) == set(want["memory"])
    assert {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}
    assert got["memory"]["argument_bytes"] == (
        want["memory"]["argument_bytes"] + PRUNED.get((arch, shape), 0))
    assert got["compile_s"] is None and got["while_trips"] == []
    assert got["hlo_collective_bytes"]["total"] == pytest.approx(sum(
        v for k, v in got["hlo_collective_bytes"].items() if k != "total"))
    ratio = got["hlo_dot_flops"] / want["hlo_dot_flops"]
    lo, hi = FLOP_RATIO.get((arch, shape), (0.9, 1.1))
    assert lo <= ratio <= hi, (got["hlo_dot_flops"], want["hlo_dot_flops"])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_static_at_by_the_dry_run_picks_the_jax_plan(arch, shape, both):
    """``tune_layout`` over ``compiled_plan_cost`` (every candidate plan's
    dry-run bound, at the same rates in both packages) picks the JAX
    package's plan; in a cell of :data:`OTHER_PICK`, the recorded other
    plan instead."""
    jax_recs, port = both
    got = port["plans"][f"{arch}/{shape}"]
    want = jax_recs["plans"][f"{arch}/{shape}"]
    assert set(got["costs"]) == set(want["costs"]) and len(got["costs"]) > 1
    assert got["won"] == min(got["costs"], key=got["costs"].get)
    assert want["won"] == min(want["costs"], key=want["costs"].get)
    assert (got["won"], want["won"]) == OTHER_PICK.get(
        (arch, shape), (want["won"], want["won"])), (got, want)


def test_the_fake_world_is_the_dry_runs_alone(both):
    _, port = both
    assert not port["fake_pg_at_import"]
    assert port["fake_pg_after"]
    assert not port["world_left_up"]


# --------------------------------------------------------------------------
# op_analysis (test_infra.py's HLO analysis tests)
# --------------------------------------------------------------------------

def test_loop_aware_flops_exact():
    """Five 64x32x32 products in a layer loop: every one counted."""
    def scanned(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x.sum()

    _, res = op_analysis.analyze_step(scanned, torch.zeros(64, 32),
                                      torch.zeros(5, 32, 32))
    assert res["dot_flops"] == 2 * 64 * 32 * 32 * 5
    assert res["while_trips"] == []


_COLLECTIVES = '''
import json, torch
import torch.distributed._functional_collectives as fc
from repro_torch.distributed.process_mesh import fake_world
from repro_torch.launch.op_analysis import analyze_step
with fake_world(2):
    def step(x):
        g = fc.all_gather_tensor(x[:64], 0, [0, 1])
        return fc.all_reduce(g, "sum", [0, 1])
    _, res = analyze_step(step, torch.zeros(128, 256))
print("COUNTS" + json.dumps(res["collective_bytes"]))
'''


def test_collective_bytes_by_kind():
    """An all-gather and an all-reduce of f32[128, 256] count
    128 x 256 x 4 bytes each (their results on one rank)."""
    out = subprocess.run(
        [sys.executable, "-c", _COLLECTIVES], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("COUNTS"))
    got = json.loads(line[len("COUNTS"):])
    assert got["all-gather"] == 128 * 256 * 4
    assert got["all-reduce"] == 128 * 256 * 4
    assert got["total"] == 2 * 128 * 256 * 4

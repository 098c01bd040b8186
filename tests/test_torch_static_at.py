"""The port's static AT (``repro_torch.configs``' shape schema,
``launch/analytic.py``, ``launch/roofline.py``, ``tuning/static.py`` and
``core/cost.py``'s H100 rows) against the JAX package's on the CPU.

* the shapes and the cells equal the JAX ones field for field;
* ``step_costs`` and ``model_flops`` are bit-equal (``==``) for every
  arch x shape (the analytic model is copied line for line);
* ``analytic_plan_cost`` is within rel 1e-12 of the JAX value with the
  JAX module's v5e constants replaced (``monkeypatch``) by the port's row
  of each card;
* the JAX ``TestStaticTuning`` cases hold at every card's rates;
* ``tune_layout`` writes the JAX package's ``OAT_StaticParam.dat`` text;
* ``from_artifact``, ``table`` and ``render`` equal the JAX output under
  equal constants.
"""
import ast
import dataclasses
import json
from pathlib import Path

import pytest

import repro.at as jat
import repro.launch.analytic as janalytic
import repro.launch.roofline as jroofline
import repro.tuning.static as jstatic
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import all_cells as jax_all_cells
from repro.configs import cell_applicable as jax_cell_applicable
from repro.configs import get_arch as jax_get_arch
import repro_torch.at as at
from repro_torch.configs import (ARCHS, SHAPES, all_cells, cell_applicable,
                                 get_arch, get_shape)
from repro_torch.core import cost
from repro_torch.core import paramfile
from repro_torch.launch import analytic, roofline
from repro_torch.tuning import static
from repro_torch.tuning import (analytic_plan_cost, candidate_plans,
                                tune_all_layouts, tune_layout)

ROOT = Path(__file__).resolve().parents[1]
SXM, PCIE, NVL = ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                  "NVIDIA H100 NVL")
CARDS = (SXM, PCIE, NVL)
CELLS = [(a, s) for a in ARCHS for s in SHAPES]


@pytest.fixture(autouse=True)
def _isolate_published():
    for pkg in (jat, at):
        pkg.clear_published()
    yield
    for pkg in (jat, at):
        pkg.clear_published()


def jax_rates(monkeypatch, card: str = SXM) -> None:
    """The JAX static and roofline modules' constants set to the port's
    row of ``card`` (no file is edited)."""
    spec = cost.chip_spec(card)
    for mod in (jstatic, jroofline):
        monkeypatch.setattr(mod, "PEAK_FLOPS", spec.peak_flops_bf16)
        monkeypatch.setattr(mod, "HBM_BW", spec.hbm_bw)
        monkeypatch.setattr(mod, "ICI_BW", spec.link_bw)


# --------------------------------------------------------------------------
# the shape schema
# --------------------------------------------------------------------------


def test_shapes_equal_the_jax_shapes():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            JAX_SHAPES[name])
        assert get_shape(name) == shape
    with pytest.raises(KeyError, match="unknown shape"):
        get_shape("train_8k")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cells_equal_the_jax_cells(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    for name, shape in SHAPES.items():
        assert cell_applicable(cfg, shape) == jax_cell_applicable(
            jcfg, JAX_SHAPES[name])


def test_all_cells_equal_the_jax_cells():
    def key(cells):
        return {(a.name, s.name): (dataclasses.asdict(a),
                                   dataclasses.asdict(s), ok, reason)
                for a, s, ok, reason in cells}

    for skipped in (False, True):
        got, want = all_cells(skipped), jax_all_cells(skipped)
        assert len(got) == len(want) == (40 if skipped else 33)
        assert key(got) == key(want)


# --------------------------------------------------------------------------
# launch/analytic.py
# --------------------------------------------------------------------------


def _statements(path: Path) -> list[str]:
    tree = ast.parse(path.read_text().replace("repro_torch", "repro"))
    body = tree.body[1:]        # the module docstring
    return [ast.dump(node) for node in body]


def test_analytic_is_the_jax_module_but_for_its_docstring():
    assert _statements(ROOT / "src/repro_torch/launch/analytic.py") == \
        _statements(ROOT / "src/repro/launch/analytic.py")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_step_costs_and_model_flops_are_bit_equal(arch, shape):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    got = analytic.step_costs(cfg, SHAPES[shape])
    want = janalytic.step_costs(jcfg, JAX_SHAPES[shape])
    assert got.flops == want.flops and got.bytes == want.bytes
    assert got.detail == want.detail
    assert analytic.model_flops(cfg, SHAPES[shape]) == \
        janalytic.model_flops(jcfg, JAX_SHAPES[shape])


# --------------------------------------------------------------------------
# core/cost.py: the H100 rows
# --------------------------------------------------------------------------


def test_the_card_table_and_its_default():
    assert cost.DEFAULT_CHIP == SXM
    assert set(cost.CHIPS) == set(CARDS)
    row = cost.chip_spec(SXM)
    assert (row.peak_flops_bf16, row.hbm_bw, row.link_bw) == \
        (989.4e12, 3.35e12, 50e9)
    assert (cost.PEAK_FLOPS_BF16, cost.HBM_BW, cost.ICI_BW) == \
        (row.peak_flops_bf16, row.hbm_bw, row.link_bw)
    assert cost.chip_spec(PCIE).peak_flops_bf16 == 756e12
    assert cost.chip_spec(NVL).hbm_bw == 3.9e12
    terms = cost.roofline_terms(989.4e12 * 2, 3.35e12, 50e9 * 4, 2)
    assert (terms.compute_s, terms.memory_s, terms.collective_s) == \
        (1.0, 0.5, 2.0)


def test_an_unknown_card_raises_and_is_not_taken_for_the_sxm():
    with pytest.raises(KeyError, match="CHIPS"):
        cost.chip_spec("NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="A100"):
        analytic_plan_cost("yi-6b", "train_4k", "tp",
                           chip="NVIDIA A100-SXM4-80GB")


# --------------------------------------------------------------------------
# tuning/static.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_analytic_plan_cost_matches_jax(monkeypatch, arch, card):
    jax_rates(monkeypatch, card)
    chip = None if card == SXM else card
    for shape in SHAPES:
        for plan in candidate_plans(SHAPES[shape].kind):
            got = analytic_plan_cost(arch, shape, plan, chip=chip)
            want = jstatic.analytic_plan_cost(arch, shape, plan)
            assert abs(got - want) <= 1e-12 * abs(want), (shape, plan)
            assert got == analytic_plan_cost(arch, shape, plan, chip=card)


def test_candidate_plans():
    assert candidate_plans("decode") == jstatic.candidate_plans("decode")
    assert candidate_plans("train") == jstatic.candidate_plans("train")
    assert "decode_seq" in candidate_plans("decode")
    assert "decode_resident" in candidate_plans("decode")
    assert "fsdp" in candidate_plans("train")


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("arch,shape,better,worse", [
    # yi-6b decode (kv=4 < model axis): the seq-sharded KV layout beats
    # tp-with-weight-gather
    ("yi-6b", "decode_32k", "decode_seq", "tp"),
    # resident model-axis weights beat per-token FSDP re-gather for every
    # dense decode cell
    ("deepseek-7b", "decode_32k", "decode_resident", "tp"),
    ("yi-6b", "decode_32k", "decode_resident", "tp"),
    # the train select is meaningful: tp beats fsdp
    ("deepseek-7b", "train_4k", "tp", "fsdp"),
])
def test_a_plan_beats_another(arch, shape, better, worse, card):
    assert analytic_plan_cost(arch, shape, better, chip=card) < \
        analytic_plan_cost(arch, shape, worse, chip=card)


def test_tune_layout_picks_min_cost(tmp_path):
    costs = {"tp": 3.0, "decode_seq": 1.0, "decode_resident": 2.0}
    best = tune_layout(at.AutoTuner(str(tmp_path)), "yi-6b", "decode_32k",
                       cost_fn=lambda p: costs[p])
    assert best == "decode_seq"
    # recorded in the static param file, keyed by BP (paper format)
    nodes = paramfile.load_file(paramfile.param_path(str(tmp_path),
                                                     "static"))
    rec = next(n for n in nodes if n.name.startswith("Layout_yi_6b"))
    assert rec.keyed_child("OAT_PROBSIZE", 32768) is not None


def test_tune_layout_accepts_a_context(tmp_path):
    from repro_torch.core import ATContext
    ctx = ATContext(str(tmp_path))
    assert tune_layout(ctx, "deepseek-7b", "train_4k") == "tp"


def _static_file(workdir: Path) -> str:
    return (workdir / "OAT_StaticParam.dat").read_text()


def _records(workdir: Path) -> list[dict]:
    """The record store's lines without the machine fingerprint (built
    from each package's own framework)."""
    lines = (workdir / "OAT_Records.jsonl").read_text().splitlines()
    return [{k: v for k, v in json.loads(x).items() if k != "machine"}
            for x in lines]


def test_static_param_file_equals_the_jax_one(tmp_path):
    """Two cells in one session with fixed costs: the BPs are set by the
    first cell only, in both packages."""
    costs = {"tp": 2.0, "fsdp": 1.0, "decode_seq": 3.0,
             "decode_resident": 0.5}
    cells = [("yi-6b", "decode_32k"), ("deepseek-7b", "train_4k"),
             ("falcon-mamba-7b", "long_500k")]
    got = tune_all_layouts(at.AutoTuner(str(tmp_path / "t")), cells,
                           cost_fn=costs.get)
    want = jstatic.tune_all_layouts(jat.AutoTuner(str(tmp_path / "j")),
                                    cells, cost_fn=costs.get)
    assert got == want == {cells[0]: "decode_resident",
                           cells[1]: "fsdp", cells[2]: "decode_resident"}
    assert _static_file(tmp_path / "t") == _static_file(tmp_path / "j")
    assert _records(tmp_path / "t") == _records(tmp_path / "j")


@pytest.mark.parametrize("card", CARDS)
def test_every_cell_tuned_at_a_card_is_the_argmin_and_warm_loads(
        monkeypatch, tmp_path, card):
    """Every applicable cell at each card's rates: the winner is the
    argmin of ``analytic_plan_cost`` (tp for train and prefill,
    decode_resident for decode, as on the JAX package's v5e), the param
    file equals the JAX package's under the same rates, and a second
    session on the directory reads every winner back without tuning."""
    jax_rates(monkeypatch, card)
    cells = [(a.name, s.name) for a, s, _, _ in all_cells()]
    got = tune_all_layouts(at.AutoTuner(str(tmp_path / "t")), cells,
                           chip=card)
    for (arch, shape), plan in got.items():
        c = {p: analytic_plan_cost(arch, shape, p, chip=card)
             for p in candidate_plans(SHAPES[shape].kind)}
        assert plan == min(c, key=c.get)
        assert plan == ("decode_resident" if SHAPES[shape].kind == "decode"
                        else "tp")
    want = jstatic.tune_all_layouts(jat.AutoTuner(str(tmp_path / "j")),
                                    cells)
    assert got == want
    assert _static_file(tmp_path / "t") == _static_file(tmp_path / "j")
    again = at.AutoTuner(str(tmp_path / "t"))
    assert tune_all_layouts(again, cells, chip=card) == got
    assert sorted(again.warm_hits) == sorted(
        ("static", f"Layout_{a}_{s}".replace("-", "_").replace(".", "_"))
        for a, s in cells)


_COMPILED_COST = '''
import functools, json, sys, tempfile
import repro_torch.at as at
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.distributed.process_mesh import fake_world, make_mesh
from repro_torch.launch import dryrun, roofline
from repro_torch.tuning import static
small = ShapeConfig("train_4k", 64, 16, "train")
# in this child only: reduced yi-6b, a small train shape, a 2x4 mesh
for mod in (dryrun, roofline, static):
    mod.get_arch = lambda n: get_arch(n).reduced()
    mod.get_shape = lambda n: small
dryrun.make_production_mesh = lambda multi_pod=False: make_mesh(
    (2, 4), ("data", "model"))
kw = dict(num_microbatches=2, remat="none")
with fake_world(8):
    costs = {p: static.compiled_plan_cost("yi-6b", "train_4k", p, **kw)
             for p in static.candidate_plans("train")}
    bound = roofline.from_artifact(dryrun.dryrun_cell(
        "yi-6b", "train_4k", plan_name="tp", verbose=False, **kw)).bound_s
    work = tempfile.mkdtemp()
    cost_fn = functools.partial(static.compiled_plan_cost, "yi-6b",
                                "train_4k", **kw)
    first = static.tune_layout(at.AutoTuner(work), "yi-6b", "train_4k",
                               cost_fn=cost_fn, chips=8)
    again = at.AutoTuner(work)
    second = static.tune_layout(again, "yi-6b", "train_4k",
                                cost_fn=cost_fn, chips=8)
print("COSTS" + json.dumps({"costs": costs, "bound": bound, "first": first,
                            "second": second,
                            "warm": sorted(map(list, again.warm_hits))}))
'''


def test_compiled_plan_cost_names_item_10():
    """``compiled_plan_cost`` is the roofline bound of the port's dry run
    of the plan (``from_artifact(dryrun_cell(...)).bound_s``), and
    ``tune_layout`` with it as ``cost_fn`` commits the cheapest plan and
    reads it back warm.  In a child process (the dry run's fake world),
    at reduced yi-6b on a 2x4 mesh."""
    import os
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", _COMPILED_COST], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(next(x for x in out.stdout.splitlines()
                          if x.startswith("COSTS"))[len("COSTS"):])
    costs = got["costs"]
    assert set(costs) == set(static.candidate_plans("train"))
    assert all(c > 0 and c == c and c != float("inf")
               for c in costs.values())
    assert costs["tp"] == got["bound"]
    assert got["first"] == got["second"] == min(costs, key=costs.get)
    assert ["static", "Layout_yi_6b_train_4k"] in got["warm"]


# --------------------------------------------------------------------------
# launch/roofline.py
# --------------------------------------------------------------------------

RECORDS = [
    {"arch": "yi-6b", "shape": "train_4k", "mesh": "16x16", "chips": 256,
     "plan": "tp", "hlo_dot_flops": 2.4e14,
     "hlo_collective_bytes": {"total": 3.1e10, "all-reduce": 3.1e10},
     "bytes_per_device": 5.5e10},
    {"arch": "falcon-mamba-7b", "shape": "long_500k", "mesh": "16x16",
     "chips": 256, "plan": "decode_resident", "hlo_dot_flops": 1.0e6,
     "hlo_collective_bytes": {"total": 2.0e6}},
    {"arch": "moonshot-v1-16b-a3b", "shape": "prefill_32k", "mesh": "16x16",
     "chips": 256, "hlo_collective_bytes": {}},
    {"arch": "whisper-tiny", "shape": "long_500k", "skipped": True,
     "reason": "long_500k skipped: pure full-attention arch"},
]


def _fields(r) -> dict:
    """A row's fields and properties; a skipped row's roofline fraction
    is left out (the JAX package's divides by its zero cards)."""
    out = dataclasses.asdict(r) | {
        "dominant": r.dominant, "bound_s": r.bound_s,
        "useful_ratio": r.useful_ratio}
    if not r.skipped:
        out["roofline_fraction"] = r.roofline_fraction
    return out


def test_from_artifact_and_render_equal_the_jax_output(monkeypatch):
    jax_rates(monkeypatch)
    got = [roofline.from_artifact(r) for r in RECORDS]
    want = [jroofline.from_artifact(r) for r in RECORDS]
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert roofline.render(got) == jroofline.render(want)
    assert got[0].compute_s == 2.4e14 / 989.4e12
    assert got[3].skipped and "SKIP" in roofline.render(got[3:])
    assert got[3].roofline_fraction == 0.0
    with pytest.raises(ZeroDivisionError):
        want[3].roofline_fraction


def test_table_and_main_read_artifacts(monkeypatch, tmp_path, capsys):
    jax_rates(monkeypatch)
    for i, rec in enumerate(RECORDS):
        for mesh in ("single", "multi"):
            (tmp_path / f"cell{i}__{mesh}.json").write_text(json.dumps(rec))
    rows = roofline.table(str(tmp_path), "single")
    assert len(rows) == len(RECORDS)
    assert [_fields(r) for r in rows] == \
        [_fields(r) for r in jroofline.table(str(tmp_path), "single")]
    out = tmp_path / "roofline.json"
    roofline.main(["--artifacts", str(tmp_path), "--json-out", str(out)])
    assert capsys.readouterr().out.strip() == roofline.render(rows)
    assert json.loads(out.read_text()) == [
        _fields(r) | {"roofline_fraction": r.roofline_fraction}
        for r in rows]

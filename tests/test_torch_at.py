"""The port's copy of the AT language (``repro_torch.core``,
``repro_torch.at``) against the JAX package's (``repro.core``,
``repro.at``) on the CPU: the same source apart from a named list of
changes, the same search trajectories, parameter files and generated
code, record files each package reads, and tuning state kept apart.
"""
import ast
import importlib.util
import itertools
import json
import os
from pathlib import Path

import pytest

import repro.at as jat
import repro.core as jcore
import repro_torch.at as tat
import repro_torch.core as tcore
from fdm_sample import fdm_stress as fdm_loops

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
CORE = ("errors", "params", "region", "cost", "fitting", "search",
        "paramfile", "executor", "runtime", "directives", "stagegraph",
        "codegen", "dsl", "__init__")
AT = ("backends", "sqlite_backend", "session", "records", "__init__")
#: top-level names (or ``import`` lines) the port changes on purpose: the
#: executor synchronises CUDA devices instead of JAX arrays and adds a
#: CUDA-event executor; the fingerprint is built from torch
CHANGED = {
    "core/executor.py": {"_block", "_cuda_devices", "CudaEventExecutor",
                         "import torch"},
    "at/records.py": {"machine_fingerprint"},
}
PACKAGES = {"jax": (jat, jcore), "torch": (tat, tcore)}


@pytest.fixture(autouse=True)
def _isolate_published():
    for at, _ in PACKAGES.values():
        at.clear_published()
    yield
    for at, _ in PACKAGES.values():
        at.clear_published()


def _strip_docstrings(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]


def _top_level(path: Path) -> dict[str, str]:
    """``ast.dump`` of each top-level statement without docstrings, keyed
    by the name it defines (imports by their text), the package's name
    normalised so that ``repro_torch`` reads as ``repro``."""
    tree = ast.parse(path.read_text().replace("repro_torch", "repro"))
    _strip_docstrings(tree)
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            key = node.name
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            key = "import " + ", ".join(a.name for a in node.names) \
                if isinstance(node, ast.Import) else ast.unparse(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            key = ", ".join(ast.unparse(t) for t in targets)
        else:
            key = ast.unparse(node)
        out[key] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel", [f"core/{m}.py" for m in CORE]
                         + [f"at/{m}.py" for m in AT])
def test_copied_module_equals_the_reference_but_for_named_changes(rel):
    ref, port = _top_level(REF / rel), _top_level(PORT / rel)
    changed = CHANGED.get(rel, set())
    assert changed <= set(ref) | set(port), "a named change does not exist"
    ref = {k: v for k, v in ref.items() if k not in changed}
    port = {k: v for k, v in port.items() if k not in changed}
    assert sorted(ref) == sorted(port)
    drifted = [k for k in ref if ref[k] != port[k]]
    assert not drifted, f"{rel}: {drifted} differ from the reference"


def _table_session(package: str, workdir: str):
    """One install, one static and one dynamic region, costed from a table
    (the same table for both packages)."""
    at, core = PACKAGES[package]
    table = {}
    for bm, bn in itertools.product((128, 256, 512), repeat=2):
        table[(("Blocks_BM", bm), ("Blocks_BN", bn))] = \
            abs(bm - 256) + abs(bn - 512) + 1.0
    for c in (32, 64, 128, 256):
        table[(("Chunk_C", c),)] = abs(c - 64) + 1.0
    tuner = at.AutoTuner(
        workdir, executor=lambda region, bp: core.TableExecutor(table))
    tuner.set_bps(numprocs=1, start=1024, end=2048, dist=1024)

    @tuner.autotune("install", "variable", name="Blocks",
                    varied=core.Varied(("bm", "bn"), values=(128, 256, 512)),
                    search="ad-hoc",
                    publish=("matmul", {"bm": "block_m", "bn": "block_n"}))
    def blocks(bm=128, bn=128):
        return 0.0

    @tuner.autotune("static", "variable", name="Chunk",
                    varied=core.Varied(("c",), values=(32, 64, 128, 256)))
    def chunk(c=32):
        return 0.0

    sel = tuner.autotune("dynamic", "select", name="Decode")
    sel.alternative(name="slow")(lambda: "slow")
    sel.alternative(name="fast")(lambda: "fast")
    return tuner, sel


def test_table_executor_sessions_agree_across_packages(tmp_path):
    runs = {}
    for package in PACKAGES:
        workdir = tmp_path / package
        tuner, sel = _table_session(package, str(workdir))
        ran = tuner.run("all")
        outs = [sel() for _ in range(3)]
        files = {name: (workdir / name).read_text()
                 for name in ("OAT_InstallParam.dat", "OAT_StaticParam.dat")}
        runs[package] = (ran, tuner.best("Blocks"), tuner.best("Chunk"),
                         tuner.executor_calls, files, outs[:2],
                         PACKAGES[package][0].tuned("matmul"))
    assert runs["jax"] == runs["torch"]
    ran, blocks, chunk, calls, files, _, tuned = runs["torch"]
    assert blocks == {"Blocks_BM": 256, "Blocks_BN": 512}
    assert chunk == {"Chunk_C": 64}
    assert tuned == {"block_m": 256, "block_n": 512}
    assert calls > 0 and "Blocks" in files["OAT_InstallParam.dat"]


def test_preprocess_of_sample_8_agrees_across_packages(tmp_path):
    out = {}
    for package, (at, _) in PACKAGES.items():
        workdir = tmp_path / package
        regions = at.AutoTuner(str(workdir)).preprocess(fdm_loops)
        region = regions["FDMStress"]
        out[package] = ([s.name for s in region.subregions],
                        (workdir / "OAT" / "OAT_fdm_stress.py").read_text())
    assert len(out["torch"][0]) == 8
    assert out["jax"] == out["torch"]


def test_record_files_read_in_both_packages(tmp_path):
    for writer, reader in (("torch", "jax"), ("jax", "torch")):
        workdir = tmp_path / writer
        tuner, _ = _table_session(writer, str(workdir))
        tuner.run("install")
        path = workdir / tat.ATRecordStore(str(workdir)).path.split(os.sep)[-1]
        records = PACKAGES[reader][0].read_records_file(str(path))
        (rec,) = [r for r in records if r.region == "Blocks"]
        assert rec.pp == {"Blocks_BM": 256, "Blocks_BN": 512}
        assert rec.machine == PACKAGES[writer][0].machine_fingerprint()
        line = json.loads(path.read_text().splitlines()[0])
        assert set(line) >= {"machine", "phase", "region", "bp", "pp"}


def test_fingerprints_differ_and_warm_loads_stay_apart(tmp_path):
    assert tat.machine_fingerprint() != jat.machine_fingerprint()
    assert "torch" in tat.machine_fingerprint()
    tuner, _ = _table_session("jax", str(tmp_path))
    tuner.run("install")
    # a port session on the JAX session's workdir finds no record keyed
    # by its own fingerprint, so it measures
    port, _ = _table_session("torch", str(tmp_path))
    port.run("install")
    assert port.executor_calls > 0 and not port.warm_hits


def test_fingerprint_caches_only_on_success(monkeypatch):
    import torch

    from repro_torch.at import records

    tat.reset_fingerprint_cache()
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    assert records.machine_fingerprint().endswith("-notorch")
    assert records._fingerprint_cache is None
    monkeypatch.undo()
    ok = records.machine_fingerprint()
    assert records._fingerprint_cache == ok and not ok.endswith("-notorch")


def test_publish_in_one_package_is_not_seen_in_the_other():
    tat.publish("matmul", block_m=32)
    assert jat.tuned("matmul") == {}
    jat.publish("matmul", block_m=512)
    assert tat.tuned("matmul") == {"block_m": 32}
    assert jat.tuned("matmul") == {"block_m": 512}


def test_quickstart_warm_path_makes_no_measurement(capsys):
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main()           # asserts tuner2.executor_calls == 0
    out = capsys.readouterr().out
    assert "with 0 measurements — OK" in out
    assert "matches numpy matmul — OK" in out

"""BENCHMARK.json against the contract it is checked by and against the
files it names, and the harness finding a new cell and a new metric as
added files alone."""
import json
import re
import shutil

import pytest

from benchcore import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_sizes(bench):
    assert set(bench) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir()
    assert len(bench["command"]) <= 32 and all(_line(w) for w in
                                               bench["command"])
    n = len(bench["workloads"])
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= n <= 24


def test_names_units_and_entries(bench):
    seen = set()
    for kind, keys in (("configs", {"name", "source", "file", "reduced",
                                    "why"}),
                       ("workloads", {"name", "config", "traffic", "chips",
                                      "why"}),
                       ("end_to_end", {"name", "unit", "better", "bound",
                                       "source", "workloads"}),
                       ("per_layer", {"name", "unit", "better", "source",
                                      "layer", "moves", "workloads"})):
        for e in bench[kind]:
            assert set(e) <= keys, (kind, e)
            assert NAME.match(e["name"]), e["name"]
            if kind == "configs":
                assert (e["name"], "c") not in seen
                seen.add((e["name"], "c"))
            for k in ("why", "layer", "source"):
                if k in e and kind in ("configs", "workloads", "per_layer"):
                    if k != "source" or kind == "configs":
                        assert _line(e[k]), (k, e[k])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                  "higher")
                assert e["source"] in SOURCES
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    cells = [w["name"] for w in bench["workloads"]]
    assert len(cells) == len(set(cells))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_end_to_end(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        reported = [m for m in bench["end_to_end"]
                    if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(reported) >= 2, w["name"]
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in bench["per_layer"])


def test_per_layer_moves_a_reported_metric(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_agree_with_benchmark(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    used = set()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell["name"] == w["name"]
        assert (cell["config"], cell["traffic"], cell["chips"]) == \
            (w["config"], w["traffic"], w["chips"])
        assert (ROOT / "bench" / "drivers" / f"{cell['driver']}.py").exists()
        spec.load_traffic(cell["traffic"])
        assert cell["check"]["limits"]
        used.add(w["config"])
    assert used == set(configs)
    for name, c in configs.items():
        assert c["file"] == f"bench/configs/{name}.json"
        conf = spec.load_config(name)
        assert conf["name"] == name and conf["reduced"] == c["reduced"]
        assert c["source"] in conf["source"]
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank", "_size")) \
                or key == "vocab_size"
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = spec.load_module("metrics", m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == \
            (m["unit"], m["better"], m["source"]), m["name"]
        if "layer" in m:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def test_new_cell_and_metric_are_found_as_added_files(tmp_path, cpu_run):
    """A copy of the benchmark plus one cell file, one traffic file, one
    metric file and their BENCHMARK.json entries: the harness runs the new
    cell and reports the new metric, no existing file edited."""
    root = tmp_path / "checkout"
    (root / "bench").mkdir(parents=True)
    for sub in ("benchcore", "cells", "configs", "drivers", "metrics",
                "reference", "roofline", "traffic"):
        shutil.copytree(ROOT / "bench" / sub, root / "bench" / sub)
    shutil.copy(ROOT / "bench" / "run.py", root / "bench" / "run.py")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = json.loads((ROOT / "bench/cells/yi-6b.chat.json").read_text())
    cell.update(name="yi-6b.chat-long", traffic="chat-long")
    (root / "bench/cells/yi-6b.chat-long.json").write_text(json.dumps(cell))
    mix = json.loads((ROOT / "bench/traffic/chat.json").read_text())
    (root / "bench/traffic/chat-long.json").write_text(json.dumps(mix))
    (root / "bench/metrics/tokens_in_window.chat-long.py").write_text(
        'UNIT, BETTER, SOURCE = "tokens", "higher", "program_counter"\n'
        'LAYER, MOVES = "engine (serving/engine.py)", "ttft_p95_s"\n'
        "def read(rec):\n"
        "    from benchcore import readers\n"
        "    return readers.window_tokens(rec)\n")
    bench["workloads"].append({"name": "yi-6b.chat-long", "config": "yi-6b",
                               "traffic": "chat-long", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "yi-6b.chat" in m.get("workloads", []):
            m["workloads"].append("yi-6b.chat-long")
    bench["per_layer"].append({
        "name": "tokens_in_window.chat-long", "unit": "tokens",
        "better": "higher", "source": "program_counter",
        "layer": "engine (serving/engine.py)", "moves": "ttft_p95_s",
        "workloads": ["yi-6b.chat-long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    import run as bench_run

    ctx = cpu_run("yi-6b.chat-long", trace=True, root=root)
    out, _ = bench_run.run_cell(ctx)
    assert out["correct"]
    assert out["metrics"]["tokens_in_window.chat-long"]["value"] > 0
    ctx = cpu_run("yi-6b.chat-long", trace=False, root=root)
    out, _ = bench_run.run_cell(ctx)
    assert set(out["metrics"]) == {"setup_s", "ttft_p95_s", "itl_p95_ms"}

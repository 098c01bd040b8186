"""Everything the harness runs is found by name, from data files and
small modules under ``bench/``:

* ``BENCHMARK.json`` at the checkout's root: the cells, the metrics and
  which cells report each metric;
* ``bench/cells/<cell>.json``: the configuration, the traffic mix, the
  driver, the engine or trainer settings, the check's sample and limits;
* ``bench/configs/<config>.json``: the model's published sizes, the cut,
  and the port's registry key;
* ``bench/traffic/<traffic>.json``: the mix's parameters, read by the one
  generator, :mod:`traffic.generate`;
* ``bench/drivers/<driver>.py``: one window driver per kind of traffic,
  with ``run(ctx) -> record``;
* ``bench/metrics/<metric>.py``: one reader per metric, with ``read(record)
  -> float | None``.

A later cell, configuration or metric is a new file and a new entry of
``BENCHMARK.json``; no file here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

#: the checkout's root (``bench/`` is one level below it)
ROOT = Path(__file__).resolve().parents[2]

_SAFE = re.compile(r"[^A-Za-z0-9_]")


def bench_dir(root: Path = ROOT) -> Path:
    return Path(root) / "bench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> dict:
    return load_json(bench_dir(root) / "cells" / f"{name}.json")


def load_config(name: str, root: Path = ROOT) -> dict:
    return load_json(bench_dir(root) / "configs" / f"{name}.json")


def load_traffic(name: str, root: Path = ROOT) -> dict:
    return load_json(bench_dir(root) / "traffic" / f"{name}.json")


def load_module(kind: str, name: str, root: Path = ROOT):
    """``bench/<kind>/<name>.py`` as a module (a name may hold dots, so
    it is loaded by its path, under a module name of its own)."""
    path = bench_dir(root) / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{_SAFE.sub('_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``kind`` (``end_to_end`` or ``per_layer``) metrics that
    ``cell`` reports: those whose ``workloads`` name it, and those
    without the key."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]

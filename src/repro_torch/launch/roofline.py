"""Roofline analysis: three terms per (arch x shape x mesh), at the rates
of the H100 rows of :data:`repro_torch.core.cost.CHIPS` (the module
defaults are the SXM card's)::

    compute    = FLOPs / (cards x 989.4 TFLOP/s bf16, dense)
    memory     = HBM bytes / (cards x 3.35 TB/s)
    collective = collective bytes / (cards x 50 GB/s, one NDR port each)

* **FLOPs**: the compiled program's per-device dot FLOPs, where a record
  carries them, else the analytic count (:mod:`.analytic`);
  MODEL_FLOPS = 6 N_active D.
* **HBM bytes**: the analytic traffic model (flash-aware attention,
  weight, optimizer and cache traffic).
* **collective bytes**: the record's per-device collective bytes.

A record is one (arch, shape, mesh) cell of a dry run (JSON: ``arch``,
``shape``, ``mesh``, ``chips``, ``plan``, ``hlo_dot_flops``,
``hlo_collective_bytes``, ``bytes_per_device``, or ``skipped`` with a
``reason``), as :mod:`repro_torch.launch.dryrun` writes them.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out build/artifacts
    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --artifacts build/artifacts --mesh single
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass

from ..configs import get_arch, get_shape
from ..core.cost import HBM_BW, ICI_BW, PEAK_FLOPS_BF16
from .analytic import model_flops, step_costs


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    plan: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    analytic_flops: float
    bytes_per_device: float
    skipped: bool = False
    reason: str = ""

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / compiled FLOPs: how much compiled compute is
        useful."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: MODEL_FLOPS-time / roofline step time;
        0 for a row without a bound (a skipped cell has no cards, where
        the JAX package's divides by zero)."""
        if not self.bound_s:
            return 0.0
        ideal = self.model_flops / (self.chips * PEAK_FLOPS_BF16)
        return ideal / self.bound_s


def from_artifact(record: dict) -> Roofline:
    """A record's per-device FLOPs and collective bytes are already per
    card (a compiled SPMD program is the per-device program); the
    analytic model is whole-step, so it divides by ``chips``, and the
    larger of the two FLOP counts is taken (a matvec-shaped decode step
    compiles to reductions, not dots, so its analytic count is the
    reliable one)."""
    if record.get("skipped"):
        return Roofline(record["arch"], record["shape"],
                        record.get("mesh", ""), 0, "", 0, 0, 0, 0, 0, 0, 0,
                        skipped=True, reason=record.get("reason", ""))
    cfg = get_arch(record["arch"])
    shape = get_shape(record["shape"])
    chips = record["chips"]
    hlo_flops_dev = record.get("hlo_dot_flops", 0.0)
    ana = step_costs(cfg, shape)
    mf = model_flops(cfg, shape)
    coll_dev = record.get("hlo_collective_bytes", {}).get("total", 0.0)
    flops_dev = max(hlo_flops_dev, ana.flops / chips)
    return Roofline(
        arch=record["arch"], shape=record["shape"], mesh=record["mesh"],
        chips=chips, plan=record.get("plan", ""),
        compute_s=flops_dev / PEAK_FLOPS_BF16,
        memory_s=ana.bytes / (chips * HBM_BW),
        collective_s=coll_dev / ICI_BW,
        model_flops=mf, hlo_flops=hlo_flops_dev * chips,
        analytic_flops=ana.flops,
        bytes_per_device=record.get("bytes_per_device", 0.0),
    )


def table(artifact_dir: str, mesh_filter: str | None = "single"
          ) -> list[Roofline]:
    rows = []
    for path in sorted(glob.glob(os.path.join(artifact_dir, "*.json"))):
        if mesh_filter and not path.endswith(f"__{mesh_filter}.json"):
            continue
        with open(path) as f:
            rows.append(from_artifact(json.load(f)))
    return rows


def render(rows: list[Roofline]) -> str:
    hdr = (f"{'arch':<24}{'shape':<13}{'plan':<11}"
           f"{'compute_s':>10}{'memory_s':>10}{'collect_s':>10}"
           f"{'dominant':>11}{'MF/HLO':>8}{'roofl%':>8}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.skipped:
            lines.append(f"{r.arch:<24}{r.shape:<13}SKIP: {r.reason[:60]}")
            continue
        lines.append(
            f"{r.arch:<24}{r.shape:<13}{r.plan:<11}"
            f"{r.compute_s:>10.4f}{r.memory_s:>10.4f}{r.collective_s:>10.4f}"
            f"{r.dominant:>11}{r.useful_ratio:>8.2f}"
            f"{100 * r.roofline_fraction:>7.1f}%")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default="experiments/artifacts")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = table(args.artifacts, args.mesh)
    print(render(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([r.__dict__ | {"dominant": r.dominant,
                                     "bound_s": r.bound_s,
                                     "useful_ratio": r.useful_ratio,
                                     "roofline_fraction":
                                         r.roofline_fraction}
                       for r in rows], f, indent=1)


if __name__ == "__main__":
    main()

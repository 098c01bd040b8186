"""Parameter search — paper §6.4.2 (brute-force / AD-HOC + nesting rules).

Semantics reproduced exactly from the paper's Sample 10 worked example.

Regions are ordered outermost-first: ``P = (V(P_1), ..., V(P_m))`` where
``P_m`` is the innermost/last-declared region.  The search "begins from the
innermost AT region, and is made to match the outermost search method":

* **all exhaustive** — one joint Cartesian product across *every scalar
  parameter of every region*: ``prod(N_i)`` evaluations (Sample 10 case 1:
  16 * 32**4 = 16,777,216; the paper prints 1,677,216, an arithmetic typo we
  note and correct).
* **otherwise** — regions are processed sequentially from innermost to
  outermost; each region optimises *its own* parameters with all other
  parameters frozen at their current best:
    - an AD-HOC region descends its scalars one coordinate at a time
      (``sum(N_ij)`` over its scalars), innermost scalar first;
    - a brute-force region takes the joint product over its own scalars
      (``prod(N_ij)``).
  Sample 10: all-AD-HOC = 16+32+32+32+32 = 144; exhaustive-outer/AD-HOC-inner
  = 144 (the AD-HOC regions are fixed first, "treated as constant values",
  then the outer searched); AD-HOC-outer/exhaustive-inner = 16+32*32+32*32
  = 2,064.

Fitting (paper §3.4.3): when a region carries a ``fitting`` spec with sample
points, only the sampled candidates are measured and the optimum over the
full grid is *inferred* (fitting.py).  Without ``fitting`` the search over
that scalar is exhaustive over its ``varied`` range.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from .errors import OATSpecError
from .fitting import auto_sample_points, fitted_minimum
from .region import ATRegion

# --------------------------------------------------------------------------
# scalar axes: one per (region, scalar-parameter)
# --------------------------------------------------------------------------


@dataclass
class Axis:
    """One scalar search coordinate: a single name of a ``varied`` tuple or a
    select region's alternative index."""

    region: ATRegion
    name: str                 # qualified PP name (e.g. MyMatMul_I)
    candidates: tuple
    sampled: tuple | None = None   # measured subset when fitting is active

    @property
    def n(self) -> int:
        return len(self.candidates)

    def measured_points(self) -> tuple:
        return self.sampled if self.sampled is not None else self.candidates


def region_axes(region: ATRegion) -> list[Axis]:
    """Scalar axes of one region (no descendants)."""
    if region.feature == "select":
        return [Axis(region, region.pp_names[0],
                     tuple(range(len(region.subregions))))]
    if region.varied is None:
        return []
    cands = region.varied.candidates()
    sampled = None
    if region.fitting is not None:
        if region.fitting.sampled is not None:
            sampled = tuple(x for x in region.fitting.sampled if x in cands) \
                or tuple(region.fitting.sampled)
        else:  # 'sampled auto'
            sampled = tuple(auto_sample_points(min(cands), max(cands)))
    return [Axis(region, pp, cands, sampled) for pp in region.pp_names]


def tree_axes(root: ATRegion) -> list[Axis]:
    """All axes of a region tree, outermost-first / declaration order."""
    out: list[Axis] = []
    for r in root.flatten():
        out.extend(region_axes(r))
    return out


# --------------------------------------------------------------------------
# search plan — composable, with exact predicted evaluation counts
# --------------------------------------------------------------------------


@dataclass
class SearchResult:
    best: dict[str, Any]
    best_cost: float
    n_evaluations: int
    history: list[tuple[dict, float]] = field(default_factory=list)
    fitted: dict[str, bool] = field(default_factory=dict)


class SearchPlan:
    """A compiled search over a region tree (paper §6.4.2 composition)."""

    def __init__(self, root: ATRegion):
        self.root = root
        self.regions = root.flatten()          # outermost-first
        self.methods = [r.search_method or "brute-force" for r in self.regions]
        self.axes_per_region = [region_axes(r) for r in self.regions]
        self.all_axes = [a for axs in self.axes_per_region for a in axs]
        if not self.all_axes:
            raise OATSpecError(
                f"region {root.name!r} has nothing to search (define-only?)")

    # -- predicted counts (paper's arithmetic, asserted in tests) ----------
    @property
    def all_exhaustive(self) -> bool:
        return all(m == "brute-force" for m in self.methods)

    def num_evaluations(self) -> int:
        """Exact evaluation count of :meth:`run` (the paper's arithmetic)."""
        if self.all_exhaustive and not any(
                a.sampled is not None for a in self.all_axes):
            n = 1
            for a in self.all_axes:
                n *= a.n
            return n
        total = 0
        for axs, m in zip(self.axes_per_region, self.methods):
            if not axs:
                continue
            if m == "brute-force" and len(axs) > 1 and all(
                    a.sampled is None for a in axs):
                p = 1
                for a in axs:
                    p *= a.n
                total += p
            else:  # coordinate pass: one scalar at a time (AD-HOC / fitted)
                total += sum(len(a.measured_points()) for a in axs)
        return total

    # -- execution ---------------------------------------------------------
    def run(self, measure: Callable[[dict[str, Any]], float],
            init: dict[str, Any] | None = None) -> SearchResult:
        """Run the composed search.

        ``measure(assignment)`` returns the cost of one full PP assignment
        (every axis bound).  Lower is better.
        """
        history: list[tuple[dict, float]] = []

        def ev(asg: dict[str, Any]) -> float:
            c = float(measure(dict(asg)))
            history.append((dict(asg), c))
            return c

        current = {a.name: a.candidates[0] for a in self.all_axes}
        if init:
            current.update({k: v for k, v in init.items() if k in current})
        fitted_axes: dict[str, bool] = {}

        if self.all_exhaustive and not any(
                a.sampled is not None for a in self.all_axes):
            best, best_cost = None, float("inf")
            names = [a.name for a in self.all_axes]
            for combo in itertools.product(
                    *[a.candidates for a in self.all_axes]):
                asg = dict(zip(names, combo))
                c = ev(asg)
                if c < best_cost:
                    best, best_cost = asg, c
            return SearchResult(best, best_cost, len(history), history,
                                fitted_axes)

        # sequential inner->outer composition (also used when fitting makes
        # a notionally-exhaustive region sampled: the per-region pass below
        # handles fitting inference per scalar axis).
        for axs, m, region in zip(reversed(self.axes_per_region),
                                  reversed(self.methods),
                                  reversed(self.regions)):
            if not axs:
                continue
            if m == "brute-force" and len(axs) > 1 and all(
                    a.sampled is None for a in axs):
                # joint product over this region's scalars
                best_local, best_cost = None, float("inf")
                for combo in itertools.product(*[a.candidates for a in axs]):
                    asg = dict(current)
                    asg.update(dict(zip([a.name for a in axs], combo)))
                    c = ev(asg)
                    if c < best_cost:
                        best_local, best_cost = combo, c
                current.update(dict(zip([a.name for a in axs], best_local)))
                continue
            # coordinate pass (AD-HOC, single-axis brute-force, or fitted):
            # innermost scalar of the region first (paper Sample 10 varies
            # the last tuple element first).
            for a in reversed(axs):
                pts = list(a.measured_points())
                costs = []
                for v in pts:
                    asg = dict(current)
                    asg[a.name] = v
                    costs.append(ev(asg))
                if a.sampled is not None and a.region.fitting is not None:
                    best_v = fitted_minimum(a.region.fitting, pts, costs,
                                            a.candidates)
                    fitted_axes[a.name] = True
                else:
                    best_v = pts[int(min(range(len(costs)),
                                         key=costs.__getitem__))]
                current[a.name] = best_v

        # cost of the chosen assignment: exact history match when the final
        # pass measured it; for a fitted (inferred, unmeasured) optimum we do
        # NOT re-measure (the paper's flow stops at inference) and report the
        # best measured cost as the achieved bound.
        final_cost = min((c for asg, c in history
                          if all(asg.get(k) == v for k, v in current.items())),
                         default=min(c for _, c in history))
        return SearchResult(dict(current), final_cost, len(history), history,
                            fitted_axes)


# --------------------------------------------------------------------------
# convenience wrappers
# --------------------------------------------------------------------------


def search_region(region: ATRegion,
                  measure: Callable[[dict[str, Any]], float],
                  init: dict[str, Any] | None = None) -> SearchResult:
    return SearchPlan(region).run(measure, init=init)


def predicted_count(region: ATRegion) -> int:
    return SearchPlan(region).num_evaluations()

"""Pluggable search and measurement backends for the ``repro_torch.at`` session.

Two registries, mirroring the paper's two orthogonal axes of tuning:

* :data:`searchers` — how the PP space is traversed.  Entries take a
  compiled :class:`~repro_torch.core.search.SearchPlan` and a ``measure``
  callable and return a :class:`~repro_torch.core.search.SearchResult`.
* :data:`executors` — how one PP assignment is costed.  Entries are
  factories ``(region, bp_env) -> measure(assignment) -> cost``.

New strategies register by name (``@searchers.register("my-search")``)
instead of editing ``core/runtime.py``; an :class:`AutoTuner` selects them
by name per session or per region (``autotune(..., executor="interp")``).

Built-ins:

========  =============================================================
searcher  semantics
========  =============================================================
composed  paper §6.4.2 per-region composition (SearchPlan.run; default)
brute-force  one joint Cartesian product over *all* axes
ad-hoc    coordinate descent over all axes, innermost scalar first
dspline-guided  coordinate pass measuring only d-Spline sample points
          per axis; the optimum over the full range is inferred (§3.4.3)
========  =============================================================

========  =============================================================
executor  semantics
========  =============================================================
wall-clock  times the region's variant callable (synchronises the CUDA
          devices of its result before the clock stops)
analytic-cost  no execution: evaluates ``metadata['cost']`` (expression
          or callable) over BPs + the assignment; if absent, calls the
          variant generator and uses its returned float as the cost
cuda-event  registered by ``tuning/install.py`` — CUDA-event device
          time of the real kernel on the card
========  =============================================================
"""
from __future__ import annotations

import itertools
from typing import Any, Callable

from ..core.errors import OATSpecError
from ..core.executor import CostModelExecutor, WallClockExecutor
from ..core.fitting import auto_sample_points, fit_dspline
from ..core.search import SearchPlan, SearchResult


class BackendRegistry:
    """Name -> backend mapping with a decorator-style ``register``."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, Any] = {}

    def register(self, name: str, obj: Any = None, *,
                 overwrite: bool = False):
        """Register ``obj`` under ``name``; usable as a decorator."""
        def do(o):
            if name in self._entries and not overwrite:
                raise OATSpecError(
                    f"{self.kind} backend {name!r} is already registered "
                    f"(pass overwrite=True to replace it)")
            self._entries[name] = o
            return o
        return do if obj is None else do(obj)

    def get(self, name: str):
        if name not in self._entries:
            raise OATSpecError(
                f"unknown {self.kind} backend {name!r}; registered: "
                f"{sorted(self._entries)}")
        return self._entries[name]

    def names(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries


searchers = BackendRegistry("searcher")
executors = BackendRegistry("executor")


# --------------------------------------------------------------------------
# built-in searchers
# --------------------------------------------------------------------------

@searchers.register("composed")
def composed_search(plan: SearchPlan, measure: Callable[[dict], float],
                    init: dict | None = None) -> SearchResult:
    """The paper's per-region method composition (§6.4.2) — the default."""
    return plan.run(measure, init=init)


@searchers.register("brute-force")
def brute_force_search(plan: SearchPlan, measure: Callable[[dict], float],
                       init: dict | None = None) -> SearchResult:
    """Joint exhaustive product over every axis of the region tree.

    Pinned axes (``init`` — user Def-file collisions, §6.3) are held
    fixed, not enumerated.
    """
    history: list[tuple[dict, float]] = []
    pinned = dict(init or {})
    free = [a for a in plan.all_axes if a.name not in pinned]
    names = [a.name for a in free]
    best, best_cost = None, float("inf")
    for combo in itertools.product(*[a.candidates for a in free]):
        asg = dict(pinned)
        asg.update(zip(names, combo))
        c = float(measure(dict(asg)))
        history.append((dict(asg), c))
        if c < best_cost:
            best, best_cost = asg, c
    return SearchResult(best, best_cost, len(history), history)


@searchers.register("ad-hoc")
def ad_hoc_search(plan: SearchPlan, measure: Callable[[dict], float],
                  init: dict | None = None) -> SearchResult:
    """Coordinate descent over all axes, innermost scalar first."""
    return _coordinate_search(plan, measure, init, guided=False)


@searchers.register("dspline-guided")
def dspline_guided_search(plan: SearchPlan, measure: Callable[[dict], float],
                          init: dict | None = None) -> SearchResult:
    """Coordinate pass measuring only d-Spline sample points per axis.

    For each numeric axis with enough candidates, only the paper's
    ``auto`` sample points are measured; the optimum over the full
    candidate range is inferred from the fitted d-Spline (§3.4.3).
    """
    return _coordinate_search(plan, measure, init, guided=True)


def _coordinate_search(plan: SearchPlan, measure, init, *,
                       guided: bool) -> SearchResult:
    history: list[tuple[dict, float]] = []

    def ev(asg: dict) -> float:
        c = float(measure(dict(asg)))
        history.append((dict(asg), c))
        return c

    current = {a.name: a.candidates[0] for a in plan.all_axes}
    if init:
        current.update({k: v for k, v in init.items() if k in current})
    fitted: dict[str, bool] = {}
    for a in reversed(plan.all_axes):
        pts = list(a.measured_points())
        numeric = all(isinstance(v, (int, float)) and not isinstance(v, bool)
                      for v in a.candidates)
        if guided and a.sampled is None and numeric and len(a.candidates) >= 5:
            samples = [v for v in auto_sample_points(
                min(a.candidates), max(a.candidates)) if v in a.candidates]
            if len(samples) >= 4:
                pts = samples
        costs = []
        for v in pts:
            asg = dict(current)
            asg[a.name] = v
            costs.append(ev(asg))
        if len(pts) < len(a.candidates) and numeric:
            pred = fit_dspline([float(p) for p in pts], costs)
            import numpy as np

            grid = np.asarray([float(c) for c in a.candidates])
            current[a.name] = a.candidates[int(np.argmin(pred(grid)))]
            fitted[a.name] = True
        else:
            current[a.name] = pts[min(range(len(costs)),
                                      key=costs.__getitem__)]
    final_cost = min((c for asg, c in history
                      if all(asg.get(k) == v for k, v in current.items())),
                     default=min(c for _, c in history))
    return SearchResult(dict(current), final_cost, len(history), history,
                        fitted)


# --------------------------------------------------------------------------
# built-in executors
# --------------------------------------------------------------------------

def variant_kwargs(region, assignment: dict, bp_env: dict) -> dict:
    """Bare kwargs for a region's variant generator from a PP assignment."""
    out: dict = {}
    for r in region.flatten():
        if r.varied is None:
            continue
        for bare, pp in zip(r.varied.names, r.pp_names):
            if pp in assignment:
                out[bare] = assignment[pp]
    out.update({k: v for k, v in bp_env.items() if k in region.bp_names})
    return out


@executors.register("wall-clock")
def wall_clock_executor(region, bp_env: dict) -> Callable[[dict], float]:
    """Time the variant callable (the paper's measurement semantics)."""
    def make_variant(assignment: dict) -> Callable[[], Any]:
        kwargs = variant_kwargs(region, assignment, bp_env)
        return lambda: region.fn(**kwargs)
    return WallClockExecutor(make_variant, repeats=1, warmup=0)


@executors.register("analytic-cost")
def analytic_cost_executor(region, bp_env: dict) -> Callable[[dict], float]:
    """Cost without execution (``according estimated`` generalised).

    Uses ``region.metadata['cost']`` (expression string or callable over
    BPs + the assignment) when present; otherwise the variant generator
    itself is treated as the cost model — it is called and its returned
    value (or the value returned by the callable it produces) is the cost.
    """
    cost = region.metadata.get("cost")
    if cost is not None:
        return CostModelExecutor(cost, env=dict(bp_env))

    def measure(assignment: dict) -> float:
        out = region.fn(**variant_kwargs(region, assignment, bp_env))
        if callable(out):
            out = out()
        return float(out)
    return measure

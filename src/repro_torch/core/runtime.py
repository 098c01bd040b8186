"""FIBER runtime — the paper's §4 API (OAT_ATexec / ATset / ATdel / ...).

Implements install-time, before-execute-time (*static*) and run-time
(*dynamic*) auto-tuning over registered :class:`~.region.ATRegion` objects,
with the paper's exact semantics:

* execution priority install -> static -> dynamic; deviation raises
  :class:`OATPriorityError` (§3.2);
* install/static AT will not run unless the default basic parameters are set
  (§4.2.2) — :class:`OATMissingBasicParamError`;
* static AT sweeps the BP sample points ``OAT_STARTTUNESIZE ..
  OAT_ENDTUNESIZE step OAT_SAMPDIST`` (plus any user BPs registered with
  ``OAT_BPset``/``OAT_BPsetName``) and records per-BP-point optima in nested
  ``(OAT_PROBSIZE <size> (Region_P v) ...)`` records (§4.2.2);
* parameter collision (§6.3): a PP pinned in a user ``...Def`` file halts AT
  for that parameter and the user value is force-set;
* run-time AT is only *armed* by ``OAT_ATexec(OAT_DYNAMIC, ...)``; actual
  tuning happens when the region is invoked (§4.1), one candidate per call
  until all alternatives have been observed, then the winner is committed;
* ``OAT_DynPerfThis`` executes a region with previously-optimised parameters
  and performs no tuning (§4.2.3).
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from . import paramfile
from .cost import According
from .errors import (OATMissingBasicParamError, OATParamCollisionError,
                     OATPriorityError, OATSpecError)
from .executor import WallClockExecutor
from .fitting import fit_dspline, fit_polynomial, fit_user_defined
from .params import (DEFAULT_BASIC_PARAMS, OAT_DEBUG, OAT_ENDTUNESIZE,
                     OAT_NUMPROCS, OAT_SAMPDIST, OAT_STARTTUNESIZE,
                     OAT_TUNEDYNAMIC, OAT_TUNESTATIC, ParamStore)
from .region import ATRegion, RegionRegistry
from .search import SearchPlan

# paper §6.1 tuning-type constants
OAT_ALL = 0
OAT_INSTALL = 1
OAT_STATIC = 2
OAT_DYNAMIC = 3

_KIND_PHASE = {OAT_INSTALL: "install", OAT_STATIC: "static",
               OAT_DYNAMIC: "dynamic"}

OAT_PROBSIZE = "OAT_PROBSIZE"


@dataclass
class BPSpec:
    """A user basic parameter registered via OAT_BPset / OAT_BPsetName."""

    name: str
    start_name: str = ""
    end_name: str = ""
    dist_name: str = ""
    cdf: str | None = None     # OAT_BPsetCDF method string

    def sample_points(self, store: ParamStore) -> list[int]:
        start = store.get_bp(self.start_name or OAT_STARTTUNESIZE)
        end = store.get_bp(self.end_name or OAT_ENDTUNESIZE)
        dist = store.get_bp(self.dist_name or OAT_SAMPDIST)
        if start is None or end is None or dist is None:
            raise OATMissingBasicParamError(
                f"sample range for basic parameter {self.name!r} is not set")
        return list(range(int(start), int(end) + 1, int(dist)))


@dataclass
class DynamicState:
    tried: dict[int, float] = field(default_factory=dict)   # cand -> cost
    committed: int | None = None
    env_seen: dict[int, dict] = field(default_factory=dict)


class ATContext:
    """One auto-tuning universe: registry + parameter store + files."""

    def __init__(self, workdir: str = ".", feedback: bool = False,
                 executor_factory: Callable[..., Callable] | None = None):
        self.workdir = workdir
        self.store = ParamStore(feedback=feedback)
        self.registry = RegionRegistry()
        self.phase_ran = {"install": False, "static": False, "dynamic": False}
        self.routines: dict[str, list[str]] = {
            "install": [], "static": [], "dynamic": []}
        self.bp_specs: dict[str, BPSpec] = {}
        self.collisions: list[tuple[str, str, Any]] = []   # (region, pp, value)
        self.dynamic_state: dict[str, DynamicState] = {}
        self.dynamic_armed = False
        self.debug_lines: list[str] = []
        self.search_log: dict[str, int] = {}
        # executor_factory(region, bp_env) -> measure(assignment)->cost;
        # default: wall-clock over the region's variant generator.
        self._executor_factory = executor_factory or self._default_executor
        # searcher(plan, measure, init) -> SearchResult; None keeps the
        # paper's per-region method composition (SearchPlan.run).  The
        # repro_torch.at session sets this from its `searchers` registry.
        self.searcher: Callable | None = None

    # ------------------------------------------------------------------
    # registration (decorators in directives.py call these)
    # ------------------------------------------------------------------
    def register(self, region: ATRegion) -> ATRegion:
        self.registry.register(region)
        if region.parent is None:
            self.routines[region.at_type].append(region.name)
        return region

    # paper API ---------------------------------------------------------
    def OAT_ATset(self, kind: int, names: list[str] | str) -> None:
        phase = _KIND_PHASE[kind]
        if isinstance(names, str):
            names = [names]
        for n in names:
            self.registry.get(n)           # must exist
            if n not in self.routines[phase]:
                self.routines[phase].append(n)

    def OAT_ATdel(self, routines: str, name: str) -> None:
        phase = {"OAT_InstallRoutines": "install",
                 "OAT_StaticRoutines": "static",
                 "OAT_DynamicRoutines": "dynamic"}.get(routines, routines)
        if phase not in self.routines:
            raise OATSpecError(f"unknown routine set {routines!r}")
        if name in self.routines[phase]:
            self.routines[phase].remove(name)

    def OAT_ATInstallInit(self, routines: str | None = None) -> None:
        """Undo install-time tuning so it can run again (§4.2.1)."""
        self.phase_ran["install"] = False
        self.store.layers["install"].clear()

    def OAT_BPset(self, name: str) -> None:
        self.bp_specs.setdefault(name, BPSpec(name))

    def OAT_BPsetName(self, kind: str, bp: str, param_name: str) -> None:
        spec = self.bp_specs.setdefault(bp, BPSpec(bp))
        k = kind.strip().upper().strip('"')
        if k == "STARTTUNESIZE":
            spec.start_name = param_name
        elif k == "ENDTUNESIZE":
            spec.end_name = param_name
        elif k == "SAMPDIST":
            spec.dist_name = param_name
        else:
            raise OATSpecError(f"unknown BPsetName kind {kind!r}")

    def OAT_BPsetCDF(self, bp: str, cdf: str) -> None:
        self.bp_specs.setdefault(bp, BPSpec(bp)).cdf = cdf

    # ------------------------------------------------------------------
    # OAT_ATexec — the main entry (§4.1)
    # ------------------------------------------------------------------
    def OAT_ATexec(self, kind: int, routines: list[str] | str | None = None
                   ) -> None:
        kinds = [OAT_INSTALL, OAT_STATIC, OAT_DYNAMIC] if kind == OAT_ALL \
            else [kind]
        for k in kinds:
            phase = _KIND_PHASE[k]
            names = self._resolve_routines(phase, routines)
            self._check_priority(phase)
            if phase == "install":
                self._run_install(names)
            elif phase == "static":
                self._run_static(names)
            else:
                self._arm_dynamic(names)
            self.phase_ran[phase] = True

    def _resolve_routines(self, phase: str, routines) -> list[str]:
        if routines is None or routines in (
                "OAT_InstallRoutines", "OAT_StaticRoutines",
                "OAT_DynamicRoutines"):
            return list(self.routines[phase])
        if routines == "OAT_AllRoutines":
            return [n for n in self.registry.all_names()
                    if self.registry.get(n).at_type == phase]
        if isinstance(routines, str):
            return [routines]
        return list(routines)

    def _check_priority(self, phase: str) -> None:
        """§3.2 — install -> static -> dynamic, strictly."""
        if phase == "static":
            if self.routines["install"] and not self.phase_ran["install"]:
                raise OATPriorityError(
                    "before execute-time AT requested but install-time AT has "
                    "not run (paper §3.2 execution priority)")
            if not self.store.has_default_bps():
                raise OATMissingBasicParamError(
                    "before execute-time AT will not run if the basic "
                    "parameters are not set (paper §4.2.2)")
            if not bool(self.store.get_bp(OAT_TUNESTATIC, True)):
                return
        if phase == "dynamic":
            if self.routines["static"] and not self.phase_ran["static"] \
                    and bool(self.store.get_bp(OAT_TUNESTATIC, True)):
                raise OATPriorityError(
                    "run-time AT requested but before execute-time AT has "
                    "not run (paper §3.2 execution priority)")
        if phase == "install" and not self.store.has_default_bps():
            raise OATMissingBasicParamError(
                "install-time AT will not run unless OAT_NUMPROCS, "
                "OAT_STARTTUNESIZE, OAT_ENDTUNESIZE and OAT_SAMPDIST are set "
                "(paper §4.2.2)")

    # ------------------------------------------------------------------
    # install-time
    # ------------------------------------------------------------------
    def _default_executor(self, region: ATRegion, bp_env: dict
                          ) -> Callable[[dict], float]:
        def make_variant(assignment: dict) -> Callable[[], Any]:
            kwargs = self._bare(region, assignment)
            kwargs.update({k: v for k, v in bp_env.items()
                           if k in region.bp_names})
            return lambda: region.fn(**kwargs)
        return WallClockExecutor(make_variant, repeats=1, warmup=0)

    @staticmethod
    def _bare(region: ATRegion, assignment: dict) -> dict:
        """Map qualified PP names (MyMatMul_I) back to bare kwargs (i)."""
        out = {}
        for r in region.flatten():
            if r.varied is None:
                continue
            for bare, pp in zip(r.varied.names, r.pp_names):
                if pp in assignment:
                    out[bare] = assignment[pp]
        return out

    def _pinned_values(self, phase: str, region: ATRegion) -> dict[str, Any]:
        """User Def-file pins for this region (collision source, §6.3)."""
        pins: dict[str, Any] = {}
        for path in (paramfile.param_path(self.workdir, phase, "", user=True),
                     paramfile.param_path(self.workdir, phase, region.name,
                                          user=True)):
            for node in paramfile.load_file(path):
                if node.name in (region.name, "BasicParam"):
                    for c in node.walk():
                        if not c.children and c.value is not None:
                            pins[c.name] = c.value
        return pins

    def _tune_one(self, region: ATRegion, phase: str, bp_env: dict,
                  strict_collision: bool = False) -> dict[str, Any]:
        """Search one region tree; returns {qualified PP: value}."""
        if region.prepro:
            region.prepro()
        try:
            if region.feature == "define":
                # run the body; it returns {out-param: value}
                out = region.fn(**{k: v for k, v in bp_env.items()
                                   if k in region.bp_names}) or {}
                for p in region.params:
                    if p.attr == "out" and p.name not in out:
                        raise OATSpecError(
                            f"define region {region.name!r} did not produce "
                            f"out parameter {p.name!r}")
                return dict(out)

            pins = self._pinned_values(phase, region)
            plan = SearchPlan(region)
            pp_names = [a.name for a in plan.all_axes]
            colliding = {k: v for k, v in pins.items() if k in pp_names}
            for k, v in colliding.items():
                self.collisions.append((region.name, k, v))
            if colliding:
                if strict_collision:
                    raise OATParamCollisionError(
                        f"parameter collision in region {region.name!r}: "
                        f"{sorted(colliding)} pinned by user file (§6.3)")
                if set(colliding) >= set(pp_names):
                    return dict(colliding)   # fully pinned: AT halts, force-set

            if region.feature == "select" and region.subregions and all(
                    s.according is not None and s.according.estimated
                    is not None for s in region.subregions):
                # cost-estimated selection — no execution (Sample 5)
                env = dict(self.store.env(phase))
                env.update(bp_env)
                costs = [s.according.estimated_cost(env)
                         for s in region.subregions]
                best = min(range(len(costs)), key=costs.__getitem__)
                return {region.pp_names[0]: best}

            measure = self._executor_factory(region, bp_env)
            if self.searcher is not None:
                res = self.searcher(plan, measure, init=colliding or None)
            else:
                res = plan.run(measure, init=colliding or None)
            self.search_log[region.name] = res.n_evaluations
            best = dict(res.best)
            best.update(colliding)           # pins always win
            if int(self.store.get_bp(OAT_DEBUG, 0) or 0) >= 1:
                self.debug_lines.append(
                    f"[OAT_DEBUG] {phase} {region.name} pp={best} "
                    f"cost={res.best_cost:.3e} evals={res.n_evaluations}")
            return best
        finally:
            if region.postpro:
                region.postpro()

    def _run_install(self, names: list[str]) -> None:
        nodes: list[paramfile.Node] = []
        for name in names:
            region = self.registry.get(name)
            best = self._tune_one(region, "install", dict(self.store.bp))
            rec = paramfile.Node(region.name)
            for k, v in best.items():
                self.store.set_pp(k, v, "install")
                rec.set(k, v)
            nodes.append(rec)
        path = paramfile.param_path(self.workdir, "install")
        existing = {n.name: n for n in paramfile.load_file(path)}
        for n in nodes:
            existing[n.name] = n
        paramfile.save_file(path, list(existing.values()))

    # ------------------------------------------------------------------
    # before-execute-time (static)
    # ------------------------------------------------------------------
    def _bp_grid(self) -> list[dict[str, int]]:
        """Cartesian grid over the default BP sweep and user BPs."""
        default_pts = list(range(
            int(self.store.get_bp(OAT_STARTTUNESIZE)),
            int(self.store.get_bp(OAT_ENDTUNESIZE)) + 1,
            int(self.store.get_bp(OAT_SAMPDIST))))
        axes: list[tuple[str, list[int]]] = [(OAT_PROBSIZE, default_pts)]
        for spec in self.bp_specs.values():
            axes.append((spec.name, spec.sample_points(self.store)))
        out = []
        for combo in itertools.product(*[pts for _, pts in axes]):
            out.append({k: v for (k, _), v in zip(axes, combo)})
        return out

    def _run_static(self, names: list[str]) -> None:
        if not bool(self.store.get_bp(OAT_TUNESTATIC, True)):
            return
        grid = self._bp_grid()
        nodes: list[paramfile.Node] = []
        header = paramfile.Node("BasicParam")
        for k in DEFAULT_BASIC_PARAMS:
            if self.store.get_bp(k) is not None:
                header.set(k, self.store.get_bp(k))
        nodes.append(header)
        for name in names:
            region = self.registry.get(name)
            rec = paramfile.Node(region.name)
            rec.set(OAT_NUMPROCS, self.store.get_bp(OAT_NUMPROCS))
            rec.set(OAT_SAMPDIST, self.store.get_bp(OAT_SAMPDIST))
            for bp_env in grid:
                env = dict(self.store.bp)
                env.update(bp_env)
                best = self._tune_one(region, "static", env)
                group = paramfile.Node(OAT_PROBSIZE, bp_env[OAT_PROBSIZE])
                for k, v in bp_env.items():
                    if k != OAT_PROBSIZE:
                        group.set(k, v)
                for k, v in best.items():
                    group.set(k, v)
                rec.children.append(group)
                bp_key = tuple(sorted(bp_env.items()))
                for k, v in best.items():
                    self.store.set_pp(f"{k}@{bp_key}", v, "static")
                    # latest BP point also lands on the plain name so
                    # downstream phases can read it without the BP key
                    self.store.set_pp(k, v, "static")
            nodes.append(rec)
        path = paramfile.param_path(self.workdir, "static")
        existing = {n.name: n for n in paramfile.load_file(path)}
        for n in nodes:
            existing[n.name] = n
        paramfile.save_file(path, list(existing.values()))

    def static_pp(self, region_name: str, pp: str, probsize: int,
                  reader_phase: str = "dynamic") -> Any:
        """Read a static-tuned PP for an arbitrary problem size.

        Sample points are read exactly; non-sample points are inferred with
        the BP's CDF (OAT_BPsetCDF; default dspline) over the recorded
        (probsize, pp) pairs.
        """
        path = paramfile.param_path(self.workdir, "static")
        xs, ys = [], []
        for node in paramfile.load_file(path):
            if node.name != region_name:
                continue
            for g in node.children:
                if g.name == OAT_PROBSIZE and g.child(pp) is not None:
                    xs.append(int(g.value))
                    ys.append(g.child_value(pp))
        if not xs:
            raise OATSpecError(
                f"no static parameter {pp!r} recorded for {region_name!r}")
        if probsize in xs:
            return ys[xs.index(probsize)]
        cdf = None
        for spec in self.bp_specs.values():
            if spec.cdf:
                cdf = spec.cdf
                break
        ysf = [float(y) for y in ys]
        if cdf and cdf.startswith("least-squares"):
            order = int(cdf.split()[1]) if len(cdf.split()) > 1 else 2
            pred = fit_polynomial(xs, ysf, order)
        elif cdf and cdf.startswith("user-defined"):
            pred = fit_user_defined(xs, ysf, cdf.split(None, 1)[1])
        else:
            pred = fit_dspline(xs, ysf)
        import numpy as np
        val = float(pred(np.array([probsize]))[0])
        return int(round(val)) if all(
                isinstance(y, int) for y in ys) else val

    # ------------------------------------------------------------------
    # run-time (dynamic)
    # ------------------------------------------------------------------
    def _arm_dynamic(self, names: list[str]) -> None:
        self.dynamic_armed = True
        for n in names:
            self.dynamic_state.setdefault(n, DynamicState())

    def execute(self, name: str, *args, **kwargs) -> Any:
        """Invoke a tuning region.

        For a dynamic region that is armed and uncommitted, each call measures
        the next untried candidate; once all have been observed the winner is
        committed (per its ``according`` criterion, default wall-clock).
        """
        region = self.registry.get(name)
        if region.at_type != "dynamic" or not self.dynamic_armed \
                or name not in self.dynamic_state:
            return self._run_committed(region, args, kwargs)
        st = self.dynamic_state[name]
        if st.committed is not None:
            return self._run_candidate(region, st.committed, args, kwargs)[0]

        n_cands = region.n_candidates()
        nxt = next((i for i in range(n_cands) if i not in st.tried), None)
        if nxt is None:
            st.committed = self._commit_dynamic(region, st)
            return self._run_candidate(region, st.committed, args, kwargs)[0]
        out, cost, env = self._run_candidate(region, nxt, args, kwargs,
                                             want_env=True)
        st.tried[nxt] = cost
        st.env_seen[nxt] = env
        if all(i in st.tried for i in range(n_cands)):
            st.committed = self._commit_dynamic(region, st)
            self._write_dynamic_file(region, st)
        return out

    def _commit_dynamic(self, region: ATRegion, st: DynamicState) -> int:
        acc: According | None = region.according
        cands = list(st.tried)
        if acc is not None and acc.minimize:
            ok = [i for i in cands
                  if acc.conditions_hold(st.env_seen.get(i, {}))]
            pool = ok or cands
            return min(pool, key=lambda i: st.env_seen.get(i, {}).get(
                acc.minimize, st.tried[i]))
        return min(cands, key=st.tried.__getitem__)

    def _run_candidate(self, region: ATRegion, idx: int, args, kwargs,
                       want_env: bool = False):
        if region.prepro:
            region.prepro()
        try:
            t0 = time.perf_counter()
            if region.feature == "select":
                fn = region.subregions[idx].fn
                out = fn(*args, **kwargs)
            else:
                vals = list(region.varied.candidates())
                pp = {b: vals[min(idx, len(vals) - 1)]
                      for b in region.varied.names}
                out = region.fn(*args, **pp, **kwargs)
            cost = time.perf_counter() - t0
        finally:
            if region.postpro:
                region.postpro()
        env = out if isinstance(out, dict) else {}
        if want_env:
            return out, cost, env
        return out, cost

    def _run_committed(self, region: ATRegion, args, kwargs) -> Any:
        """Run with previously-optimised PPs (also OAT_DynPerfThis §4.2.3)."""
        if region.feature == "select":
            idx = 0
            st = self.dynamic_state.get(region.name)
            if st and st.committed is not None:
                idx = st.committed
            else:
                e = self.store.entry(region.pp_names[0])
                if e is not None:
                    idx = int(e.value)
            return region.subregions[idx].fn(*args, **kwargs)
        pp = {}
        for bare, q in zip(region.varied.names if region.varied else (),
                           region.pp_names):
            e = self.store.entry(q)
            if e is not None:
                pp[bare] = e.value
        if not pp and region.varied is not None:
            pp = {b: region.varied.candidates()[0]
                  for b in region.varied.names}
        return region.fn(*args, **pp, **kwargs)

    def OAT_DynPerfThis(self, name: str, *args, **kwargs) -> Any:
        """Execute with optimised parameters; no tuning here (§4.2.3)."""
        return self._run_committed(self.registry.get(name), args, kwargs)

    def _write_dynamic_file(self, region: ATRegion, st: DynamicState) -> None:
        rec = paramfile.Node(region.name)
        rec.set(region.pp_names[0] if region.pp_names else "SELECT",
                st.committed)
        path = paramfile.param_path(self.workdir, "dynamic", region.name)
        paramfile.save_file(path, [rec])
        self.store.set_pp(region.pp_names[0] if region.pp_names else
                          f"{region.name}_SELECT", st.committed, "dynamic")


# module-level default context mirroring the paper's common-block globals
_default: ATContext | None = None


def default_context() -> ATContext:
    global _default
    if _default is None:
        _default = ATContext()
    return _default


def reset_default_context(workdir: str = ".", **kw) -> ATContext:
    global _default
    _default = ATContext(workdir=workdir, **kw)
    return _default

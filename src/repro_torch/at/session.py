"""The ``AutoTuner`` session — one coherent frontend over the FIBER runtime.

This subsumes the four historical frontends (the ``#OAT$`` comment DSL, the
``install_unroll``-family decorators, the ``SelectRegion`` class, and raw
``OAT_ATexec`` calls) behind a single object:

    import repro_torch.at as at

    tuner = at.AutoTuner(workdir)
    tuner.set_bps(numprocs=1, start=1024, end=4096, dist=1024)

    @tuner.autotune("install", "variable", name="MatmulBlocks",
                    varied=at.Varied(("bm", "bn"), values=(128, 256, 512)),
                    search="ad-hoc", publish=("matmul", {"bm": "block_m",
                                                         "bn": "block_n"}))
    def matmul_blocks(bm=128, bn=128):
        ...

    sel = tuner.autotune("dynamic", "select", name="DecodeBucket_512")
    sel.alternative(name="bk=256")(decode_256)

    tuner.run("install")            # warm-loads from the ATRecordStore,
                                    # tunes only what has no record
    at.tuned("matmul")              # {'block_m': 256, 'block_n': 128}

Kernels call :func:`tuned` instead of importing ``ops.set_tuned``
side-channels; tuned optima persist across processes through the
:class:`~repro_torch.at.records.ATRecordStore` (install/static results are
re-loaded without re-timing — zero executor invocations on the warm path).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

from ..core import paramfile
from ..core.cost import According
from ..core.directives import _coerce_params, region as _region_decorator
from ..core.errors import OATSpecError
from ..core.params import (DEFAULT_BASIC_PARAMS, OAT_ENDTUNESIZE,
                           OAT_NUMPROCS, OAT_SAMPDIST, OAT_STARTTUNESIZE)
from ..core.region import ATRegion, Subregion
from ..core.runtime import (OAT_ALL, OAT_DYNAMIC, OAT_INSTALL, OAT_PROBSIZE,
                            OAT_STATIC, ATContext)
from ..core.search import SearchPlan
from .backends import executors, searchers
from .records import ATRecordStore, bp_key, open_record_store

PHASE_ORDER = ("install", "static", "dynamic")
_PHASE_KIND = {"install": OAT_INSTALL, "static": OAT_STATIC,
               "dynamic": OAT_DYNAMIC}

_BP_ALIASES = {
    "numprocs": OAT_NUMPROCS, "start": OAT_STARTTUNESIZE,
    "end": OAT_ENDTUNESIZE, "dist": OAT_SAMPDIST,
}

# --------------------------------------------------------------------------
# published kernel PPs — the lookup the kernel layer reads (replaces the
# ops.set_tuned side-channel; ops.set_tuned is now a shim over publish())
# --------------------------------------------------------------------------

_published: dict[str, dict[str, Any]] = {}
_published_bp: dict[tuple, dict[str, Any]] = {}   # (kernel, bp_key) -> pps


def publish(kernel: str, **pps: Any) -> None:
    """Record tuned PPs for a kernel (machine-global within the process)."""
    _published.setdefault(kernel, {}).update(pps)


def publish_for_bp(kernel: str, bp: dict[str, Any], **pps: Any) -> None:
    _published_bp.setdefault((kernel, bp_key(bp)), {}).update(pps)


def tuned(kernel: str, **bps: Any) -> dict[str, Any]:
    """Tuned PPs for ``kernel``; a BP point selects per-size static optima.

    ``tuned("matmul")`` returns install-time (machine-scoped) optima;
    ``tuned("matmul", OAT_PROBSIZE=2048)`` overlays any static optimum
    recorded for that exact BP point.
    """
    out = dict(_published.get(kernel, {}))
    if bps:
        out.update(_published_bp.get((kernel, bp_key(bps)), {}))
    return out


def clear_published() -> None:
    """Reset the published-PP tables (test isolation)."""
    _published.clear()
    _published_bp.clear()


# --------------------------------------------------------------------------
# session-level handles
# --------------------------------------------------------------------------

_current: "AutoTuner | None" = None


def current_session() -> "AutoTuner | None":
    return _current


def use_session(session: "AutoTuner | None") -> "AutoTuner | None":
    global _current
    prev, _current = _current, session
    return prev


class TunedRegion:
    """Handle returned by :meth:`AutoTuner.autotune` for non-select regions.

    Callable — invoking it executes the region through the runtime with the
    currently-committed PPs (run-time AT happens here for dynamic regions).
    """

    def __init__(self, session: "AutoTuner", region: ATRegion):
        self.session = session
        self.region = region

    @property
    def name(self) -> str:
        return self.region.name

    def __call__(self, *args, **kwargs) -> Any:
        return self.session.execute(self.region.name, *args, **kwargs)

    def best(self) -> dict[str, Any]:
        return self.session.best(self.region.name)


class SelectHandle:
    """Handle that declares ``select`` regions under a session.

    Unlike the legacy ``SelectRegion``, the region registers immediately —
    there is no ``finalize`` step to forget (it remains as a no-op for
    migration ease).  Alternatives append via the ``alternative`` decorator.
    """

    def __init__(self, session: "AutoTuner", phase: str, name: str, *,
                 params: Sequence = (), according=None, search=None,
                 number=None, parent: ATRegion | None = None,
                 metadata: dict | None = None):
        self.session = session
        if isinstance(according, str):
            according = According.parse(according)
        self.region = ATRegion(
            at_type=phase, feature="select", name=name,
            params=_coerce_params(params), according=according,
            search=search, number=number, metadata=metadata or {})
        if parent is not None:
            parent.add_child(self.region)
            session.ctx.registry.register(self.region)
        else:
            session.ctx.register(self.region)

    @property
    def name(self) -> str:
        return self.region.name

    def alternative(self, according=None, name: str = "") -> Callable:
        if isinstance(according, str):
            according = According.parse(according)

        def deco(fn: Callable) -> Callable:
            self.region.subregions.append(
                Subregion(fn=fn, according=according,
                          name=name or fn.__name__))
            return fn
        return deco

    def finalize(self) -> ATRegion:
        return self.region          # compat no-op: already registered

    def __call__(self, *args, **kwargs) -> Any:
        return self.session.execute(self.region.name, *args, **kwargs)


# --------------------------------------------------------------------------
# the session object
# --------------------------------------------------------------------------

class AutoTuner:
    """One auto-tuning session: context + parameter store + record DB.

    Parameters
    ----------
    workdir:
        Where parameter files and the tuning database live.
    ctx:
        Adopt an existing :class:`ATContext` instead of creating one
        (migration path for callers holding a raw context).
    machine:
        Override the machine fingerprint records are keyed by.
    executor:
        Default executor backend name (``at.executors``) for regions that
        do not select one via ``autotune(..., executor=...)``.
    searcher:
        Optional searcher backend name (``at.searchers``); ``None`` keeps
        the paper's per-region method composition.
    record_backend:
        Tuning-DB storage backend name (``at.record_backends``):
        ``"jsonl"`` (default) or ``"sqlite"``.
    golden_db:
        Path to a read-only golden winner DB (a record file of winners)
        overlaid under the local store:
        local record beats golden, golden beats cold — a fresh workdir
        pointed at a golden DB warm-loads with zero measurements.
    """

    def __init__(self, workdir: str = ".", *, ctx: ATContext | None = None,
                 machine: str | None = None, feedback: bool = False,
                 executor: str = "wall-clock", searcher: str | None = None,
                 records: ATRecordStore | None = None,
                 record_backend: str = "jsonl",
                 golden_db: str | None = None):
        self.ctx = ctx or ATContext(workdir, feedback=feedback)
        self.workdir = self.ctx.workdir
        self.records = records or open_record_store(
            self.workdir, backend=record_backend, machine=machine,
            golden_db=golden_db)
        self.executor = executor
        self.executor_calls = 0
        self.warm_hits: list[tuple[str, str]] = []    # (phase, region)
        self._publish_maps: dict[str, tuple[str, dict]] = {}
        self._dynamic_persisted: set[str] = set()
        # adopting a context that already carries a caller-supplied
        # executor factory (the pre-session API) keeps it: that factory
        # measures every region, as it did before the session existed
        prior = self.ctx._executor_factory
        self._adopted_factory = None if getattr(
            prior, "__func__", None) is ATContext._default_executor else prior
        self.ctx._executor_factory = self._executor_factory
        if searcher is not None:
            self.ctx.searcher = searchers.get(searcher)
        self.ctx._at_session = self
        use_session(self)

    @classmethod
    def for_context(cls, ctx: "ATContext | AutoTuner") -> "AutoTuner":
        """The session owning ``ctx`` (created and cached on first use)."""
        if isinstance(ctx, AutoTuner):
            return ctx
        existing = getattr(ctx, "_at_session", None)
        if existing is not None:
            return existing
        return cls(ctx=ctx)

    # ------------------------------------------------------------------
    # basic parameters
    # ------------------------------------------------------------------
    def set_bps(self, **bps: Any) -> "AutoTuner":
        """Set basic parameters; lowercase aliases map to the OAT names
        (``numprocs``/``start``/``end``/``dist``)."""
        for k, v in bps.items():
            self.ctx.store.set_bp(_BP_ALIASES.get(k, k), v)
        return self

    def ensure_default_bps(self, numprocs: int = 1, start: int = 1024,
                           end: int = 4096, dist: int = 1024) -> "AutoTuner":
        if not self.ctx.store.has_default_bps():
            self.set_bps(numprocs=numprocs, start=start, end=end, dist=dist)
        return self

    # ------------------------------------------------------------------
    # declaration — the one decorator
    # ------------------------------------------------------------------
    def autotune(self, phase: str = "install", feature: str = "variable", *,
                 name: str | None = None, varied=None, fitting=None,
                 params: Sequence = (), according=None, search=None,
                 number=None, executor: str | Callable | None = None,
                 cost=None, publish: tuple[str, dict] | None = None,
                 prepro=None, postpro=None, debug: tuple = (),
                 parent: ATRegion | None = None, metadata: dict | None = None):
        """Declare a tuning region (all four legacy frontends in one).

        * ``feature='variable' | 'unroll' | 'define'`` — returns a decorator
          for a variant generator; the decorated object is a callable
          :class:`TunedRegion` handle.
        * ``feature='select'`` — returns a :class:`SelectHandle` handle
          (``.alternative`` decorator; no ``finalize`` needed).
        * ``publish=(kernel, {pp: kernel_kwarg})`` wires tuned values into
          :func:`tuned` for the kernel layer (PP keys may be bare ``varied``
          names or qualified ``Region_PP`` names).
        * ``executor`` / ``cost`` select the measurement backend for this
          region (``at.executors`` name, or an inline cost model).
        """
        md = dict(metadata or {})
        if executor is not None:
            md["executor"] = executor
        if cost is not None:
            md["cost"] = cost
        if feature == "select":
            if name is None:
                raise OATSpecError("select regions require a name")
            handle = SelectHandle(self, phase, name, params=params,
                                  according=according, search=search,
                                  number=number, parent=parent, metadata=md)
            if publish is not None:
                self._publish_maps[name] = publish
            return handle

        def deco(fn: Callable) -> TunedRegion:
            r = _region_decorator(
                self.ctx, phase, feature, name or fn.__name__,
                varied=varied, fitting=fitting, params=params,
                according=according, search=search, number=number,
                prepro=prepro, postpro=postpro, debug=debug, parent=parent,
                metadata=md)(fn)
            if publish is not None:
                self._publish_maps[r.name] = publish
            return TunedRegion(self, r)
        return deco

    def preprocess(self, fn: Callable, outdir: str | None = None
                   ) -> dict[str, ATRegion]:
        """The comment-DSL path: expand ``#OAT$`` directives in ``fn`` via
        OATCodeGen and register the resulting regions with this session."""
        from ..core.dsl import preprocess as _preprocess
        return _preprocess(fn, self.ctx, outdir)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _executor_factory(self, region: ATRegion, bp_env: dict
                          ) -> Callable[[dict], float]:
        if self._adopted_factory is not None:
            factory = self._adopted_factory
        else:
            backend = region.metadata.get("executor") or self.executor
            factory = executors.get(backend) if isinstance(backend, str) \
                else backend
        inner = factory(region, bp_env)

        def measure(assignment: dict) -> float:
            self.executor_calls += 1
            return inner(assignment)
        return measure

    def run(self, phase: str | int = "all",
            routines: Sequence[str] | None = None,
            force: bool = False) -> dict[str, list[str]]:
        """Run one or all tuning phases, warm-loading persisted optima.

        For each region: if the :class:`ATRecordStore` holds a record for
        this machine + region + BP point (all grid points, for static), the
        optimum is applied without invoking any executor; otherwise the
        region is tuned through ``OAT_ATexec`` and the result persisted.
        ``force=True`` re-tunes everything.  Returns ``{phase: tuned
        region names}`` (warm loads excluded — see :attr:`warm_hits`).
        """
        if phase in (OAT_ALL, "all"):
            phases: tuple[str, ...] = PHASE_ORDER
        elif phase in _PHASE_KIND:
            phases = (str(phase),)
        elif phase in (OAT_INSTALL, OAT_STATIC, OAT_DYNAMIC):
            phases = ({v: k for k, v in _PHASE_KIND.items()}[phase],)
        else:
            raise OATSpecError(f"unknown phase {phase!r}")
        ran: dict[str, list[str]] = {}
        for ph in phases:
            names = list(routines) if routines is not None \
                else list(self.ctx.routines[ph])
            if ph == "dynamic":
                if names:
                    self.ctx.OAT_ATexec(OAT_DYNAMIC, names)
                    if not force:
                        self._warm_dynamic(names)
                ran[ph] = names
                continue
            warm: list[tuple[str, Any]] = []
            cold: list[str] = []
            for n in names:
                rec = None if force else self._warm_lookup(ph, n)
                if rec is not None:
                    warm.append((n, rec))
                else:
                    cold.append(n)
            if warm:
                self._apply_warm(ph, warm)
            if cold:
                self.ctx.OAT_ATexec(_PHASE_KIND[ph], cold)
                self._persist_phase(ph, cold)
            elif names:
                self.ctx.phase_ran[ph] = True
            for n in names:
                self._publish_region(self.ctx.registry.get(n))
            ran[ph] = cold
        return ran

    def execute(self, name: str, *args, **kwargs) -> Any:
        """Invoke a region (run-time AT happens here for dynamic regions);
        newly-committed dynamic winners are persisted to the record store."""
        out = self.ctx.execute(name, *args, **kwargs)
        st = self.ctx.dynamic_state.get(name)
        if st is not None and st.committed is not None \
                and name not in self._dynamic_persisted:
            region = self.ctx.registry.get(name)
            pp_name = region.pp_names[0] if region.pp_names \
                else f"{name}_SELECT"
            # OAT_NUMALT stamps the record with the size of the variant
            # space the winner index is valid against: a later session
            # whose region has grown (e.g. a new num_splits axis) must
            # re-measure instead of committing a stale index
            self.records.put("dynamic", name, {},
                             {pp_name: st.committed,
                              "OAT_NUMALT": len(region.subregions)},
                             cost=st.tried.get(st.committed))
            self._dynamic_persisted.add(name)
            self._publish_region(region)
        return out

    def best(self, region_name: str) -> dict[str, Any]:
        """The tuned PP assignment currently committed for a region."""
        region = self.ctx.registry.get(region_name)
        out: dict[str, Any] = {}
        for pp in self._pp_names(region):
            e = self.ctx.store.entry(pp)
            if e is not None:
                out[pp] = e.value
        return out

    def static_pp(self, region_name: str, pp: str, probsize: int) -> Any:
        """Static-tuned PP at an arbitrary problem size (CDF-interpolated)."""
        return self.ctx.static_pp(region_name, pp, probsize)

    # ------------------------------------------------------------------
    # warm path / persistence
    # ------------------------------------------------------------------
    @staticmethod
    def _pp_names(region: ATRegion) -> list[str]:
        if region.feature == "define":
            return [p.name for p in region.params if p.attr == "out"]
        try:
            return [a.name for a in SearchPlan(region).all_axes]
        except OATSpecError:
            return []

    def _warm_lookup(self, phase: str, name: str):
        if phase == "install":
            rec = self.records.lookup("install", name, {})
            return rec if rec is not None and rec.pp else None
        # static: every BP grid point must be recorded
        try:
            grid = self.ctx._bp_grid()
        except Exception:
            return None
        out = []
        for bp_env in grid:
            rec = self.records.lookup("static", name, bp_env)
            if rec is None or not rec.pp:
                return None
            out.append((bp_env, rec))
        return out

    def _apply_warm(self, phase: str, warm: list[tuple[str, Any]]) -> None:
        if phase == "install":
            path = paramfile.param_path(self.workdir, "install")
            nodes = {n.name: n for n in paramfile.load_file(path)}
            for name, rec in warm:
                node = paramfile.Node(name)
                for k, v in rec.pp.items():
                    self.ctx.store.set_pp(k, v, "install")
                    node.set(k, v)
                nodes[name] = node
                self.warm_hits.append(("install", name))
            paramfile.save_file(path, list(nodes.values()))
        else:
            path = paramfile.param_path(self.workdir, "static")
            nodes = {n.name: n for n in paramfile.load_file(path)}
            header = paramfile.Node("BasicParam")
            for k in DEFAULT_BASIC_PARAMS:
                if self.ctx.store.get_bp(k) is not None:
                    header.set(k, self.ctx.store.get_bp(k))
            nodes["BasicParam"] = header
            for name, recs in warm:
                node = paramfile.Node(name)
                node.set(OAT_NUMPROCS, self.ctx.store.get_bp(OAT_NUMPROCS))
                node.set(OAT_SAMPDIST, self.ctx.store.get_bp(OAT_SAMPDIST))
                for bp_env, rec in recs:
                    group = paramfile.Node(OAT_PROBSIZE,
                                           bp_env[OAT_PROBSIZE])
                    for k, v in bp_env.items():
                        if k != OAT_PROBSIZE:
                            group.set(k, v)
                    key = bp_key(bp_env)
                    for k, v in rec.pp.items():
                        group.set(k, v)
                        self.ctx.store.set_pp(f"{k}@{key}", v, "static")
                        self.ctx.store.set_pp(k, v, "static")
                    node.children.append(group)
                nodes[name] = node
                self.warm_hits.append(("static", name))
            paramfile.save_file(path, list(nodes.values()))
        self.ctx.phase_ran[phase] = True

    def _persist_phase(self, phase: str, names: list[str]) -> None:
        path = paramfile.param_path(self.workdir, phase)
        nodes = {n.name: n for n in paramfile.load_file(path)}
        for name in names:
            node = nodes.get(name)
            if node is None:
                continue
            region = self.ctx.registry.get(name)
            n_evals = self.ctx.search_log.get(name)
            if phase == "install":
                pp = {c.name: c.value for c in node.children
                      if not c.children and c.value is not None}
                if pp:
                    self.records.put("install", name, {}, pp,
                                     n_evaluations=n_evals)
                continue
            pp_names = set(self._pp_names(region))
            for group in node.children:
                if group.name != OAT_PROBSIZE:
                    continue
                bp = {OAT_PROBSIZE: group.value}
                pp = {}
                for c in group.children:
                    (pp if c.name in pp_names else bp)[c.name] = c.value
                if pp:
                    self.records.put("static", name, bp, pp,
                                     n_evaluations=n_evals)

    def _warm_dynamic(self, names: list[str]) -> None:
        for name in names:
            rec = self.records.lookup("dynamic", name, {})
            if rec is None or not rec.pp:
                continue
            region = self.ctx.registry.get(name)
            st = self.ctx.dynamic_state.get(name)
            if st is None or st.committed is not None:
                continue
            pp = dict(rec.pp)
            n_alt = pp.pop("OAT_NUMALT", None)
            if not pp:
                continue
            if n_alt is not None and int(n_alt) != len(region.subregions):
                # the variant space grew/shrank since this winner was
                # recorded (its index means something else now): fall
                # through to a cold re-measure of just this region
                continue
            pp_name, idx = next(iter(pp.items()))
            st.committed = int(idx)
            self.ctx.store.set_pp(pp_name, int(idx), "dynamic")
            self._dynamic_persisted.add(name)
            self.warm_hits.append(("dynamic", name))
            self._publish_region(region)

    # ------------------------------------------------------------------
    # publishing into the kernel-layer lookup
    # ------------------------------------------------------------------
    def _publish_region(self, region: ATRegion) -> None:
        spec = self._publish_maps.get(region.name)
        if spec is None:
            return
        kernel, mapping = spec
        vals: dict[str, Any] = {}
        for src, dst in mapping.items():
            e = self.ctx.store.entry(src) \
                or self.ctx.store.entry(f"{region.name}_{src.upper()}")
            if e is not None:
                vals[dst] = e.value
        if vals:
            publish(kernel, **vals)
        if region.at_type == "static":
            for rec in self.records.lookup_all("static", region.name):
                per_bp: dict[str, Any] = {}
                for src, dst in mapping.items():
                    qual = f"{region.name}_{src.upper()}"
                    if src in rec.pp:
                        per_bp[dst] = rec.pp[src]
                    elif qual in rec.pp:
                        per_bp[dst] = rec.pp[qual]
                if per_bp:
                    publish_for_bp(kernel, rec.bp, **per_bp)

"""AT region model (paper §3.4).

A *tuning region* (AT region) is the program fragment between
``!OAT$ ... region start`` and ``!OAT$ ... region end``.  It carries:

  * an auto-tuning type (``install`` / ``static`` / ``dynamic``),
  * a feature name (``define`` / ``variable`` / ``select`` / ``unroll``),
  * subtype specifiers (``name``, ``parameter``, ``varied``, ``fitting``,
    ``according``, ``number``, ``prepro``/``postpro``, ``debug``),
  * nested child regions (nesting legality per paper §6.4.1).

In this adaptation a region wraps a *variant generator*: a callable that,
given concrete PP values as keyword arguments, returns a runnable
implementation.  ``select`` regions carry a list of sub-region
alternatives instead.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from .errors import OATNestingError, OATSpecError
from .params import ParamDecl, Varied

FEATURES = ("define", "variable", "select", "unroll")
AT_TYPES = ("install", "static", "dynamic")

# Paper Table 1 — nesting availability by auto-tuning type
# (superior row may nest subordinate column)
_TYPE_NEST = {
    "install": {"install"},
    "static": {"install", "static"},
    "dynamic": {"install", "static", "dynamic"},
}

# Paper Table 2 — nesting availability by feature (unroll may nest nothing)
_FEATURE_NEST = {
    "define": set(FEATURES),
    "variable": set(FEATURES),
    "select": set(FEATURES),
    "unroll": set(),
}

MAX_NEST_DEPTH = 3  # paper §6.4.1

# Paper §6.4.2 — default search method per feature
DEFAULT_SEARCH = {
    "define": None,          # no search needed
    "variable": "brute-force",
    "select": "ad-hoc",
    "unroll": "brute-force",
}


@dataclass
class Fitting:
    """``fitting <method> sampled <scope>`` (paper §3.4.3)."""

    method: str = "auto"           # least-squares | dspline | user-defined | auto
    order: int = 2                 # polynomial order for least-squares
    expr: str | None = None        # user-defined basis expression over 'x'
    sampled: list[int] | None = None  # sample points; None => 'auto'

    @classmethod
    def least_squares(cls, order: int, sampled=None) -> "Fitting":
        return cls("least-squares", order=order, sampled=list(sampled) if sampled else None)

    @classmethod
    def dspline(cls, sampled=None) -> "Fitting":
        return cls("dspline", sampled=list(sampled) if sampled else None)

    @classmethod
    def user_defined(cls, expr: str, sampled=None) -> "Fitting":
        return cls("user-defined", expr=expr, sampled=list(sampled) if sampled else None)

    @classmethod
    def auto(cls) -> "Fitting":
        return cls("auto")


@dataclass
class Subregion:
    """One alternative of a ``select`` region (``select sub region``)."""

    fn: Callable
    according: Any = None       # According object (cost.py) or None
    name: str = ""


@dataclass
class ATRegion:
    at_type: str
    feature: str
    name: str
    fn: Callable | None = None              # variant generator (PPs as kwargs)
    params: list[ParamDecl] = field(default_factory=list)
    varied: Varied | None = None
    fitting: Fitting | None = None
    according: Any = None                   # region-level According (select)
    subregions: list[Subregion] = field(default_factory=list)
    number: int | None = None               # processing order override
    prepro: Callable | None = None
    postpro: Callable | None = None
    debug: tuple = ()
    search: str | None = None               # brute-force | ad-hoc | None=default
    children: list["ATRegion"] = field(default_factory=list)
    parent: "ATRegion | None" = None
    metadata: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.at_type not in AT_TYPES:
            raise OATSpecError(f"unknown auto-tuning type {self.at_type!r}")
        if self.feature not in FEATURES:
            raise OATSpecError(f"unknown feature {self.feature!r}")
        if self.feature in ("variable", "unroll") and self.varied is None:
            raise OATSpecError(
                f"{self.feature} region {self.name!r} requires a `varied` range")

    # ---------------------------------------------------------------
    @property
    def search_method(self) -> str | None:
        return self.search if self.search is not None else DEFAULT_SEARCH[self.feature]

    @property
    def pp_names(self) -> tuple[str, ...]:
        """Qualified PP names, paper style: ``MyMatMul_I`` etc."""
        if self.feature == "select":
            return (f"{self.name}_SELECT",)
        if self.varied is None:
            return ()
        return tuple(f"{self.name}_{n.upper()}" for n in self.varied.names)

    @property
    def bp_names(self) -> tuple[str, ...]:
        return tuple(p.name for p in self.params if p.attr == "bp")

    def n_candidates(self) -> int:
        if self.feature == "select":
            return len(self.subregions)
        if self.varied is None:
            return 1
        return self.varied.n ** len(self.varied.names)

    # ---------------------------------------------------------------
    def add_child(self, child: "ATRegion") -> "ATRegion":
        if child.at_type not in _TYPE_NEST[self.at_type]:
            raise OATNestingError(
                f"a {self.at_type!r} region may not nest a {child.at_type!r} "
                f"region (paper Table 1)")
        if child.feature not in _FEATURE_NEST[self.feature]:
            raise OATNestingError(
                f"a {self.feature!r} region may not nest a {child.feature!r} "
                f"region (paper Table 2)")
        if self.depth() + 1 >= MAX_NEST_DEPTH + 1:
            raise OATNestingError(
                f"maximum nesting depth is {MAX_NEST_DEPTH} (paper §6.4.1)")
        child.parent = self
        self.children.append(child)
        return child

    def depth(self) -> int:
        d, r = 1, self
        while r.parent is not None:
            d += 1
            r = r.parent
        return d

    def flatten(self) -> list["ATRegion"]:
        """Self + descendants, in declaration order (respecting `number`)."""
        out = [self]
        for c in self.children:
            out.extend(c.flatten())
        return out


class RegionRegistry:
    """The paper's OAT_AllRoutines / OAT_<Phase>Routines storage (§4.1)."""

    def __init__(self):
        self._regions: dict[str, ATRegion] = {}

    def register(self, region: ATRegion) -> ATRegion:
        if region.name in self._regions:
            raise OATSpecError(f"duplicate tuning region name {region.name!r}")
        self._regions[region.name] = region
        return region

    def delete(self, name: str) -> None:
        """OAT_ATdel semantics — remove a region from the candidates."""
        self._regions.pop(name, None)

    def get(self, name: str) -> ATRegion:
        if name not in self._regions:
            raise OATSpecError(f"unknown tuning region {name!r}")
        return self._regions[name]

    def __contains__(self, name: str) -> bool:
        return name in self._regions

    def by_phase(self, phase: str) -> list[ATRegion]:
        rs = [r for r in self._regions.values()
              if r.at_type == phase and r.parent is None]
        # `number` overrides declaration (first-to-last) order; only outermost
        # regions may carry a number (paper §3.4.3)
        numbered = sorted((r for r in rs if r.number is not None),
                          key=lambda r: r.number)
        rest = [r for r in rs if r.number is None]
        return numbered + rest

    def all_names(self) -> list[str]:
        return list(self._regions)

    def clear(self) -> None:
        self._regions.clear()

"""Basic / performance parameters and the FIBER visibility hierarchy.

Paper §3.3: two parameter kinds —
  * **BP** (basic parameters): set by the end user (problem size, #procs).
  * **PP** (performance parameters): chosen by the tuner, conditioned on BPs.

Paper Fig. 4 (hierarchy of parameter information referencing):
  * install-determined params are visible to static and dynamic phases;
  * static-determined params are visible only to the dynamic phase;
  * dynamic-determined params are visible only to the dynamic phase;
  * exception — the *feedback model*: static may re-read dynamic results.

Paper §6.3 (collisions): a value pinned in a *user specification file* halts
AT for that parameter and is force-set.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from .errors import OATHierarchyError, OATSpecError

PHASES = ("install", "static", "dynamic")
PHASE_RANK = {p: i for i, p in enumerate(PHASES)}

# Default basic parameters (paper §4.2.2 / §6.1 reserved words)
OAT_NUMPROCS = "OAT_NUMPROCS"
OAT_STARTTUNESIZE = "OAT_STARTTUNESIZE"
OAT_ENDTUNESIZE = "OAT_ENDTUNESIZE"
OAT_SAMPDIST = "OAT_SAMPDIST"
OAT_TUNESTATIC = "OAT_TUNESTATIC"
OAT_TUNEDYNAMIC = "OAT_TUNEDYNAMIC"
OAT_DEBUG = "OAT_DEBUG"

DEFAULT_BASIC_PARAMS = (OAT_NUMPROCS, OAT_STARTTUNESIZE, OAT_ENDTUNESIZE,
                        OAT_SAMPDIST)

RESERVED_WORDS = frozenset(DEFAULT_BASIC_PARAMS) | {
    OAT_TUNESTATIC, OAT_TUNEDYNAMIC, OAT_DEBUG,
    "OAT_ALL", "OAT_INSTALL", "OAT_STATIC", "OAT_DYNAMIC",
    "OAT_AllRoutines", "OAT_InstallRoutines", "OAT_StaticRoutines",
    "OAT_DynamicRoutines",
}


@dataclass(frozen=True)
class ParamDecl:
    """A ``parameter (<attr> <name>, ...)`` entry (paper §3.4.3).

    attr is one of ``in`` (defined externally, read here), ``out`` (defined in
    this tuning region) or ``bp`` (basic parameter).
    """

    name: str
    attr: str = "in"  # in | out | bp

    def __post_init__(self):
        if self.attr not in ("in", "out", "bp"):
            raise OATSpecError(f"bad parameter attribute {self.attr!r}")


@dataclass
class ParamEntry:
    value: Any
    phase: str                # phase that determined it
    bp_key: tuple | None = None   # BP context it was tuned under (static PPs)
    pinned: bool = False      # came from a user Def file (collision source)


class ParamStore:
    """Layered parameter store implementing the FIBER hierarchy.

    Values live in one of three phase layers plus a BP layer (BPs are set by
    the user and visible everywhere).  ``get`` enforces Fig. 4 visibility:
    a reader at phase *r* may see values determined at phase *d* iff
    ``rank(d) <= rank(r)``, except that dynamic-determined values are visible
    only to dynamic readers (which the rank rule already gives) and, when
    ``feedback`` is enabled, static readers may also see dynamic values
    (the FIBER feedback model, paper §3.1 footnote).
    """

    def __init__(self, feedback: bool = False):
        self.feedback = feedback
        self.bp: dict[str, Any] = {}
        self.layers: dict[str, dict[str, ParamEntry]] = {p: {} for p in PHASES}

    # -- BPs --------------------------------------------------------------
    def set_bp(self, name: str, value: Any) -> None:
        self.bp[name] = value

    def get_bp(self, name: str, default: Any = None) -> Any:
        return self.bp.get(name, default)

    def has_default_bps(self) -> bool:
        return all(k in self.bp for k in DEFAULT_BASIC_PARAMS)

    # -- PPs --------------------------------------------------------------
    def set_pp(self, name: str, value: Any, phase: str,
               bp_key: tuple | None = None, pinned: bool = False) -> None:
        if phase not in PHASES:
            raise OATSpecError(f"unknown phase {phase!r}")
        self.layers[phase][name] = ParamEntry(value, phase, bp_key, pinned)

    def entry(self, name: str) -> ParamEntry | None:
        # dynamic shadows static shadows install (later phases refine)
        for p in reversed(PHASES):
            if name in self.layers[p]:
                return self.layers[p][name]
        return None

    def get(self, name: str, reader_phase: str, default: Any = None) -> Any:
        """Visibility-checked read (paper Fig. 4)."""
        if name in self.bp:
            return self.bp[name]
        e = self.entry(name)
        if e is None:
            return default
        if PHASE_RANK[e.phase] > PHASE_RANK[reader_phase]:
            if self.feedback and reader_phase == "static" and e.phase == "dynamic":
                return e.value  # FIBER feedback model
            raise OATHierarchyError(
                f"parameter {name!r} determined at {e.phase!r} is not visible "
                f"to a {reader_phase!r} reader (FIBER hierarchy, paper Fig.4)")
        return e.value

    def is_pinned(self, name: str) -> bool:
        e = self.entry(name)
        return e is not None and e.pinned

    def env(self, reader_phase: str) -> dict[str, Any]:
        """All parameters visible to ``reader_phase`` (for cost expressions)."""
        out: dict[str, Any] = {}
        for p in PHASES:
            if PHASE_RANK[p] > PHASE_RANK[reader_phase] and not (
                    self.feedback and reader_phase == "static" and p == "dynamic"):
                continue
            for k, e in self.layers[p].items():
                out[k] = e.value
        out.update(self.bp)
        return out


@dataclass
class Varied:
    """``varied (p[, p]) from X to Y [step S]`` — the PP search range."""

    names: tuple[str, ...]
    lo: int
    hi: int
    step: int = 1
    values: tuple | None = None   # explicit candidate list overrides lo..hi

    def __init__(self, names, lo: int = 1, hi: int = 1, step: int = 1,
                 values=None):
        if isinstance(names, str):
            names = (names,)
        self.names = tuple(names)
        self.lo, self.hi, self.step = lo, hi, step
        self.values = tuple(values) if values is not None else None

    def candidates(self) -> tuple:
        if self.values is not None:
            return self.values
        return tuple(range(self.lo, self.hi + 1, self.step))

    @property
    def n(self) -> int:
        return len(self.candidates())


def parse_sampled(spec: str | list | tuple) -> list[int]:
    """Parse the paper's ``sampled (1-5, 8, 16)`` notation."""
    if isinstance(spec, (list, tuple)):
        return [int(x) for x in spec]
    s = spec.strip().strip("()")
    out: list[int] = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part[1:]:  # allow negative first char
            a, b = part.split("-", 1)
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out

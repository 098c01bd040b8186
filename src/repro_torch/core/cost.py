"""Selection criteria — the ``according`` subtype specifier (paper §3.4.3).

    according (<conditional expression> | estimated <expr>)

    <conditional expression> ::=
        [ (min(<param>) | condition(<cond>)) <connector> ]
        <connector> ::= [.and. | .or.] <conditional expression>

``estimated <expr>`` selects the sub-region with the minimum user-defined
cost, evaluated over the visible parameter environment (Sample 5 uses
``2.0d0*CacheSize*OAT_PROBSIZE**2 / (3.0d0*OAT_NUMPROC)`` style formulas).

We accept Fortran-flavoured expressions (``2.0d0``, ``dlog``, ``.and.``,
``.or.``, ``.true.``) and translate them to Python before evaluation in a
restricted namespace.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Callable

from .errors import OATSpecError

_SAFE = {
    "log": math.log, "dlog": math.log, "log2": math.log2, "exp": math.exp,
    "sqrt": math.sqrt, "dsqrt": math.sqrt, "abs": math.abs if hasattr(math, "abs") else abs,
    "min": min, "max": max, "ceil": math.ceil, "floor": math.floor,
    "pi": math.pi, "true": True, "false": False,
}


def fortran_to_python(expr: str) -> str:
    """Translate Fortran90-style formula syntax to Python."""
    e = expr
    e = re.sub(r"(\d+(?:\.\d*)?)[dD]([+-]?\d+)", r"\1e\2", e)   # 2.0d0 -> 2.0e0
    e = e.replace(".and.", " and ").replace(".AND.", " and ")
    e = e.replace(".or.", " or ").replace(".OR.", " or ")
    e = e.replace(".not.", " not ").replace(".NOT.", " not ")
    e = e.replace(".true.", "True").replace(".false.", "False")
    e = re.sub(r"(?<![*/])\*\*", "**", e)                        # keep powers
    e = re.sub(r"\.eq\.", "==", e, flags=re.I)
    e = re.sub(r"\.ne\.", "!=", e, flags=re.I)
    e = re.sub(r"\.lt\.", "<", e, flags=re.I)
    e = re.sub(r"\.le\.", "<=", e, flags=re.I)
    e = re.sub(r"\.gt\.", ">", e, flags=re.I)
    e = re.sub(r"\.ge\.", ">=", e, flags=re.I)
    return e


def eval_expr(expr: str, env: dict[str, Any]) -> Any:
    ns = dict(_SAFE)
    ns.update(env)
    try:
        return eval(fortran_to_python(expr), {"__builtins__": {}}, ns)  # noqa: S307
    except NameError as e:
        raise OATSpecError(f"unknown name in expression {expr!r}: {e}") from e
    except Exception as e:
        raise OATSpecError(f"failed to evaluate expression {expr!r}: {e}") from e


@dataclass
class According:
    """Selection criterion for a ``select`` (sub-)region.

    Exactly one of:
      * ``estimated`` — cost expression string or callable(env)->float,
        minimised across sub-regions;
      * ``minimize``  — parameter name whose *measured* value is minimised
        (the paper's ``min(eps)``), optionally combined with ``conditions``
        via ``.and.``/``.or.`` connectors.
    """

    estimated: str | Callable | None = None
    minimize: str | None = None
    conditions: list[str] = field(default_factory=list)
    connectors: list[str] = field(default_factory=list)  # 'and' | 'or', len = len(conditions) joined with minimize

    @classmethod
    def parse(cls, text: str) -> "According":
        """Parse the paper's textual form, e.g.
        ``min (eps) .and. condition (iter < 5)`` or ``estimated <expr>``."""
        t = text.strip()
        if t.lower().startswith("estimated"):
            return cls(estimated=t[len("estimated"):].strip())
        acc = cls()
        # split on .and. / .or. at top level
        parts = re.split(r"(\.and\.|\.or\.)", t)
        for p in parts:
            p = p.strip()
            if not p:
                continue
            if p in (".and.", ".or."):
                acc.connectors.append(p.strip("."))
                continue
            m = re.match(r"min\s*\((.+)\)\s*$", p)
            if m:
                acc.minimize = m.group(1).strip()
                continue
            m = re.match(r"condition\s*\((.+)\)\s*$", p)
            if m:
                acc.conditions.append(m.group(1).strip())
                continue
            raise OATSpecError(f"cannot parse according clause {p!r}")
        return acc

    # ------------------------------------------------------------------
    def estimated_cost(self, env: dict[str, Any]) -> float:
        if self.estimated is None:
            raise OATSpecError("according has no estimated cost")
        if callable(self.estimated):
            return float(self.estimated(env))
        return float(eval_expr(self.estimated, env))

    def conditions_hold(self, env: dict[str, Any]) -> bool:
        """Evaluate condition(...) clauses.  Connector semantics: clauses are
        combined left-to-right with the recorded connectors ('and' default)."""
        if not self.conditions:
            return True
        vals = [bool(eval_expr(c, env)) for c in self.conditions]
        out = vals[0]
        # connectors may also join min() with conditions; use trailing ones
        conns = self.connectors[-(len(vals) - 1):] if len(vals) > 1 else []
        for v, c in zip(vals[1:], conns + ["and"] * (len(vals) - 1 - len(conns))):
            out = (out or v) if c == "or" else (out and v)
        return out


# --------------------------------------------------------------------------
# Built-in roofline cost model (TPU v5e, as in the JAX package; the
# port's static AT will bring H100 constants) — used as a first-class `estimated`
# callable by the static-AT tuner and available to user expressions as
# roofline_seconds(flops, bytes, coll_bytes, chips).
# --------------------------------------------------------------------------

PEAK_FLOPS_BF16 = 197e12      # per chip
HBM_BW = 819e9                # bytes/s per chip
ICI_BW = 50e9                 # bytes/s per link


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Roofline lower bound on step time (max of the three terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def overlap_s(self) -> float:
        """Perfectly-overlapped model: max(compute, memory, collective)."""
        return self.bound_s


def roofline_terms(total_flops: float, total_bytes: float,
                   collective_bytes: float, chips: int,
                   peak_flops: float = PEAK_FLOPS_BF16,
                   hbm_bw: float = HBM_BW, ici_bw: float = ICI_BW
                   ) -> RooflineTerms:
    """The three roofline terms in seconds (totals across `chips`)."""
    return RooflineTerms(
        compute_s=total_flops / (chips * peak_flops),
        memory_s=total_bytes / (chips * hbm_bw),
        collective_s=collective_bytes / (chips * ici_bw),
    )


def roofline_seconds(flops: float, bytes_: float, coll_bytes: float,
                     chips: int = 1) -> float:
    return roofline_terms(flops, bytes_, coll_bytes, chips).bound_s

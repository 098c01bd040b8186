"""`#OAT$` directive language — parsing + the full preprocessor pipeline.

This is the literal adaptation of the paper's annotation flow: a Python
function carrying ``#OAT$`` comment directives is preprocessed by
:class:`~.codegen.OATCodeGen` into variants under ``./OAT/``, and this module
turns each annotated region into a registered :class:`~.region.ATRegion` so
``OAT_ATexec`` can tune it.

Subtype-specifier parsers accept the paper's surface syntax::

    varied (i, j) from 1 to 16
    fitting least-squares 5 sampled (1-5, 8, 16)
    parameter (bp n, in CacheSize, out CacheLine)
    according min (eps) .and. condition (iter < 5)
    according estimated 2.0d0*CacheSize*OAT_PROBSIZE**2/(3.0d0*OAT_NUMPROC)
    search AD-HOC | search Brute-force
"""
from __future__ import annotations

import re
from typing import Callable

from .codegen import (GeneratedVariant, OATCodeGen, RegionSource,
                      extract_regions)
from .cost import According
from .errors import OATSpecError
from .params import ParamDecl, Varied, parse_sampled
from .region import ATRegion, Fitting, Subregion
from .runtime import ATContext

_VARIED_RE = re.compile(
    r"\(?\s*([\w\s,]+?)\s*\)?\s+from\s+(-?\d+)\s+to\s+(-?\d+)"
    r"(?:\s+step\s+(-?\d+))?\s*$")


def parse_varied(text: str) -> Varied:
    m = _VARIED_RE.match(text.strip())
    if not m:
        raise OATSpecError(f"cannot parse varied clause {text!r}")
    names = tuple(n.strip() for n in m.group(1).split(","))
    return Varied(names, int(m.group(2)), int(m.group(3)),
                  int(m.group(4) or 1))


def parse_fitting(text: str) -> Fitting:
    t = text.strip()
    m = re.match(r"(least-squares\s+\d+|dspline|auto|user-defined\s+.+?)"
                 r"(?:\s+sampled\s+(.+))?$", t)
    if not m:
        raise OATSpecError(f"cannot parse fitting clause {text!r}")
    method_part, sampled_part = m.group(1), m.group(2)
    sampled = None
    if sampled_part and sampled_part.strip() != "auto":
        sampled = parse_sampled(sampled_part)
    if method_part.startswith("least-squares"):
        return Fitting("least-squares", order=int(method_part.split()[1]),
                       sampled=sampled)
    if method_part == "dspline":
        return Fitting("dspline", sampled=sampled)
    if method_part == "auto":
        return Fitting("auto", sampled=sampled)
    return Fitting("user-defined", expr=method_part.split(None, 1)[1],
                   sampled=sampled)


def parse_parameter(text: str) -> list[ParamDecl]:
    t = text.strip().strip("()")
    out: list[ParamDecl] = []
    for item in t.split(","):
        parts = item.split()
        if not parts:
            continue
        if len(parts) == 2:
            out.append(ParamDecl(parts[1], parts[0]))
        else:
            out.append(ParamDecl(parts[0]))
    return out


def parse_search(text: str) -> str:
    t = text.strip().lower()
    if t in ("brute-force", "bruteforce", "exhaustive"):
        return "brute-force"
    if t in ("ad-hoc", "adhoc"):
        return "ad-hoc"
    raise OATSpecError(f"unknown search method {text!r}")


def region_from_source(reg: RegionSource) -> ATRegion:
    """Build an (unregistered, fn-less) ATRegion from parsed directives."""
    kw: dict = {}
    if "varied" in reg.subtypes:
        kw["varied"] = parse_varied(reg.subtypes["varied"])
    if "fitting" in reg.subtypes:
        kw["fitting"] = parse_fitting(reg.subtypes["fitting"])
    if "parameter" in reg.subtypes:
        kw["params"] = parse_parameter(reg.subtypes["parameter"])
    if "according" in reg.subtypes:
        kw["according"] = According.parse(reg.subtypes["according"])
    if "search" in reg.subtypes:
        kw["search"] = parse_search(reg.subtypes["search"])
    if "number" in reg.subtypes:
        kw["number"] = int(reg.subtypes["number"])
    if "debug" in reg.subtypes:
        kw["debug"] = tuple(
            d.strip() for d in reg.subtypes["debug"].strip("()").split(","))
    feature = reg.feature
    if feature in ("LoopFusionSplit", "LoopFusion"):
        feature = "select"      # variant selection among generated codes
    return ATRegion(at_type=reg.at_type, feature=feature, name=reg.name,
                    **kw)


def preprocess(fn: Callable, ctx: ATContext, outdir: str | None = None
               ) -> dict[str, ATRegion]:
    """The complete paper pipeline for one annotated function.

    Runs OATCodeGen over ``fn``, registers one ATRegion per ``#OAT$`` region:

    * ``LoopFusionSplit`` / ``LoopFusion`` regions become ``select`` regions
      whose sub-regions are the generated variants (Sample 8's 8 candidates);
    * ``unroll`` regions become ``unroll`` regions whose variant generator
      produces the unrolled code on demand for each searched factor.
    """
    import inspect
    import textwrap
    gen = OATCodeGen(outdir or ctx.workdir)
    generated = gen.generate(fn)

    src = textwrap.dedent(inspect.getsource(fn))
    src_lines = src.splitlines()
    def_idx = next(i for i, l in enumerate(src_lines)
                   if l.startswith("def "))
    body = textwrap.dedent("\n".join(src_lines[def_idx + 1:]))
    _, reg_sources = extract_regions(body)

    out: dict[str, ATRegion] = {}
    for reg_src in reg_sources:
        region = region_from_source(reg_src)
        variants = generated.get(reg_src.name, [])
        if reg_src.feature in ("LoopFusionSplit", "LoopFusion"):
            for v in variants:
                region.subregions.append(
                    Subregion(fn=v.fn, name=v.description))
            region.metadata["variants"] = variants
        elif reg_src.feature == "unroll":
            def make_unrolled(fn=fn, name=reg_src.name,
                              varied=region.varied):
                cache: dict[tuple, GeneratedVariant] = {}

                def variant_gen(*args, **kwargs):
                    factors = {v: int(kwargs.pop(v))
                               for v in varied.names if v in kwargs}
                    key = tuple(sorted(factors.items()))
                    if key not in cache:
                        cache[key] = gen.unroll_variant(fn, name, factors)
                    f = cache[key].fn
                    if args or kwargs:
                        return f(*args, **kwargs)
                    return f

                return variant_gen

            region.fn = make_unrolled()
            region.metadata["codegen"] = gen
        ctx.register(region)
        out[reg_src.name] = region
    return out

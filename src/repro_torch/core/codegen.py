"""OATCodeGen — the preprocessor (paper §4.3, §5) adapted to Python source.

Parses ``#OAT$`` comment directives out of a Python function, applies the
paper's loop transformations to the annotated region, and writes generated
variant functions to an ``OAT/`` directory (mirroring the paper's
``./OAT/OAT_test.f`` output), returning runnable callables.

Supported region features:

* ``unroll`` — loop unrolling by PP factors (Samples 1/4), with remainder
  loops; unroll depth per loop variable.
* ``LoopFusionSplit`` — §5.2: loop split at any level named by
  ``SplitPoint (k, j, i)``, with flow-dependent scalars re-computed via
  ``SplitPointCopyDef`` / ``SplitPointCopyInsert``; loop fusion (collapse)
  of 2 or 3 nest levels; and their compositions.  For a 3-nest with a split
  point this yields exactly the paper's 8 variants.
* ``LoopFusion`` — §5.3: fusion variants × statement re-ordering
  (``RotationOrder sub region``), dependence-checked via stagegraph.

Restrictions (documented DSL contract): loops must be ``for v in range(...)``
with 1–2 arguments; statements inside AT regions are single-line.
"""
from __future__ import annotations

import ast
import copy
import inspect
import os
import re
import textwrap
from dataclasses import dataclass, field
from typing import Any, Callable

from .errors import OATCodegenError
from .stagegraph import (RW, interleave_orders, order_legal, stmt_rw,
                         uncovered_flow_deps)

# --------------------------------------------------------------------------
# loop IR
# --------------------------------------------------------------------------


@dataclass
class Stmt:
    src: str
    recompute: bool = False      # inside a SplitPointCopyDef region
    rotation_group: int = -1     # RotationOrder group index, -1 = unmarked


@dataclass
class SplitMarker:
    vars: tuple[str, ...]


@dataclass
class CopyInsertMarker:
    pass


@dataclass
class Loop:
    var: str
    range_args: list[str]
    body: list = field(default_factory=list)

    @property
    def lo(self) -> str:
        return "0" if len(self.range_args) == 1 else self.range_args[0]

    @property
    def hi(self) -> str:
        return self.range_args[-1] if len(self.range_args) <= 2 \
            else self.range_args[1]

    @property
    def length(self) -> str:
        if len(self.range_args) == 1:
            return f"({self.range_args[0]})"
        return f"(({self.hi}) - ({self.lo}))"


Node = Any  # Stmt | Loop | SplitMarker | CopyInsertMarker

_FOR_RE = re.compile(r"^for\s+(\w+)\s+in\s+range\((.*)\)\s*:\s*$")
_OAT_RE = re.compile(r"^#\s*[oO][aA][tT]\$\s*(.*)$")


def _split_args(s: str) -> list[str]:
    """Split a range(...) argument list at top-level commas."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return [a for a in out if a]


def parse_loop_nest(lines: list[str]) -> list[Node]:
    """Parse dedented region-body source lines into the loop IR."""
    # normalise: keep (indent, content) for non-empty lines
    items: list[tuple[int, str]] = []
    for raw in lines:
        if not raw.strip():
            continue
        items.append((len(raw) - len(raw.lstrip()), raw.strip()))

    pos = 0
    in_copydef = False
    rotation_group = -1
    next_group = 0

    def parse_block(indent: int) -> list[Node]:
        nonlocal pos, in_copydef, rotation_group, next_group
        nodes: list[Node] = []
        while pos < len(items):
            ind, text = items[pos]
            if ind < indent:
                return nodes
            m = _OAT_RE.match(text)
            if m:
                d = m.group(1).strip()
                pos += 1
                low = d.lower()
                if low.startswith("splitpointcopydef"):
                    in_copydef = "start" in low
                elif low.startswith("splitpointcopyinsert"):
                    nodes.append(CopyInsertMarker())
                elif low.startswith("splitpoint"):
                    vars_m = re.search(r"\((.*)\)", d)
                    vs = tuple(v.strip() for v in
                               vars_m.group(1).split(",")) if vars_m else ()
                    nodes.append(SplitMarker(vs))
                elif low.startswith("rotationorder"):
                    if "start" in low:
                        rotation_group = next_group
                        next_group += 1
                    else:
                        rotation_group = -1
                # other directives (name/varied/...) handled by dsl.py
                continue
            fm = _FOR_RE.match(text)
            if fm:
                pos += 1
                body = parse_block(ind + 1)
                nodes.append(Loop(fm.group(1), _split_args(fm.group(2)), body))
                continue
            nodes.append(Stmt(text, recompute=in_copydef,
                              rotation_group=rotation_group))
            pos += 1
        return nodes

    return parse_block(0)


def render(nodes: list[Node], indent: int = 0) -> list[str]:
    pad = "    " * indent
    out: list[str] = []
    for n in nodes:
        if isinstance(n, Loop):
            out.append(f"{pad}for {n.var} in range("
                       f"{', '.join(n.range_args)}):")
            out.extend(render(n.body, indent + 1))
        elif isinstance(n, Stmt):
            out.append(pad + n.src)
        # markers render to nothing
    return out


# --------------------------------------------------------------------------
# transforms
# --------------------------------------------------------------------------


def _subst(src: str, var: str, repl: str) -> str:
    return re.sub(rf"\b{re.escape(var)}\b", repl, src)


def _subst_tree(nodes: list[Node], var: str, repl: str) -> list[Node]:
    out = []
    for n in nodes:
        if isinstance(n, Loop):
            if n.var == var:       # shadowed
                out.append(n)
                continue
            out.append(Loop(n.var, [_subst(a, var, repl)
                                    for a in n.range_args],
                            _subst_tree(n.body, var, repl)))
        elif isinstance(n, Stmt):
            out.append(Stmt(_subst(n.src, var, repl), n.recompute,
                            n.rotation_group))
        else:
            out.append(n)
    return out


def _strip_markers(nodes: list[Node]) -> list[Node]:
    out = []
    for n in nodes:
        if isinstance(n, Loop):
            out.append(Loop(n.var, list(n.range_args),
                            _strip_markers(n.body)))
        elif isinstance(n, Stmt):
            out.append(n)
    return out


def _find_loop(nodes: list[Node], var: str
               ) -> tuple[list[Node], int] | None:
    """(containing body list, index) of the loop with variable ``var``."""
    for i, n in enumerate(nodes):
        if isinstance(n, Loop):
            if n.var == var:
                return nodes, i
            found = _find_loop(n.body, var)
            if found:
                return found
    return None


def _scalar_writes(stmts: list[Stmt]) -> set[str]:
    out: set[str] = set()
    for s in stmts:
        try:
            tree = ast.parse(s.src)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
            elif isinstance(node, ast.AugAssign) and isinstance(
                    node.target, ast.Name):
                out.add(node.target.id)
    return out


def transform_split(nodes: list[Node], var: str) -> list[Node]:
    """Loop fission at the loop named ``var`` (paper §5.2).

    Statements before the ``SplitPoint`` marker go to the first nest;
    the re-computation copies plus post-split statements to the second.
    """
    nodes = copy.deepcopy(nodes)
    found = _find_loop(nodes, var)
    if not found:
        raise OATCodegenError(f"no loop over {var!r} to split")
    parent_body, idx = found

    def has_marker(ns: list[Node]) -> bool:
        return any(isinstance(n, SplitMarker) or
                   (isinstance(n, Loop) and has_marker(n.body)) for n in ns)

    if not has_marker([parent_body[idx]]):
        raise OATCodegenError(f"loop {var!r} contains no SplitPoint")

    def dup(loop: Loop) -> tuple[Loop, Loop]:
        inner = next((n for n in loop.body if isinstance(n, Loop)
                      and has_marker([n])), None)
        if inner is not None:
            pre_i, post_i = dup(inner)
            pre_body = [pre_i if n is inner else copy.deepcopy(n)
                        for n in loop.body if not isinstance(n, SplitMarker)]
            # the second nest keeps only the loop (scalars before the split
            # level would be recomputed via copydef if needed)
            post_body = [post_i if n is inner else copy.deepcopy(n)
                         for n in loop.body
                         if isinstance(n, Loop) or isinstance(
                             n, CopyInsertMarker)]
            return (Loop(loop.var, list(loop.range_args), pre_body),
                    Loop(loop.var, list(loop.range_args), post_body))
        # innermost: partition statements at the SplitMarker
        pre: list[Node] = []
        post: list[Node] = []
        recompute: list[Stmt] = []
        seen_split = False
        for n in loop.body:
            if isinstance(n, SplitMarker):
                seen_split = True
                continue
            if isinstance(n, CopyInsertMarker):
                if seen_split:
                    post.extend(copy.deepcopy(s) for s in recompute)
                continue
            if isinstance(n, Stmt) and n.recompute:
                recompute.append(n)
            (post if seen_split else pre).append(copy.deepcopy(n))
        if not seen_split:
            raise OATCodegenError("SplitPoint marker not found in innermost "
                                  "loop body")
        if not any(isinstance(n, Stmt) and n.recompute for n in post):
            post = [copy.deepcopy(s) for s in recompute] + post
        # legality: scalar flow deps pre->post must be covered (§5.2)
        pre_s = [n for n in pre if isinstance(n, Stmt)]
        post_s = [n for n in post if isinstance(n, Stmt) and not n.recompute]
        uncovered = uncovered_flow_deps(
            [stmt_rw(s.src) for s in pre_s],
            [stmt_rw(s.src) for s in post_s],
            recompute_writes=set().union(
                *[stmt_rw(s.src).writes for s in recompute]) if recompute
            else set(),
            loop_carried=set().union(
                *[stmt_rw(s.src).writes for s in pre_s]) - _scalar_writes(
                    pre_s) if pre_s else set())
        if uncovered:
            raise OATCodegenError(
                f"loop split at {var!r} breaks flow dependences on "
                f"{sorted(uncovered)} — add SplitPointCopyDef (paper §5.2)")
        # re-computation must be idempotent: its inputs may not be
        # overwritten by the first nest (Sample 8's QG reads only
        # untouched fields)
        if recompute:
            rc_reads = set().union(*[stmt_rw(s.src).reads
                                     for s in recompute])
            rc_writes = set().union(*[stmt_rw(s.src).writes
                                      for s in recompute])
            pre_writes = set().union(
                *[stmt_rw(s.src).writes for s in pre_s]) if pre_s else set()
            clobbered = (rc_reads - rc_writes) & pre_writes
            if clobbered:
                raise OATCodegenError(
                    f"SplitPointCopyDef inputs {sorted(clobbered)} are "
                    f"overwritten before the split point — re-computation "
                    f"would not reproduce the value (paper §5.2)")
        return (Loop(loop.var, list(loop.range_args), pre),
                Loop(loop.var, list(loop.range_args), post))

    pre_l, post_l = dup(parent_body[idx])
    parent_body[idx:idx + 1] = [pre_l, post_l]
    return _strip_markers(nodes)


def transform_fuse(nodes: list[Node], vars: tuple[str, ...],
                   tag: str = "") -> list[Node]:
    """Collapse the first occurrence of the ``vars`` loop chain
    (outer..inner) into a single loop with index reconstruction."""
    nodes = copy.deepcopy(nodes)
    found = _find_loop(nodes, vars[0])
    if not found:
        raise OATCodegenError(f"no loop over {vars[0]!r} to fuse")
    parent_body, idx = found
    chain: list[Loop] = [parent_body[idx]]
    for v in vars[1:]:
        inner = [n for n in chain[-1].body if isinstance(n, Loop)]
        others = [n for n in chain[-1].body
                  if isinstance(n, Stmt) and n.src.strip()]
        if len(inner) != 1 or inner[0].var != v or others:
            raise OATCodegenError(
                f"loops {vars} are not perfectly nested; cannot fuse")
        chain.append(inner[0])
    fvar = "_".join(["_f", tag] + [l.var for l in chain])
    lens = [l.length for l in chain]
    total = "*".join(lens)
    decode: list[Node] = []
    rem = fvar
    for d, l in enumerate(chain):
        inner_prod = "*".join(lens[d + 1:]) if d + 1 < len(chain) else ""
        if inner_prod:
            decode.append(Stmt(
                f"{l.var} = ({l.lo}) + ({rem}) // ({inner_prod})"))
            nrem = f"_r{d}_{fvar}"
            decode.append(Stmt(f"{nrem} = ({rem}) % ({inner_prod})"))
            rem = nrem
        else:
            decode.append(Stmt(f"{l.var} = ({l.lo}) + ({rem})"))
    parent_body[idx] = Loop(fvar, [total], decode + list(chain[-1].body))
    return nodes


def transform_fuse_all(nodes: list[Node], vars: tuple[str, ...]
                       ) -> list[Node]:
    """Fuse every occurrence of the ``vars`` chain (post-split: both nests)."""
    nodes = copy.deepcopy(nodes)
    count = 0
    while _find_loop(nodes, vars[0]) is not None:
        parent_body, idx = _find_loop(nodes, vars[0])
        sub = transform_fuse([parent_body[idx]], vars, tag=str(count))
        parent_body[idx] = sub[0]
        count += 1
        if count > 16:
            raise OATCodegenError("fusion did not terminate")
    return nodes


def transform_unroll(nodes: list[Node], var: str, factor: int) -> list[Node]:
    """Unroll the loop named ``var`` by ``factor`` with a remainder loop."""
    if factor <= 1:
        return _strip_markers(copy.deepcopy(nodes))
    nodes = copy.deepcopy(nodes)
    found = _find_loop(nodes, var)
    if not found:
        raise OATCodegenError(f"no loop over {var!r} to unroll")
    parent_body, idx = found
    loop = parent_body[idx]
    if len(loop.range_args) == 3:
        raise OATCodegenError("unroll supports step-1 range loops only")
    lo, hi = loop.lo, loop.hi
    main_hi = f"({lo}) + (({hi}) - ({lo})) // {factor} * {factor}"
    main_body: list[Node] = []
    for d in range(factor):
        repl = loop.var if d == 0 else f"({loop.var} + {d})"
        main_body.extend(_subst_tree(_strip_markers(loop.body),
                                     loop.var, repl))
    main = Loop(loop.var, [str(lo), main_hi, str(factor)], main_body)
    rem = Loop(loop.var, [main_hi, str(hi)], _strip_markers(loop.body))
    parent_body[idx:idx + 1] = [main, rem]
    return _strip_markers(nodes)


def transform_rotation(nodes: list[Node], mode: str) -> list[Node]:
    """RotationOrder (§5.3): 'grouped' keeps source order, 'interleave'
    round-robins the marked statement groups (dependence-checked)."""
    nodes = copy.deepcopy(nodes)
    if mode == "grouped":
        return _strip_markers(nodes)

    def visit(body: list[Node]) -> list[Node]:
        for n in body:
            if isinstance(n, Loop):
                n.body = visit(n.body)
        marked_idx = [i for i, n in enumerate(body)
                      if isinstance(n, Stmt) and n.rotation_group >= 0]
        if not marked_idx:
            return body
        gids = sorted({body[i].rotation_group for i in marked_idx})
        sizes = [sum(1 for i in marked_idx
                     if body[i].rotation_group == g) for g in gids]
        stmts = [body[i] for i in marked_idx]
        perm = interleave_orders(sizes)[1]
        rws = [stmt_rw(s.src) for s in stmts]
        if not order_legal(rws, perm):
            raise OATCodegenError(
                "RotationOrder interleave violates dependences")
        reordered = [stmts[p] for p in perm]
        out, it = [], iter(reordered)
        for i, n in enumerate(body):
            out.append(next(it) if i in marked_idx else n)
        return out

    return _strip_markers(visit(nodes))


# --------------------------------------------------------------------------
# variant enumeration per region feature
# --------------------------------------------------------------------------


@dataclass
class Variant:
    index: int
    description: str
    nodes: list[Node]
    pps: dict[str, Any] = field(default_factory=dict)


def enumerate_fusionsplit_variants(nodes: list[Node]) -> list[Variant]:
    """Paper §5.2 Sample 8 — for a 3-nest (k,j,i) with a SplitPoint this
    returns exactly the 8 enumerated candidates."""
    def find_split_vars(ns) -> tuple[str, ...]:
        for n in ns:
            if isinstance(n, SplitMarker):
                return n.vars
            if isinstance(n, Loop):
                v = find_split_vars(n.body)
                if v:
                    return v
        return ()

    split_vars = find_split_vars(nodes)
    loops: list[str] = []

    def collect(ns):
        for n in ns:
            if isinstance(n, Loop):
                loops.append(n.var)
                collect(n.body)

    collect(nodes)
    out: list[Variant] = [Variant(1, "baseline", _strip_markers(
        copy.deepcopy(nodes)))]
    i = 2
    for v in split_vars:
        out.append(Variant(i, f"split@{v}", transform_split(nodes, v)))
        i += 1
    if len(loops) >= 2:
        fuse2 = tuple(loops[:2])
        out.append(Variant(i, f"fuse{fuse2}", transform_fuse_all(
            _strip_markers(copy.deepcopy(nodes)), fuse2)))
        i += 1
        if split_vars:
            out.append(Variant(
                i, f"split@{split_vars[0]}+fuse{fuse2}",
                transform_fuse_all(transform_split(nodes, split_vars[0]),
                                   fuse2)))
            i += 1
    if len(loops) >= 3:
        fuse3 = tuple(loops[:3])
        out.append(Variant(i, f"collapse{fuse3}", transform_fuse_all(
            _strip_markers(copy.deepcopy(nodes)), fuse3)))
        i += 1
        if split_vars:
            out.append(Variant(
                i, f"split@{split_vars[0]}+collapse{fuse3}",
                transform_fuse_all(transform_split(nodes, split_vars[0]),
                                   fuse3)))
            i += 1
    return out


def enumerate_fusion_variants(nodes: list[Node]) -> list[Variant]:
    """Paper §5.3 Sample 9 — fusion options × rotation orders."""
    loops: list[str] = []

    def collect(ns):
        for n in ns:
            if isinstance(n, Loop):
                loops.append(n.var)
                collect(n.body)

    collect(nodes)
    fusions: list[tuple[str, tuple[str, ...] | None]] = [("nofuse", None)]
    if len(loops) >= 2:
        fusions.append((f"fuse{tuple(loops[:2])}", tuple(loops[:2])))
    if len(loops) >= 3:
        fusions.append((f"collapse{tuple(loops[:3])}", tuple(loops[:3])))
    out: list[Variant] = []
    i = 1
    for fname, fvars in fusions:
        for mode in ("grouped", "interleave"):
            base = transform_rotation(nodes, mode)
            if fvars is not None:
                base = transform_fuse_all(base, fvars)
            out.append(Variant(i, f"{fname}+{mode}", base))
            i += 1
    return out


def enumerate_unroll_variants(nodes: list[Node], factors: dict[str, int]
                              ) -> Variant:
    """One unroll variant for the given {loop var: factor} assignment."""
    cur = copy.deepcopy(nodes)
    for var, f in factors.items():
        cur = transform_unroll(cur, var, int(f))
    return Variant(0, "unroll" + str(sorted(factors.items())), cur,
                   dict(factors))


# --------------------------------------------------------------------------
# source-level orchestration (the OATCodeGen command, §4.3)
# --------------------------------------------------------------------------


@dataclass
class GeneratedVariant:
    name: str
    index: int
    description: str
    source: str
    fn: Callable
    pps: dict[str, Any] = field(default_factory=dict)


@dataclass
class RegionSource:
    at_type: str
    feature: str
    name: str
    body_lines: list[str]
    header_span: tuple[int, int]       # line span in the function body
    subtypes: dict[str, str] = field(default_factory=dict)


_REGION_RE = re.compile(
    r"^#\s*[oO][aA][tT]\$\s*(install|static|dynamic)\s+(\w+)\s*"
    r"(?:\(([^)]*)\))?\s*region\s+(start|end)\s*$")
_SUBTYPE_RE = re.compile(r"^#\s*[oO][aA][tT]\$\s*(name|varied|fitting|search|"
                         r"parameter|according|number|debug)\s+(.*)$")


def extract_regions(src: str) -> tuple[list[str], list[RegionSource]]:
    """Find top-level AT regions in (dedented) function source lines."""
    lines = src.splitlines()
    regions: list[RegionSource] = []
    i = 0
    while i < len(lines):
        m = _REGION_RE.match(lines[i].strip())
        if m and m.group(4) == "start":
            at_type, feature = m.group(1), m.group(2)
            start = i
            subtypes: dict[str, str] = {}
            j = i + 1
            while j < len(lines):
                sm = _SUBTYPE_RE.match(lines[j].strip())
                if sm:
                    subtypes[sm.group(1)] = sm.group(2).strip()
                    j += 1
                    continue
                break
            body_start = j
            depth = 1
            while j < len(lines):
                em = _REGION_RE.match(lines[j].strip())
                if em:
                    depth += 1 if em.group(4) == "start" else -1
                    if depth == 0:
                        break
                j += 1
            if depth != 0:
                raise OATCodegenError(
                    f"unterminated region at line {start + 1}")
            regions.append(RegionSource(
                at_type=at_type, feature=feature,
                name=subtypes.get("name", f"region{len(regions)}"),
                body_lines=lines[body_start:j],
                header_span=(start, j), subtypes=subtypes))
            i = j + 1
            continue
        i += 1
    return lines, regions


class OATCodeGen:
    """``OATCodeGen test.py`` (paper §4.3): generate variant code under
    ``<outdir>/OAT/`` and return runnable callables."""

    def __init__(self, outdir: str = ".", debug: bool = False,
                 visualization: bool = False):
        self.outdir = os.path.join(outdir, "OAT")
        self.debug = debug
        self.visualization = visualization

    def generate(self, fn: Callable) -> dict[str, list[GeneratedVariant]]:
        src = textwrap.dedent(inspect.getsource(fn))
        src_lines = src.splitlines()
        def_idx = next(i for i, l in enumerate(src_lines)
                       if l.startswith("def "))
        header = src_lines[def_idx]
        body = textwrap.dedent("\n".join(src_lines[def_idx + 1:]))
        lines, regions = extract_regions(body)
        if not regions:
            raise OATCodegenError(f"{fn.__name__} has no #OAT$ regions")

        out: dict[str, list[GeneratedVariant]] = {}
        all_sources: list[str] = [
            "# Auto-generated by OATCodeGen (ppOpen-AT reproduction).",
            "# One function per variant; numerically identical to the "
            "baseline.", ""]
        for reg in regions:
            body_ir = parse_loop_nest(reg.body_lines)
            if reg.feature == "LoopFusionSplit":
                variants = enumerate_fusionsplit_variants(body_ir)
            elif reg.feature == "LoopFusion":
                variants = enumerate_fusion_variants(body_ir)
            elif reg.feature == "unroll":
                varied = reg.subtypes.get("varied", "")
                vm = re.match(r"\(([^)]*)\)\s*from\s+(\S+)\s+to\s+(\S+)",
                              varied)
                if not vm:
                    raise OATCodegenError(
                        f"unroll region {reg.name!r} needs "
                        f"'varied (v,...) from X to Y'")
                uvars = [v.strip() for v in vm.group(1).split(",")]
                lo, hi = int(vm.group(2)), int(vm.group(3))
                variants = []
                # variant per factor assignment is generated lazily in real
                # tuning; for the generated file emit the diagonal plus edges
                for f in sorted({lo, max(lo, min(4, hi)), hi}):
                    v = enumerate_unroll_variants(
                        body_ir, {u: f for u in uvars})
                    v.index = len(variants) + 1
                    variants.append(v)
            else:
                raise OATCodegenError(
                    f"unsupported codegen feature {reg.feature!r}")

            gen: list[GeneratedVariant] = []
            for v in variants:
                vname = f"{fn.__name__}__{reg.name}__v{v.index}"
                new_body = list(lines)
                s, e = reg.header_span
                rendered = render(v.nodes)
                new_body[s:e + 1] = rendered or ["pass"]
                vsrc = (header.replace(f"def {fn.__name__}(",
                                       f"def {vname}(", 1) + "\n" +
                        textwrap.indent("\n".join(new_body), "    "))
                ns: dict = dict(fn.__globals__)
                try:
                    exec(compile(vsrc, f"<OAT:{vname}>", "exec"), ns)
                except SyntaxError as exc:
                    raise OATCodegenError(
                        f"generated variant {vname} does not compile: {exc}\n"
                        f"{vsrc}") from exc
                gen.append(GeneratedVariant(vname, v.index, v.description,
                                            vsrc, ns[vname], v.pps))
                all_sources.append(f"# --- {reg.name} variant {v.index}: "
                                   f"{v.description}")
                all_sources.append(vsrc)
                all_sources.append("")
            out[reg.name] = gen

        os.makedirs(self.outdir, exist_ok=True)
        path = os.path.join(self.outdir, f"OAT_{fn.__name__}.py")
        with open(path, "w") as f:
            f.write("\n".join(all_sources))
        return out

    def unroll_variant(self, fn: Callable, region_name: str,
                       factors: dict[str, int]) -> GeneratedVariant:
        """Generate one unroll variant on demand (used by install-time AT)."""
        src = textwrap.dedent(inspect.getsource(fn))
        src_lines = src.splitlines()
        def_idx = next(i for i, l in enumerate(src_lines)
                       if l.startswith("def "))
        header = src_lines[def_idx]
        body = textwrap.dedent("\n".join(src_lines[def_idx + 1:]))
        lines, regions = extract_regions(body)
        reg = next(r for r in regions if r.name == region_name)
        v = enumerate_unroll_variants(parse_loop_nest(reg.body_lines),
                                      factors)
        vname = f"{fn.__name__}__{region_name}__u" + "_".join(
            f"{k}{val}" for k, val in sorted(factors.items()))
        new_body = list(lines)
        s, e = reg.header_span
        new_body[s:e + 1] = render(v.nodes)
        vsrc = (header.replace(f"def {fn.__name__}(", f"def {vname}(", 1)
                + "\n" + textwrap.indent("\n".join(new_body), "    "))
        ns: dict = dict(fn.__globals__)
        exec(compile(vsrc, f"<OAT:{vname}>", "exec"), ns)
        return GeneratedVariant(vname, 0, v.description, vsrc, ns[vname],
                                dict(factors))

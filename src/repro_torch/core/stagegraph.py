"""Dependence-aware statement graph for the §5 loop transforms.

The paper's extended functions (loop split/fusion with flow dependences,
statement re-ordering) require knowing which statements read/write which
names.  We extract read/write sets from Python statement source via ``ast``
and provide the legality predicates used by codegen.py:

* split legality — a value *defined* before the split point and *used* after
  it must be covered by a re-computation copy (``SplitPointCopyDef``), else
  the split is illegal (the paper: "There is a flow dependency ... hence in
  general it is difficult to perform loop splitting using compilers");
* re-ordering legality — a permutation of statements is legal iff every
  (RAW, WAR, WAW) dependent pair keeps its relative order.

Array accesses are treated at name granularity (A[i,j] reads/writes "A"),
which is conservative and safe for the paper's kernels.
"""
from __future__ import annotations

import ast
import itertools
from dataclasses import dataclass, field


@dataclass
class RW:
    reads: set[str] = field(default_factory=set)
    writes: set[str] = field(default_factory=set)


def _base_name(node: ast.AST) -> str | None:
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def stmt_rw(src: str) -> RW:
    """Read/write sets of one (single- or multi-line) Python statement."""
    tree = ast.parse(src.strip() or "pass")
    rw = RW()

    class V(ast.NodeVisitor):
        def visit_Assign(self, n: ast.Assign):
            for t in n.targets:
                b = _base_name(t)
                if b:
                    rw.writes.add(b)
                if isinstance(t, ast.Subscript):
                    # index expressions are reads
                    self.visit(t.slice)
                    if b:
                        rw.reads.add(b)  # partial write: old value observable
            self.visit(n.value)

        def visit_AugAssign(self, n: ast.AugAssign):
            b = _base_name(n.target)
            if b:
                rw.writes.add(b)
                rw.reads.add(b)
            if isinstance(n.target, ast.Subscript):
                self.visit(n.target.slice)
            self.visit(n.value)

        def visit_Name(self, n: ast.Name):
            if isinstance(n.ctx, ast.Load):
                rw.reads.add(n.id)

    V().visit(tree)
    return rw


def depends(a: RW, b: RW) -> bool:
    """True if statement b depends on a (RAW, WAR or WAW) when a precedes b."""
    return bool((a.writes & b.reads) or (a.reads & b.writes)
                or (a.writes & b.writes))


def order_legal(stmts_rw: list[RW], perm: list[int]) -> bool:
    """Is permutation ``perm`` of statements (given original order) legal?"""
    pos = {s: i for i, s in enumerate(perm)}
    for i, j in itertools.combinations(range(len(stmts_rw)), 2):
        if depends(stmts_rw[i], stmts_rw[j]) and pos[i] > pos[j]:
            return False
    return True


def interleave_orders(group_sizes: list[int]) -> list[list[int]]:
    """Candidate orders for RotationOrder groups (paper Sample 9).

    Statements are indexed globally in original order, groups are contiguous.
    Returns [grouped (original), round-robin interleaved]."""
    offsets = [0]
    for s in group_sizes:
        offsets.append(offsets[-1] + s)
    n = offsets[-1]
    grouped = list(range(n))
    rr: list[int] = []
    for k in range(max(group_sizes)):
        for g, size in enumerate(group_sizes):
            if k < size:
                rr.append(offsets[g] + k)
    return [grouped, rr]


def uncovered_flow_deps(pre_rw: list[RW], post_rw: list[RW],
                        recompute_writes: set[str],
                        loop_carried: set[str] = frozenset()) -> set[str]:
    """Names defined in the pre-split body and used post-split that are NOT
    re-computed — these make the split illegal (paper §5.2).

    ``loop_carried`` names (arrays indexed by the loop vars) are excluded:
    array elements written pre-split persist in memory across the fission.
    Only *scalars* (privatised per-iteration temporaries) need re-computation.
    """
    defined_pre = set().union(*[r.writes for r in pre_rw]) if pre_rw else set()
    used_post = set().union(*[r.reads for r in post_rw]) if post_rw else set()
    return (defined_pre & used_post) - recompute_writes - set(loop_carried)

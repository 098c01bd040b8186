"""Parameter information files — the paper's S-expression format (§4.2.1, §6.2).

Example from the paper::

    (SetCacheParam
    (CacheSize 64)
    (CacheLine 8)
    )

and the nested before-execute-time form::

    (MyMatMul
    (OAT_NUMPROCS 4)
    (OAT_SAMPDIST 1024)
    (OAT_PROBSIZE 1024
    (MyMatMul_I 4)
    (MyMatMul_J 8))
    )

We model a file as a list of ``Node`` trees.  A ``Node`` has a ``name``, an
optional scalar ``value`` (the paper's ``(key value)`` pairs and the keyed
``(OAT_PROBSIZE 1024 ...)`` group headers), and child nodes.

File-name conventions (§6.2) are provided by :func:`param_path`:
``OAT_InstallParam{X}.dat`` etc., where X is the AT region name ('' for the
global file).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator

from .errors import OATSpecError

Scalar = int | float | str | bool


def _fmt_scalar(v: Scalar) -> str:
    if isinstance(v, bool):
        return ".true." if v else ".false."
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, str):
        # quote anything that would not tokenize back to the same string
        needs_quote = (not v or any(c.isspace() for c in v)
                       or any(c in '()"' for c in v)
                       or _parse_scalar(v) != v)
        return f'"{v}"' if needs_quote else v
    return str(v)


def _parse_scalar(tok: str) -> Scalar:
    if tok == ".true.":
        return True
    if tok == ".false.":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    if len(tok) >= 2 and tok[0] == '"' and tok[-1] == '"':
        return tok[1:-1]
    return tok


@dataclass
class Node:
    """One parenthesised record: ``(name [value] child*)``."""

    name: str
    value: Scalar | None = None
    children: list["Node"] = field(default_factory=list)

    # -- convenience accessors -------------------------------------------
    def child(self, name: str) -> "Node | None":
        for c in self.children:
            if c.name == name:
                return c
        return None

    def child_value(self, name: str, default: Scalar | None = None) -> Scalar | None:
        c = self.child(name)
        return default if c is None or c.value is None else c.value

    def set(self, name: str, value: Scalar) -> None:
        c = self.child(name)
        if c is None:
            self.children.append(Node(name, value))
        else:
            c.value = value

    def keyed_child(self, name: str, value: Scalar) -> "Node | None":
        """Find e.g. the ``(OAT_PROBSIZE 1024 ...)`` group for value 1024."""
        for c in self.children:
            if c.name == name and c.value == value:
                return c
        return None

    def as_dict(self) -> dict:
        """Flatten leaf children to a dict (group headers keep subtrees)."""
        out: dict = {}
        for c in self.children:
            if c.children:
                out.setdefault(c.name, []).append((c.value, c.as_dict()))
            else:
                out[c.name] = c.value
        return out

    def walk(self) -> Iterator["Node"]:
        yield self
        for c in self.children:
            yield from c.walk()


# --------------------------------------------------------------------------
# serialisation
# --------------------------------------------------------------------------

def dumps(nodes: list[Node]) -> str:
    lines: list[str] = []

    def emit(n: Node, depth: int) -> None:
        head = f"({n.name}" + (f" {_fmt_scalar(n.value)}" if n.value is not None else "")
        if not n.children:
            lines.append(head + ")")
            return
        lines.append(head)
        for c in n.children:
            emit(c, depth + 1)
        lines.append(")")

    for n in nodes:
        emit(n, 0)
    return "\n".join(lines) + "\n"


def _tokenize(text: str) -> list[str]:
    toks: list[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch in "()":
            toks.append(ch)
            i += 1
        elif ch == '"':
            j = text.find('"', i + 1)
            if j < 0:
                raise OATSpecError("unterminated string in parameter file")
            toks.append(text[i : j + 1])
            i = j + 1
        elif ch.isspace():
            i += 1
        else:
            j = i
            while j < n and not text[j].isspace() and text[j] not in "()":
                j += 1
            toks.append(text[i:j])
            i = j
    return toks


def loads(text: str) -> list[Node]:
    toks = _tokenize(text)
    pos = 0

    def parse() -> Node:
        nonlocal pos
        if toks[pos] != "(":
            raise OATSpecError(f"expected '(' at token {pos}: {toks[pos]!r}")
        pos += 1
        if pos >= len(toks) or toks[pos] in "()":
            raise OATSpecError("expected a name after '('")
        node = Node(toks[pos])
        pos += 1
        # optional scalar value
        if pos < len(toks) and toks[pos] not in "()":
            node.value = _parse_scalar(toks[pos])
            pos += 1
        while pos < len(toks) and toks[pos] == "(":
            node.children.append(parse())
        if pos >= len(toks) or toks[pos] != ")":
            raise OATSpecError(f"missing ')' for node {node.name}")
        pos += 1
        return node

    nodes: list[Node] = []
    while pos < len(toks):
        nodes.append(parse())
    return nodes


# --------------------------------------------------------------------------
# file conventions (paper §6.2)
# --------------------------------------------------------------------------

PHASE_FILE = {"install": "OAT_InstallParam", "static": "OAT_StaticParam",
              "dynamic": "OAT_DynamicParam"}


def param_path(workdir: str, phase: str, region: str = "", user: bool = False) -> str:
    """Path of a system (output) or user (``...Def``) parameter file."""
    if phase not in PHASE_FILE:
        raise OATSpecError(f"unknown phase {phase!r}")
    stem = PHASE_FILE[phase] + ("Def" if user else "") + region + ".dat"
    return os.path.join(workdir, stem)


def load_file(path: str) -> list[Node]:
    if not os.path.exists(path):
        return []
    with open(path, "r") as f:
        return loads(f.read())


def save_file(path: str, nodes: list[Node]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(dumps(nodes))
    os.replace(tmp, path)  # atomic on POSIX

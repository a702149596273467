"""Shared rule infrastructure: one parsed-file context, one base class.

Every rule is a single AST pass over a `FileContext`; the context carries
the pieces most rules need -- import-alias resolution (so ``F.one_hot``
and ``torch.nn.functional.one_hot``, ``np.full`` and ``numpy.full`` are
the same function), parent links, and enclosing-function lookup -- so
each rule module stays a small visitor over plain ast nodes.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional

from ..report import Finding

_PARENT = "_reprolint_torch_parent"


def _import_aliases(tree: ast.AST) -> Dict[str, str]:
    """Map local names to fully-qualified module paths.

    ``import numpy as np`` -> {"np": "numpy"}; ``import
    torch.nn.functional as F`` -> {"F": "torch.nn.functional"}; ``from
    time import perf_counter`` -> {"perf_counter": "time.perf_counter"}.
    Relative imports keep their leading dots so in-package imports
    (``from ..parallel.compat import local_map``) never collide with
    absolute torch/numpy paths.
    """
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = "." * node.level + (node.module or "")
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{mod}.{a.name}"
    return aliases


class FileContext:
    """One parsed file plus the lookups rules share."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.aliases = _import_aliases(self.tree)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                setattr(child, _PARENT, node)

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return getattr(node, _PARENT, None)

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Resolve a Name/Attribute chain to a dotted path through the
        file's import aliases (``F.one_hot`` ->
        "torch.nn.functional.one_hot"); None when the chain is rooted in
        anything but a plain name."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        root = self.aliases.get(parts[0], parts[0])
        return ".".join([root] + parts[1:])

    def enclosing_functions(self, node: ast.AST) -> Iterator[ast.AST]:
        """Innermost-first chain of enclosing function definitions."""
        cur = self.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield cur
            cur = self.parent(cur)

    def function_defs(self) -> Iterator[ast.AST]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node


def is_neg_one(node: ast.AST) -> bool:
    """True for the literal ``-1`` (ast stores it as USub(Constant(1)))."""
    return (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)
            and node.operand.value == 1)


def method_name(call: ast.Call) -> Optional[str]:
    """``x.f(...)`` -> "f"; None for a call of a plain name."""
    return call.func.attr if isinstance(call.func, ast.Attribute) else None


def keyword(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


class Rule:
    """Base class: subclasses set `id`/`description` and implement check().

    check() returns *raw* findings; pragma suppression is applied by the
    engine (`repro_torch.analysis.lint`), so rules never see pragmas.
    """

    id: str = ""
    description: str = ""

    def check(self, ctx: FileContext) -> List[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(path=ctx.path, line=node.lineno,
                       col=node.col_offset, rule=self.id, message=message)

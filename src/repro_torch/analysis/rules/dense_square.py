"""dense-square: no dense [n, n] materialization on the simulation path.

The graph core is CSR-first and the blocked engines exist precisely so
nothing on the scaled path ever allocates an O(n^2) array; on the card an
[n, n] buffer at PF(157) (24,807 routers) is 2.5 GB of int32.  This rule
flags, in the scoped simulation-path modules:

* square symbolic allocations -- ``np.zeros((n, n))`` / ``torch.full((n,
  n), v)`` / ``torch.empty(n, n)`` / ``np.ones`` (numpy and torch
  ``zeros``, ``ones``, ``full``, ``empty``) where the same non-constant
  dimension expression repeats (``(3, 3)`` literals are someone's
  stencil, not a scaling hazard), and the same through a tensor's
  ``new_zeros`` / ``new_ones`` / ``new_full`` / ``new_empty``;
* ``np.eye(n)`` / ``torch.eye(n)`` with a symbolic size;
* outer-broadcast comparisons ``x[:, None] == y[None, :]``, which
  materialize the full [n, n] comparison matrix.

Functions whose name contains ``_reference`` or ``dense`` are exempt: the
two-engine discipline deliberately keeps a small-n dense twin per engine.
Everything else needs a ``# reprolint-torch: allow[dense-square] --
reason``.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Sequence

from ..report import Finding
from .base import FileContext, Rule, method_name

_KINDS = ("zeros", "ones", "full", "empty")
_ALLOC = {f"{m}.{f}" for m in ("numpy", "torch") for f in _KINDS}
# torch takes a shape as separate positional ints too: torch.zeros(n, n)
_VARARGS = {f"torch.{f}" for f in ("zeros", "ones", "empty")}
_NEW = {f"new_{f}" for f in _KINDS}
_EYE = {"numpy.eye", "torch.eye"}
_EXEMPT_FN = re.compile(r"_reference|dense")


def _axis_pattern(node: ast.AST) -> Optional[str]:
    """"col" for ``x[:, None]``, "row" for ``x[None, :]``, else None."""
    if not (isinstance(node, ast.Subscript)
            and isinstance(node.slice, ast.Tuple)
            and len(node.slice.elts) == 2):
        return None
    a, b = node.slice.elts

    def is_none(e):
        return isinstance(e, ast.Constant) and e.value is None

    if isinstance(a, ast.Slice) and is_none(b):
        return "col"
    if is_none(a) and isinstance(b, ast.Slice):
        return "row"
    return None


def _repeated(dims: Sequence[ast.AST]) -> Optional[str]:
    """The repeated symbolic dimension expression among `dims`, or None.
    Constant dims never count: only a repeated *expression* (``(n, n)``,
    ``(g.n, g.n)``) scales quadratically with the input."""
    seen = set()
    for e in dims:
        if isinstance(e, ast.Constant):
            continue
        d = ast.unparse(e)
        if d in seen:
            return d
        seen.add(d)
    return None


def _shape_dims(call: ast.Call, varargs: bool) -> Sequence[ast.AST]:
    """The dimension expressions of an allocation's shape: its first
    argument's elements, or (torch's varargs form) every positional
    argument."""
    if not call.args:
        return ()
    first = call.args[0]
    if isinstance(first, (ast.Tuple, ast.List)):
        return first.elts
    return call.args if varargs else ()


class DenseSquareRule(Rule):
    id = "dense-square"
    description = ("no dense [n, n] allocation (numpy, torch, "
                   "Tensor.new_*) or outer-broadcast compare on the "
                   "simulation path (the blocked engines exist for this)")

    def check(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if any(_EXEMPT_FN.search(fn.name)
                   for fn in ctx.enclosing_functions(node)):
                continue
            if isinstance(node, ast.Call):
                fq = ctx.dotted(node.func)
                meth = method_name(node)
                dim = None
                if fq in _ALLOC:
                    dim = _repeated(_shape_dims(node, fq in _VARARGS))
                elif meth in _NEW:
                    dim = _repeated(_shape_dims(node, meth != "new_full"))
                if dim is not None:
                    out.append(self.finding(
                        ctx, node,
                        f"square allocation {ast.unparse(node.func)}"
                        f"((.., {dim}, {dim}, ..)) materializes [n, n];"
                        " use the blocked/CSR engines or suppress with"
                        " a reason"))
                elif (fq in _EYE and node.args
                        and not isinstance(node.args[0], ast.Constant)):
                    out.append(self.finding(
                        ctx, node,
                        f"{ast.unparse(node.func)}({ast.unparse(node.args[0])})"
                        " materializes a dense [n, n] identity; stream"
                        " per-block or suppress with a reason"))
            elif isinstance(node, ast.Compare):
                sides = [node.left] + list(node.comparators)
                pats = {p for p in map(_axis_pattern, sides) if p}
                if pats == {"col", "row"}:
                    out.append(self.finding(
                        ctx, node,
                        "outer-broadcast comparison ([:, None] vs [None, :])"
                        " materializes the full [n, n] matrix"))
        return out

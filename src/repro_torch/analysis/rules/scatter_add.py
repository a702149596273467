"""scatter-add: no accumulating scatter on the simulation path.

The reference reformulated the fluid solver's link-load scatter-add as a
padded gather + row sum because XLA:CPU serializes scatter.  The port
keeps the gather for a torch reason of its own: on the card an
accumulating scatter is a float atomic add per element, whose summation
order changes from run to run, and that breaks the bit-for-bit checks the
port is held to (card against card, card against the CPU).  This rule
flags, in the scoped modules:

* ``index_add`` / ``index_add_``, ``scatter_add`` / ``scatter_add_``,
  ``scatter_reduce`` / ``scatter_reduce_`` (as tensor methods or
  ``torch.*`` functions);
* ``index_put`` / ``index_put_`` / ``put`` / ``put_`` with
  ``accumulate=True``.

A plain ``index_put_`` (no accumulate) with unique indices stays legal.
Any surviving accumulating scatter must be a deliberate, measured fallback
and carry a ``# reprolint-torch: allow[scatter-add] -- reason`` pragma.
"""

from __future__ import annotations

import ast
from typing import List

from ..report import Finding
from .base import FileContext, Rule, keyword, method_name

_ACCUMULATING = {"index_add", "index_add_", "scatter_add", "scatter_add_",
                 "scatter_reduce", "scatter_reduce_"}
_PUT = {"index_put", "index_put_", "put", "put_"}


def _is_true(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _scatter_name(call: ast.Call, ctx: FileContext):
    """The scatter's name when `call` is an accumulating scatter."""
    fq = ctx.dotted(call.func) or ""
    is_fn = fq.startswith("torch.") and fq.count(".") == 1
    name = fq.split(".", 1)[1] if is_fn else method_name(call)
    if name in _ACCUMULATING:
        return name
    if name in _PUT:
        # accumulate is the third argument of the method, the fourth of
        # the torch.* function (after the tensor)
        pos = 3 if is_fn else 2
        acc = keyword(call, "accumulate")
        if acc is None and len(call.args) > pos:
            acc = call.args[pos]
        if _is_true(acc):
            return f"{name}(..., accumulate=True)"
    return None


class ScatterAddRule(Rule):
    id = "scatter-add"
    description = ("index_add_/scatter_add_/scatter_reduce_/accumulating "
                   "index_put_ on the simulation path -- float atomics on "
                   "the card change the sum order run to run; use the "
                   "padded gather")

    def check(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _scatter_name(node, ctx)
            if name is not None:
                out.append(self.finding(
                    ctx, node,
                    f"{name} is an accumulating scatter -- float atomics "
                    "on the card sum in a different order each run, which "
                    "breaks bit-for-bit parity; use the padded gather or "
                    "suppress with a reason"))
        return out

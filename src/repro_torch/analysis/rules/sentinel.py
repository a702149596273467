"""sentinel: one UNREACHABLE constant, no magic -1 / 32000 markers.

``repro_torch.core.graph.UNREACHABLE`` (= -1) is the only sentinel that
leaves any routing API, as ``repro.core.graph.UNREACHABLE`` is in the
reference, and the old ``32000`` "big distance" magic number is gone.
This rule keeps it that way in the scoped core/simulation modules:

* any literal ``32000`` (the retired pseudo-infinity);
* equality comparisons against literal ``-1`` (``x == -1`` / ``x != -1``)
  -- distance/next-hop code must compare against ``UNREACHABLE``;
* ``-1`` fills: ``np.full(shape, -1)``, ``torch.full(shape, -1)``,
  ``torch.full_like(x, -1)`` and ``x.new_full(shape, -1)`` -- tables of
  unreachable markers must be filled with ``UNREACHABLE``.

Legitimate -1s with a *different* meaning (edge-id pads, "no edge"
lookup misses, unassigned-slot markers) suppress with a reason naming
that meaning, which doubles as documentation at the use site.
"""

from __future__ import annotations

import ast
from typing import List

from ..report import Finding
from .base import FileContext, Rule, is_neg_one, keyword, method_name

_FULL = {"numpy.full", "torch.full", "torch.full_like"}
_RETIRED_MAGIC = 32000


def _fill_value(call: ast.Call, ctx: FileContext):
    if ctx.dotted(call.func) in _FULL or method_name(call) == "new_full":
        if len(call.args) >= 2:
            return call.args[1]
        return keyword(call, "fill_value")
    return None


class SentinelRule(Rule):
    id = "sentinel"
    description = ("use repro_torch.core.graph.UNREACHABLE, not literal "
                   "-1/32000 sentinels")

    def check(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Constant)
                    and node.value == _RETIRED_MAGIC):
                out.append(self.finding(
                    ctx, node,
                    f"literal {_RETIRED_MAGIC} is the retired "
                    "pseudo-infinity sentinel; use UNREACHABLE (or a "
                    "named module constant)"))
            elif isinstance(node, ast.Compare):
                sides = [node.left] + list(node.comparators)
                if (any(isinstance(op, (ast.Eq, ast.NotEq))
                        for op in node.ops)
                        and any(is_neg_one(s) for s in sides)):
                    out.append(self.finding(
                        ctx, node,
                        "comparison against literal -1; compare against "
                        "UNREACHABLE (repro_torch.core.graph) or suppress "
                        "with the marker's actual meaning"))
            elif (isinstance(node, ast.Call)
                    and is_neg_one(_fill_value(node, ctx))):
                out.append(self.finding(
                    ctx, node,
                    f"{ast.unparse(node.func)}(..., -1) sentinel fill; fill "
                    "with UNREACHABLE or suppress with the marker's actual "
                    "meaning"))
        return out

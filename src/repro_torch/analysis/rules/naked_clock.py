"""naked-clock: timings must wait for the card.

Torch queues CUDA work and returns at once, so a bare
``time.perf_counter()`` pair around a device computation stops the clock
while the work is still in flight.  A function named ``timed`` (the
port's bench harness's, as ``benchmarks.common.timed`` is the
reference's) is the only place allowed to touch the clock directly, and
it must synchronize the card before its closing read.

The rule flags:

* every wall-clock read (``perf_counter`` / ``monotonic`` / ``time`` /
  ``perf_counter_ns``) in scoped files outside a function named
  ``timed``;
* a ``timed`` whose closing clock read (its last) is not preceded, after
  its opening read, by ``torch.cuda.synchronize()`` or an event's or
  stream's ``.synchronize()``.

Host-only timing that deliberately includes dispatch (e.g. whole-phase
wall times) suppresses with a reason.
"""

from __future__ import annotations

import ast
from typing import List

from ..report import Finding
from .base import FileContext, Rule, method_name

_CLOCKS = {f"time.{f}" for f in
           ("perf_counter", "perf_counter_ns", "monotonic", "time")}
_BLESSED_FN = "timed"


def _is_sync(call: ast.Call, ctx: FileContext) -> bool:
    return (ctx.dotted(call.func) == "torch.cuda.synchronize"
            or method_name(call) == "synchronize")


def _pos(node: ast.AST):
    return (node.lineno, node.col_offset)


class NakedClockRule(Rule):
    id = "naked-clock"
    description = ("wall-clock reads only inside `timed`, which must "
                   "synchronize the card before its closing read (CUDA "
                   "work is queued, not done, when a torch call returns)")

    def check(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and ctx.dotted(node.func) in _CLOCKS):
                continue
            if any(fn.name == _BLESSED_FN
                   for fn in ctx.enclosing_functions(node)):
                continue
            out.append(self.finding(
                ctx, node,
                f"naked {ast.unparse(node.func)}() -- CUDA work is queued "
                "when a torch call returns, so the clock can stop before "
                "the card finishes; time through `timed` (which "
                "synchronizes) or suppress with a reason"))
        for fn in ctx.function_defs():
            if fn.name != _BLESSED_FN:
                continue
            calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
            reads = sorted((n for n in calls
                            if ctx.dotted(n.func) in _CLOCKS), key=_pos)
            if len(reads) < 2:
                continue
            first, last = _pos(reads[0]), _pos(reads[-1])
            if not any(first < _pos(n) < last and _is_sync(n, ctx)
                       for n in calls):
                out.append(self.finding(
                    ctx, reads[-1],
                    "`timed` reads its closing clock without "
                    "torch.cuda.synchronize() (or an event's "
                    ".synchronize()) after the timed work"))
        return out

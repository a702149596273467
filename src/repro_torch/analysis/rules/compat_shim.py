"""compat-shim: experimental and private torch APIs route through the shims.

The card runs torch 2.11 and the CPU tests 2.13.  ``local_map`` lives in
``torch.distributed.tensor.experimental`` (earlier DTensor lived in
``torch.distributed._tensor``), and the launch tools reach into private
modules (``torch._C``'s dispatch-mode and autograd-node hooks,
``torch.utils._python_dispatch``, ``torch.testing._internal``'s fake
store, ``torch.cuda.memory._record_memory_history``), none of which
torch promises to keep.  ``repro_torch/parallel/compat.py`` and
``repro_torch/launch/mesh.py`` own those guards; every other call site
must go through the shim, or the next torch bump breaks call sites one by
one instead of in one file.

Flags, outside the two shim files (excluded via the rule's scope config):

* imports or attribute uses of ``torch.distributed.tensor.experimental``
  and of ``torch.distributed._tensor``;
* any ``torch`` module path or imported name with a ``_``-prefixed
  segment (``torch._C._get_dispatch_mode``,
  ``torch.utils._python_dispatch.TorchDispatchMode``,
  ``from torch.distributed.distributed_c10d import
  _resolve_process_group``), including through an alias of a public
  module (``profiler._is_profiler_enabled``).

Dunder names (``torch.__version__``) are not private, and strings (a
logger's name) are not uses.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..report import Finding
from .base import FileContext, Rule

_MSG = ("experimental or private torch API used directly; route through "
        "repro_torch.parallel.compat so the torch 2.11/2.13 differences "
        "stay guarded in one place")
_EXPERIMENTAL = ("torch.distributed.tensor.experimental",
                 "torch.distributed._tensor")


def _private(segment: str) -> bool:
    return segment.startswith("_") and not (
        segment.startswith("__") and segment.endswith("__"))


def _flagged_path(path: Optional[str]) -> bool:
    """A dotted torch path that is experimental or has a private segment."""
    if not path or not (path == "torch" or path.startswith("torch.")):
        return False
    if any(path == t or path.startswith(t + ".") for t in _EXPERIMENTAL):
        return True
    return any(_private(s) for s in path.split(".")[1:])


def _flagged_import(node: ast.AST) -> bool:
    if isinstance(node, ast.Import):
        return any(_flagged_path(a.name) for a in node.names)
    if node.level:  # relative import (e.g. from ..parallel.compat import)
        return False
    mod = node.module or ""
    return any(_flagged_path(f"{mod}.{a.name}") for a in node.names
               if a.name != "*") or _flagged_path(mod)


class CompatShimRule(Rule):
    id = "compat-shim"
    description = ("local_map and private torch modules only via "
                   "parallel/compat.py and launch/mesh.py (torch "
                   "2.11/2.13 guards)")

    def check(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                if _flagged_import(node):
                    out.append(self.finding(ctx, node, _MSG))
            elif isinstance(node, ast.Attribute):
                # only the outermost link of a dotted chain, so
                # torch._C._TorchDispatchModeKey.FAKE reports once
                if isinstance(ctx.parent(node), ast.Attribute):
                    continue
                if _flagged_path(ctx.dotted(node)):
                    out.append(self.finding(ctx, node, _MSG))
        return out

"""reprolint-torch engine + CLI: ``python -m repro_torch.analysis.lint
[paths...]`` (default: ``src/repro_torch`` and ``chip_smoke.py``).

Walks the given files/directories, parses each ``*.py`` once, runs every
rule whose scope covers the file, applies pragma suppression
(``repro_torch.analysis.pragmas``), and reports (text or JSON).  Exit
code 0 iff no unsuppressed findings -- the gate contract.  The JAX
package's ``repro.analysis.lint`` with the port's scope.

Scope configuration lives here, not in the rules: DEFAULT_SCOPE encodes
*the port's* discipline (which modules are on the simulation path, which
hold the device loops, where the compat shims live), while the rules
themselves stay path-agnostic so the fixture tests can point them at
anything.
"""

from __future__ import annotations

import argparse
import os
import sys
from fnmatch import fnmatch
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from .pragmas import Pragma, parse_pragmas
from .report import Finding, LintResult, render_json, render_text
from .rules import ALL_RULES, RULES_BY_ID, FileContext

# Per-rule (include, exclude) fnmatch patterns over posix relpaths.  Note
# fnmatch's "*" crosses "/" -- "src/repro_torch/core/*.py" also matches
# nested dirs, which is fine here (core/ and simulation/ are flat).
_PKG = "src/repro_torch"
# the port's copies of the JAX package's simulation-path modules
_SIM_PATH_MODULES = tuple(f"{_PKG}/{m}" for m in (
    "core/routing.py",
    "core/metrics.py",
    "core/stepping.py",
    "simulation/paths.py",
    "simulation/fluid.py",
    "simulation/packet.py",
    "parallel/blockwise.py",
))
DEFAULT_SCOPE: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    # the modules kept free of [n, n] materialization, plus the blockwise
    # executor their streaming loops run through
    "dense-square": (_SIM_PATH_MODULES, ()),
    # anything the fluid solver or graph core executes per iteration,
    # including the minplus kernel pair's wrappers (the certified solver's
    # per-iteration cost reduction)
    "scatter-add": ((f"{_PKG}/simulation/*.py", f"{_PKG}/core/*.py",
                     f"{_PKG}/parallel/blockwise.py",
                     f"{_PKG}/kernels/minplus/*.py"),
                    ()),
    # the modules that hold the device loops: the counterparts of the
    # reference's jit bodies (solver, packet engine, device BFS, blockwise
    # executor, kernel wrappers, models, the train step, serve / train)
    "host-sync": ((f"{_PKG}/simulation/*.py", f"{_PKG}/core/routing.py",
                   f"{_PKG}/parallel/blockwise.py",
                   f"{_PKG}/kernels/*/ops.py", f"{_PKG}/models/*.py",
                   f"{_PKG}/train/train_step.py",
                   f"{_PKG}/launch/serve.py", f"{_PKG}/launch/train.py"),
                  ()),
    # timing discipline: the port's bench harness and its obs recorder
    # (a timing layer: every clock read there sits inside `timed` or
    # carries the one documented recorder-internal pragma)
    "naked-clock": ((f"{_PKG}/bench/*.py", f"{_PKG}/obs/*.py"), ()),
    # the two files that OWN the version guards are the only exceptions
    "compat-shim": (("*",),
                    (f"{_PKG}/parallel/compat.py",
                     f"{_PKG}/launch/mesh.py")),
    # everywhere UNREACHABLE is the law: graph core + simulation + the
    # blockwise executor they stream through
    "sentinel": ((f"{_PKG}/core/*.py", f"{_PKG}/simulation/*.py",
                  f"{_PKG}/parallel/blockwise.py"), ()),
}
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")

ScopeConfig = Dict[str, Tuple[Sequence[str], Sequence[str]]]


def _in_scope(rule_id: str, relpath: str, scope: ScopeConfig) -> bool:
    include, exclude = scope.get(rule_id, ((), ()))
    return (any(fnmatch(relpath, p) for p in include)
            and not any(fnmatch(relpath, p) for p in exclude))


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    """Expand files/directories into a sorted stream of .py files,
    skipping caches and hidden directories."""
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d != "__pycache__" and not d.startswith("."))
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def _relpath(path: str) -> str:
    """Posix path relative to the cwd when possible (so DEFAULT_SCOPE
    patterns written from the repo root match), else as given."""
    rel = os.path.relpath(path)
    if not rel.startswith(".."):
        path = rel
    return path.replace(os.sep, "/")


def _function_pragma_ranges(ctx: FileContext, pragmas: List[Pragma]
                            ) -> List[Tuple[int, int, Pragma]]:
    """(start, end, pragma) for every pragma sitting on a `def` line; a
    match suppresses covered rules across the whole function body."""
    by_line = {p.line: p for p in pragmas}
    out = []
    for fn in ctx.function_defs():
        p = by_line.get(fn.lineno)
        if p is not None:
            out.append((fn.lineno, fn.end_lineno or fn.lineno, p))
    return out


def lint_file(path: str, rules: Sequence, scope: ScopeConfig,
              result: LintResult) -> None:
    relpath = _relpath(path)
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    result.files_scanned += 1
    try:
        ctx = FileContext(relpath, source)
    except SyntaxError as e:
        result.findings.append(Finding(
            path=relpath, line=e.lineno or 1, col=(e.offset or 1) - 1,
            rule="parse-error", message=f"file does not parse: {e.msg}"))
        return

    pragmas = parse_pragmas(source)
    for p in pragmas:
        unknown = [r for r in p.rules if r not in RULES_BY_ID]
        if not p.rules or unknown:
            names = ", ".join(unknown) or "<empty>"
            result.findings.append(Finding(
                path=relpath, line=p.line, col=0, rule="bad-pragma",
                message=f"pragma names unknown rule(s): {names}"))
            p.used = True  # a broken pragma is reported once, not twice
        elif not p.reason:
            result.findings.append(Finding(
                path=relpath, line=p.line, col=0, rule="bad-pragma",
                message="suppression without a reason; write "
                        "`# reprolint-torch: allow[rule] -- <why>`"))
            p.used = True

    by_line: Dict[int, List[Pragma]] = {}
    for p in pragmas:
        by_line.setdefault(p.line, []).append(p)
    fn_ranges = _function_pragma_ranges(ctx, pragmas)

    def suppressing_pragma(f: Finding) -> Optional[Pragma]:
        for p in by_line.get(f.line, ()):
            if p.reason and p.covers(f.rule):
                return p
        # innermost enclosing def-line pragma wins; ranges from nested
        # functions are shorter, so pick the tightest covering one
        best = None
        for start, end, p in fn_ranges:
            if start <= f.line <= end and p.reason and p.covers(f.rule):
                if best is None or (end - start) < (best[1] - best[0]):
                    best = (start, end, p)
        return best[2] if best else None

    for rule in rules:
        if not _in_scope(rule.id, relpath, scope):
            continue
        for f in rule.check(ctx):
            p = suppressing_pragma(f)
            if p is not None:
                p.used = True
                result.suppressed += 1
                result.suppressed_by_rule[f.rule] = (
                    result.suppressed_by_rule.get(f.rule, 0) + 1)
            else:
                result.findings.append(f)

    for p in pragmas:
        if not p.used:
            result.findings.append(Finding(
                path=relpath, line=p.line, col=0, rule="unused-pragma",
                message="pragma suppresses nothing (stale allow for "
                        f"[{', '.join(p.rules)}]); remove it"))


def lint_paths(paths: Iterable[str], scope: Optional[ScopeConfig] = None,
               select: Optional[Sequence[str]] = None) -> LintResult:
    """Run the configured rules over `paths`.  `scope` overrides
    DEFAULT_SCOPE (fixture tests pass {"rule": (("*",), ())}); `select`
    restricts to a subset of rule ids."""
    scope = DEFAULT_SCOPE if scope is None else scope
    rules = (ALL_RULES if select is None
             else [RULES_BY_ID[r] for r in select])
    result = LintResult()
    for path in iter_py_files(paths):
        lint_file(path, rules, scope, result)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="reprolint-torch: AST invariant checks for the port "
                    "(run from the repo root so scope patterns match)")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files or directories to lint")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print rule ids + descriptions and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.id}: {r.description}")
        return 0

    select = None
    if args.select:
        select = [s.strip() for s in args.select.split(",") if s.strip()]
        unknown = [s for s in select if s not in RULES_BY_ID]
        if unknown:
            ap.error(f"unknown rule(s): {', '.join(unknown)}")

    result = lint_paths(args.paths, select=select)
    out = (render_json(result) if args.format == "json"
           else render_text(result))
    print(out, end="" if out.endswith("\n") else "\n")
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())

"""Finding / result containers and the text + JSON reporters.

Stdlib-only: the port's lint runs without torch, numpy or jax installed.
The JAX package's ``repro.analysis.report``, with the summary line
naming this tool.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List

TOOL = "reprolint-torch"


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location.

    `rule` is a rule id from ``repro_torch.analysis.rules`` or one of the
    engine's meta ids (``bad-pragma``, ``unused-pragma``, ``parse-error``),
    which report problems with the suppression machinery itself and cannot
    be suppressed.
    """

    path: str  # as scanned (posix, repo-relative when run from the root)
    line: int  # 1-based
    col: int  # 0-based, matching ast
    rule: str
    message: str

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"


@dataclass
class LintResult:
    """Outcome of one lint run over a set of files."""

    findings: List[Finding] = field(default_factory=list)  # unsuppressed
    suppressed: int = 0  # findings silenced by a valid pragma
    files_scanned: int = 0
    # rule id -> findings silenced by a pragma (the chip smoke run prints it)
    suppressed_by_rule: Dict[str, int] = field(default_factory=dict)

    @property
    def counts_by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0


def render_text(result: LintResult) -> str:
    """One `path:line:col: rule: message` row per finding + a summary line
    (the summary always prints, so a clean run is visibly clean)."""
    rows = [f"{f.location()}: {f.rule}: {f.message}"
            for f in sorted(result.findings)]
    by_rule = ", ".join(f"{rule}={n}" for rule, n in
                        sorted(result.counts_by_rule.items()))
    rows.append(
        f"{TOOL}: {len(result.findings)} finding(s)"
        + (f" [{by_rule}]" if by_rule else "")
        + f", {result.suppressed} suppressed,"
        f" {result.files_scanned} file(s) scanned")
    return "\n".join(rows)


def render_json(result: LintResult) -> str:
    """Machine-readable report: the same schema as the JAX package's."""
    return json.dumps(
        {
            "findings": [
                {"path": f.path, "line": f.line, "col": f.col,
                 "rule": f.rule, "message": f.message}
                for f in sorted(result.findings)
            ],
            "counts_by_rule": result.counts_by_rule,
            "suppressed": result.suppressed,
            "files_scanned": result.files_scanned,
            "exit_code": result.exit_code,
        },
        indent=2, sort_keys=True) + "\n"

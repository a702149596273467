"""Inline suppression pragmas.

Syntax (trailing comment, reason mandatory)::

    expr  # reprolint-torch: allow[rule-a,rule-b] -- why this is deliberately fine

The token is ``reprolint-torch``, not the JAX package's ``reprolint``:
that package's linter scans all of ``src/`` (the port included) and
reports every ``# reprolint:`` pragma whose rule it does not know or has
out of scope there, so a port pragma must not match its grammar, and this
parser honours no ``# reprolint:`` comment either.

Placement:

* on the offending line -- suppresses the listed rules for that line;
* on a ``def`` line -- suppresses the listed rules for the whole function
  body (the idiom for the dense *reference* engines, where every
  allocation in the function is intentionally [n, n]).

A pragma with a missing or empty reason, or naming an unknown rule, is
itself reported (``bad-pragma``); a pragma that suppresses nothing is
reported as ``unused-pragma``.  Neither meta finding can be suppressed --
the reason string is the point of the mechanism.
"""

from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import List, Tuple

# The `--` separator is part of the grammar: everything after it is the
# human-readable justification, and it must be non-empty.
_PRAGMA_RE = re.compile(
    r"#\s*reprolint-torch:\s*allow\[(?P<rules>[^\]]*)\]"
    r"\s*(?:--\s*(?P<reason>.*))?")


@dataclass
class Pragma:
    line: int  # 1-based line the pragma comment sits on
    rules: Tuple[str, ...]
    reason: str  # stripped; "" means the mandatory reason is missing
    used: bool = field(default=False, compare=False)

    def covers(self, rule: str) -> bool:
        return rule in self.rules


def parse_pragmas(source: str) -> List[Pragma]:
    """Extract every pragma from a file's *comments*.

    Tokenize-based on purpose: docstrings and string literals that merely
    talk about the pragma syntax (this module's own docstring, for one)
    must not register as suppressions.
    """
    out: List[Pragma] = []
    toks = tokenize.generate_tokens(io.StringIO(source).readline)
    for tok in toks:
        if tok.type != tokenize.COMMENT:
            continue
        m = _PRAGMA_RE.search(tok.string)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",")
                      if r.strip())
        reason = (m.group("reason") or "").strip()
        out.append(Pragma(line=tok.start[0], rules=rules, reason=reason))
    return out

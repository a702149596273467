"""Rule registry: one module, one AST visitor per invariant.

Adding a rule: subclass `Rule` in a new module, give it an `id` and a
`description`, implement `check(ctx)`, and list it in ALL_RULES.  Scope
(which files it runs on) is configured centrally in
``repro_torch.analysis.lint.DEFAULT_SCOPE``, keeping rules path-agnostic
and unit-testable on fixture files.
"""

from .base import FileContext, Finding, Rule  # noqa: F401
from .compat_shim import CompatShimRule
from .dense_square import DenseSquareRule
from .host_sync import HostSyncRule
from .naked_clock import NakedClockRule
from .scatter_add import ScatterAddRule
from .sentinel import SentinelRule

ALL_RULES = (
    DenseSquareRule(),
    ScatterAddRule(),
    HostSyncRule(),
    NakedClockRule(),
    CompatShimRule(),
    SentinelRule(),
)

RULES_BY_ID = {r.id: r for r in ALL_RULES}

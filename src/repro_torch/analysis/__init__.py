"""reprolint-torch: AST-based invariant checks for the port.

The JAX package's ``repro.analysis`` (reprolint) with rules written
against torch idioms: its rules look for ``@jax.jit`` bodies,
``.at[].add()``, ``jax.shard_map`` and ``jax.numpy`` allocators, none of
which the port has.  The six rule ids stay the reference's, so each
rule's counterpart is plain to see:

    dense-square  numpy / torch square allocations, ``Tensor.new_*``
    scatter-add   ``index_add_``, ``scatter_add_``, ``scatter_reduce_``,
                  ``index_put_(..., accumulate=True)``
    host-sync     host reads inside the device loop (a loop body or a
                  per-step function): ``.item()``, ``bool(t)``, ...
    naked-clock   clock reads outside ``timed``, and a ``timed`` that
                  reads its closing clock before synchronizing the card
    compat-shim   ``local_map`` and private torch modules only through
                  ``repro_torch.parallel.compat`` / ``launch/mesh.py``
    sentinel      ``repro_torch.core.graph.UNREACHABLE``, not -1 / 32000

From the repo root::

    PYTHONPATH=src python -m repro_torch.analysis.lint

lints ``src/repro_torch`` and ``chip_smoke.py``.  Suppress a finding with
a reason::

    x = torch.full((n, k), -1)  # reprolint-torch: allow[sentinel] -- why

(``reprolint-torch``, not ``reprolint``: see ``pragmas``).  A pragma on a
``def`` line suppresses the rule for the whole function body.  The
package is stdlib-only: it imports no torch, numpy or jax, and nothing of
``repro``.
"""

from .report import Finding, LintResult  # noqa: F401
from .rules import ALL_RULES  # noqa: F401

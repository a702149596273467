"""Profiler annotation: a thin shim over ``torch.profiler.record_function``.

Counterpart of the JAX package's ``obs/profiler.py``: :func:`named_scope`
labels the ops issued inside it in a ``torch.profiler`` capture (used by
``kernels/minplus/ops.path_costs``).  Outside a capture it records
nothing.
"""

from __future__ import annotations

import torch

__all__ = ["named_scope"]


def named_scope(name: str) -> torch.profiler.record_function:
    """Label the ops issued inside the ``with`` block."""
    return torch.profiler.record_function(name)

"""Profiler annotations: thin shims over ``torch.profiler.record_function``.

Counterpart of the JAX package's ``obs/profiler.py``:

- :func:`named_scope` labels the ops issued inside it in a
  ``torch.profiler`` capture (used by ``kernels/minplus/ops.path_costs``,
  the flash-attention wrappers and the model and train scopes).  Outside a
  capture it records nothing.
- :func:`trace_annotation` labels a host-side interval in a capture (used
  around each round of the blockwise device backend).  Outside a capture
  it is a ``nullcontext``: it does not even enter the profiler.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Any

import torch

__all__ = ["named_scope", "trace_annotation"]


def named_scope(name: str) -> torch.profiler.record_function:
    """Label the ops issued inside the ``with`` block."""
    return torch.profiler.record_function(name)


def trace_annotation(name: str) -> Any:
    """Host-interval annotation for ``torch.profiler`` captures; a no-op
    context manager when no capture is running."""
    # imported here: the parallel package imports this module
    from ..parallel.compat import profiler_enabled

    if profiler_enabled():
        return torch.profiler.record_function(name)
    return nullcontext()

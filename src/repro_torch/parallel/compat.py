"""Torch-version compatibility for the port's experimental and private
torch APIs.

The H100 runs torch 2.11 and the CPU tests run torch 2.13.  The port
needs a few APIs that torch does not promise to keep where they are:
``local_map`` (``torch.distributed.tensor.experimental``), the dispatch
mode base class (``torch.utils._python_dispatch``), ``torch._C``'s
fake-mode and autograd-node hooks, the process-group resolver of
``distributed_c10d``, the fake store of ``torch.testing._internal``, the
allocator's memory history, the card's busy-wait and the autograd
profiler's enabled flag.  Every call site reaches them through this
module, so a torch bump moves them here, in one file; the JAX package's
``repro.parallel.compat`` does the same for ``shard_map``.  The
``compat-shim`` rule of ``repro_torch.analysis`` flags any use outside
this file and ``launch/mesh.py``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["TorchDispatchMode", "active_fake_mode", "cuda_sleep",
           "current_autograd_node", "fake_store", "local_map",
           "memory_snapshot", "process_group_size", "profiler_enabled",
           "record_memory_history"]


def __getattr__(name: str):
    # `local_map` on first use: importing the experimental DTensor module
    # is left to the code that runs on a mesh
    if name == "local_map":
        from torch.distributed.tensor.experimental import local_map

        return local_map
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def active_fake_mode() -> Optional[Any]:
    """The FakeTensorMode on the dispatch-mode stack, or None."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)


def current_autograd_node() -> Optional[Any]:
    """The autograd node whose backward is running, or None outside the
    backward."""
    return torch._C._current_autograd_node()


def process_group_size(name) -> int:
    """The size of the process group a functional collective names."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


def fake_store():
    """A store for ``init_process_group("fake", ...)``: a world of any size
    in one process, every collective a no-op."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore()


def record_memory_history(enabled: Optional[str] = "all", **kw) -> None:
    """Start (``enabled="all"``) or stop (``enabled=None``) the CUDA
    caching allocator's history of allocations and their stacks."""
    torch.cuda.memory._record_memory_history(enabled=enabled, **kw)


def memory_snapshot() -> dict:
    """The allocator's segments and recorded history as a dict."""
    return torch.cuda.memory._snapshot()


def cuda_sleep(cycles: int) -> None:
    """Keep the current stream busy for about `cycles` clock cycles."""
    torch.cuda._sleep(cycles)


def profiler_enabled() -> bool:
    """True while a ``torch.profiler`` capture runs."""
    return bool(torch.autograd.profiler._is_profiler_enabled)

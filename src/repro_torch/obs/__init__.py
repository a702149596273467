"""repro_torch.obs — spans, counters and convergence traces.

A copy of the JAX package's ``repro.obs``: the recorder, with
``Span.sync`` draining CUDA work; the profiler annotations, built on
``torch.profiler.record_function``; the fluid solver's
``ConvergenceTrace``; and the JSONL report (``python -m
repro_torch.obs.report``).
"""

from .profiler import named_scope
from .record import (
    NullRecorder,
    Recorder,
    Span,
    get_recorder,
    recording,
    set_recorder,
)
from .trace import ConvergenceTrace

__all__ = [
    "ConvergenceTrace",
    "NullRecorder",
    "Recorder",
    "Span",
    "get_recorder",
    "named_scope",
    "recording",
    "set_recorder",
]

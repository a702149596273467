"""repro_torch.obs — spans and counters.

A copy of the JAX package's ``repro.obs`` recorder, with
``Span.sync`` draining CUDA work and the profiler annotations built on
``torch.profiler.record_function``.
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

__all__ = [
    "NullRecorder",
    "Recorder",
    "Span",
    "get_recorder",
    "named_scope",
    "recording",
    "set_recorder",
]

"""ConvergenceTrace: structured convergence telemetry from the fluid solver.

A copy of the JAX package's ``repro.obs.trace`` (numpy only).  The fluid
engines keep their samples in fixed-size device buffers, written in the
loop without reading anything back on the host, and this host-side numpy
view is assembled after the solve returns.  Samples are taken every
iteration for the uncertified Frank-Wolfe loop and every ``_CERT_STRIDE``
chunk for the certified engine; ``stride`` records which.

A saturation search contributes one sample stream per bisection probe
(``probe[k]`` names the owning probe) plus a per-probe ``brackets`` row
``(offered, feasible, lo, hi)`` describing the bisection state after
that probe.  Single solves have one probe and an empty bracket table.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

__all__ = ["ConvergenceTrace"]


def _np1(x: Any, dtype: Any = np.float64) -> np.ndarray:
    return np.asarray(x, dtype=dtype).reshape(-1)


@dataclass
class ConvergenceTrace:
    """Per-sample convergence telemetry for one fluid solve or saturation.

    Arrays are aligned per sample (length ``num_samples``):

    - ``iters``: cumulative FW iteration count at the sample
    - ``gap``: Frank-Wolfe duality gap (0 for oblivious modes)
    - ``max_util``: measured max link utilization of the current iterate
    - ``util_lb`` / ``util_ub``: certified utilization bracket
      (NaN when the solve was not certified)
    - ``step_size``: FW step size gamma used at the sample
    - ``probe``: index of the owning bisection probe (0 for solves)

    ``brackets`` is ``[num_probes, 4]``: offered load, feasibility
    decision (1.0 feasible), and the bisection bracket ``(lo, hi)``
    after the probe.  ``stride`` is the sampling stride in FW
    iterations; ``kind`` matches ``Certificate.kind`` (or
    ``"uncertified"``).
    """

    mode: str
    kind: str
    stride: int
    iters: np.ndarray
    gap: np.ndarray
    max_util: np.ndarray
    util_lb: np.ndarray
    util_ub: np.ndarray
    step_size: np.ndarray
    probe: np.ndarray
    brackets: np.ndarray = field(default_factory=lambda: np.zeros((0, 4)))

    def __post_init__(self) -> None:
        self.iters = _np1(self.iters, np.int64)
        self.gap = _np1(self.gap)
        self.max_util = _np1(self.max_util)
        self.util_lb = _np1(self.util_lb)
        self.util_ub = _np1(self.util_ub)
        self.step_size = _np1(self.step_size)
        self.probe = _np1(self.probe, np.int64)
        self.brackets = np.asarray(self.brackets, dtype=np.float64).reshape(-1, 4)

    @property
    def num_samples(self) -> int:
        return int(self.gap.shape[0])

    @property
    def num_probes(self) -> int:
        return max(int(self.brackets.shape[0]), 1)

    @property
    def final_gap(self) -> float:
        """Duality gap at the last sample of the last probe.

        For certified runs this matches ``Certificate.gap`` exactly: the
        trace buffer's final sample is written from the same carried gap
        value the certificate is built from.
        """
        if self.num_samples == 0:
            return float("nan")
        return float(self.gap[-1])

    def probe_slice(self, p: int) -> "ConvergenceTrace":
        """The sub-trace belonging to bisection probe ``p``."""
        m = self.probe == p
        return ConvergenceTrace(
            mode=self.mode,
            kind=self.kind,
            stride=self.stride,
            iters=self.iters[m],
            gap=self.gap[m],
            max_util=self.max_util[m],
            util_lb=self.util_lb[m],
            util_ub=self.util_ub[m],
            step_size=self.step_size[m],
            probe=self.probe[m],
            brackets=self.brackets[p : p + 1] if p < self.brackets.shape[0] else np.zeros((0, 4)),
        )

    def to_metrics(self, recorder: Any, name: str = "fluid") -> None:
        """Emit this trace into ``recorder`` as gauges and series."""
        recorder.gauge(f"{name}.final_gap", self.final_gap)
        if self.num_samples:
            recorder.gauge(f"{name}.final_max_util", float(self.max_util[-1]))
            recorder.series(f"{name}.gap", self.gap)
            recorder.series(f"{name}.max_util", self.max_util)
        recorder.gauge(f"{name}.samples", float(self.num_samples))
        recorder.gauge(f"{name}.probes", float(self.num_probes))

    def __repr__(self) -> str:  # keep reprs readable in doctests/logs
        return (
            f"ConvergenceTrace(mode={self.mode!r}, kind={self.kind!r}, "
            f"stride={self.stride}, samples={self.num_samples}, "
            f"probes={self.num_probes}, final_gap={self.final_gap:.3g})"
        )

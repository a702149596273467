"""Elastic scaling + straggler mitigation.

The JAX package's ``train/elastic.py``:

* `reshard_state`: move a train state onto a different mesh (grow/shrink
  data parallelism): each leaf laid out per its spec on the new mesh;
  combined with `checkpoint.restore` this is scale-up/scale-down restart.

* `StragglerDetector`: per-step wall-time tracker; flags steps whose
  duration exceeds median * threshold and recommends an action (the
  paper's diameter-2 fabric makes respawn-on-spare cheap: every spare is
  <= 2 hops from all survivors -- see fabric/placement.remap_failed).
* `FailureInjector`: deterministic fault hook for tests/demos (kill the
  process at step N, or corrupt a device's step time).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

from ..models.common import tree_map
from ..parallel.sharding import constrain, is_dtensor

__all__ = ["reshard_state", "StragglerDetector", "FailureInjector"]


def reshard_state(state, pspec_tree, new_mesh):
    """Every leaf of `state` laid out on `new_mesh` per the spec tree: a
    DTensor on `new_mesh` is redistributed, one on another mesh gathered
    first (``full_tensor``: every rank of its mesh takes part), and a plain
    tensor -- the global value, the same on every rank -- keeps this
    rank's shard."""
    def one(x, spec):
        if is_dtensor(x) and x.device_mesh != new_mesh:
            x = x.full_tensor()
        return constrain(x, new_mesh, spec)

    return tree_map(one, state, pspec_tree)


@dataclass
class StragglerDetector:
    window: int = 32
    threshold: float = 1.5  # x median
    min_excess_s: float = 0.25  # ignore sub-absolute-threshold jitter
    times: Deque[float] = field(default_factory=deque)
    flagged: List[int] = field(default_factory=list)
    _t0: Optional[float] = None
    step: int = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> Dict[str, Any]:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.popleft()
        med = sorted(self.times)[len(self.times) // 2]
        is_straggler = (len(self.times) >= 8 and dt > self.threshold * med
                        and dt - med > self.min_excess_s)
        if is_straggler:
            self.flagged.append(self.step)
        self.step += 1
        return {"step_time": dt, "median": med, "straggler": is_straggler}

    def recommendation(self) -> str:
        if len(self.flagged) >= 3:
            return ("persistent straggler: remap rank to hot spare "
                    "(fabric.placement.remap_failed) and restart from latest "
                    "checkpoint")
        if self.flagged:
            return "transient stragglers observed: no action"
        return "healthy"


@dataclass
class FailureInjector:
    fail_at_step: Optional[int] = None
    slow_at_step: Optional[int] = None
    slow_seconds: float = 0.5

    def maybe_fail(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise RuntimeError(f"[injected] node failure at step {step}")
        if self.slow_at_step is not None and step == self.slow_at_step:
            time.sleep(self.slow_seconds)

"""Shared blockwise execution core for the streaming engines (host backend).

A copy of the JAX package's ``parallel/blockwise.py`` with its host
backend only.  The source-blocked BFS (`repro_torch.core.routing`), the
destination-blocked path builder (`repro_torch.simulation.paths`,
``engine="blocked"``) and chunked flow-path assembly all size a block from
a byte budget, loop over blocks, and stream results to a consumer:

* `BlockPlan` -- the block axis: total item count and items per block
  (sized via `block_size_for_budget`).
* `run_blocks` -- the executor.  ``backend="host"`` (and ``"auto"``) is a
  sequential Python loop calling `host_fn(items_blk)` per block.  The
  reference's ``backend="sharded"`` (one block per device) is not ported
  yet and raises `NotImplementedError` (ROADMAP Queue 1, item 7).
* `block_size_for_budget` / `peak_bytes` -- the byte-accounting helper
  pair behind the routing and path-builder estimators.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np

from ..obs.record import get_recorder

__all__ = [
    "DEFAULT_BUDGET_BYTES",
    "BlockPlan",
    "plan_blocks",
    "block_size_for_budget",
    "peak_bytes",
    "run_blocks",
]

# Default transient working-set budget shared by every blocked engine
# (routing aliases this as its historical `_BFS_BUDGET_BYTES` name).
DEFAULT_BUDGET_BYTES = 512 * 2 ** 20


def block_size_for_budget(total: int, per_item_bytes: int,
                          budget_bytes: int = DEFAULT_BUDGET_BYTES) -> int:
    """Items per block so the transient working set fits `budget_bytes`.

    Always at least 1 (a single item is the floor every streaming engine
    can run at -- arbitrarily small budgets degrade throughput, never
    correctness) and never more than `total`.
    """
    return int(min(max(total, 1),
                   max(1, budget_bytes // max(per_item_bytes, 1))))


def peak_bytes(block: int, per_item_bytes: int,
               resident_bytes: int = 0) -> int:
    """Estimated peak bytes of a blocked run: one block's transient
    working set plus whatever stays resident across blocks (output
    tables, per-flow arrays; streaming consumers pass 0)."""
    return block * per_item_bytes + resident_bytes


@dataclass(frozen=True)
class BlockPlan:
    """The block axis of a blocked computation.

    `total` items split into ceil(total / block) blocks; every block has
    exactly `block` items except a possibly short tail.

    `per_item_bytes` is informational: `plan_blocks` carries the byte
    sizing through so `run_blocks` can report per-block working-set
    bytes (`peak_bytes`) on its obs spans; 0 means unknown (plans built
    directly from an explicit `block`).
    """

    total: int
    block: int
    per_item_bytes: int = 0

    def __post_init__(self):
        if self.total < 0 or self.block < 1:
            raise ValueError(
                f"invalid BlockPlan(total={self.total}, block={self.block})")

    @property
    def num_blocks(self) -> int:
        return -(-self.total // self.block) if self.total else 0

    def bounds(self, i: int) -> Tuple[int, int]:
        """[lo, hi) item range of block i."""
        lo = i * self.block
        return lo, min(lo + self.block, self.total)


def plan_blocks(total: int, per_item_bytes: Optional[int] = None,
                budget_bytes: int = DEFAULT_BUDGET_BYTES,
                block: Optional[int] = None) -> BlockPlan:
    """Build a `BlockPlan`, sizing the block from a byte budget unless an
    explicit `block` is given (same precedence every blocked engine uses)."""
    if block is None:
        if per_item_bytes is None:
            raise ValueError("plan_blocks needs per_item_bytes or block")
        block = block_size_for_budget(total, per_item_bytes, budget_bytes)
    return BlockPlan(total=total, block=int(block),
                     per_item_bytes=int(per_item_bytes or 0))


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _resolve_backend(backend: str) -> str:
    if backend == "sharded":
        raise NotImplementedError(
            "backend='sharded' is not ported yet (ROADMAP Queue 1, item 7); "
            "use backend='host'")
    if backend not in ("auto", "host"):
        raise ValueError(f"unknown backend {backend!r}")
    return "host"


def _run_host(items: np.ndarray, plan: BlockPlan,
              host_fn: Callable) -> Iterator[Tuple[np.ndarray, tuple]]:
    for i in range(plan.num_blocks):
        lo, hi = plan.bounds(i)
        blk = items[lo:hi]
        yield blk, _as_tuple(host_fn(blk))


def run_blocks(items: Sequence, plan: BlockPlan, host_fn: Callable,
               backend: str = "auto",
               progress: Optional[Callable[[int, int], None]] = None,
               ) -> Iterator[Tuple[np.ndarray, tuple]]:
    """Stream ``(items_blk, outputs)`` per block, in block order.

    `items` is the 1-D array being blocked (source ids, destination ids,
    flow indices, ...).  `host_fn(items_blk)` is the numpy reference; it
    may return a single value or a tuple (normalized to a tuple either
    way -- non-array returns such as FlowPaths chunks are passed through
    untouched).  ``backend`` is ``"auto"`` or ``"host"`` (the same loop);
    ``"sharded"`` raises `NotImplementedError` (ROADMAP Queue 1, item 7).

    Every block is wrapped in a ``blockwise.block`` obs span recording
    the backend, block index, item count, and (when the plan carries
    `per_item_bytes`) the block's working-set bytes.
    `progress(done_blocks, num_blocks)` is called after each block is
    produced (before it is yielded).
    """
    resolved = _resolve_backend(backend)
    items = np.asarray(items)
    if plan.total != len(items):
        raise ValueError(f"plan.total={plan.total} != len(items)={len(items)}")
    if plan.total == 0:
        return
    inner = _run_host(items, plan, host_fn)
    rec = get_recorder()
    nblocks = plan.num_blocks
    for i in range(nblocks):
        with rec.span("blockwise.block", backend=resolved, index=i) as sp:
            blk, outs = next(inner)
            sp.set(items=len(blk))
            if plan.per_item_bytes:
                sp.set(bytes=peak_bytes(len(blk), plan.per_item_bytes))
        if progress is not None:
            progress(i + 1, nblocks)
        yield blk, outs

"""Shared blockwise execution core for the streaming engines.

The counterpart of the JAX package's ``parallel/blockwise.py``.  The
source-blocked BFS (`repro_torch.core.routing`), the destination-blocked
path builder (`repro_torch.simulation.paths`, ``engine="blocked"``) and
chunked flow-path assembly all size a block from a byte budget, loop over
blocks, and stream results to a consumer:

* `BlockPlan` -- the block axis: total item count, items per block (sized
  via `block_size_for_budget`), and the device count the sharded backend
  targets.
* `run_blocks` -- the executor, with two backends that agree bit for bit:

    - ``backend="host"`` -- the reference: a sequential Python loop
      calling `host_fn(items_blk)` per block.
    - ``backend="sharded"`` -- `device_fn`, the PyTorch twin of `host_fn`,
      runs each block on the device its tensors live on (the caller builds
      `device_fn` for one device, the card unless it asks for the CPU),
      one block at a time, and each block's outputs come back to the host
      as numpy arrays.  One card is one device: blocks are not spread over
      several cards.

  ``backend="auto"`` keeps the reference's rule: sharded only when the
  plan asks for more than one device, more than one is visible, and there
  is more than one block.  Both backends yield ``(items_blk, outputs)`` in
  block order, so consumers are backend-blind.
* `block_size_for_budget` / `peak_bytes` -- the byte-accounting helper
  pair behind the routing and path-builder estimators.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.profiler import trace_annotation
from ..obs.record import get_recorder

__all__ = [
    "DEFAULT_BUDGET_BYTES",
    "BlockPlan",
    "plan_blocks",
    "block_size_for_budget",
    "peak_bytes",
    "available_devices",
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
    exactly `block` items except a possibly short tail.  `devices` is the
    device count ``backend="auto"`` looks at (the host backend ignores it).

    `per_item_bytes` is informational: `plan_blocks` carries the byte
    sizing through so `run_blocks` can report per-block working-set
    bytes (`peak_bytes`) on its obs spans; 0 means unknown (plans built
    directly from an explicit `block`).
    """

    total: int
    block: int
    devices: int = 1
    per_item_bytes: int = 0

    def __post_init__(self):
        if self.total < 0 or self.block < 1 or self.devices < 1:
            raise ValueError(
                f"invalid BlockPlan(total={self.total}, block={self.block}, "
                f"devices={self.devices})")

    @property
    def num_blocks(self) -> int:
        return -(-self.total // self.block) if self.total else 0

    def bounds(self, i: int) -> Tuple[int, int]:
        """[lo, hi) item range of block i."""
        lo = i * self.block
        return lo, min(lo + self.block, self.total)


def plan_blocks(total: int, per_item_bytes: Optional[int] = None,
                budget_bytes: int = DEFAULT_BUDGET_BYTES,
                block: Optional[int] = None, devices: int = 1) -> BlockPlan:
    """Build a `BlockPlan`, sizing the block from a byte budget unless an
    explicit `block` is given (same precedence every blocked engine uses)."""
    if block is None:
        if per_item_bytes is None:
            raise ValueError("plan_blocks needs per_item_bytes or block")
        block = block_size_for_budget(total, per_item_bytes, budget_bytes)
    return BlockPlan(total=total, block=int(block), devices=int(devices),
                     per_item_bytes=int(per_item_bytes or 0))


def available_devices() -> int:
    """Visible CUDA devices (`torch.cuda.device_count()`; 0 without a
    card)."""
    return torch.cuda.device_count()


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _resolve_backend(backend: str, plan: BlockPlan, device_fn) -> str:
    if backend not in ("auto", "host", "sharded"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "sharded":
        if device_fn is None:
            raise ValueError("backend='sharded' requires a device_fn")
        return "sharded"
    if backend == "host" or device_fn is None:
        return "host"
    # auto: shard only when a multi-device run was requested AND the
    # devices exist, and there is more than one block to spread --
    # otherwise the host loop is both the reference and the fastest option
    if plan.devices > 1 and plan.num_blocks > 1 and available_devices() > 1:
        return "sharded"
    return "host"


def _run_host(items: np.ndarray, plan: BlockPlan,
              host_fn: Callable) -> Iterator[Tuple[np.ndarray, tuple]]:
    for i in range(plan.num_blocks):
        lo, hi = plan.bounds(i)
        blk = items[lo:hi]
        yield blk, _as_tuple(host_fn(blk))


def _run_sharded(items: np.ndarray, plan: BlockPlan,
                 device_fn: Callable) -> Iterator[Tuple[np.ndarray, tuple]]:
    """`device_fn` on each block in turn; the block's ids go to the device
    as an int64 tensor and its outputs come back as numpy arrays (one
    device-to-host copy per output, which is the block's one host sync),
    the round labelled "blockwise.round" in a ``torch.profiler`` capture
    (`obs.trace_annotation`, as the reference labels its rounds).  No
    padding: PyTorch runs any block width without recompiling."""
    for i in range(plan.num_blocks):
        lo, hi = plan.bounds(i)
        blk = items[lo:hi]
        with trace_annotation("blockwise.round"):
            outs = device_fn(torch.from_numpy(np.ascontiguousarray(
                blk, np.int64)))
            outs = tuple(o.cpu().numpy() for o in _as_tuple(outs))  # reprolint-torch: allow[host-sync] -- the block's one device-to-host copy per output: run_blocks yields numpy, the reference's contract
        yield blk, outs


def run_blocks(items: Sequence, plan: BlockPlan, host_fn: Callable,
               device_fn: Optional[Callable] = None,
               backend: str = "auto",
               progress: Optional[Callable[[int, int], None]] = None,
               ) -> Iterator[Tuple[np.ndarray, tuple]]:
    """Stream ``(items_blk, outputs)`` per block, in block order.

    `items` is the 1-D array being blocked (source ids, destination ids,
    flow indices, ...).  `host_fn(items_blk)` is the numpy reference; it
    may return a single value or a tuple (normalized to a tuple either
    way -- non-array returns such as FlowPaths chunks are passed through
    untouched by the host backend).  `device_fn` is its PyTorch twin: it
    takes the block's ids as a CPU int64 tensor, moves them to its own
    device, and returns tensors with a leading block axis; rows must be
    independent.

    ``backend="auto"`` runs sharded only when `plan.devices > 1`, more
    than one device is visible, there is more than one block, and a
    `device_fn` exists; everything else runs the host loop, so on one card
    ``"auto"`` is the reference path and ``"sharded"`` is asked for by
    name.

    Every block is wrapped in a ``blockwise.block`` obs span recording
    the backend, block index, item count, and (when the plan carries
    `per_item_bytes`) the block's working-set bytes.
    `progress(done_blocks, num_blocks)` is called after each block is
    produced (before it is yielded).
    """
    items = np.asarray(items)
    if plan.total != len(items):
        raise ValueError(f"plan.total={plan.total} != len(items)={len(items)}")
    if plan.total == 0:
        return
    resolved = _resolve_backend(backend, plan, device_fn)
    inner = (_run_host(items, plan, host_fn) if resolved == "host"
             else _run_sharded(items, plan, device_fn))
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

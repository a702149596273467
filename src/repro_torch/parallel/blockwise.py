"""Shared blockwise execution core for the streaming engines.

The counterpart of the JAX package's ``parallel/blockwise.py``.  The
source-blocked BFS (`repro_torch.core.routing`), the destination-blocked
path builder (`repro_torch.simulation.paths`, ``engine="blocked"``) and
chunked flow-path assembly all size a block from a byte budget, loop over
blocks, and stream results to a consumer:

* `BlockPlan` -- the block axis: total item count, items per block (sized
  via `block_size_for_budget`), and the device count the sharded backend
  spreads a round over (`num_rounds` rounds of `devices` blocks).
* `run_blocks` -- the executor, with two backends that agree bit for bit:

    - ``backend="host"`` -- the reference: a sequential Python loop
      calling `host_fn(items_blk)` per block.
    - ``backend="sharded"`` -- `device_fn`, the PyTorch twin of `host_fn`
      (one twin a device, each built on its device by the caller), runs
      round r's blocks r * ndev .. r * ndev + ndev - 1 at once, block j of
      the round on device j, ``ndev = min(plan.devices, twins)``, as the
      reference's ``shard_map`` runs one block a device.  Every block of a
      round is issued (one host thread a device, so that each card's
      level loop runs beside the others') before any is copied back; the
      outputs come back as numpy arrays.  No padding: PyTorch runs any
      block width without recompiling.  Rounds over several cards are bit
      for bit one card's, but at the blocked routing stack's block sizes
      no measurement has yet found them faster than one card
      (scripts/blockwise_cards.py): each card's BFS reads its frontier
      back once a level.  So only an explicit device count or list
      spreads a run; ``devices=None`` is one card.

  ``backend="auto"`` keeps the reference's rule: sharded only when the
  plan asks for more than one device, more than one twin exists, and
  there is more than one block.  Both backends yield ``(items_blk,
  outputs)`` in block order, so consumers are backend-blind.
* `resolve_devices` -- the devices a sharded run spreads over (an
  explicit list, the counterpart of the reference's
  ``jax.devices()[:ndev]``; or a count clamped to the visible cards,
  ``cuda:0 .. cuda:ndev - 1``; or ``device`` alone where that is one or
  no count is given).
* `block_size_for_budget` / `peak_bytes` -- the byte-accounting helper
  pair behind the routing and path-builder estimators.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..obs.profiler import trace_annotation
from ..obs.record import get_recorder

__all__ = [
    "DEFAULT_BUDGET_BYTES",
    "BlockPlan",
    "plan_blocks",
    "block_size_for_budget",
    "peak_bytes",
    "available_devices",
    "resolve_devices",
    "run_blocks",
]

DeviceLike = Union[str, torch.device]
# a device count, or an explicit list of devices
Devices = Union[int, Sequence[DeviceLike], None]

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
    exactly `block` items except a possibly short tail.  The sharded
    backend runs `devices` blocks a round, one a device, so `devices` is
    the width it targets -- the host backend ignores it.

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

    @property
    def num_rounds(self) -> int:
        """Sharded-backend rounds: ceil(num_blocks / devices)."""
        return -(-self.num_blocks // self.devices)

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


def resolve_devices(devices: Devices = None,
                    device: DeviceLike = "cuda") -> List[torch.device]:
    """The devices a sharded run spreads its blocks over.

    An explicit sequence is taken as given (the counterpart of the
    reference's ``jax.devices()[:ndev]``; the tests pass several
    ``torch.device("cpu")`` entries).  A count `n` gives ``cuda:0 ..
    cuda:ndev - 1``, ``ndev = min(n, visible cards)`` -- the reference's
    clamp, so ``devices=4`` on one card runs on one.  Where that is one
    card or none, `devices` is None, or `device` is the CPU, it is
    `device` alone: ``device=`` keeps its meaning for one device.  (None
    stays on one card because several cards have not yet been measured
    faster at the blocked stack's block sizes: see the module docstring.)
    """
    if devices is None:
        return [resolve_device(device)]
    if not isinstance(devices, (int, np.integer)):
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("devices= is an empty list")
        return devs
    visible = available_devices()
    ndev = min(int(devices), visible)
    if ndev <= 1 or torch.device(device).type != "cuda":
        return [resolve_device(device)]
    return [torch.device("cuda", i) for i in range(ndev)]


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _twins(device_fn) -> List[Callable]:
    if device_fn is None:
        return []
    return [device_fn] if callable(device_fn) else list(device_fn)


def _resolve_backend(backend: str, plan: BlockPlan, twins: list) -> str:
    if backend not in ("auto", "host", "sharded"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "sharded":
        if not twins:
            raise ValueError("backend='sharded' requires a device_fn")
        return "sharded"
    if backend == "host" or not twins:
        return "host"
    # auto: shard only when a multi-device run was requested AND the
    # devices exist, and there is more than one block to spread --
    # otherwise the host loop is both the reference and the fastest option
    if plan.devices > 1 and plan.num_blocks > 1 and len(twins) > 1:
        return "sharded"
    return "host"


def _run_host(items: np.ndarray, plan: BlockPlan,
              host_fn: Callable) -> Iterator[Tuple[np.ndarray, tuple]]:
    for i in range(plan.num_blocks):
        lo, hi = plan.bounds(i)
        blk = items[lo:hi]
        yield blk, _as_tuple(host_fn(blk))


def _call(fn_blk):
    fn, blk = fn_blk
    return _as_tuple(fn(torch.from_numpy(np.ascontiguousarray(blk,
                                                              np.int64))))


def _run_sharded(items: np.ndarray, plan: BlockPlan,
                 twins: List[Callable]) -> Iterator[Tuple[np.ndarray, tuple]]:
    """Round r: blocks r * ndev .. r * ndev + ndev - 1, block j on
    ``twins[j]``'s device, all of them issued (one host thread a device
    when there are several) before any output is copied back; then the
    round's blocks are yielded in block order.  The round is labelled
    "blockwise.round" in a ``torch.profiler`` capture
    (`obs.trace_annotation`, as the reference labels its rounds)."""
    ndev = min(plan.devices, len(twins))
    pool = ThreadPoolExecutor(max_workers=ndev) if ndev > 1 else None
    run = map if pool is None else pool.map
    try:
        for r in range(-(-plan.num_blocks // ndev)):
            idx = range(r * ndev, min(r * ndev + ndev, plan.num_blocks))
            blocks = [items[slice(*plan.bounds(i))] for i in idx]
            with trace_annotation("blockwise.round"):
                outs = list(run(_call, zip(twins, blocks)))
                outs = [tuple(o.cpu().numpy() for o in out) for out in outs]  # reprolint-torch: allow[host-sync] -- the round's one device-to-host copy per block and output, after every block of the round was issued: run_blocks yields numpy, the reference's contract
            yield from zip(blocks, outs)
    finally:
        if pool is not None:
            pool.shutdown()


def run_blocks(items: Sequence, plan: BlockPlan, host_fn: Callable,
               device_fn: Union[Callable, Sequence[Callable], None] = None,
               backend: str = "auto",
               progress: Optional[Callable[[int, int], None]] = None,
               ) -> Iterator[Tuple[np.ndarray, tuple]]:
    """Stream ``(items_blk, outputs)`` per block, in block order.

    `items` is the 1-D array being blocked (source ids, destination ids,
    flow indices, ...).  `host_fn(items_blk)` is the numpy reference; it
    may return a single value or a tuple (normalized to a tuple either
    way -- non-array returns such as FlowPaths chunks are passed through
    untouched by the host backend).  `device_fn` is its PyTorch twin, or a
    sequence of twins, one a device: a twin takes the
    block's ids as a CPU int64 tensor, moves them to its own device, and
    returns tensors with a leading block axis; rows must be independent.

    ``backend="auto"`` runs sharded only when `plan.devices > 1`, more
    than one twin exists, and there is more than one block; everything
    else runs the host loop, so on one card ``"auto"`` is the reference
    path and ``"sharded"`` is asked for by name (and then never leaves
    the device).

    Every block is wrapped in a ``blockwise.block`` obs span recording
    the backend, block index, item count, and (when the plan carries
    `per_item_bytes`) the block's working-set bytes.  The sharded backend
    computes a whole round at its first block's ``next()``, so that
    round's wall time lands on the round's first span.
    `progress(done_blocks, num_blocks)` is called after each block is
    produced (before it is yielded).
    """
    items = np.asarray(items)
    if plan.total != len(items):
        raise ValueError(f"plan.total={plan.total} != len(items)={len(items)}")
    if plan.total == 0:
        return
    twins = _twins(device_fn)
    resolved = _resolve_backend(backend, plan, twins)
    inner = (_run_host(items, plan, host_fn) if resolved == "host"
             else _run_sharded(items, plan, twins))
    rec = get_recorder()
    nblocks = plan.num_blocks
    try:
        for i in range(nblocks):
            with rec.span("blockwise.block", backend=resolved,
                          index=i) as sp:
                blk, outs = next(inner)
                sp.set(items=len(blk))
                if plan.per_item_bytes:
                    sp.set(bytes=peak_bytes(len(blk), plan.per_item_bytes))
            if progress is not None:
                progress(i + 1, nblocks)
            yield blk, outs
    finally:
        inner.close()  # a consumer that stops early ends the round's threads

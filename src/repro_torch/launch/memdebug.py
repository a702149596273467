"""Buffer-level memory diagnosis of a dry-run cell: the top-N largest
per-device buffers live at the peak, with the op that made each and the
model code it came from.

The JAX package's ``launch/memdebug.py``, which lists the largest HLO
buffers of a compiled cell.  Two modes here:

  * on the fake world (default): `MemoryTrace` follows every storage the
    traced call creates or was given (`launch.dryrun`'s trace on the meta
    device: this rank's shards, allocating nothing) and lists those live
    at the peak;
  * ``--card``: the cell's step run once on the card (one device: the
    plan on a (1, 1) mesh, the model without one) under
    ``torch.cuda.memory._record_memory_history``; the largest blocks live
    at the peak of ``torch.cuda.memory._snapshot()``'s trace, with their
    Python frames (`card_top_blocks`; "?" where the allocation has none
    of the port's, as autograd's engine thread in the backward).
    Without CUDA it raises.

  PYTHONPATH=src python -m repro_torch.launch.memdebug --hbm-gb 80 \
      --arch qwen2-0.5b --shape train_4k [--multipod] [--top 25] \
      [--remat full|2level|none]
  PYTHONPATH=src python -m repro_torch.launch.memdebug --card \
      --arch qwen2-0.5b --shape train_4k [--batch 8 --microbatches 8]
"""

from __future__ import annotations

import argparse
import traceback
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from ..models.common import REMAT
from ..parallel.compat import (TorchDispatchMode, active_fake_mode,
                               current_autograd_node)

__all__ = ["MemoryTrace", "card_top_blocks", "main"]

_PKG = "repro_torch"


def _source() -> str:
    """The innermost frame of the port's own code ("file:line function"),
    after "bwd:<autograd node> " inside the backward."""
    node = current_autograd_node()
    pre = f"bwd:{node.name()} " if node is not None else ""
    return pre + _frame()


def _frame() -> str:
    for f in reversed(traceback.extract_stack(limit=48)):
        if f"/{_PKG}/" in f.filename and "/launch/" not in f.filename \
                and "/parallel/sharding" not in f.filename:
            name = f.filename.split(f"/{_PKG}/", 1)[1]
            return f"{name}:{f.lineno} {f.name}"
    return "?"


class MemoryTrace(TorchDispatchMode):
    """Live bytes of every storage a call creates (and of the tensors
    `track` is given), by storage: the peak, and the buffers live at it.

    A DTensor op is left to DTensor (NotImplemented), so the buffers are
    the local shards.  Each storage is followed by a weak reference, so a
    free is seen when the last tensor on it dies; views and in-place
    results add nothing.  ``record=True`` keeps each buffer's shape, op
    and source for `top`."""

    def __init__(self, record: bool = False):
        super().__init__()
        self.record = record
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}
        self._events: List[Tuple[int, int]] = []  # (+key/-key, bytes)
        self._info: Dict[int, Tuple[int, str, str, str]] = {}
        self._next = 0

    def _add(self, t: torch.Tensor, op: str, where: str) -> None:
        st = t.untyped_storage()
        sid = id(st)
        if sid in self._refs and self._refs[sid]() is st:
            return
        self._next += 1
        key, size = self._next, st.nbytes()

        def freed(_, key=key, size=size, sid=sid):
            self.live -= size
            self._events.append((-key, size))
            if self._refs.get(sid) is ref:
                del self._refs[sid]

        ref = weakref.ref(st, freed)
        self._refs[sid] = ref
        self.live += size
        self.peak = max(self.peak, self.live)
        self._events.append((key, size))
        if self.record:
            self._info[key] = (size, f"{str(t.dtype)[6:]}"
                               f"{list(t.shape)}", op, where)

    def track(self, tree, label: str = "input") -> None:
        """Count the tensors of `tree` (nested dicts / lists; a DTensor's
        local shard) as live from now on."""
        from ..parallel.sharding import is_dtensor

        if isinstance(tree, dict):
            for v in tree.values():
                self.track(v, label)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                self.track(v, label)
        elif isinstance(tree, torch.Tensor):
            t = tree.to_local() if is_dtensor(tree) else tree
            self._add(t, label, label)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if active_fake_mode() is not None:
            return out  # DTensor's own shape propagation
        self.observe(func, out)
        return out

    def observe(self, func, out) -> None:
        """Count the storages `func` returned (`launch.cost.CostMode`
        calls it where one mode does both)."""
        outs = out if isinstance(out, (list, tuple)) else (out,)
        where = _source() if self.record else ""
        for t in outs:
            if isinstance(t, torch.Tensor):
                self._add(t, func.overloadpacket.__name__, where)

    def top(self, n: int = 25) -> List[Tuple[int, str, str, str]]:
        """The `n` largest buffers live at the peak: (bytes, dtype[shape],
        op, source), distinct by (shape, op, source) as the reference's."""
        live, best, at = 0, -1, 0
        for i, (key, size) in enumerate(self._events):
            live += size if key > 0 else -size
            if live > best:
                best, at = live, i
        alive = set()
        for key, _ in self._events[:at + 1]:
            if key > 0:
                alive.add(key)
            else:
                alive.discard(-key)
        rows = sorted((self._info[k] for k in alive if k in self._info),
                      key=lambda r: -r[0])
        seen, out = set(), []
        for row in rows:
            if row[1:] in seen:
                continue
            seen.add(row[1:])
            out.append(row)
            if len(out) >= n:
                break
        return out


def card_top_blocks(snapshot: dict, n: int = 10
                    ) -> Tuple[int, List[Tuple[int, str, str]]]:
    """(peak bytes, the `n` largest blocks live at the peak) of one
    device's ``torch.cuda.memory._snapshot()`` taken after a run recorded
    with ``_record_memory_history``: each block (bytes, "alloc" site, the
    port's innermost Python frame).  The live set is walked back from the
    snapshot's allocated blocks through the trace's events, so the peak
    is the highest point inside the recorded window."""
    live: Dict[int, Tuple[int, str]] = {}
    for seg in snapshot["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] in ("active_allocated", "active_pending_free"):
                live[blk["address"]] = (blk["size"],
                                        _frames(blk.get("frames", [])))
    events = snapshot["device_traces"][0]
    cur = sum(s for s, _ in live.values())
    best, best_live, at = cur, dict(live), len(events)
    for i in range(len(events) - 1, -1, -1):  # live: before event i
        ev = events[i]
        act, addr = ev["action"], ev["addr"]
        if act == "alloc":
            live.pop(addr, None)
            cur -= ev["size"]
        elif act == "free_completed":
            live[addr] = (ev["size"], "?")
            cur += ev["size"]
        else:
            continue
        if cur > best:
            best, best_live, at = cur, dict(live), i
    site = {}  # where each block live at the peak was allocated
    for ev in events[:at]:
        if ev["action"] == "alloc":
            site[ev["addr"]] = _frames(ev.get("frames", []))
    rows = sorted(((s, hex(a), site.get(a, w))
                   for a, (s, w) in best_live.items()), key=lambda r: -r[0])
    return best, rows[:n]


def _frames(frames) -> str:
    """The innermost frame of the port's model code in a snapshot's
    frames (innermost first), past the launch tools' own."""
    for f in frames:
        name = f.get("filename", "")
        if f"/{_PKG}/" in name and "/launch/" not in name \
                and "/parallel/sharding" not in name:
            return f"{name.split(f'/{_PKG}/', 1)[1]}:{f['line']} {f['name']}"
    return "?"


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None, choices=list(REMAT),
                    help="in place of the plan's remat")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="device memory when no card is present")
    ap.add_argument("--card", action="store_true",
                    help="run the cell's step once on the card (one device)")
    ap.add_argument("--batch", type=int, default=None,
                    help="with --card: this many sequences in place of the "
                         "cell's global batch")
    args = ap.parse_args(argv)
    extra = {"num_microbatches": args.microbatches,
             "remat": args.remat}
    from . import dryrun

    if args.card:
        if not torch.cuda.is_available():
            raise SystemExit("--card needs a CUDA card")
        res = dryrun.card_step(args.arch, args.shape, extra=extra,
                               memory_history=True, top=args.top,
                               batch=args.batch)
        print(f"peak {res['peak_bytes'] / 1e9:.2f} GB in the recorded "
              f"window; max_memory_allocated "
              f"{res['max_memory_allocated'] / 1e9:.2f} GB; plan "
              f"{res['plan']['est_bytes_per_chip'] / 1e9:.2f} GB")
        for size, addr, where in res["top"]:
            print(f"{size / 1e9:8.2f} GB  {addr:16s} {where}")
        return
    hbm = _hbm(ap, args.hbm_gb)
    trace = MemoryTrace(record=True)
    dryrun.trace_cell(args.arch, args.shape,
                      "multipod" if args.multipod else "pod", hbm,
                      extra=extra, memory=trace)
    print(f"peak {trace.peak / 1e9:.2f} GB a device")
    for size, shape, op, where in trace.top(args.top):
        print(f"{size / 1e9:8.2f} GB  {shape:34s} {op:18s} {where}")


def _hbm(ap, hbm_gb):
    from . import dryrun

    try:
        return dryrun.hbm_bytes(hbm_gb)
    except ValueError as e:
        ap.error(str(e))


if __name__ == "__main__":
    main()

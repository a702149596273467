"""One process a rank: the launcher of the port's multi-rank runs.

`run_ranks(fn, world, tmp, *args, backend=...)` starts `world`
processes with ``torch.multiprocessing``'s spawn context (a parent that
has touched CUDA cannot fork), joins them in a process group through a
``FileStore`` in `tmp` (a fresh file each call, never a fixed port, so
concurrent worlds do not collide), runs ``fn(rank, world, tmp, *args)``
in each and returns each rank's result.

* ``backend="nccl"``: rank r runs on card r.  It calls
  ``torch.cuda.set_device(r)`` before anything touches CUDA, then
  ``init_process_group("nccl", device_id=cuda:r)``, which binds the
  communicator to that card at once.  So a plain ``"cuda"`` in the
  rank's code means its own card.
* ``backend="gloo"``: CPU processes of one thread each (the CPU tests'
  worlds).

The call has a deadline.  A rank that raises writes its traceback to
``tmp/rank<r>.err`` and exits non-zero; the launcher then kills the other
ranks at once (they would wait in a collective for it) and raises
`RankFailure` with every traceback.  Ranks still running at the deadline
(a hang in a collective, a send no rank receives) are killed and the call
raises too.  No rank's failure is caught and no rank falls back to the
CPU.

A rank's result is what `fn` returns, written as JSON to
``tmp/rank<r>.json`` (numbers, strings, lists, dicts): `run_ranks`
returns the list of them in rank order (None where `fn` returned None).
`fn` must be importable by name in a fresh interpreter: a module-level
function of a module that the child can import.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from typing import Any, Callable, List

__all__ = ["RankFailure", "run_ranks", "rank_device"]

# the process group's own timeout for one collective, seconds: a rank
# whose peer died raises after it, inside the launcher's deadline
PG_TIMEOUT = 300.0


class RankFailure(RuntimeError):
    """A rank raised, exited non-zero, or was still running at the
    deadline."""


def rank_device(backend: str, rank: int):
    """The device rank `rank` runs on under `backend`."""
    import torch

    return torch.device("cuda", rank) if backend == "nccl" \
        else torch.device("cpu")


def _entry(fn: Callable, rank: int, world: int, tmp: str, store: str,
           backend: str, pg_timeout: float, args: tuple) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)  # before anything touches CUDA
            kw = {"device_id": rank_device(backend, rank)}
        else:
            torch.set_num_threads(1)
            kw = {}
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=pg_timeout), **kw)
        out = fn(rank, world, tmp, *args)
        if out is not None:
            with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
                json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world: int, tmp, *args, backend: str = "nccl",
              timeout: float = 600.0) -> List[Any]:
    """``fn(rank, world, tmp, *args)`` on `world` ranks of `backend`
    (module docstring); each rank's result, in rank order.  Raises
    `RankFailure` when a rank fails or the deadline of `timeout` seconds
    passes."""
    import torch.multiprocessing as mp

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        import torch

        have = torch.cuda.device_count()
        if world > have:
            raise ValueError(f"a world of {world} NCCL ranks needs {world} "
                             f"cards, {have} visible")
    tmp = os.fspath(tmp)
    for r in range(world):  # a rank's files from an earlier world
        for ext in ("err", "json"):
            path = os.path.join(tmp, f"rank{r}.{ext}")
            if os.path.exists(path):
                os.remove(path)
    # a fresh store file each call: a used one holds the last world's keys
    store = os.path.join(tmp, f"store_{time.time_ns()}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(fn, r, world, tmp, store, backend,
                               min(PG_TIMEOUT, timeout), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    failed = False
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            failed = True  # the others would wait for it in a collective
            break
        time.sleep(0.1)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    errs = {}
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errs[r] = f.read()
    codes = [p.exitcode for p in procs]
    if errs or failed or hung or any(c != 0 for c in codes):
        why = f"ranks {hung} still running after {timeout} s, killed" \
            if hung and not failed else f"ranks failed, {hung} killed"
        what = "".join(f"\nrank {r}:\n{e}" for r, e in errs.items())
        raise RankFailure(f"{why} (exit codes {codes}){what}")
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                out.append(json.load(f))
        else:
            out.append(None)
    return out

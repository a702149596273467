"""Fixture: clock uses the naked-clock rule must NOT flag (torch)."""
import time

import torch


def timed(fn):
    # the blessed harness function itself must be allowed to read the clock
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()  # the card's work is done before the read
    return out, time.perf_counter() - t0


def wall(fn):  # reprolint-torch: allow[naked-clock] -- fixture: module-level wall time, not a device benchmark
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0

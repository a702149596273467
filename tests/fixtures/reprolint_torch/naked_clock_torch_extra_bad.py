"""Fixture: torch-only naked-clock forms the rule must flag; each line
marked `# form: <name>` is one case."""
import time
from time import perf_counter

import torch


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0  # form: timed_without_sync


def sync_after(fn):
    def timed():
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0  # form: sync_after_closing_read
        torch.cuda.synchronize()
        return dt
    return timed


def sync_before_start(fn):
    def timed():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        return time.monotonic() - t0  # form: sync_before_opening_read
    return timed


def aliased():
    return perf_counter()  # form: aliased_clock


def wall_time():
    return time.time()  # form: time_time

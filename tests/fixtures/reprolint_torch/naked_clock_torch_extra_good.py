"""Fixture: the quiet counterparts of naked_clock_torch_extra_bad.py."""
import time
from time import perf_counter

import torch


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0  # form: timed_without_sync


def event_sync(fn, end):
    def timed():
        t0 = time.perf_counter()
        fn()
        end.record()
        end.synchronize()
        return time.perf_counter() - t0  # form: sync_after_closing_read
    return timed


def stream_sync(fn):
    def timed():
        t0 = time.monotonic()
        fn()
        torch.cuda.current_stream().synchronize()
        return time.monotonic() - t0  # form: sync_before_opening_read
    return timed


def timed_alias(fn):
    def timed():
        t0 = perf_counter()
        fn()
        torch.cuda.synchronize()
        return perf_counter() - t0  # form: aliased_clock
    return timed


def wall_time():
    return time.time()  # reprolint-torch: allow[naked-clock] -- fixture: a host wall time # form: time_time

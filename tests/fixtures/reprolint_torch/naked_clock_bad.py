"""Fixture: the torch translation of reprolint's naked_clock_bad.py."""
import time


def bench(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def bench_ns(fn):
    t0 = time.perf_counter_ns()
    fn()
    return time.perf_counter_ns() - t0

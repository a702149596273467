"""Fixture: the torch translation of reprolint's host_sync_bad.py."""
import functools

import numpy as np
import torch


@torch.no_grad()
def decode_step(x):
    return x.item()


@torch.no_grad()
def train_step(x):
    return float(x) * 2.0


@functools.lru_cache(maxsize=None)
def cycle(x, k: int):
    return np.asarray(x)[:k]


def each(xs):
    return [float(x) + 1.0 for x in xs]


each_no_grad = torch.no_grad()(each)


def chunk(idx):
    return int(idx)


mapped = [chunk for _ in range(0)]

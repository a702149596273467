"""Fixture: the torch translation of reprolint's dense_square_bad.py."""
import torch
from torch import Tensor


def build(n, a: Tensor, b: Tensor):
    d = torch.zeros((n, n))                    # alloc, repeated symbolic dim
    e = torch.full((n, n), 0, dtype=torch.int16)  # full with square shape
    f = torch.empty((n, n))                    # empty with square shape
    g = torch.eye(n)                           # symbolic-order identity
    mask = a[:, None] == b[None, :]            # outer-broadcast [n, n]
    return d, e, f, g, mask

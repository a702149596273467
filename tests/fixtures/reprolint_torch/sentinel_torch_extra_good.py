"""Fixture: the quiet counterparts of sentinel_torch_extra_bad.py."""
import numpy as np
import torch

from repro_torch.core.graph import UNREACHABLE


def tables(x, n, dist):
    a = torch.full_like(x, int(UNREACHABLE))  # form: full_like
    b = x.new_full((n,), int(UNREACHABLE))  # form: new_full
    c = torch.full((n,), fill_value=int(UNREACHABLE))  # form: fill_value_kw
    d = np.full((n,), fill_value=UNREACHABLE)  # form: numpy_fill_value_kw
    e = dist != UNREACHABLE  # form: not_equal
    return a, b, c, d, e

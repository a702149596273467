"""Fixture: torch-only sentinel forms the rule must flag; each line marked
`# form: <name>` is one case."""
import numpy as np
import torch


def tables(x, n, dist):
    a = torch.full_like(x, -1)  # form: full_like
    b = x.new_full((n,), -1)  # form: new_full
    c = torch.full((n,), fill_value=-1)  # form: fill_value_kw
    d = np.full((n,), fill_value=-1)  # form: numpy_fill_value_kw
    e = dist != -1  # form: not_equal
    return a, b, c, d, e

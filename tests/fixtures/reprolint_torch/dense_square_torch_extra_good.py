"""Fixture: the quiet counterparts of dense_square_torch_extra_bad.py."""
import numpy as np
import torch


def build(g, x, n, m, b):
    z = torch.zeros(n, m)  # form: varargs
    e = torch.empty(g.n, 3)  # form: varargs_attr
    o = torch.ones((b, n, m))  # form: batched
    nz = x.new_zeros((n, 3))  # form: new_zeros
    no = x.new_ones(n, 4)  # form: new_ones_varargs
    nf = x.new_full((n,), n)  # form: new_full
    ne = x.new_empty((n, m))  # form: new_empty
    nn = np.zeros((n, 3))  # form: numpy_zeros
    i = torch.eye(8, dtype=torch.bool)  # form: eye_attr
    return z, e, o, nz, no, nf, ne, nn, i

"""Fixture: torch-only dense-square forms the rule must flag; each line
marked `# form: <name>` is one case."""
import numpy as np
import torch


def build(g, x, n, b):
    z = torch.zeros(n, n)  # form: varargs
    e = torch.empty(g.n, g.n)  # form: varargs_attr
    o = torch.ones((b, n, n))  # form: batched
    nz = x.new_zeros((n, n))  # form: new_zeros
    no = x.new_ones(n, n)  # form: new_ones_varargs
    nf = x.new_full((n, n), 0)  # form: new_full
    ne = x.new_empty((n, n))  # form: new_empty
    nn = np.zeros((n, n))  # form: numpy_zeros
    i = torch.eye(g.n, dtype=torch.bool)  # form: eye_attr
    return z, e, o, nz, no, nf, ne, nn, i

"""Fixture: shapes the dense-square rule must NOT flag (torch)."""
import torch


def build(n, m, a):
    r = torch.zeros((n, 3))     # constant second dim
    s = torch.zeros((n, m))     # two different symbolic dims
    t = torch.eye(4)            # constant-order identity
    u = a[:, None] * 2          # one-sided broadcast, no [None, :] partner
    return r, s, t, u


def dense_reference(n):
    # function name matches the _reference|dense exemption
    return torch.zeros((n, n))


def suppressed(n):
    return torch.ones((n, n))  # reprolint-torch: allow[dense-square] -- fixture: pragma suppression must work

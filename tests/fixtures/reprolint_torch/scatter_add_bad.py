"""Fixture: the torch translation of reprolint's scatter_add_bad.py."""
import torch


def loads(idx, w, e):
    return torch.zeros(e).index_add_(0, idx, w)

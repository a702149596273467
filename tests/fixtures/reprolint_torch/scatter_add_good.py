"""Fixture: index writes the scatter-add rule must NOT flag (torch)."""
import torch


def setter(idx, w, e):
    return torch.zeros(e).index_copy_(0, idx, w)  # a copy is not an add


def gathered(tbl, idx):
    return tbl[idx].sum(dim=1)  # padded gather, the blessed pattern


def suppressed(idx, w, e):
    return torch.zeros(e).index_add_(0, idx, w)  # reprolint-torch: allow[scatter-add] -- fixture: deliberate fallback

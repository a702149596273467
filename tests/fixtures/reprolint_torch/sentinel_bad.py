"""Fixture: the torch translation of reprolint's sentinel_bad.py."""
import torch

BIG = 32000


def unreachable_pairs(dist):
    return dist == -1


def miss_table(n):
    return torch.full((n,), -1, dtype=torch.int32)

"""Fixture: sentinel uses the rule must NOT flag (torch)."""
import torch

from repro_torch.core.graph import UNREACHABLE


def unreachable_pairs(dist):
    return dist == UNREACHABLE


def dist_table(n):
    return torch.full((n,), int(UNREACHABLE), dtype=torch.int16)


def pad_table(n):
    return torch.full((n,), -1, dtype=torch.int32)  # reprolint-torch: allow[sentinel] -- fixture: -1 is an edge-id pad here


def negative_math(x):
    return x - 1, x * -1  # arithmetic -1, not a comparison or fill

"""Fixture: shim-routed imports the compat-shim rule must NOT flag."""
from repro_torch.parallel.compat import local_map  # the shim, not torch


def sharded(f, placements):
    return local_map(f, out_placements=placements)

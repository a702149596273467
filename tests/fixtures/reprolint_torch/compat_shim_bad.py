"""Fixture: the torch translation of reprolint's compat_shim_bad.py."""
import torch
from torch.distributed.tensor.experimental import local_map
from torch.utils._python_dispatch import TorchDispatchMode


def fake_key():
    return torch._C._TorchDispatchModeKey.FAKE


def new_style(f, placements):
    return torch.distributed.tensor.experimental.local_map(f, out_placements=placements)

"""Plain PyTorch version of the per-candidate path-cost reduction.

The CPU path of `ops.path_costs`, and the oracle the CUDA kernel
(`csrc/path_costs.cu`) is held against on the card.
"""

from __future__ import annotations

import torch


def path_costs_ref(delay: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """Per-candidate path costs from a padded per-link delay table.

    ``delay`` is ``[E + 1]`` (the last slot is the zero pad that -1-padded
    edge ids were remapped to); ``eidx`` is ``[F, K, L]`` int32.  Returns
    ``cost[f, k] = sum_l delay[eidx[f, k, l]]`` in ``delay.dtype``.

    The sum runs in an explicit loop ``l = 0 .. L-1`` starting from 0, so
    its order is defined: the kernel adds in the same order and matches
    this bit for bit, and so does the JAX package's ``path_costs_ref`` on
    the CPU (XLA reduces the short L axis in order).
    """
    acc = torch.zeros(eidx.shape[:-1], dtype=delay.dtype, device=delay.device)
    for l in range(eidx.shape[-1]):
        acc = acc + delay[eidx[..., l]]
    return acc

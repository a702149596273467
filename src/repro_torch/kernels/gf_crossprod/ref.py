"""Plain PyTorch version of the all-pairs GF(q) cross product with
left-normalisation (paper §IV-D).

The CPU path of `ops.crossprod_normalized`, and the oracle the CUDA kernel
(`csrc/crossprod.cu`) is held against on the card.  Prime q only, as in
the JAX package (prime-power fields go through the table-based host path
in `repro_torch.core.gf`).
"""

from __future__ import annotations

import torch


def _mod(x: torch.Tensor, q: int) -> torch.Tensor:
    return torch.remainder(x, q)


def _pow_mod(a: torch.Tensor, e: int, q: int) -> torch.Tensor:
    """a**e mod q by binary exponentiation."""
    result = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            result = _mod(result * base, q)
        base = _mod(base * base, q)
        e >>= 1
    return result


def crossprod_normalized_ref(s: torch.Tensor, d: torch.Tensor,
                             q: int) -> torch.Tensor:
    """[n, 3] x [m, 3] int32 -> [n, m, 3] left-normalised cross products
    mod q.

    Parallel rows (s == d up to scale) give the zero vector; callers read
    it as "no 2-hop intermediate".  The leading nonzero component is
    inverted by Fermat (``lead ** (q - 2)``; the inverse of 0 is 0)."""
    s = s.to(torch.int32)[:, None, :]  # [n, 1, 3]
    d = d.to(torch.int32)[None, :, :]  # [1, m, 3]
    c0 = _mod(s[..., 1] * d[..., 2] - s[..., 2] * d[..., 1], q)
    c1 = _mod(s[..., 2] * d[..., 0] - s[..., 0] * d[..., 2], q)
    c2 = _mod(s[..., 0] * d[..., 1] - s[..., 1] * d[..., 0], q)
    lead = torch.where(c0 != 0, c0, torch.where(c1 != 0, c1, c2))
    inv = _pow_mod(lead, q - 2, q)
    return torch.stack([_mod(c0 * inv, q), _mod(c1 * inv, q),
                        _mod(c2 * inv, q)], dim=-1)

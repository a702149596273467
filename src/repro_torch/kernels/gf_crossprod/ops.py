"""Dispatching wrapper of the GF(q) cross-product kernel, and the §IV-D
routing table built on it.

`crossprod_normalized` sends CPU tensors to the plain PyTorch version
(`ref.crossprod_normalized_ref`) and launches the hand-written CUDA kernel
(`csrc/crossprod.cu`) for CUDA tensors.  A CUDA tensor never falls back:
if the kernel cannot be built or launched, the call raises.  `LAUNCHES`
counts kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import numpy as np
import torch

from .. import _build
from ...device import resolve_device
from ...obs.profiler import named_scope
from .ref import crossprod_normalized_ref

__all__ = ["crossprod_normalized", "intermediate_table", "LAUNCHES"]

LAUNCHES = 0

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("gf_crossprod").crossprod_normalized_i32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def crossprod_normalized(s: torch.Tensor, d: torch.Tensor,
                         q: int) -> torch.Tensor:
    """All-pairs left-normalised GF(q) cross products, prime q only.

    ``s`` is ``[n, 3]`` and ``d`` ``[m, 3]``, int32, contiguous, entries in
    ``[0, q)``; returns ``[n, m, 3]`` int32 on their device.  The device
    chooses the version (the JAX package's ``use_pallas`` does not carry
    over).
    """
    global LAUNCHES
    if s.dtype != torch.int32 or d.dtype != torch.int32:
        raise TypeError(f"s and d must be int32, got {s.dtype} and {d.dtype}")
    if s.dim() != 2 or d.dim() != 2 or s.shape[1] != 3 or d.shape[1] != 3:
        raise ValueError(f"s and d must be [n, 3] and [m, 3]; got "
                         f"{tuple(s.shape)} and {tuple(d.shape)}")
    if not (s.is_contiguous() and d.is_contiguous()):
        raise ValueError("s and d must be contiguous")
    if s.device != d.device:
        raise ValueError(f"s on {s.device} but d on {d.device}")
    if not 2 <= q < 46341:  # products of two residues stay below 2**31
        raise ValueError(f"q={q} out of range")
    if s.device.type == "cpu":
        return crossprod_normalized_ref(s, d, q)
    if s.device.type != "cuda":
        raise ValueError(f"unsupported device {s.device}")
    n, m = s.shape[0], d.shape[0]
    out = torch.empty((n, m, 3), dtype=torch.int32, device=s.device)
    if out.numel() == 0:
        return out
    with named_scope("gf_crossprod.crossprod_normalized"), \
            torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = _launcher()(s.data_ptr(), d.data_ptr(), out.data_ptr(), n, m, q,
                          stream)
    if err != 0:
        raise RuntimeError(f"crossprod kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def intermediate_table(vertices: np.ndarray, q: int,
                       device: Optional[Union[str, torch.device]] = "cuda"
                       ) -> np.ndarray:
    """[N, N] int32 table of 2-hop intermediate vertex ids for ER_q (prime
    q), computed on `device`.

    Parallel (s == d) pairs come back as -1.  Device-computed counterpart
    of `PolarFly.intermediates_all_pairs()`."""
    dev = resolve_device(device)
    vt = torch.as_tensor(np.asarray(vertices, dtype=np.int32), device=dev)
    w = crossprod_normalized(vt.contiguous(), vt.contiguous(), q).long()
    code = (w[..., 0] * q + w[..., 1]) * q + w[..., 2]
    del w
    lut = torch.full((q ** 3,), -1, dtype=torch.int32, device=dev)
    v = vt.long()
    lut[(v[:, 0] * q + v[:, 1]) * q + v[:, 2]] = torch.arange(
        len(vt), dtype=torch.int32, device=dev)
    return lut[code].cpu().numpy()

"""Dispatching wrappers of the path-cost and tropical-product kernels.

`path_costs` and `minplus` send a CPU tensor to the plain PyTorch version
(`ref.path_costs_ref`, `ref.minplus_ref`) and launch the hand-written CUDA
kernel (`csrc/path_costs.cu`, `csrc/minplus.cu`) for a CUDA tensor.  A
CUDA tensor never falls back: if the kernel cannot be built or launched,
the call raises.  `apsp` and `diameter_from_adj` are the §IX entry points
built on `minplus`.

`LAUNCHES` counts path-cost kernel launches and `MINPLUS_LAUNCHES`
tropical-product launches (and nothing else), so a run can show that its
path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import numpy as np
import torch

from .. import _build
from ...device import resolve_device
from ...obs.profiler import named_scope
from .ref import (INF, adjacency_to_dist0, apsp_steps, minplus_ref,
                  path_costs_ref)

__all__ = ["path_costs", "minplus", "apsp", "diameter_from_adj", "LAUNCHES",
           "MINPLUS_LAUNCHES"]

LAUNCHES = 0
MINPLUS_LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_SYMBOLS = {torch.float32: "path_costs_f32", torch.float64: "path_costs_f64"}
_launchers = {}


def _launcher(dtype: torch.dtype):
    fn = _launchers.get(dtype)
    if fn is None:
        fn = getattr(_build.load("minplus"), _SYMBOLS[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _launchers[dtype] = fn
    return fn


def _check(delay: torch.Tensor, eidx: torch.Tensor) -> None:
    if delay.dtype not in _SYMBOLS:
        raise TypeError(f"delay must be float32 or float64, got {delay.dtype}")
    if eidx.dtype != torch.int32:
        raise TypeError(f"eidx must be int32, got {eidx.dtype}")
    if delay.dim() != 1 or eidx.dim() < 1:
        raise ValueError(f"delay must be [E+1] and eidx [..., L]; got "
                         f"{tuple(delay.shape)} and {tuple(eidx.shape)}")
    if not (delay.is_contiguous() and eidx.is_contiguous()):
        raise ValueError("delay and eidx must be contiguous")
    if delay.device != eidx.device:
        raise ValueError(f"delay on {delay.device} but eidx on {eidx.device}")


def path_costs(delay: torch.Tensor, eidx: torch.Tensor) -> torch.Tensor:
    """``[F, K]`` per-candidate path costs ``sum_l delay[eidx[f, k, l]]``.

    ``delay`` is ``[E + 1]`` float32 or float64 with a zero pad slot at E;
    ``eidx`` is ``[F, K, L]`` int32 with every entry in ``[0, E]`` (pads
    remapped to E).  The kernel does not range-check the indices, since
    that would sync the host once per call: `FlowPaths.device_arrays`
    checks them once on the host.  Returns ``delay.dtype``.
    """
    global LAUNCHES
    _check(delay, eidx)
    if delay.device.type == "cpu":
        return path_costs_ref(delay, eidx)
    if delay.device.type != "cuda":
        raise ValueError(f"unsupported device {delay.device}")
    out = torch.empty(eidx.shape[:-1], dtype=delay.dtype, device=delay.device)
    if out.numel() == 0:
        return out
    with named_scope("minplus.path_costs"), torch.cuda.device(delay.device):
        stream = torch.cuda.current_stream(delay.device).cuda_stream
        err = _launcher(delay.dtype)(delay.data_ptr(), eidx.data_ptr(),
                                     out.data_ptr(), out.numel(),
                                     eidx.shape[-1], stream)
    if err != 0:
        raise RuntimeError(f"path_costs kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


_minplus_fn = None


def _minplus_launcher():
    global _minplus_fn
    if _minplus_fn is None:
        fn = _build.load("minplus").minplus_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _minplus_fn = fn
    return _minplus_fn


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tropical product ``C[i, j] = min_k A[i, k] + B[k, j]``.

    ``a`` is ``[m, k]`` and ``b`` ``[k, n]``, float32, contiguous, on one
    device, k >= 1.  The device chooses the version: the plain PyTorch one
    on the CPU, the CUDA kernel on the card (the JAX package's
    ``use_pallas``/``block`` knobs do not carry over).
    """
    global MINPLUS_LAUNCHES
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"minplus takes float32, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] \
            or a.shape[1] == 0:
        raise ValueError(f"minplus needs [m, k] and [k, n] with k >= 1; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if a.device != b.device:
        raise ValueError(f"a on {a.device} but b on {b.device}")
    if a.device.type == "cpu":
        return minplus_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    with named_scope("minplus.minplus"), torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _minplus_launcher()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: CUDA error {err}")
    MINPLUS_LAUNCHES += 1
    return out


def apsp(adj, device: Optional[Union[str, torch.device]] = "cuda"
         ) -> np.ndarray:
    """All-pairs shortest-path distances from a boolean adjacency matrix.

    Repeated tropical squaring, ``ceil(log2(max(n - 1, 2)))`` products of
    `minplus` on `device`.  Returns a float32 numpy ``[n, n]`` array;
    unreachable pairs come back as ``inf`` (the JAX package's contract).
    """
    dev = resolve_device(device)
    adj = torch.as_tensor(np.asarray(adj, dtype=bool), device=dev)
    d = adjacency_to_dist0(adj)
    for _ in range(apsp_steps(adj.shape[0])):
        d = minplus(d, d)
    d = d.cpu().numpy()
    d[d >= INF / 2] = np.inf
    return d


def diameter_from_adj(adj, device: Optional[Union[str, torch.device]] = "cuda"
                      ) -> float:
    """Graph diameter (``inf`` if disconnected) -- drop-in for the §IX
    sweeps.  (`core.metrics.diameter_and_aspl` says -1 for the same
    graph; both keep the JAX package's conventions.)"""
    return float(apsp(adj, device=device).max())

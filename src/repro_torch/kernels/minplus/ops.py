"""Dispatching wrapper of the path-cost kernel.

`path_costs` sends a CPU tensor to the plain PyTorch version
(`ref.path_costs_ref`) and launches the hand-written CUDA kernel
(`csrc/path_costs.cu`) for a CUDA tensor.  A CUDA tensor never falls back:
if the kernel cannot be built or launched, the call raises.

`LAUNCHES` counts kernel launches (and nothing else), so a run can show
that the main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...obs.profiler import named_scope
from .ref import path_costs_ref

__all__ = ["path_costs", "LAUNCHES"]

LAUNCHES = 0

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

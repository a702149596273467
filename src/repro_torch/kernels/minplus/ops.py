"""Dispatching wrappers of the path-cost and tropical-product kernels.

`path_costs`, `minplus` and `minplus_hops` send a CPU tensor to the plain
PyTorch version (`ref.path_costs_ref`, `ref.minplus_ref`,
`ref.minplus_hops_ref`) and launch the hand-written CUDA kernel
(`csrc/path_costs.cu`, `csrc/minplus.cu`, `csrc/minplus_dpx.cu`) for a
CUDA tensor.  A CUDA tensor never falls back: if the kernel cannot be
built or launched, the call raises.  `apsp` and `diameter_from_adj` are
the §IX entry points: a symmetric hop-count matrix (an undirected graph)
of at most `HOPS_UNREACHABLE` vertices is squared as int16 by
`minplus_hops` (Hopper's DPX add-then-min, two candidates an
instruction), anything else in float32 by `minplus`; both give the JAX
package's distances bit for bit.

`LAUNCHES` counts path-cost kernel launches (`LAUNCHES_BY_DTYPE` splits
them by the delay table's dtype, "float32" for `path_costs_f32` and
"float64" for `path_costs_f64`), `MINPLUS_LAUNCHES` float and
`MINPLUS_HOPS_LAUNCHES` int16 tropical-product launches (and nothing
else), so a run can show that its path went through the kernels.

Each kernel's launch geometry is a pure function of the shapes
(`_path_costs_plan`, `_minplus_plan`, `_hops_plan`), so the CPU tests
hold it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Union

import numpy as np
import torch

from .. import _build
from ...device import resolve_device
from ...obs.profiler import named_scope
from .ref import (HOPS_UNREACHABLE, INF, adjacency_to_dist0, apsp_steps,
                  minplus_hops_ref, minplus_ref, path_costs_ref)

__all__ = ["path_costs", "minplus", "minplus_hops", "apsp", "apsp_dist0",
           "apsp_hops0", "diameter_from_adj", "LAUNCHES", "LAUNCHES_BY_DTYPE",
           "MINPLUS_LAUNCHES", "MINPLUS_HOPS_LAUNCHES"]

LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"float32": 0, "float64": 0}
MINPLUS_LAUNCHES = 0
MINPLUS_HOPS_LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

SMS = 132  # the H100's SMs
# csrc/path_costs.cu: threads a block, and rows a thread of its L <= 4
# kernel (kRows there)
PATH_COSTS_THREADS = 256
PATH_COSTS_ROWS = 8
# bytes a row's vector load takes, by L; L = 1 and 3 load 4 bytes at a time
_ROW_ALIGN = {1: 4, 2: 8, 3: 4, 4: 16}
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


def _path_costs_plan(n_out: int, L: int, eidx_ptr: int) -> Dict[str, int]:
    """Launch geometry of csrc/path_costs.cu for ``n_out`` rows of ``L``
    indices at address ``eidx_ptr``: ``rows`` a thread of the L <= 4
    kernel, whose rows are one aligned vector load each, or ``rows = 0``
    for the generic kernel (L > 4, or a base not aligned for the vector
    load); and the ``blocks`` of 256 threads."""
    if L in _ROW_ALIGN and eidx_ptr % _ROW_ALIGN[L] == 0:
        rows = PATH_COSTS_ROWS
        return {"rows": rows,
                "blocks": -(-n_out // (PATH_COSTS_THREADS * rows))}
    return {"rows": 0, "blocks": min(-(-n_out // PATH_COSTS_THREADS),
                                     SMS * 8)}


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
    L = eidx.shape[-1]
    plan = _path_costs_plan(out.numel(), L, eidx.data_ptr())
    with named_scope("minplus.path_costs"), torch.cuda.device(delay.device):
        stream = torch.cuda.current_stream(delay.device).cuda_stream
        err = _launcher(delay.dtype)(delay.data_ptr(), eidx.data_ptr(),
                                     out.data_ptr(), out.numel(), L,
                                     plan["rows"], stream)
    if err != 0:
        raise RuntimeError(f"path_costs kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[str(delay.dtype).split(".")[-1]] += 1
    return out


_minplus_fn = None
# csrc/minplus.cu and csrc/minplus_dpx.cu: C tile edge, k slice, and
# blocks an SM holds (ptxas keeps the 256-thread blocks within 128
# registers; 36 and 40 KB of shared memory)
MINPLUS_TILE = 128
MINPLUS_K = 16
HOPS_K = 32
MINPLUS_BLOCKS_PER_SM = 2


def _minplus_launcher():
    global _minplus_fn
    if _minplus_fn is None:
        fn = _build.load("minplus").minplus_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _minplus_fn = fn
    return _minplus_fn


def _minplus_plan(m: int, n: int, k: int,
                  k_slice: int = MINPLUS_K) -> Dict[str, int]:
    """Launch geometry of csrc/minplus.cu (and, with ``k_slice =
    HOPS_K``, csrc/minplus_dpx.cu) for ``[m, k] x [k, n]``.

    128x128 C tiles; where they are fewer than the card's block slots (132
    SMs x 2), k is split so the grid fills them: ``splits`` ranges of
    ``kper`` (a multiple of the k slice), range z covering ``[z kper,
    min(k, (z + 1) kper))``, each a block per tile, their partial minima
    combined by a second pass.  Returns tile, splits, kper and the grid's
    blocks."""
    tiles = math.ceil(m / MINPLUS_TILE) * math.ceil(n / MINPLUS_TILE)
    slots = SMS * MINPLUS_BLOCKS_PER_SM
    splits = max(1, min(slots // tiles, math.ceil(k / k_slice)))
    kper = math.ceil(math.ceil(k / splits) / k_slice) * k_slice
    splits = math.ceil(k / kper)  # no empty range
    return {"tile": MINPLUS_TILE, "splits": splits, "kper": kper,
            "blocks": tiles * splits}


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` ([r, c], contiguous) if its rows are 16-byte aligned, else a
    copy with its columns padded to a multiple of 4 with +inf: the kernel
    copies rows in 16-byte pieces, and +inf never wins a min."""
    r, c = x.shape
    if c % 4 == 0 and x.data_ptr() % 16 == 0:
        return x
    out = torch.full((r, -(-c // 4) * 4), float("inf"), dtype=x.dtype,
                     device=x.device)
    out[:, :c] = x
    return out


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tropical product ``C[i, j] = min_k A[i, k] + B[k, j]``.

    ``a`` is ``[m, k]`` and ``b`` ``[k, n]``, float32, contiguous, on one
    device, k >= 1.  The device chooses the version: the plain PyTorch one
    on the CPU, the CUDA kernel on the card (the JAX package's
    ``use_pallas``/``block`` knobs do not carry over).  On the card a
    ragged ``k`` or ``n`` costs a padded copy of ``a`` or ``b`` (`apsp`
    keeps its matrices padded instead).
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
    plan = _minplus_plan(m, n, k)
    a_ = _aligned(a)
    b_ = a_ if b is a else _aligned(b)
    part = torch.empty((plan["splits"], m, n), dtype=torch.float32,
                       device=a.device) if plan["splits"] > 1 else None
    with named_scope("minplus.minplus"), torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _minplus_launcher()(
            a_.data_ptr(), b_.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), m, n, k,
            a_.stride(0), b_.stride(0), plan["splits"], plan["kper"], stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: CUDA error {err}")
    MINPLUS_LAUNCHES += 1
    return out


def apsp_dist0(adj: torch.Tensor) -> torch.Tensor:
    """The 1-step distance matrix `apsp` squares: `adjacency_to_dist0`
    padded to a multiple of 4 vertices with isolated ones (+inf rows and
    columns), which keeps every product's rows 16-byte aligned and never
    changes a distance between real vertices."""
    n = adj.shape[0]
    size = -(-n // 4) * 4
    d = adjacency_to_dist0(adj)
    if size == n:
        return d
    out = torch.full((size, size), float("inf"), dtype=torch.float32,
                     device=adj.device)
    out[:n, :n] = d
    return out


_hops_fn = None


def _hops_launcher():
    global _hops_fn
    if _hops_fn is None:
        fn = _build.load("minplus").minplus_sym_s16
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _hops_fn = fn
    return _hops_fn


def _hops_plan(n: int) -> Dict[str, int]:
    """Launch geometry of csrc/minplus_dpx.cu for an ``[n, n]`` squaring."""
    return _minplus_plan(n, n, n, HOPS_K)


def minplus_hops(d: torch.Tensor) -> torch.Tensor:
    """``d`` min-plus ``d`` for `apsp`'s integer route: ``d`` is a
    symmetric ``[n, n]`` int16 hop-count matrix, ``n % 8 == 0``, entries in
    ``[0, HOPS_UNREACHABLE]`` (not checked on the card: that would sync).
    The plain version on the CPU, csrc/minplus_dpx.cu on the card."""
    global MINPLUS_HOPS_LAUNCHES
    if d.dtype != torch.int16 or d.dim() != 2 or d.shape[0] != d.shape[1] \
            or d.shape[0] % 8 or d.shape[0] > HOPS_UNREACHABLE:
        raise ValueError(f"minplus_hops takes a square int16 matrix of a "
                         f"multiple of 8 rows up to {HOPS_UNREACHABLE}; got "
                         f"{d.dtype} {tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError("d must be contiguous")
    if d.device.type == "cpu":
        return minplus_hops_ref(d)
    if d.device.type != "cuda":
        raise ValueError(f"unsupported device {d.device}")
    n = d.shape[0]
    out = torch.empty_like(d)
    if n == 0:
        return out
    plan = _hops_plan(n)
    part = torch.empty((plan["splits"], n, n), dtype=torch.int16,
                       device=d.device) if plan["splits"] > 1 else None
    with named_scope("minplus.minplus_hops"), torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = _hops_launcher()(d.data_ptr(), out.data_ptr(),
                               None if part is None else part.data_ptr(), n,
                               plan["splits"], plan["kper"], stream)
    if err != 0:
        raise RuntimeError(f"minplus_hops kernel launch failed: CUDA error "
                           f"{err}")
    MINPLUS_HOPS_LAUNCHES += 1
    return out


def apsp_hops0(adj: torch.Tensor) -> torch.Tensor:
    """The 1-step hop matrix of the integer route: int16, 0 on the
    diagonal, 1 on an edge, `HOPS_UNREACHABLE` else, padded to a multiple
    of 8 vertices with isolated ones (their diagonal 0, so no sum ever
    exceeds twice the sentinel)."""
    n = adj.shape[0]
    size = -(-n // 8) * 8
    d = torch.full((size, size), HOPS_UNREACHABLE, dtype=torch.int16,
                   device=adj.device)
    d[:n, :n] = torch.where(adj, 1, HOPS_UNREACHABLE).to(torch.int16)
    d.fill_diagonal_(0)
    return d


def _apsp_route(n: int, symmetric: bool) -> str:
    """``"hops"`` (int16 on DPX) where every distance is a hop count below
    the sentinel and the matrix is symmetric, else ``"float"``."""
    return "hops" if symmetric and n <= HOPS_UNREACHABLE else "float"


def _apsp_device(adj, device) -> torch.Tensor:
    """``[n, n]`` float32 APSP distances on `device`, INF where
    unreachable."""
    dev = resolve_device(device)
    adj = torch.as_tensor(np.asarray(adj, dtype=bool), device=dev)
    n = adj.shape[0]
    steps = apsp_steps(n)
    if _apsp_route(n, bool(torch.equal(adj, adj.T))) == "hops":
        d = apsp_hops0(adj)
        for _ in range(steps):
            d = minplus_hops(d)
        d = d[:n, :n]
        return torch.where(d == HOPS_UNREACHABLE, INF, d.to(torch.float32))
    d = apsp_dist0(adj)
    for _ in range(steps):
        d = minplus(d, d)
    return d[:n, :n]


def apsp(adj, device: Optional[Union[str, torch.device]] = "cuda"
         ) -> np.ndarray:
    """All-pairs shortest-path distances from a boolean adjacency matrix.

    Repeated tropical squaring, ``ceil(log2(max(n - 1, 2)))`` products of
    `minplus` on `device`.  Returns a float32 numpy ``[n, n]`` array;
    unreachable pairs come back as ``inf`` (the JAX package's contract).
    """
    d = _apsp_device(adj, device).cpu().numpy()
    d[d >= INF / 2] = np.inf
    return d


def diameter_from_adj(adj, device: Optional[Union[str, torch.device]] = "cuda"
                      ) -> float:
    """Graph diameter (``inf`` if disconnected) -- drop-in for the §IX
    sweeps.  (`core.metrics.diameter_and_aspl` says -1 for the same
    graph; both keep the JAX package's conventions.)  The max is taken on
    the device: one number comes back, not the ``n x n`` matrix."""
    diam = float(_apsp_device(adj, device).max())
    return float("inf") if diam >= INF / 2 else diam

"""Dispatching wrapper of the flash-attention kernels.

`attention` sends CPU tensors to the plain PyTorch version (`ref.py`:
`attention_ref`, or `attention_chunked` from S = 4096 on, as the JAX
package's ``ops.attention`` does) and CUDA tensors to one of two
hand-written CUDA kernels, both replacing the JAX package's
``kernels/flash_attention/kernel.py::flash_attention_pallas``:

- ``"sm90"`` (`csrc/flash_attention_sm90.cu`): bf16 on the tensor cores
  (wgmma fed by TMA, warp-specialised), head dims 64, 128, 192 and 256;
- ``"simt"`` (`csrc/flash_attention.cu`): float32 FMAs on the CUDA cores,
  float32 or bf16, head dims a multiple of 4 up to 256.

`_route` chooses by dtype and head dim alone, never on failure: a CUDA
tensor whose kernel cannot be built or launched raises.  The JAX package's
``use_pallas``/``bq``/``bk`` knobs do not carry over.

On the card the least time is the operations (4 D flops per unmasked
(query, key) pair and head) at the tensor cores' dense bf16 rate: 0.56 ms
for one Gemma2-9B global layer at S = 8192, 0.42 ms for a local one (the
kernels' times are in PERF.md).

`LAUNCHES` counts kernel launches (and nothing else), so a run can show
that its path went through a kernel; `LAUNCHES_BY_KERNEL` splits the count
by route.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .. import _build
from ...obs.profiler import named_scope
from .ref import attention_chunked, attention_ref

__all__ = ["attention", "smem_bytes", "LAUNCHES", "LAUNCHES_BY_KERNEL"]

LAUNCHES = 0
LAUNCHES_BY_KERNEL: Dict[str, int] = {"sm90": 0, "simt": 0}

_CHUNK_THRESHOLD = 4096  # the plain version goes q-block by q-block from here
_MAX_HEAD_DIM = 256
_SM90_HEAD_DIMS = (64, 128, 192, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_SYMBOLS = {("simt", torch.float32): "flash_attention_f32",
            ("simt", torch.bfloat16): "flash_attention_bf16",
            ("sm90", torch.bfloat16): "flash_attention_bf16_sm90"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_launchers = {}


def _route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel takes a CUDA call: "sm90" for bf16 at the head dims the
    tensor-core kernel is built for, "simt" for everything else."""
    return "sm90" if dtype == torch.bfloat16 \
        and head_dim in _SM90_HEAD_DIMS else "simt"


def _launcher(route: str, dtype: torch.dtype):
    fn = _launchers.get((route, dtype))
    if fn is None:
        fn = getattr(_build.load("flash_attention"), _SYMBOLS[route, dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _launchers[route, dtype] = fn
    return fn


def smem_bytes(head_dim: int, route: str = "simt") -> int:
    """Dynamic shared memory of one block of the `route` kernel at
    `head_dim`, in bytes (builds the kernel library if needed)."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_sm90_smem_bytes if route == "sm90" \
        else lib.flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(head_dim))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           softcap: Optional[float], window: Optional[int]) -> None:
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"attention needs q [B, Hq, S, D] and k, v "
                         f"[B, Hkv, S, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[1] == 0 or q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"Hq = {q.shape[1]} is not a multiple of "
                         f"Hkv = {k.shape[1]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous and 16-byte aligned, copying only if it is not.

    `models.attention._project_qkv`'s einsums return permuted views, so on
    the model path this copies q, k and v once each; the kernel takes no
    strides."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, softcap: Optional[float] = None,
              window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention: q [B, Hq, S, D], k and v [B, Hkv, S, D], float32 or
    bfloat16 -> [B, Hq, S, D] in q's dtype.

    ``window = w`` keeps keys with ``pos_q - w < pos_k <= pos_q``;
    ``scale`` defaults to ``D ** -0.5``.  On the card D must be a multiple
    of 4 and at most 256.
    """
    _check(q, k, v, softcap, window)
    if q.device.type == "cpu":
        plain = attention_chunked if q.shape[2] >= _CHUNK_THRESHOLD \
            else attention_ref
        return plain(q, k, v, causal=causal, softcap=softcap, window=window,
                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, causal, softcap, window, scale,
                   _route(q.dtype, q.shape[3]))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            softcap: Optional[float], window: Optional[int],
            scale: Optional[float], route: str) -> torch.Tensor:
    """Launch the `route` kernel on checked CUDA tensors.  `attention`
    calls it with `_route`'s choice; chip_smoke.py also times the "simt"
    kernel in bf16 through it."""
    global LAUNCHES
    b, hq, s, d = q.shape
    if (route, q.dtype) not in _SYMBOLS or d % 4 != 0 or d > _MAX_HEAD_DIM \
            or (route == "sm90" and d not in _SM90_HEAD_DIMS):
        raise ValueError(f"the {route!r} kernel does not take {q.dtype} at "
                         f"head_dim {d} (simt: a multiple of 4 up to "
                         f"{_MAX_HEAD_DIM}; sm90: bf16 at {_SM90_HEAD_DIMS})")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else d ** -0.5
    with named_scope(f"flash_attention_{route}"), torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher(route, q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            k.shape[1], s, d, int(causal),
            float(softcap) if softcap is not None else 0.0,
            int(window) if window is not None else 0, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_KERNEL[route] += 1
    return out

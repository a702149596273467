"""Dispatching wrapper of the flash-attention kernel.

`attention` sends CPU tensors to the plain PyTorch version (`ref.py`:
`attention_ref`, or `attention_chunked` from S = 4096 on, as the JAX
package's ``ops.attention`` does) and launches the hand-written CUDA
kernel (`csrc/flash_attention.cu`, replacing the JAX package's
``kernels/flash_attention/kernel.py::flash_attention_pallas``) for CUDA
tensors.  A CUDA tensor never falls back: if the kernel cannot be built or
launched, the call raises.  The JAX package's ``use_pallas``/``bq``/``bk``
knobs do not carry over; the device chooses the version.

On the card the kernel's least time is its operations (4 D flops per
unmasked (query, key) pair and head) at the tensor cores' dense bf16 rate:
0.56 ms for one Gemma2-9B global layer at S = 8192, 0.42 ms for a local
one.  The kernel runs float32 FMAs on the CUDA cores, far from that bound
(its times are in PERF.md).

`LAUNCHES` counts kernel launches (and nothing else), so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ...obs.profiler import named_scope
from .ref import attention_chunked, attention_ref

__all__ = ["attention", "smem_bytes", "LAUNCHES"]

LAUNCHES = 0

_CHUNK_THRESHOLD = 4096  # the plain version goes q-block by q-block from here
_MAX_HEAD_DIM = 256
_SYMBOLS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_launchers = {}


def _launcher(dtype: torch.dtype):
    fn = _launchers.get(dtype)
    if fn is None:
        fn = getattr(_build.load("flash_attention"), _SYMBOLS[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _launchers[dtype] = fn
    return fn


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one kernel block at `head_dim`, in bytes
    (builds the kernel library if needed)."""
    fn = _build.load("flash_attention").flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(head_dim))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           softcap: Optional[float], window: Optional[int]) -> None:
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SYMBOLS:
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
    global LAUNCHES
    _check(q, k, v, softcap, window)
    if q.device.type == "cpu":
        plain = attention_chunked if q.shape[2] >= _CHUNK_THRESHOLD \
            else attention_ref
        return plain(q, k, v, causal=causal, softcap=softcap, window=window,
                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, hq, s, d = q.shape
    if d % 4 != 0 or d > _MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim a multiple of 4 up to "
                         f"{_MAX_HEAD_DIM}; got {d}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else d ** -0.5
    with named_scope("flash_attention"), torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            k.shape[1], s, d, int(causal),
            float(softcap) if softcap is not None else 0.0,
            int(window) if window is not None else 0, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out

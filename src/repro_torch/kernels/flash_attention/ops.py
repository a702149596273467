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

Gradients.  Where autograd needs one (grad enabled and q, k or v
requiring grad), a CUDA call goes through `_Attention`, a
``torch.autograd.Function`` whose forward launches the same kernel as
above and saves q, k, v and the output, and whose backward launches one
of two deterministic backward kernels (dq, dk, dv), chosen by
`_bwd_route` from dtype and head dim alone:

- ``"bwd_sm90"`` (`csrc/flash_attention_bwd_sm90.cu`): bf16 on the tensor
  cores at head dims 64 and 128.  It reads each row's logsumexp from the
  sm90 forward, which `_Attention` asks for (and saves) on this route;
  without it `_launch_bwd` raises;
- ``"bwd"`` (`csrc/flash_attention_bwd.cu`): float32 FMAs on the CUDA
  cores, float32 or bf16, any head dim the CUDA-core forward takes; it
  recomputes the logsumexp itself.

The JAX package has no counterpart: its Pallas kernel defines no VJP, and
its train paths differentiate ``ref.attention_ref`` with XLA.  Under
``inference_mode``, or with no input requiring grad, nothing is saved, no
logsumexp is written, and the forward gives the same bits as without
autograd.  A CPU call is differentiated through the plain version by
autograd itself.

`LAUNCHES` counts kernel launches (and nothing else), so a run can show
that its path went through a kernel; `LAUNCHES_BY_KERNEL` splits the count
by route ("sm90", "simt") and counts the backward's ("bwd_sm90", "bwd")
apart.
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
LAUNCHES_BY_KERNEL: Dict[str, int] = {"sm90": 0, "simt": 0, "bwd": 0,
                                      "bwd_sm90": 0}

_CHUNK_THRESHOLD = 4096  # the plain version goes q-block by q-block from here
_MAX_HEAD_DIM = 256
_SM90_HEAD_DIMS = (64, 128, 192, 256)
_BWD_SM90_HEAD_DIMS = (64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_SYMBOLS = {("simt", torch.float32): "flash_attention_f32",
            ("simt", torch.bfloat16): "flash_attention_bf16",
            ("sm90", torch.bfloat16): "flash_attention_bf16_sm90"}
_BWD_SYMBOLS = {("bwd", torch.float32): "flash_attention_bwd_f32",
                ("bwd", torch.bfloat16): "flash_attention_bwd_bf16",
                ("bwd_sm90", torch.bfloat16): "flash_attention_bwd_bf16_sm90"}
_TAIL = [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
# pointers, then b, hq, hkv, s, d, causal, then softcap, window, scale,
# stream; the sm90 forward takes lse after o, the sm90 backward lse,
# dq, dk, dv and its two scratch buffers after do
_ARGTYPES = {"simt": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + _TAIL,
             "sm90": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + _TAIL,
             "bwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + _TAIL,
             "bwd_sm90": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + _TAIL}
_launchers = {}


def _route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel takes a CUDA call: "sm90" for bf16 at the head dims the
    tensor-core kernel is built for, "simt" for everything else."""
    return "sm90" if dtype == torch.bfloat16 \
        and head_dim in _SM90_HEAD_DIMS else "simt"


def _bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which backward kernel takes a CUDA call: "bwd_sm90" for bf16 at the
    head dims the tensor-core backward is built for, "bwd" for everything
    else."""
    return "bwd_sm90" if dtype == torch.bfloat16 \
        and head_dim in _BWD_SM90_HEAD_DIMS else "bwd"


def _launcher(route: str, dtype: torch.dtype):
    """The C launcher of `route` ("sm90", "simt", "bwd" or "bwd_sm90") for
    `dtype`."""
    fn = _launchers.get((route, dtype))
    if fn is None:
        fn = getattr(_build.load("flash_attention"),
                     {**_SYMBOLS, **_BWD_SYMBOLS}[route, dtype])
        fn.argtypes = _ARGTYPES[route]
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
    route = _route(q.dtype, q.shape[3])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, softcap, window, scale,
                                route)
    return _launch(q, k, v, causal, softcap, window, scale, route)


class _Attention(torch.autograd.Function):
    """The `route` kernel forward, the `_bwd_route` kernel backward; on the
    "bwd_sm90" route the forward also writes each row's logsumexp, which
    the backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softcap, window, scale, route):
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        if _bwd_route(q.dtype, q.shape[3]) == "bwd_sm90":
            out, lse = _launch(q, k, v, causal, softcap, window, scale, route,
                               with_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = _launch(q, k, v, causal, softcap, window, scale, route)
            ctx.save_for_backward(q, k, v, out)
        ctx.args = (causal, softcap, window, scale)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, *lse = ctx.saved_tensors
        return (*_launch_bwd(q, k, v, out, dout, *ctx.args,
                             lse=lse[0] if lse else None),
                None, None, None, None, None)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            softcap: Optional[float], window: Optional[int],
            scale: Optional[float], route: str, with_lse: bool = False):
    """Launch the `route` kernel on checked CUDA tensors.  `attention`
    calls it with `_route`'s choice; chip_smoke.py also times the "simt"
    kernel in bf16 through it.  With `with_lse` (the "sm90" route only)
    it returns (out, lse): lse [B, Hq, S] float32, each row's logsumexp in
    the kernel's log2 units (the natural one times log2(e)); the output is
    the same bits either way."""
    global LAUNCHES
    b, hq, s, d = q.shape
    if (route, q.dtype) not in _SYMBOLS or d % 4 != 0 or d > _MAX_HEAD_DIM \
            or (route == "sm90" and d not in _SM90_HEAD_DIMS) \
            or (with_lse and route != "sm90"):
        raise ValueError(f"the {route!r} kernel does not take {q.dtype} at "
                         f"head_dim {d}{' with lse' if with_lse else ''} "
                         f"(simt: a multiple of 4 up to {_MAX_HEAD_DIM}; "
                         f"sm90: bf16 at {_SM90_HEAD_DIMS}, the only one "
                         f"that writes lse)")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    scale = scale if scale is not None else d ** -0.5
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if route == "sm90":
        ptrs.append(lse.data_ptr() if with_lse else None)
    with named_scope(f"flash_attention_{route}"), torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher(route, q.dtype)(
            *ptrs, b, hq, k.shape[1], s, d, int(causal),
            float(softcap) if softcap is not None else 0.0,
            int(window) if window is not None else 0, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_KERNEL[route] += 1
    return (out, lse) if with_lse else out


def _bwd_sm90_rows(s: int) -> int:
    """float2 entries of the sm90 backward's (lse, Dsum) scratch a (b, q
    head): S rounded up to the dq pass's 128-row tile (the kernel's own
    `s_pad`)."""
    fn = _launchers.get("bwd_sm90_rows")
    if fn is None:
        fn = _build.load("flash_attention").flash_attention_bwd_sm90_rows
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
        _launchers["bwd_sm90_rows"] = fn
    return int(fn(s))


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, dout: torch.Tensor, causal: bool,
                softcap: Optional[float], window: Optional[int],
                scale: Optional[float], lse: Optional[torch.Tensor] = None,
                route: Optional[str] = None):
    """(dq, dk, dv) from the `route` backward kernel (`_bwd_route`'s choice
    by default), on checked CUDA tensors: q, k, v and `out` as the forward
    saw them, `dout` the output's gradient, and on the "bwd_sm90" route
    `lse`, the sm90 forward's logsumexp (`_launch(..., with_lse=True)`),
    without which it raises (the CUDA-core route recomputes its own and
    takes none).  `_Attention.backward` calls it; chip_smoke.py times both
    routes in bf16 through it."""
    global LAUNCHES
    b, hq, s, d = q.shape
    route = route or _bwd_route(q.dtype, d)
    if (route, q.dtype) not in _BWD_SYMBOLS or d % 4 != 0 \
            or d > _MAX_HEAD_DIM \
            or (route == "bwd_sm90" and d not in _BWD_SM90_HEAD_DIMS):
        raise ValueError(f"the {route!r} backward kernel does not take "
                         f"{q.dtype} at head_dim {d} (bwd: float32 or bf16, "
                         f"a multiple of 4 up to {_MAX_HEAD_DIM}; bwd_sm90: "
                         f"bf16 at {_BWD_SM90_HEAD_DIMS})")
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} and out "
                         f"{tuple(out.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    if route == "bwd_sm90":
        if lse is None:
            raise ValueError(f"the bwd_sm90 kernel (bf16, head_dim {d}) "
                             f"reads the forward's logsumexp: pass lse= "
                             f"from _launch(..., with_lse=True)")
        if lse.shape != q.shape[:3] or lse.dtype != torch.float32 \
                or lse.device != q.device:
            raise ValueError(f"lse must be float32 {tuple(q.shape[:3])} on "
                             f"{q.device}; got {lse.dtype} "
                             f"{tuple(lse.shape)} on {lse.device}")
    elif lse is not None:
        raise ValueError(f"the {route!r} kernel recomputes the logsumexp "
                         f"and takes no lse")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out, dout = _aligned(out), _aligned(dout.to(q.dtype))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    scale = scale if scale is not None else d ** -0.5
    f32 = {"dtype": torch.float32, "device": q.device}
    if route == "bwd_sm90":
        # the kernel's scratch: (lse, do . o) rows, and with GQA the float32
        # per-q-head partials of dk and dv that its last pass sums
        rows = torch.empty(b * hq * _bwd_sm90_rows(s) * 2, **f32)
        part = torch.empty(2 * q.numel(), **f32) if hq > k.shape[1] else None
        ptrs = [q, k, v, out, dout, lse.contiguous(), dq, dk, dv, rows, part]
    else:
        # per-row log-sum-exp and do . o, written by the kernel's first pass
        scratch = torch.empty((b, hq, s), **f32)
        ptrs = [q, k, v, out, dout, dq, dk, dv, scratch,
                torch.empty_like(scratch)]
    with named_scope(f"flash_attention_{route}"), \
            torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _launcher(route, q.dtype)(
            *(t.data_ptr() if t is not None else None for t in ptrs),
            b, hq, k.shape[1], s, d, int(causal),
            float(softcap) if softcap is not None else 0.0,
            int(window) if window is not None else 0, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {route} backward kernel launch "
                           f"failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_KERNEL[route] += 1
    return dq, dk, dv

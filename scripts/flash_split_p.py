"""Why the tensor-core flash-attention kernel splits P, measured on the card.

`src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu`
feeds the softmax numerator p to the P V product as two bf16 operands,
p_hi = bf16(p) and p_lo = bf16(p - p_hi).  Built with -DFLASH_SM90_PLAIN_P
it uses p_hi alone: the textbook FlashAttention rounding.  This script
builds the source both ways (nvcc, the flags of `kernels/_build.py`, into
build/split_p/), runs both on the same bf16 inputs (seeded, as
chip_smoke.py makes them) at the Gemma2-9B prefill shapes (B = 1, 16/8
heads, S = 8192, D = 256, softcap 50, window 4096 and none) and at S =
1024, and prints one JSON line per shape and build: the largest difference
from the plain version (`attention_chunked`), the worst share of
chip_smoke.py's one-rounding bar (2^-7 |ref| + 1e-5, element by element)
and the kernel's median time over 10 calls.  Then the card's name and
power limit.

    python scripts/flash_split_p.py          # on a machine with the card
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_chunked  # noqa: E402

SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "flash_attention",
                      "csrc", "flash_attention_sm90.cu")
OUT = os.path.join(ROOT, "build", "split_p")
BUILDS = {"split_p": [], "plain_p": ["-DFLASH_SM90_PLAIN_P"]}
BAR = {"atol": 1e-5, "rtol": 2.0 ** -7}  # chip_smoke.FLASH_BF16_BAR
SHAPES = [(8192, 4096), (8192, None), (1024, None)]  # S, window


def build():
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, defs in BUILDS.items():
        lib = os.path.join(OUT, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-shared", "-o", lib,
             SOURCE], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        fn = ctypes.CDLL(lib).flash_attention_bf16_sm90
        fn.argtypes = ops._ARGTYPES["sm90"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, q, k, v, softcap, window):
    out = torch.empty_like(q)
    b, hq, s, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
             b, hq, k.shape[1], s, d, 1, softcap, window or 0, d ** -0.5,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def median_ms(fn, samples=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main():
    if not torch.cuda.is_available():
        print("flash_split_p: needs a CUDA card", file=sys.stderr)
        return 2
    fns = build()
    for s, window in SHAPES:
        rng = np.random.default_rng(1)
        q, k, v = (torch.from_numpy(rng.standard_normal(shape) * 0.5).to(
            "cuda", torch.bfloat16) for shape in ((1, 16, s, 256),
                                                  (1, 8, s, 256),
                                                  (1, 8, s, 256)))
        want = attention_chunked(q, k, v, softcap=50.0, window=window).float()
        for name, fn in fns.items():
            got = launch(fn, q, k, v, 50.0, window).float()
            diff = (got - want).abs()
            share = diff / (BAR["atol"] + BAR["rtol"] * want.abs())
            print(json.dumps({
                "build": name, "shape": [1, 16, 8, s, 256], "softcap": 50.0,
                "window": window, "max_abs_err": float(diff.max()),
                "worst_share_of_bar": float(share.max()),
                "elements_over_bar": int((share > 1).sum()),
                "ms": median_ms(lambda: launch(fn, q, k, v, 50.0, window))}),
                flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

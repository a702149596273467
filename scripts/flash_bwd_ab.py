"""Where the tensor-core attention backward's time goes, and whether the sm90
forward's output bits moved when it gained its lse argument.

At each shape below the script runs the sm90 forward once for o and its
logsumexp, calls the "bwd_sm90" backward through `ops._launch_bwd` (the
path's own build and scratch), holds dq, dk, dv against the plain backward
(`attention_backward_ref`) at chip_smoke.py's bf16 bar (2e-2 of each
gradient's largest magnitude), times the call (CUDA events, median of 10,
L2 emptied before each, as chip_smoke.py's `gpu_ms`) and splits one call
into its kernels (dq pass, dk/dv pass, group sum) under torch.profiler.
One JSON line per shape, then the card's name and power limit.

With ``--parent DIR`` (a checkout of the parent commit, e.g. ``git
archive <parent> | tar -x -C build/parent``) it first builds that tree's
sm90 forward (`flash_attention_sm90.cu`, which had no lse argument) and
prints, at the forward's path shapes, whether this tree's forward gives
the same output bits, with its lse pointer null and set.

    python scripts/flash_bwd_ab.py [--parent build/parent]   # on the card
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_backward_ref  # noqa: E402

OUT = os.path.join(ROOT, "build", "flash_bwd_ab")
# b, hq, hkv, s, d, causal: the qwen2-0.5b train layer (g = 7), the same at
# B = 1 (a quarter of the dk/dv blocks), and a GQA 2:1 head at D = 128
SHAPES = [(4, 14, 2, 2048, 64, True), (1, 14, 2, 2048, 64, True),
          (1, 8, 4, 4096, 128, True)]
# the forward's path shapes, b, hq, hkv, s, d, causal, softcap, window:
# the qwen2 train layer, a Gemma2-9B local and global layer, the MoE and
# Griffin prefill layers, whisper's encoder
FWD_SHAPES = [(4, 14, 2, 2048, 64, True, None, None),
              (1, 16, 8, 8192, 256, True, 50.0, 4096),
              (1, 16, 8, 8192, 256, True, 50.0, None),
              (1, 16, 16, 4096, 128, True, None, None),
              (1, 16, 1, 4096, 256, True, None, 2048),
              (1, 8, 8, 1500, 64, False, None, None)]
TOL = chip_smoke.FLASH_BWD_TOL["bfloat16"]


def parent_forward_bits(tree):
    """One JSON line a forward path shape: the parent tree's sm90 forward
    and this tree's (lse null, lse set) give the same output bits."""
    lib = os.path.join(OUT, "parent_forward.so")
    src = os.path.join(tree, "src", "repro_torch", "kernels",
                       "flash_attention", "csrc", "flash_attention_sm90.cu")
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", lib, src], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent:\n{out.stderr}")
    fn = ctypes.CDLL(lib).flash_attention_bf16_sm90
    fn.argtypes = ops._ARGTYPES["simt"]  # the parent's: no lse
    fn.restype = ctypes.c_int
    for b, hq, hkv, s, d, causal, cap, win in FWD_SHAPES:
        rng = np.random.default_rng(6)
        q, k, v = (torch.from_numpy(rng.standard_normal(sh) * 0.5).to(
            "cuda", torch.bfloat16) for sh in ((b, hq, s, d), (b, hkv, s, d),
                                               (b, hkv, s, d)))
        old = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), old.data_ptr(),
                 b, hq, hkv, s, d, int(causal), cap or 0.0, win or 0,
                 d ** -0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent launch failed: CUDA error {err}")
        new = ops._launch(q, k, v, causal, cap, win, None, "sm90")
        new_lse, _ = ops._launch(q, k, v, causal, cap, win, None, "sm90",
                                 with_lse=True)
        print(json.dumps({"forward_shape": [b, hq, hkv, s, d],
                          "causal": causal, "softcap": cap, "window": win,
                          "bits_equal_parent": torch.equal(old, new),
                          "bits_equal_parent_with_lse":
                          torch.equal(old, new_lse)}), flush=True)
        del q, k, v, old, new, new_lse
        torch.cuda.empty_cache()


def launch(q, k, v, o, do, lse, causal):
    """dq, dk, dv from the path's "bwd_sm90" kernel."""
    return ops._launch_bwd(q, k, v, o, do, causal, None, None, None, lse=lse,
                           route="bwd_sm90")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of the parent commit: "
                    "compare its sm90 forward's output bits first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 2
    if args.parent:
        os.makedirs(OUT, exist_ok=True)
        parent_forward_bits(args.parent)
    for b, hq, hkv, s, d, causal in SHAPES:
        rng = np.random.default_rng(5)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(sh) * sc).to(
            "cuda", torch.bfloat16) for sh, sc in (((b, hq, s, d), 0.5),
                                                   ((b, hkv, s, d), 0.5),
                                                   ((b, hkv, s, d), 0.5),
                                                   ((b, hq, s, d), 1.0)))
        o, lse = ops._launch(q, k, v, causal, None, None, None, "sm90",
                             with_lse=True)
        want = attention_backward_ref(q, k, v, do, causal=causal)
        got = launch(q, k, v, o, do, lse, causal)
        share = max(float((g.float() - w.float()).abs().max())
                    / (TOL * float(w.float().abs().max()))
                    for g, w in zip(got, want))
        if share > 1.0:
            raise AssertionError(f"bwd_sm90 misses the bar: {share}")
        prof = chip_smoke.device_time_by_kernel(
            torch, lambda: launch(q, k, v, o, do, lse, causal))
        print(json.dumps({
            "shape": [b, hq, hkv, s, d], "causal": causal,
            "dkdv_blocks": -(-s // 128) * b * hq, "share_of_bar": share,
            "ms": chip_smoke.gpu_ms(
                torch, lambda: launch(q, k, v, o, do, lse, causal),
                samples=10),
            "kernels_ms": {r["kernel"]: r["ms"] for r in prof.get("top", [])},
            "bound_ms": chip_smoke.flash_bwd_bound_ms(
                b, hq, hkv, s, d, causal, None, 2)[0]}), flush=True)
        del q, k, v, do, o, lse, want, got
        torch.cuda.empty_cache()
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Count the kernel-launching ops of the port's SSM and encoder-decoder
paths on the CPU, at full depth and narrow widths.

A launch count depends on the depth, the sequence length and the chunking,
not on the widths, so narrow float32 models (falcon-mamba-7b's 64 layers at
d_model 64; whisper-base's 6 + 6 layers at d_model 64, 8 heads of 8) run
here in seconds.  Under `torch.profiler` on the CPU, every leaf `aten::` op
that is not a view, a reshape or an allocation counts as one launch.
Printed: a falcon-mamba prefill (B = 1, S = 4096) and decode step (B = 4),
a whisper-base prefill (B = 1, 1500 frames, 448 tokens), `init_cache` (B
= 4, the encoder over 1500 frames) and decode step.  On the card, bf16
adds casts that float32 skips, and some ops launch more or fewer kernels,
so these are estimates for a prediction, not device counts.

    PYTHONPATH=src python scripts/count_model_ops.py
"""
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# ops that launch no kernel: views, reshapes, allocations, dtype queries
NO_KERNEL = {
    "aten::empty", "aten::empty_like", "aten::empty_strided", "aten::view",
    "aten::_unsafe_view", "aten::_reshape_alias", "aten::reshape",
    "aten::slice", "aten::select", "aten::as_strided", "aten::expand",
    "aten::t", "aten::transpose", "aten::permute", "aten::unsqueeze",
    "aten::squeeze", "aten::split", "aten::split_with_sizes",
    "aten::narrow", "aten::alias", "aten::detach", "aten::lift_fresh",
    "aten::resolve_conj", "aten::resolve_neg", "aten::unbind",
    "aten::result_type", "aten::item", "aten::_local_scalar_dense",
    "aten::numpy_T"}


def count(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    ops = [e for e in prof.events() if e.name.startswith("aten::")]
    leaves = [e for e in ops if not any(c.name.startswith("aten::")
                                        for c in e.cpu_children)]
    return sum(1 for e in leaves if e.name not in NO_KERNEL)


def main():
    torch.set_num_threads(4)
    gen = torch.Generator().manual_seed(0)
    cfg = get_config("falcon-mamba-7b").with_(d_model=64, vocab_size=512,
                                              dtype="float32")
    mamba = build_model(cfg, device="cpu")
    toks = torch.randint(0, 512, (4, 4096), generator=gen)
    print("falcon-mamba prefill, S = 4096:",
          count(lambda: mamba.forward(toks[:1])))
    cache = mamba.init_cache(4, 48)
    print("falcon-mamba decode step, B = 4:",
          count(lambda: mamba.decode_step(cache, toks[:, :1], 3)))
    cfg = get_config("whisper-base").with_(
        d_model=64, num_heads=8, num_kv_heads=8, head_dim=8, d_ff=128,
        vocab_size=512, dtype="float32")
    whisper = build_model(cfg, device="cpu")
    frames = torch.randn(4, 1500, 64, generator=gen)
    print("whisper-base prefill, 1500 frames + 448 tokens:",
          count(lambda: whisper.forward(toks[:1, :448], frames[:1])))
    print("whisper-base init_cache, B = 4:",
          count(lambda: whisper.init_cache(4, 48, frames=frames)))
    cache = whisper.init_cache(4, 48, frames=frames)
    print("whisper-base decode step, B = 4:",
          count(lambda: whisper.decode_step(cache, toks[:, :1], 5)))


if __name__ == "__main__":
    main()

"""The MoE router's position scan along the outer and the innermost dim, on
the card.

`repro_torch.models.mlp.moe_route` gives each (token, k) slot its position
in its expert's capacity buffer: the number of earlier slots of its group
that chose the same expert, an exclusive running count over the group's
g * K slots for each of the E experts.  Laid out [G, g*K, E], the count is
a scan along an outer dim; laid out [G, E, g*K] (what `moe_route` does),
along the innermost one.  This script times both at the prefill shapes of
deepseek-moe-16b (T = 4096 tokens, E = 64, K = 6, groups of 2048) and
qwen2-moe-a2.7b (E = 64 padded, K = 4), in turns (outer, innermost,
innermost, outer), checks that both give the same positions, times one
whole MoE layer (`_moe_local`: route, dispatch, expert GEMMs, combine;
bf16, random weights at the published widths) and runs it once more under
``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises).  One
JSON line per shape, then the card's name and power limit.

    PYTHONPATH=src python scripts/moe_route_ab.py    # on a machine with the card
"""
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402

T = 4096


def positions_outer(idx, e_total):
    """The running count with the scan along an outer dim ([G, g*K, E])."""
    ngroups, g, k = idx.shape
    flat = idx.view(ngroups, g * k, 1)
    onehot = flat == torch.arange(e_total, device=idx.device)
    earlier = torch.cumsum(onehot, dim=1) - onehot.long()
    return earlier.gather(2, flat).view(ngroups, g, k)


def positions_inner(idx, e_total):
    """The running count as `moe_route` forms it ([G, E, g*K])."""
    ngroups, g, k = idx.shape
    flat = idx.view(ngroups, 1, g * k)
    onehot = flat == torch.arange(e_total, device=idx.device).view(1, -1, 1)
    earlier = torch.cumsum(onehot, dim=2) - onehot.long()
    return earlier.gather(1, flat).view(ngroups, g, k)


def event_ms(fn, reps=20):
    """Median of `reps` CUDA-event timings of one call, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
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
        print("moe_route_ab: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("deepseek-moe-16b", "qwen2-moe-a2.7b"):
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = init_params(mlp.moe_defs(cfg), gen, torch.bfloat16, "cuda")
        x = torch.randn(T, cfg.d_model, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        capacity = max(1, int(cfg.moe_capacity_factor * T * cfg.top_k
                              / cfg.experts_padded))
        r = mlp.moe_route(p["router"], x, cfg, capacity)
        e = cfg.experts_padded
        same = bool(torch.equal(positions_outer(r.idx, e),
                                positions_inner(r.idx, e)))
        runs = []
        for name in ("outer", "inner", "inner", "outer"):
            fn = positions_outer if name == "outer" else positions_inner
            runs.append((name, event_ms(lambda: fn(r.idx, e))))
        layer_ms = event_ms(lambda: mlp._moe_local(
            p, x, cfg, 0, cfg.experts_padded, capacity), reps=10)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            mlp._moe_local(p, x, cfg, 0, cfg.experts_padded, capacity)
            sync_free = True
        except RuntimeError:
            sync_free = False
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(json.dumps({
            "arch": arch, "tokens": T, "experts": e, "top_k": cfg.top_k,
            "group": r.g, "cap": r.cap, "positions_equal": same,
            "scan_ms_in_turns": runs, "moe_layer_ms": layer_ms,
            "moe_layer_sync_free": sync_free,
            "kept_slots": int(r.within.sum()),
            "slots": int(r.within.numel())}), flush=True)
        del p, x, r
        torch.cuda.empty_cache()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

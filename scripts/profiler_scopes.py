"""How `torch.profiler` attributes device time to a `named_scope`, on the
card, at falcon-mamba-7b's prefill.

`chip_smoke.py`'s prefill breakdown reports the device time of each
`named_scope` ("mamba.scan", "griffin.scan", "moe.experts", ...).  The
profiler's own figure for a scope, the `device_time_total` of its CPU
event, sums the kernels it links to the CPU ops inside the scope; the
smoke script reads the scope off the device timeline instead
(`chip_smoke.scope_device_ms`: the kernels that ran inside the scope's
device-side ranges).  This script runs one falcon-mamba-7b prefill (bf16,
random weights from seed 0, B = 1, S = 4096: 16 scan chunks of 256 a
layer) under the profiler at 2 layers and at all 64, and prints for each
one JSON line: the device time (every kernel and copy), the "mamba.scan"
scope both ways, the kernels the profiler linked to CPU events beside the
device's kernel count, and the CPU events that share an id.  Then, by
CUDA events, `selective_scan` alone on one layer's shapes times the
layers: the scan's share by another clock.  Last, the card's name and
power limit.

    PYTHONPATH=src python scripts/profiler_scopes.py    # on a machine with the card
"""
import collections
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import gpu_ms, scope_device_ms  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.mamba import selective_scan  # noqa: E402

ARCH = "falcon-mamba-7b"
SEQ = 4096
SCOPE = "mamba.scan"


def profiled_prefill(layers):
    cfg = get_config(ARCH).with_(num_layers=layers)
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=gen,
                           device="cuda")
    model.forward(tokens)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.forward(tokens)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    linked = [k.duration for e in cpu for k in e.kernels]
    ids = collections.Counter(e.id for e in cpu)
    row = {
        "arch": ARCH, "layers": layers, "seq": SEQ,
        "device_ms": sum(e.time_range.end - e.time_range.start
                         for e in device) / 1e3,
        "device_kernels": len(device),
        "profiler_linked_kernels": len(linked),
        "profiler_linked_ms": sum(linked) / 1e3,
        "cpu_events": len(cpu),
        "cpu_ids_shared": sum(1 for n in ids.values() if n > 1),
        "scope_device_time_total_ms": sum(e.device_time_total for e in cpu
                                          if e.name == SCOPE) / 1e3,
        "scope_timeline_ms": scope_device_ms(events, (SCOPE,)).get(SCOPE),
    }
    del model
    torch.cuda.empty_cache()
    return row


def scan_by_cuda_events(layers):
    """`selective_scan` on one layer's shapes (bf16 x, dt, B, C as the
    mixer gives them; float32 a and D), median of 5, times `layers`."""
    cfg = get_config(ARCH)
    e, n = cfg.d_inner, cfg.ssm_state
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    x, dt = rand(1, SEQ, e), F.softplus(rand(1, SEQ, e) - 2.0)
    a = -torch.exp(0.1 * rand(e, n, dtype=torch.float32))
    b, c = rand(1, SEQ, n), rand(1, SEQ, n)
    d = torch.ones(e, device="cuda")
    ms = gpu_ms(torch, lambda: selective_scan(x, dt, a, b, c, d), samples=5,
                warmup=1)
    return {"scan_ms_a_layer": ms, "layers": layers, "scan_ms": ms * layers}


def main():
    if not torch.cuda.is_available():
        print("profiler_scopes: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = [profiled_prefill(layers) for layers in (2, 64)]
    cuda = scan_by_cuda_events(64)
    cuda["share_of_device_ms"] = cuda["scan_ms"] / rows[-1]["device_ms"]
    for row in rows + [cuda]:
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
